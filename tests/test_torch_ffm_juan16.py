"""The port's field-aware FM at Juan et al.'s (2016) Criteo settings (39
fields, k = 4, no bias or linear term, instance-normalised values,
adagrad with eps 1, V ~ U(0, 1/sqrt(k))) against the benchmark's plain
per-pair reference (``portbench/reference/ffm.py``, float64), which the
JAX package cannot stand in for: it does not train this model from
these settings. Also the reference's score against the port's three FFM
forms, the benchmark cell at a CPU size (the program correct, the
planted faults and the bf16 reference failing its limits), the count of
the step's work against a brute count, the configuration's widths, the
fused step's spans and counter, and the cell's four readers.

Tolerances of the three fused steps, each from the float32 program
against float64:

- losses rtol 1e-6: float32 sums of 741 pair products over 64 examples
  read ~1e-7 apart;
- adagrad's slots after step 1 rtol 1e-4, atol 1e-15: each is a sum of
  a few squared per-slot gradients of ~1e-5, whose float32 products
  round at ~1e-7 relative;
- V after 3 steps atol 2e-7: |v| <= 0.5, where a float32 ulp is 6e-8,
  and each step rounds each touched coordinate once (an update of ~1e-5
  a step carries no more rounding than that).
"""

import json
import math
import os
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import profile

from portbench import harness
from portbench.counts import ffm_sgd
from portbench.gen import ffm as gen_ffm
from portbench.reference import ffm as R
from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.data import batching as PB
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import interaction as I
from sparkfm_tpu_torch.solvers import sgd as sgd_solver
from sparkfm_tpu_torch.solvers import sgd_fused
from sparkfm_tpu_torch.utils import profiling

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "portbench", "configs", "criteo-ffm-juan16.json")
CELL = "ffm-train-criteo"
SEED = 2 ** 31 + 99
F, FIELDS, K, B = 1 << 10, 39, 4, 64
LR, EPS, REG_V = 0.2, 1.0, 1e-5


def _cfg(**kw):
    return FMConfig(**dict(dict(
        num_features=F, num_factors=K, num_fields=FIELDS,
        slot_major_fields=True, use_bias=False, use_linear=False,
        task=Task.CLASSIFICATION, reg_w=0.0, reg_v=REG_V), **kw))


def _data(seed=0, n=3 * B):
    """Slot l holds field l; zipf-repeated ids a field, so rows repeat
    within and across batches; values 1/sqrt(39); random labels."""
    rng = np.random.default_rng(seed)
    per = F // FIELDS
    ids = ((rng.zipf(1.5, (n, FIELDS)) - 1) % per
           + per * np.arange(FIELDS)).astype(np.int32)
    vals = gen_ffm.normalized(np.ones((n, FIELDS), np.float32))
    y = rng.integers(0, 2, n).astype(np.float32)
    return PB.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)


@pytest.mark.parametrize("accumulate,host", [
    ("auto", False), ("segsum", False), ("scatter", True), ("segsum", True)])
def test_three_fused_steps_match_the_reference(accumulate, host):
    cfg = _cfg()
    sgd = SGDConfig(batch_size=B, optimizer="adagrad", learning_rate=LR,
                    adagrad_eps=EPS, update_path="fused", host_plan=host,
                    accumulate=accumulate)
    ds = _data(1)
    w0, w, v = gen_ffm.ffm_weights(F, FIELDS, K, 5, "cpu")
    assert float(v.min()) >= 0 and float(v.max()) <= 1 / math.sqrt(K)
    state = sgd_fused.fused_from_params(FMParams(w0, w, v), cfg,
                                        device="cpu")
    step = sgd_fused.make_fused_train_step(cfg, sgd)
    plan_kw = dict(dedup_budget="ladder", dedup_fill=F) if host else {}
    losses, slot1, snaps = [], None, []
    for batch in PB.batch_iterator(ds, B, device="cpu", **plan_kw):
        state, aux = step(state, batch)
        losses.append(float(aux["loss"]))
        if slot1 is None:
            slot1 = state.table[:F, FIELDS * K:2 * FIELDS * K].clone()
        snaps.append(state.table[:F].clone())
    rows = np.unique(ds.ids)
    batches = [{"idx": torch.as_tensor(np.searchsorted(rows,
                                                       ds.ids[s:s + B])),
                "vals": torch.as_tensor(ds.vals[s:s + B]),
                "y": torch.as_tensor(ds.y[s:s + B]),
                "field_ids": torch.arange(FIELDS).expand(B, -1)}
               for s in range(0, 3 * B, B)]
    r = torch.as_tensor(rows, dtype=torch.long)
    ref = R.sgd_steps(v[r], batches, fields=FIELDS, lr=LR, eps=EPS,
                      reg_v=REG_V, block=16)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-6)
    np.testing.assert_allclose(slot1[r].double().numpy(),
                               ref["slot1"].numpy(), rtol=1e-4, atol=1e-15)
    vk = FIELDS * K
    got = snaps[-1][r, :vk].double()
    np.testing.assert_allclose(got.numpy(), ref["params"][-1].numpy(),
                               rtol=0, atol=2e-7)
    # the steps moved V by far more than the tolerance
    assert float((ref["params"][-1] - v[r].double()).abs().max()) > 1e-5
    # no bias and no linear term: w, its slot and w0 stay 0
    assert not snaps[-1][:, 2 * vk:2 * vk + 2].any()
    assert float(state.w0) == 0.0 and float(state.slot_w0) == 0.0


def test_the_cells_model_takes_the_fused_path():
    cfg = _cfg(num_features=1 << 20)
    sgd = SGDConfig(batch_size=65536, optimizer="adagrad", learning_rate=LR,
                    adagrad_eps=EPS, host_plan=False)
    assert sgd_solver.resolve_update_path(cfg, sgd) == "fused"
    assert sgd_fused.record_width(K, FIELDS) == 316


@pytest.mark.parametrize("b,fields,k,seed", [(6, 39, 4, 0), (5, 6, 3, 1),
                                             (4, 7, 2, 2)])
def test_pair_scores_match_the_ports_forms(b, fields, k, seed):
    g = torch.Generator().manual_seed(seed)
    vr = torch.randn((b, fields, fields * k), generator=g,
                     dtype=torch.float64)
    x = torch.rand((b, fields), generator=g, dtype=torch.float64)
    x[0, 1] = 0.0                               # an empty slot
    slot_major = torch.arange(fields).expand(b, -1)
    want = R.pair_scores(vr, x, slot_major, fields)
    got = I.ffm_interaction_slot_major(vr.view(b, fields, fields, k), x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    got = I.ffm_interaction_from_rows(vr, x, slot_major, fields)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    # random fields, several slots a field: the field-aggregated and the
    # port's pairwise forms against the per-pair sum
    fid = torch.randint(0, fields, (b, fields), generator=g)
    want = R.pair_scores(vr, x, fid, fields)
    got = I.ffm_interaction_from_rows(vr, x, fid, fields)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
    zero = torch.zeros((), dtype=torch.float64)
    got = I.ffm_scores_pairwise(zero, torch.zeros_like(x), vr, x, fid,
                                fields, use_bias=False, use_linear=False,
                                compute_dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)


def test_pair_scores_by_hand():
    # two slots of fields 0 and 1: <v[a, 1], v[c, 0]> x_a x_c
    vr = torch.tensor([[[1., 2., 3., 4.], [5., 6., 7., 8.]]],
                      dtype=torch.float64)          # fields 2, k 2
    x = torch.tensor([[0.5, 2.0]], dtype=torch.float64)
    got = R.pair_scores(vr, x, torch.tensor([[0, 1]]), 2)
    assert float(got) == (3 * 5 + 4 * 6) * 0.5 * 2.0
    shared = R.pair_scores(vr, x, torch.tensor([[0, 1]]), 2, "shared")
    assert float(shared) == (1 * 7 + 2 * 8) * 0.5 * 2.0


def _tiny(tmp) -> tuple:
    """(spec, root, bench dir) of a benchmark whose FFM configuration is
    cut to a CPU size: 2^16 buckets (so that "auto" takes the fused
    path), 1,024 examples, B = 128; the 39 fields and k = 4 kept."""
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    c = json.load(open(CONFIG))
    c.update(num_buckets=1 << 16, num_examples=1024)
    c["training"]["batch_size"] = 128
    c["assumed"].update(categorical_cardinalities=[7, 50, 300, 20] * 6
                        + [11, 13], integer_cardinalities=[16] * 13)
    entry = next(e for e in spec["configs"]
                 if e["name"] == "criteo-ffm-juan16")
    os.makedirs(os.path.join(tmp, "b", "configs"))
    entry["file"] = "b/configs/criteo-ffm-juan16.json"
    json.dump(c, open(os.path.join(tmp, entry["file"]), "w"))
    json.dump(spec, open(os.path.join(tmp, "BENCHMARK.json"), "w"))
    return spec, tmp, os.path.join(tmp, "b")


@pytest.fixture
def tiny_cell(tmp_path):
    spec, root, bench = _tiny(str(tmp_path))
    return harness.resolve_cell(spec, CELL, root, bench)


def test_the_cell_is_correct_and_traced_on_the_cpu(tiny_cell):
    line = harness.run_cell(tiny_cell, SEED, 0.3, True, torch.device("cpu"),
                            time.perf_counter())
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(tiny_cell.limits)
    assert line["metrics"]["mfu_pct.train"]["value"] > 0
    # the CPU records no device times: the FFM readers read None
    assert not any(m.startswith("ffm.") for m in line["metrics"])


@pytest.mark.parametrize("stand_in", ["bfloat16", "float64:half",
                                      "float64:shared", "float64:stale"])
def test_faults_and_bf16_fail_the_limits(tiny_cell, stand_in):
    ctx = harness.Context(tiny_cell, SEED, 0.0, False, torch.device("cpu"),
                          time.perf_counter())
    dtype, _, fault = stand_in.partition(":")
    readings = harness.entry_of(tiny_cell).stand_in(
        ctx, getattr(torch, dtype), fault or None)
    assert readings["leaves_counted"] == FIELDS
    ok, checks = harness.judge(readings, tiny_cell.limits)
    assert not ok, checks


def test_float32_reference_in_the_programs_place_passes(tiny_cell):
    ctx = harness.Context(tiny_cell, SEED, 0.0, False, torch.device("cpu"),
                          time.perf_counter())
    readings = harness.entry_of(tiny_cell).stand_in(ctx, torch.float32)
    ok, checks = harness.judge(readings, tiny_cell.limits)
    assert ok, checks


def _brute_step_work(batch, fields, distinct, k):
    flops = nbytes = 0
    vk = fields * k
    for _ in range(batch):
        for a in range(fields):
            for c in range(a + 1, fields):
                flops += 2 * k + 3          # dot, x_a x_c, add
                flops += 2 + 2 * k          # kappa x_a x_c, two gradients
        for _ in range(fields):
            flops += 2 * vk + 3 * (vk + 1)  # L2 gradient, sums, squares
            nbytes += 4 + 4                 # id, value
        flops += 8                          # loss and its gradient
        nbytes += 4 + 4                     # label, score
    for _ in range(distinct):
        flops += 6 * (vk + 1)
        nbytes += 2 * 4 * (2 * vk + 2)
    return {"flops": float(flops), "bytes": float(nbytes + 4)}


@pytest.mark.parametrize("batch,fields,distinct,k", [(2, 3, 4, 2),
                                                     (3, 5, 7, 4)])
def test_step_work_against_a_brute_count(batch, fields, distinct, k):
    assert ffm_sgd.step_work(batch, fields, distinct, k) == \
        _brute_step_work(batch, fields, distinct, k)


def test_interaction_bytes_against_a_brute_count():
    fields, k, examples = 3, 2, 5
    nbytes = 0
    for _ in range(examples):
        for _ in range(fields):
            nbytes += 4 * (fields * k + 1)      # [v | w] row read
            nbytes += 4                         # its value
            nbytes += 4 * (fields * k + 1)      # its gradient written
        nbytes += 4                             # the score
    assert ffm_sgd.interaction_bytes(examples * fields, fields, k) == nbytes


def test_the_configuration_keeps_the_published_widths():
    c = json.load(open(CONFIG))
    pub = c["published"]
    assert c["num_factors"] == pub["k"] == 4
    assert c["num_fields"] == pub["fields"] == 39
    assert c["num_integer_fields"] + c["num_categorical_fields"] == 39
    assert len(c["assumed"]["categorical_cardinalities"]) == 26
    assert len(c["assumed"]["integer_cardinalities"]) == 13
    assert c["reg_v"] == pub["lambda"] / 2
    assert c["training"]["learning_rate"] == pub["eta"]
    assert c["training"]["adagrad_eps"] == 1.0
    assert c["use_bias"] is False and c["use_linear"] is False
    assert c["instance_normalization"] is True
    assert c["reduced"] == ["num_examples"]
    assert c["num_examples"] < pub["num_examples"]
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    entry = next(e for e in spec["configs"]
                 if e["name"] == "criteo-ffm-juan16")
    assert entry["reduced"] == ["num_examples"]
    assert entry["source"] == c["source"]
    cell = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["chips"]) == ("criteo-ffm-juan16", 1)


@pytest.fixture
def record():
    profiling.clear()
    yield
    profiling.clear()


@pytest.mark.parametrize("fields", [0, FIELDS])
def test_the_fused_step_records_its_spans_and_slots(record, fields):
    """Three host spans a step (no device times on the CPU), one after
    another under the enclosing span, and the counter of B * L slots;
    nothing outside a profiler session."""
    cfg = _cfg(num_fields=fields, slot_major_fields=fields > 0)
    sgd = SGDConfig(batch_size=B, optimizer="adagrad", learning_rate=LR,
                    update_path="fused", host_plan=False)
    state = sgd_fused.init_fused_state(cfg, device="cpu")
    step = sgd_fused.make_fused_train_step(cfg, sgd)
    batches = list(PB.batch_iterator(_data(2, 2 * B), B, device="cpu"))
    step(state, batches[0])
    assert profiling.recorded() == {"spans": {}, "counters": {}}
    with profile():
        with profiling.annotate("train.dispatch"):
            for batch in batches:
                step(state, batch)
    got = profiling.recorded()
    for name in ("fused.rows", "fused.interaction", "fused.update"):
        span = got["spans"][name]
        assert span["calls"] == 2 and span["device_s"] is None
        assert span["parent"] == "train.dispatch"
    assert got["counters"] == {"fused.slot_rows": 2 * B * FIELDS}


READERS = ["ffm.rows_ms.train", "ffm.interaction_ms.train",
           "ffm.update_ms.train", "ffm.interaction_roofline.train"]
SPANS = {"ffm.rows_ms.train": "fused.rows",
         "ffm.interaction_ms.train": "fused.interaction",
         "ffm.update_ms.train": "fused.update"}
REC = types.SimpleNamespace(window_s=2.0, steps=8,
                            notes={"ffm_fields": FIELDS, "ffm_k": K},
                            peaks={"hbm_bytes_per_s": 3.35e12})


def _reader(name):
    path = os.path.join(ROOT, "portbench", "metrics", name + ".py")
    return harness.load_module(path, "test_reader_" + name.replace(".", "_")
                               ).read


def _fused_record(monkeypatch, device):
    """Eight fused steps' spans and slot counts recorded in a session,
    their device times set by hand (the CPU records none)."""
    with profile():
        for _ in range(REC.steps):
            profiling.count("fused.slot_rows", 65536 * FIELDS)
            for name in ("fused.rows", "fused.interaction", "fused.update"):
                with profiling.annotate(name):
                    pass
    recorded = profiling.recorded

    def with_device():
        out = recorded()
        for span, secs in device.items():
            out["spans"][span]["device_s"] = secs
        return out
    monkeypatch.setattr(profiling, "recorded", with_device)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_none_without_its_span(record, name):
    assert _reader(name)(REC) is None
    with profile():
        for span in SPANS.values():         # spans with no device time
            with profiling.annotate(span):
                pass
        profiling.count("fused.slot_rows", 64)
    assert _reader(name)(REC) is None


def test_readers_read_device_ms_a_step_and_the_roofline(record,
                                                        monkeypatch):
    device = {"fused.rows": 0.016, "fused.interaction": 0.08,
              "fused.update": 0.024}
    _fused_record(monkeypatch, device)
    for name, span in SPANS.items():
        assert _reader(name)(REC) == pytest.approx(1e3 * device[span] / 8)
    slots = 8 * 65536 * FIELDS
    want = (100.0 * ffm_sgd.interaction_bytes(slots, FIELDS, K) / 3.35e12
            / 0.08)
    got = _reader("ffm.interaction_roofline.train")(REC)
    assert got == pytest.approx(want)
    # 8 steps of 65,536 examples move 25.8 GB at least, 7.7 ms at
    # 3.35 TB/s: 9.6% of 80 ms
    assert 9 < got < 10
    no_notes = types.SimpleNamespace(**dict(vars(REC), notes={}))
    assert _reader("ffm.interaction_roofline.train")(no_notes) is None
