"""The port's fused train step against the JAX package's
``make_fused_train_step``, both started from the same fused table (carried
across by ``fused_state_from_numpy``) on the same batches: host ladder
plans or plans built in the step (``host_plan=False``), the scatter and
segsum reduces, the three optimizers, both tasks, masked tails, attribute
groups, and no linear term or bias.

Tolerance: rtol 1e-5, atol 1e-6 after one step; after 20 steps losses at
rtol 1e-4 and tables ``[:F, :2k+2]`` at rtol 2e-4, atol 2e-5 (float32 sums
in another order, compounded through the adagrad accumulators; the
sorted path's parity test in the JAX package holds itself to the fused
step at the same tolerance)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.config import FMConfig as JFMConfig
from sparkfm_tpu.config import SGDConfig as JSGDConfig
from sparkfm_tpu.config import Task as JTask
from sparkfm_tpu.data import batching as jbatching
from sparkfm_tpu.models.fm import FMParams as JFMParams
from sparkfm_tpu.solvers import sgd_fused as jfused
from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.data import batching as pbatching
from sparkfm_tpu_torch.ops import segsum
from sparkfm_tpu_torch.solvers import sgd as psgd
from sparkfm_tpu_torch.solvers import sgd_fused

torch.set_num_threads(1)
F, K, L, B, N = 500, 4, 6, 128, 700
BUDGET = 512
STEPS = 20
GROUPS = dict(feature_groups=tuple(i % 3 for i in range(F)),
              group_reg_w=(0.01, 0.0, 0.05), group_reg_v=(0.03, 0.1, 0.0))


def _data(task: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.5, (N, L)) % F).astype(np.int32)
    vals = np.where(rng.random((N, L)) < 0.1, 0.0,
                    rng.normal(1.0, 0.5, (N, L))).astype(np.float32)
    y = (rng.integers(0, 2, N) if task == "classification"
         else rng.normal(3.0, 1.0, N)).astype(np.float32)
    params = (np.float32(0.2), rng.normal(0, 0.1, F).astype(np.float32),
              rng.normal(0, 0.1, (F, K)).astype(np.float32))
    return ids, vals, y, params


def _configs(task, fm_kw=None, **sgd_kw):
    kw = dict(num_features=F, num_factors=K, reg0=0.01, reg_w=0.02,
              reg_v=0.03, seed=7, **(fm_kw or {}))
    skw = dict(dict(batch_size=B, learning_rate=0.1, unique_budget=BUDGET,
                    update_path="fused"), **sgd_kw)
    return (JFMConfig(task=JTask(task), **kw), JSGDConfig(**skw),
            FMConfig(task=Task(task), **kw), SGDConfig(**skw))


def _batches(pkg, ids, vals, y, host):
    """STEPS batches over shuffled epochs (every 6th is a masked tail),
    with host plans or none."""
    kw = dict(shuffle=True, seed=7)
    if host:
        kw.update(dedup_budget=BUDGET, dedup_fill=F)
    mod = jbatching if pkg == "jax" else pbatching
    ds = mod.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    out = []
    epoch = 0
    while len(out) < STEPS:
        out.extend(jbatching.batch_iterator(ds, B, epoch=epoch, **kw)
                   if pkg == "jax" else
                   pbatching.batch_iterator(ds, B, device="cpu", epoch=epoch,
                                            **kw))
        epoch += 1
    return out[:STEPS]


def _states(jcfg, pcfg, params):
    w0, w, v = params
    jstate = jfused.fused_from_params(
        JFMParams(w0=jnp.asarray(w0), w=jnp.asarray(w), v=jnp.asarray(v)),
        jcfg)
    pstate = sgd_fused.fused_state_from_numpy(
        np.asarray(jstate.table), np.asarray(jstate.w0),
        np.asarray(jstate.slot_w0), np.asarray(jstate.step), pcfg,
        device="cpu")
    return jstate, pstate


def _assert_close(jstate, jaux, pstate, paux, rtol, atol, loss_rtol):
    np.testing.assert_allclose(float(paux["loss"]), float(jaux["loss"]),
                               rtol=loss_rtol, atol=1e-6)
    np.testing.assert_allclose(paux["scores"].numpy(),
                               np.asarray(jaux["scores"]), rtol=rtol,
                               atol=atol)
    used = 2 * K + 2
    np.testing.assert_allclose(pstate.table[:F, :used].numpy(),
                               np.asarray(jstate.table)[:F, :used],
                               rtol=rtol, atol=atol)
    for name in ("w0", "slot_w0"):
        np.testing.assert_allclose(getattr(pstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=rtol, atol=atol, err_msg=name)
    assert int(pstate.step) == int(jstate.step)
    assert int(paux["unique_count"]) == int(jaux["unique_count"])
    assert bool(paux["unique_overflow"]) == bool(jaux["unique_overflow"])


CASES = [  # (task, optimizer, accumulate, host plans, FMConfig extras)
    ("regression", "adagrad", "scatter", True, None),
    ("classification", "adagrad", "auto", True, None),
    ("regression", "adagrad_row", "scatter", True, None),
    ("classification", "sgd", "scatter", True, None),
    ("classification", "adagrad", "segsum", True, None),
    ("regression", "adagrad_row", "segsum", True, None),
    ("classification", "adagrad", "scatter", False, None),
    ("regression", "sgd", "segsum", False, None),
    ("classification", "adagrad", "segsum", True, GROUPS),
    ("regression", "adagrad", "scatter", True,
     dict(use_linear=False, use_bias=False)),
]


def _count_calls(monkeypatch, module, *names):
    """Count the calls of ``module.<name>`` for each name (the CPU runs
    the kernels' plain versions, whose launch counts stay 0)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("task,opt,accumulate,host,fm_kw", CASES)
def test_fused_step_matches_jax(task, opt, accumulate, host, fm_kw,
                                monkeypatch):
    """Also the route of the per-unique sums: on sorted runs adagrad and
    sgd sum ``[g_v | g_w]`` by B6, which forms the squares, and
    adagrad_row its (N, k+3) pack by B5; the scatter reduce neither."""
    calls = _count_calls(monkeypatch, segsum, "segment_rowsum",
                         "segment_rowsum_sq")
    ids, vals, y, params = _data(task)
    jcfg, jsgd, pcfg, psgd_cfg = _configs(task, fm_kw, optimizer=opt,
                                          accumulate=accumulate,
                                          host_plan=host)
    jb = _batches("jax", ids, vals, y, host)
    pb = _batches("torch", ids, vals, y, host)
    assert not bool(pb[5].mask.all())                 # a masked tail
    assert (pb[0].plan is not None) == host
    jstep = jfused.make_fused_train_step(jcfg, jsgd)
    pstep = sgd_fused.make_fused_train_step(pcfg, psgd_cfg)
    jstate, pstate = _states(jcfg, pcfg, params)
    table = pstate.table
    rowsum_before = segsum.ROWSUM.launches
    for i in range(STEPS):
        jstate, jaux = jstep(jstate, jb[i])
        pstate, paux = pstep(pstate, pb[i])
        assert pstate.table is table                  # updated in place
        if i == 0:
            _assert_close(jstate, jaux, pstate, paux, 1e-5, 1e-6, 1e-5)
    _assert_close(jstate, jaux, pstate, paux, 2e-4, 2e-5, 1e-4)
    assert segsum.ROWSUM.launches == rowsum_before    # CPU: plain versions
    sorted_runs = accumulate == "segsum"              # "auto": CPU scatter
    b6 = STEPS if sorted_runs and opt != "adagrad_row" else 0
    b5 = STEPS if sorted_runs and opt == "adagrad_row" else 0
    assert calls == {"segment_rowsum": b5, "segment_rowsum_sq": b6}


def test_device_plans_stay_on_the_device_side():
    """Without a host plan the step's count and overflow are tensors (no
    host number was read to build the plan)."""
    ids, vals, y, params = _data("classification", seed=2)
    jcfg, _, pcfg, psgd_cfg = _configs("classification", host_plan=False,
                                       accumulate="segsum")
    batch = _batches("torch", ids, vals, y, host=False)[0]
    _, pstate = _states(jcfg, pcfg, params)
    _, aux = sgd_fused.make_fused_train_step(pcfg, psgd_cfg)(pstate, batch)
    assert torch.is_tensor(aux["unique_count"])
    assert torch.is_tensor(aux["unique_overflow"])
    assert not bool(aux["unique_overflow"])


def test_valid_slots_from_host_and_device_counts():
    for count in (3, np.int32(3), torch.tensor(3, dtype=torch.int32)):
        assert sgd_fused.valid_slots(count, 5, "cpu").tolist() == [
            True, True, True, False, False]
    assert sgd_fused.valid_slots(torch.tensor(9), 4, "cpu").all()


def test_batch_loss_gathers_group_strengths():
    """With attribute groups each active slot is regularized by its
    feature's group strengths; with every group at the scalar strengths
    the loss equals the scalar form."""
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, F, (4, L)).astype(np.int32))
    vals = torch.from_numpy(rng.normal(size=(4, L)).astype(np.float32))
    batch = pbatching.SparseBatch(ids=ids, vals=vals, y=torch.ones(4),
                                  mask=torch.tensor([True] * 3 + [False]))
    w0 = torch.tensor(0.1)
    w_rows = torch.from_numpy(rng.normal(size=(4, L)).astype(np.float32))
    v_rows = torch.from_numpy(rng.normal(size=(4, L, K)).astype(np.float32))
    flat = FMConfig(num_features=F, num_factors=K, reg_w=0.02, reg_v=0.03)
    same = flat.replace(feature_groups=(0,) * F, group_reg_w=(0.02,),
                        group_reg_v=(0.03,))
    a = psgd._batch_loss_from_rows(w0, w_rows, v_rows, batch, flat)[0]
    b = psgd._batch_loss_from_rows(w0, w_rows, v_rows, batch, same,
                                   psgd.reg_vectors(same))[0]
    np.testing.assert_allclose(float(b), float(a), rtol=1e-6)
    assert psgd.reg_vectors(flat) is None


@pytest.mark.parametrize("fm_kw,sgd_kw,exc", [
    ({}, dict(optimizer="adam"), ValueError),
    ({}, dict(optimizer="sgd", momentum=0.9), ValueError),
    ({}, dict(accumulate="tree"), ValueError),
])
def test_restrictions_raise(fm_kw, sgd_kw, exc):
    _, _, pcfg, psgd_cfg = _configs("regression", fm_kw)
    with pytest.raises(exc):
        sgd_fused.make_fused_train_step(
            pcfg, dataclasses.replace(psgd_cfg, **sgd_kw))


@pytest.mark.parametrize("fm_kw,sgd_kw", [
    (dict(num_fields=2), {}),
    ({}, dict(update_path="dedup")),
    ({}, dict(update_path="direct")),
])
def test_steps_where_jax_steps(fm_kw, sgd_kw):
    """The JAX fused step takes an FFM record (vk = num_fields * K) and
    does not read update_path: both packages build the step and, from one
    table, take 3 steps that agree (losses rtol 1e-5, tables rtol 1e-4,
    atol 1e-6)."""
    ids, vals, y, (w0, w, _) = _data("regression", seed=5)
    vk = K * max(1, fm_kw.get("num_fields", 0))
    v = np.random.default_rng(5).normal(0, 0.1, (F, vk)).astype(np.float32)
    fids = (np.arange(L, dtype=np.int32) % 2)[None, :].repeat(N, 0)
    jcfg, jsgd, pcfg, psgd_cfg = _configs("regression", fm_kw, **sgd_kw)
    plan_kw = dict(dedup_budget=BUDGET, dedup_fill=F)
    jb = jbatching.batch_iterator(jbatching.SparseDataset(
        ids=ids, vals=vals, y=y, num_features=F, field_ids=fids), B,
        **plan_kw)
    pb = pbatching.batch_iterator(pbatching.SparseDataset(
        ids=ids, vals=vals, y=y, num_features=F, field_ids=fids), B,
        device="cpu", **plan_kw)
    jstep = jfused.make_fused_train_step(jcfg, jsgd)
    pstep = sgd_fused.make_fused_train_step(pcfg, psgd_cfg)
    jstate, pstate = _states(jcfg, pcfg, (w0, w, v))
    for _, jbatch, pbatch in zip(range(3), jb, pb):
        jstate, jaux = jstep(jstate, jbatch)
        pstate, paux = pstep(pstate, pbatch)
        np.testing.assert_allclose(float(paux["loss"]), float(jaux["loss"]),
                                   rtol=1e-5)
    used = 2 * vk + 2
    np.testing.assert_allclose(pstate.table[:F, :used].numpy(),
                               np.asarray(jstate.table)[:F, :used],
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("accumulate", ["auto", "segsum"])
def test_steps_per_dispatch_trains_one_step_at_a_time_as_jax(accumulate):
    """steps_per_dispatch groups hybrid steps only; the JAX trainer runs
    fused steps one by one whatever it says. A fused step built with 2
    trains: bit for bit the step built with 1, and the JAX fused step
    built with 2 at this file's tolerance."""
    ids, vals, y, params = _data("classification", seed=4)
    jcfg, jsgd, pcfg, psgd_cfg = _configs(
        "classification", accumulate=accumulate, steps_per_dispatch=2)
    jb = _batches("jax", ids, vals, y, host=True)
    pb = _batches("torch", ids, vals, y, host=True)
    jstep = jfused.make_fused_train_step(jcfg, jsgd)
    jstate, pstate = _states(jcfg, pcfg, params)
    _, single = _states(jcfg, pcfg, params)
    pstep = sgd_fused.make_fused_train_step(pcfg, psgd_cfg)
    one = sgd_fused.make_fused_train_step(
        pcfg, dataclasses.replace(psgd_cfg, steps_per_dispatch=1))
    for i in range(STEPS):
        jstate, jaux = jstep(jstate, jb[i])
        pstate, paux = pstep(pstate, pb[i])
        single, saux = one(single, pb[i])
        assert torch.equal(paux["loss"], saux["loss"])
    assert torch.equal(pstate.table, single.table)
    _assert_close(jstate, jaux, pstate, paux, 2e-4, 2e-5, 1e-4)


def test_auto_accumulate_takes_scatter_on_cpu_and_b5_on_the_card(
        monkeypatch):
    """"auto" keeps the JAX choice (index_add_ by rank) for CPU tensors
    and sums by B5 over sorted runs for CUDA tensors, whose sums repeat
    and which is ~25x faster than index_add_ at the main path's shape;
    "scatter" and "segsum" choose the same on both."""
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert not sgd_fused.segsum_accumulate("auto", cpu)
    assert sgd_fused.segsum_accumulate("auto", card)
    for device in (cpu, card):
        assert sgd_fused.segsum_accumulate("segsum", device)
        assert not sgd_fused.segsum_accumulate("scatter", device)
    # on the CPU, "auto" runs the scatter reduce and never the row sums
    calls = []
    monkeypatch.setattr(segsum, "segment_rowsum",
                        lambda *a: calls.append("B5"))
    ids, vals, y, params = _data("regression", seed=5)
    jcfg, _, pcfg, psgd_cfg = _configs("regression", accumulate="auto")
    batch = _batches("torch", ids, vals, y, host=True)[0]
    _, pstate = _states(jcfg, pcfg, params)
    _, aux = sgd_fused.make_fused_train_step(pcfg, psgd_cfg)(pstate, batch)
    assert calls == [] and bool(torch.isfinite(aux["loss"]))


def test_segsum_needs_the_sort_permutation():
    ids, vals, y, params = _data("regression")
    jcfg, _, pcfg, psgd_cfg = _configs("regression", accumulate="segsum")
    batch = _batches("torch", ids, vals, y, host=True)[0]
    _, pstate = _states(jcfg, pcfg, params)
    step = sgd_fused.make_fused_train_step(pcfg, psgd_cfg)
    with pytest.raises(ValueError, match="plan.order"):
        step(pstate, dataclasses.replace(
            batch, plan=batch.plan._replace(order=None)))
