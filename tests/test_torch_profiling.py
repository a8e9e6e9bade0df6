"""The port's profiling hooks (``utils/profiling.py``), after the JAX
package's ``utils/profiling.py``: the StepTimer's stats keys and sync
modes, a trace written to disk with the program's spans in it and the
NaN-check switch; and the record of spans and counters: off unless a
profiler session runs, parents and self times per thread, the spans and
counters of the input pipeline, the trainer and the ALS sweep, and the
host-to-device byte counts. Times taken here are CPU times and are only
checked to exist or against sleeps."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import profile

from sparkfm_tpu_torch import FMConfig, SGDConfig, train_sgd
from sparkfm_tpu_torch.config import ALSConfig
from sparkfm_tpu_torch.data import synth
from sparkfm_tpu_torch.data.batching import (SparseDataset, batch_iterator,
                                             prefetch)
from sparkfm_tpu_torch.models.fm import params_from_numpy
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.solvers import als as A
from sparkfm_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.mark.parametrize("sync", ["block", "fetch", "none"])
def test_step_timer_stats_keys(sync):
    timer = profiling.StepTimer(sync=sync)
    assert timer.stats() == {}
    for i in range(5):
        timer.start()
        out = {"aux": [torch.full((3,), float(i))]}
        assert timer.stop(out) >= 0.0
    stats = timer.stats()
    assert set(stats) == {"mean_ms", "p50_ms", "p95_ms", "steps"}
    assert stats["steps"] == 5
    assert 0.0 <= stats["p50_ms"] <= stats["p95_ms"]


def test_step_timer_rejects_an_unknown_sync():
    with pytest.raises(ValueError, match="sync"):
        profiling.StepTimer(sync="wait")


def test_first_tensor_walks_results():
    import dataclasses

    @dataclasses.dataclass
    class State:
        step: int
        table: torch.Tensor

    t = torch.ones(2)
    assert profiling._first_tensor((State(3, t), {"x": 1})) is t
    assert profiling._first_tensor({"a": [1, 2]}) is None


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    log_dir = str(tmp_path / "trace")
    ids = np.array([[5, 3, 5], [3, 9, 0]], np.int32)
    with profiling.trace(log_dir) as prof:
        with profiling.annotate("sfm_gather"):
            torch.ones(64).cumsum(0)
        E.host_dedup(ids, 8, 15)
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"sfm_gather", "plan.host_dedup"} <= names
    assert any(e.key == "sfm_gather" for e in prof.key_averages())


@pytest.mark.filterwarnings("ignore:Error detected")
def test_enable_nan_checks_toggles_anomaly_mode():
    try:
        profiling.enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (x / x).sum().backward()
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


@pytest.fixture
def record():
    """An empty record, emptied again after the test."""
    profiling.clear()
    yield
    profiling.clear()


def test_annotate_off_is_the_shared_noop_and_records_nothing(record):
    assert not profiling.session()
    span = profiling.annotate("a")
    assert span is profiling.annotate("b", device=True)
    with span:
        with profiling.annotate("c"):
            pass
    profiling.count("n", 3)
    t = torch.ones(4)
    profiling.count_h2d(t, "cuda")
    assert profiling.recorded() == {"spans": {}, "counters": {}}


def test_a_session_records_calls_host_time_parents_and_self_time(record):
    with profile():
        assert profiling.session()
        with profiling.annotate("outer"):
            time.sleep(0.02)
            for _ in range(2):
                with profiling.annotate("inner"):
                    time.sleep(0.01)
    assert not profiling.session()
    spans = profiling.recorded()["spans"]
    assert set(spans) == {"outer", "inner"}
    outer, inner = spans["outer"], spans["inner"]
    assert (outer["calls"], inner["calls"]) == (1, 2)
    assert (outer["parent"], inner["parent"]) == (None, "outer")
    assert inner["host_s"] >= 0.02 and inner["self_s"] == inner["host_s"]
    assert outer["host_s"] >= 0.04
    assert outer["self_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=1e-6)
    assert outer["self_s"] >= 0.02
    assert outer["device_s"] is None and inner["device_s"] is None


def test_a_span_on_a_second_thread_keeps_its_own_parent_chain(record):
    def worker():
        with profiling.annotate("thread.outer"):
            with profiling.annotate("thread.inner"):
                time.sleep(0.01)

    with profile():
        with profiling.annotate("main.outer"):
            t = threading.Thread(target=worker)
            t.start()
            with profiling.annotate("main.inner"):
                t.join()
    spans = profiling.recorded()["spans"]
    assert spans["thread.outer"]["parent"] is None
    assert spans["thread.inner"]["parent"] == "thread.outer"
    assert spans["main.inner"]["parent"] == "main.outer"
    # the thread's spans are not the main thread's children
    main = spans["main.outer"]
    assert main["self_s"] == pytest.approx(
        main["host_s"] - spans["main.inner"]["host_s"], abs=1e-6)


def test_a_span_closed_after_the_session_stops_is_recorded(record):
    with profiling.annotate("before"):      # opened off: not recorded
        prof = profile()
        prof.__enter__()
        span = profiling.annotate("across")
        span.__enter__()
        prof.__exit__(None, None, None)
    span.__exit__(None, None, None)
    assert set(profiling.recorded()["spans"]) == {"across"}


def test_device_spans_of_one_parent_share_events_and_stream(
        record, monkeypatch):
    clock = iter(range(100))

    class Event:                # a timing event on a clock of whole ms
        def __init__(self, stream):
            assert stream == "stream"
            self.t = next(clock)

        def elapsed_time(self, end):
            return float(end.t - self.t)
    streams = []
    monkeypatch.setattr(profiling, "_event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: streams.append(1) or "stream")
    with profile():
        for _ in range(2):                          # events 0-5, 6-11
            with profiling.annotate("outer", device=True):
                for name in ("a", "b", "c"):
                    with profiling.annotate(name, device=True):
                        pass
        with profiling.annotate("host"):            # no events
            pass
    spans = profiling.recorded()["spans"]
    # 6 events a pass, not 8: b and c start at a's and b's end events;
    # the stream is looked up once a pass, by the outer span
    assert next(clock) == 12 and len(streams) == 2
    assert spans["outer"]["device_s"] == pytest.approx(2 * 5e-3)
    for name in ("a", "b", "c"):
        assert spans[name]["device_s"] == pytest.approx(2 * 1e-3)
    assert spans["host"]["device_s"] is None


def test_count_adds_only_in_a_session(record):
    profiling.count("copies", 5)
    with profile():
        profiling.count("copies", 2)
        profiling.count("copies", 3)
        profiling.count("other", 1)
    profiling.count("copies", 7)
    assert profiling.recorded()["counters"] == {"copies": 5, "other": 1}
    profiling.clear()
    assert profiling.recorded() == {"spans": {}, "counters": {}}


def test_h2d_bytes_are_counted_by_source_memory(record, monkeypatch):
    arrays = [np.zeros((16, 39), np.int32), np.ones((16,), np.float32),
              np.zeros((16,), bool)]
    with profile():
        # on the CPU nothing is copied to a card, so nothing is counted
        for a in arrays:
            out = profiling.to_device(a, "cpu")
            assert out.device.type == "cpu"
            np.testing.assert_array_equal(out.numpy(), a)
        assert profiling.recorded()["counters"] == {}
        for a in arrays:
            profiling.count_h2d(torch.as_tensor(a), torch.device("cuda"))
        profiling.count_h2d(torch.ones(3), "cpu")
        monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)
        profiling.count_h2d(torch.ones(10), "cuda")
    assert profiling.recorded()["counters"] == {
        "copy.h2d_pageable_bytes": sum(a.nbytes for a in arrays),
        "copy.h2d_pinned_bytes": 40}


def test_to_device_copies_a_host_tensor_when_asked(record):
    t = torch.arange(6)
    assert profiling.to_device(t, "cpu") is t
    c = profiling.to_device(t, "cpu", copy=True)
    assert c is not t and torch.equal(c, t)


def _ctr(n=300, seed=3):
    ds = synth.synth_ctr(num_examples=n, num_fields=5, num_buckets=997,
                         seed=seed)
    return ds


def test_batch_iterator_records_a_batch_and_a_plan_each(record):
    ds = _ctr()
    with profile():
        batches = list(batch_iterator(ds, 64, device="cpu",
                                      dedup_budget="ladder",
                                      dedup_fill=ds.num_features))
    assert len(batches) == 5
    rec = profiling.recorded()
    spans = rec["spans"]
    assert set(spans) == {"data.batch", "plan.host_dedup"}
    assert spans["data.batch"]["calls"] == 5
    assert spans["plan.host_dedup"]["calls"] == 5
    assert spans["plan.host_dedup"]["parent"] == "data.batch"
    assert rec["counters"] == {}            # CPU batches: no copies


def test_prefetch_records_the_consumers_wait(record):
    def slow():
        for i in range(4):
            time.sleep(0.005)
            yield i

    with profile():
        assert list(prefetch(slow(), depth=1)) == [0, 1, 2, 3]
    wait = profiling.recorded()["spans"]["data.prefetch_wait"]
    assert wait["calls"] == 5               # four items and the end
    assert wait["parent"] is None and wait["host_s"] > 0


@pytest.mark.parametrize("path", ["hybrid", "fused"])
def test_train_sgd_records_dispatches_and_epoch_ends(record, path):
    ds = _ctr(n=300)
    cfg = FMConfig(num_features=ds.num_features, num_factors=4, seed=1)
    sgd_cfg = SGDConfig(batch_size=64, learning_rate=0.05, epochs=2,
                        update_path=path, host_plan=path == "hybrid")
    with profile():
        res = train_sgd(cfg, sgd_cfg, ds, device="cpu")
    assert len(res.history) == 2
    spans = profiling.recorded()["spans"]
    assert spans["train.dispatch"]["calls"] == 2 * 5
    assert spans["train.epoch_end"]["calls"] == 2
    assert spans["train.dispatch"]["parent"] is None
    assert spans["data.prefetch_wait"]["calls"] == 2 * 6
    assert spans["data.batch"]["calls"] == 2 * 5
    plans = spans.get("plan.host_dedup", {"calls": 0})["calls"]
    assert plans == (2 * 5 if path == "hybrid" else 0)


def test_als_sweep_records_its_phases_per_factor_and_block(record):
    rng = np.random.default_rng(4)
    n, users, movies, k = 400, 30, 20, 3
    ids = np.stack([rng.integers(0, users, n),
                    users + rng.integers(0, movies, n)], 1).astype(np.int32)
    ds = SparseDataset(ids=ids, vals=np.ones((n, 2), np.float32),
                       y=rng.normal(size=n).astype(np.float32),
                       num_features=users + movies)
    cfg = FMConfig(num_features=users + movies, num_factors=k, reg_v=0.1)
    ws, nb = A.build_workspace(ds, cfg,
                               ALSConfig(feature_blocks=A.slot_blocks(ds)),
                               device="cpu")
    assert nb == 2
    p = params_from_numpy(np.float32(0.1),
                          rng.normal(0, 0.1, users + movies)
                          .astype(np.float32),
                          rng.normal(0, 0.1, (users + movies, k))
                          .astype(np.float32), device="cpu")
    nr = int(ws.present.shape[0])
    with profile():
        for _ in range(2):
            p = A.als_sweep_compact(p, ws, nb, nr, 0.0, 0.0, 0.1,
                                    column_pure=True, csc_uniform=True)
    spans = profiling.recorded()["spans"]
    for name in ("als.sweep", "als.forward", "als.linear"):
        assert spans[name]["calls"] == 2
    for name in ("als.stream_sums", "als.solve", "als.patch"):
        assert spans[name]["calls"] == 2 * k * nb
        assert spans[name]["parent"] == "als.sweep"
    assert spans["als.forward"]["parent"] == "als.sweep"
    assert all(s["device_s"] is None for s in spans.values())


@pytest.mark.cuda
def test_card_spans_time_the_device_and_count_copies(record):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(1 << 24, device="cuda")
    host = np.ones((1 << 20,), np.float32)
    pinned = torch.ones(1 << 18).pin_memory()
    with profile():
        with profiling.annotate("card.work", device=True):
            for _ in range(20):
                x = x * 1.0001
        profiling.to_device(host, "cuda")
        profiling.to_device(pinned, "cuda", non_blocking=True)
    rec = profiling.recorded()
    assert rec["spans"]["card.work"]["device_s"] > 0
    assert rec["counters"] == {"copy.h2d_pageable_bytes": host.nbytes,
                               "copy.h2d_pinned_bytes": pinned.nbytes}


@pytest.mark.parametrize("path", ["dedup", "direct"])
def test_deepfm_step_records_its_four_spans_without_a_host_sync(
        record, monkeypatch, path):
    """Each DeepFM step (adam, dropout 0.5) records deepfm.gather,
    deepfm.dense, deepfm.update and deepfm.tower_update once, each a child
    of the trainer's dispatch, and reads nothing of the device to the
    host after its first step (which reads the global step once for the
    dropout masks): any read of a tensor's value raises there."""
    from sparkfm_tpu_torch.models import deepfm as DF
    ds = synth.synth_ctr(num_examples=256, num_fields=5, num_buckets=1 << 16,
                         seed=3)
    cfg = DF.DeepFMConfig(fm=FMConfig(num_features=ds.num_features,
                                      num_factors=4, num_fields=5, seed=2),
                          hidden=(8, 8), dropout=0.5)
    sgd_cfg = SGDConfig(optimizer="adam", batch_size=64, update_path=path)
    state = DF.initial_state(cfg, sgd_cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = DF.make_train_step(cfg, sgd_cfg)
    batches = list(batch_iterator(ds, 64, device="cpu"))
    names = ("deepfm.gather", "deepfm.dense", "deepfm.update",
             "deepfm.tower_update")
    with profile():
        with profiling.annotate("train.dispatch"):
            step(state, batches[0])

        def no_sync(*a, **k):
            raise AssertionError("the step read a tensor to the host")
        for attr in ("item", "tolist", "__bool__", "__int__", "__float__",
                     "__index__"):
            monkeypatch.setattr(torch.Tensor, attr, no_sync)
        monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
        for b in batches[1:]:
            with profiling.annotate("train.dispatch"):
                step(state, b)
        monkeypatch.undo()
    spans = profiling.recorded()["spans"]
    assert spans["train.dispatch"]["calls"] == len(batches) == 4
    for name in names:
        assert spans[name]["calls"] == 4, name
        assert spans[name]["parent"] == "train.dispatch"
        assert spans[name]["device_s"] is None      # no card: no events
    assert int(state.fm.step) == 4
