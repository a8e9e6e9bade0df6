"""The benchmark's readers of the port's spans and counters
(``portbench/metrics/``): each gives None where its span or counter was
not recorded, and the value its docstring defines from a record filled on
the CPU under a profiler session. Device times come from CUDA events, so
the ALS readers are given a record whose device times are set by hand."""

import os
import time
import types

import pytest
from torch.profiler import profile

from portbench import harness
from sparkfm_tpu_torch.utils import profiling

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench", "metrics")
READERS = ["data.input_wait_pct.train", "plan.host_dedup_ms.train",
           "copy.h2d_pageable_mb_per_step.train", "als.gather_ms.als",
           "als.streams_ms.als", "als.patch_ms.als",
           "als.stream_sums_ms.als", "deepfm.dense_ms.train",
           "deepfm.dense_fp32_pct.train", "deepfm.rows_ms.train",
           "deepfm.tower_update_ms.train", "xdeepfm.cin_ms.train",
           "xdeepfm.cin_fp32_pct.train"]
REC = types.SimpleNamespace(window_s=2.0, steps=8,
                            notes={"deepfm_dense_flops": 4.7e10,
                                   "xdeepfm_cin": {"fields": 39, "k": 10,
                                                   "widths": [200, 200,
                                                              200]}},
                            peaks={"fp32_flops_per_s": 67e12})
DEEPFM = ("deepfm.gather", "deepfm.dense", "deepfm.update",
          "deepfm.tower_update")


def _reader(name):
    return harness.load_module(os.path.join(METRICS, name + ".py"),
                               "test_reader_" + name.replace(".", "_")).read


@pytest.fixture
def record():
    profiling.clear()
    yield
    profiling.clear()


def _fill():
    """Spans and counters of a few steps, recorded in a session."""
    with profile():
        for _ in range(3):
            with profiling.annotate("data.prefetch_wait"):
                time.sleep(0.002)
        for _ in range(4):
            with profiling.annotate("data.batch"):
                with profiling.annotate("plan.host_dedup"):
                    time.sleep(0.001)
        profiling.count("copy.h2d_pageable_bytes", 18_100_000)
        profiling.count("copy.h2d_pageable_bytes", 18_100_000)
        profiling.count("copy.h2d_pinned_bytes", 5)
        with profiling.annotate("als.sweep"):
            for name in ("als.gather", "als.streams", "als.colsums",
                         "als.stream_sums", "als.patch"):
                with profiling.annotate(name):
                    pass
    return profiling.recorded()


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_none_without_its_span(record, name):
    assert _reader(name)(REC) is None
    with profile():
        with profiling.annotate("something.else"):
            pass
        profiling.count("copy.h2d_pinned_bytes", 64)
    assert _reader(name)(REC) is None


def test_input_wait_is_the_waits_share_of_the_window(record):
    wait = _fill()["spans"]["data.prefetch_wait"]
    got = _reader("data.input_wait_pct.train")(REC)
    assert got == pytest.approx(100.0 * wait["host_s"] / REC.window_s)
    assert got >= 100.0 * 3 * 0.002 / REC.window_s


def test_host_dedup_ms_is_the_mean_plan_time(record):
    plan = _fill()["spans"]["plan.host_dedup"]
    assert plan["calls"] == 4
    got = _reader("plan.host_dedup_ms.train")(REC)
    assert got == pytest.approx(1e3 * plan["host_s"] / 4)
    assert got >= 1.0


def test_pageable_mb_per_step_reads_the_counter(record):
    _fill()
    got = _reader("copy.h2d_pageable_mb_per_step.train")(REC)
    assert got == pytest.approx(2 * 18.1 / REC.steps)


@pytest.mark.parametrize("name", ["als.gather", "als.streams", "als.patch",
                                  "als.stream_sums"])
def test_als_readers_read_device_ms_a_sweep(record, monkeypatch, name):
    rec = _fill()
    reader = _reader(name + "_ms.als")
    # on the CPU the spans carry no device time: nothing to read
    assert rec["spans"][name]["device_s"] is None
    assert reader(REC) is None
    device = {"als.gather": 0.504, "als.streams": 0.8, "als.patch": 0.2,
              "als.stream_sums": 0.3}
    recorded = profiling.recorded

    def with_device():
        out = recorded()
        for span, secs in device.items():
            out["spans"][span]["device_s"] = secs
        return out
    monkeypatch.setattr(profiling, "recorded", with_device)
    assert reader(REC) == pytest.approx(1e3 * device[name] / REC.steps)


def _deepfm_record(monkeypatch, device):
    """Eight DeepFM steps' spans recorded in a session, their device
    times set by hand (the CPU records none)."""
    with profile():
        for _ in range(REC.steps):
            with profiling.annotate("train.dispatch"):
                for name in DEEPFM:
                    with profiling.annotate(name):
                        pass
    recorded = profiling.recorded

    def with_device():
        out = recorded()
        for span, secs in device.items():
            out["spans"][span]["device_s"] = secs
        return out
    monkeypatch.setattr(profiling, "recorded", with_device)


def test_deepfm_readers_read_none_without_device_times(record):
    with profile():
        for name in DEEPFM:
            with profiling.annotate(name):
                pass
    for name in ("dense_ms", "dense_fp32_pct", "rows_ms", "tower_update_ms"):
        assert _reader(f"deepfm.{name}.train")(REC) is None


def test_deepfm_readers_read_device_ms_a_step(record, monkeypatch):
    device = {"deepfm.gather": 0.0016, "deepfm.dense": 0.012,
              "deepfm.update": 0.0024, "deepfm.tower_update": 0.004}
    _deepfm_record(monkeypatch, device)
    assert _reader("deepfm.dense_ms.train")(REC) == pytest.approx(1.5)
    assert _reader("deepfm.rows_ms.train")(REC) == pytest.approx(0.5)
    assert _reader("deepfm.tower_update_ms.train")(REC) == pytest.approx(
        0.5)
    # 8 calls of 4.7e10 FLOPs at 67 TFLOP/s over 12 ms of device time
    assert _reader("deepfm.dense_fp32_pct.train")(REC) == pytest.approx(
        100.0 * 8 * 4.7e10 / 67e12 / 0.012)
    # without the entry's count of the dense FLOPs: nothing to read
    no_note = types.SimpleNamespace(**dict(vars(REC), notes={}))
    assert _reader("deepfm.dense_fp32_pct.train")(no_note) is None


def test_deepfm_rows_reader_needs_both_spans(record, monkeypatch):
    with profile():
        with profiling.annotate("deepfm.gather"):
            pass
    recorded = profiling.recorded

    def with_device():
        out = recorded()
        out["spans"]["deepfm.gather"]["device_s"] = 0.001
        return out
    monkeypatch.setattr(profiling, "recorded", with_device)
    assert _reader("deepfm.rows_ms.train")(REC) is None


def test_xdeepfm_readers_read_the_cins_device_ms_and_share(record,
                                                           monkeypatch):
    """Two ``deepfm.cin`` calls a step (forward and backward) summed:
    ``xdeepfm.cin_ms.train`` their device ms a step, and
    ``xdeepfm.cin_fp32_pct.train`` the counted CIN FLOPs of the rows that
    ``deepfm.cin_rows`` counted at the float32 peak over that time."""
    from portbench.counts import xdeepfm
    with profile():
        for _ in range(REC.steps):
            for name in ("deepfm.gather", "deepfm.cin", "deepfm.dense",
                         "deepfm.cin"):
                with profiling.annotate(name):
                    pass
            profiling.count("deepfm.cin_rows", 4096)
    assert _reader("xdeepfm.cin_ms.train")(REC) is None     # CPU: no events
    recorded = profiling.recorded

    def with_device():
        out = recorded()
        out["spans"]["deepfm.cin"]["device_s"] = 0.2
        return out
    monkeypatch.setattr(profiling, "recorded", with_device)
    assert recorded()["spans"]["deepfm.cin"]["calls"] == 2 * REC.steps
    assert _reader("xdeepfm.cin_ms.train")(REC) == pytest.approx(25.0)
    flops = 8 * 4096 * xdeepfm.cin_flops(39, 10, (200, 200, 200))
    assert _reader("xdeepfm.cin_fp32_pct.train")(REC) == pytest.approx(
        100.0 * flops / 67e12 / 0.2)
    # without the entry's note of the CIN's shape: nothing to read
    no_note = types.SimpleNamespace(**dict(vars(REC), notes={}))
    assert _reader("xdeepfm.cin_fp32_pct.train")(no_note) is None


def test_the_cin_share_needs_the_counter(record, monkeypatch):
    with profile():
        with profiling.annotate("deepfm.cin"):
            pass
    recorded = profiling.recorded

    def with_device():
        out = recorded()
        out["spans"]["deepfm.cin"]["device_s"] = 0.01
        return out
    monkeypatch.setattr(profiling, "recorded", with_device)
    assert _reader("xdeepfm.cin_ms.train")(REC) is not None
    assert _reader("xdeepfm.cin_fp32_pct.train")(REC) is None
