"""The frozen counts against hand sums, the readers and the trace
reduction on made-up records."""

import types

import pytest

from portbench import counts, harness, tracing
from portbench.counts import als as als_counts
from portbench.counts import fm_sgd

PEAKS = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


def test_sgd_step_work_by_hand():
    b, l, u, k = 2, 3, 4, 2
    w = fm_sgd.step_work(b, l, u, k)
    n = b * l
    assert w["bytes"] == 4 * (2 * n + b + 2 * u * (2 * k + 2) + b + 1)
    assert w["flops"] == (n * 10 + b * 8 + n * 10 + n * 9 + u * 18)


def test_als_sweep_work_by_hand():
    w = als_counts.sweep_work(entries=10, examples=5, features=3, k=2)
    assert w["bytes"] == 4 * (2 * 5 + 10 * 4 + 2 * 10 * 6 + 3 * 3 * 2)
    assert w["flops"] == 12 * 10 * 3 + 10


def test_b7_bytes_at_the_sweeps_shape():
    # the count of PERF.md's kernel table: 604.4 MB at S = 5, 200.9 at S = 1
    assert als_counts.b7_bytes(5, 25_000_095, 221_588) == 604_434_040
    assert als_counts.b7_bytes(1, 25_000_095, 221_588) == 200_887_112


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(67e12, 1.0, PEAKS) == pytest.approx(1.0)
    assert counts.least_seconds(1.0, 3.35e12, PEAKS) == pytest.approx(1.0)


def test_peaks_table_names_the_h100():
    assert harness.peaks_for("NVIDIA H100 80GB HBM3") == PEAKS
    assert harness.peaks_for("some other card") == PEAKS


class _Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def test_trace_summary_unions_device_time_and_counts_launches():
    from torch.autograd import DeviceType
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    evs = [_Ev("k1", cuda, 0, 100), _Ev("k2", cuda, 50, 100),
           _Ev("k1", cuda, 1000, 10), _Ev("cudaLaunchKernel", cpu, 0, 5),
           _Ev("cudaGraphLaunch", cpu, 10, 5), _Ev("outer", cpu, 0, 2000),
           _Ev("plan", cpu, 400, 300)]
    s = tracing.summarize(evs, 2e-6)
    assert s.busy_s == pytest.approx(160e-9)
    assert s.launches == 2
    assert s.kernels["k1"] == (pytest.approx(110e-9), 2)
    assert s.device_ops[0][0] == "k1"
    assert s.idle_gaps == [["plan", pytest.approx(850e-9)]]


def test_trace_summary_leaves_out_annotations_on_the_device():
    from torch.autograd import DeviceType
    ann = _Ev("flush", DeviceType.CUDA, 0, 1000)
    ann.is_user_annotation = lambda: True
    s = tracing.summarize([ann, _Ev("k", DeviceType.CUDA, 10, 10)], 1e-6)
    assert s.busy_s == pytest.approx(10e-9) and list(s.kernels) == ["k"]


def _records(**kw):
    base = dict(window_s=2.0, steps=4, rate_window_s=2.0,
                spans={}, counters={}, work={}, notes={}, trace=None,
                peaks=PEAKS)
    base.update(kw)
    return harness.Records(**base)


def _reader(name):
    cell = types.SimpleNamespace(bench_dirs=(harness.PACKAGE_DIR,))
    return harness.reader_of(cell, name)


def test_readers_on_made_up_records():
    tr = tracing.Summary(busy_s=0.5, window_s=2.0,
                         kernels={"colsums_chunks_kernel": (0.002, 3),
                                  "gather": (0.1, 9)},
                         launches=40, device_ops=[], idle_gaps=[])
    rec = _records(trace=tr, rate_window_s=4.0,
                   work={"flops": 67e12 * 0.02, "bytes": 3.35e12 * 0.1},
                   notes={"b7_bytes": 3.35e12 * 0.001})
    assert _reader("device.idle_pct.train")(rec) == pytest.approx(75.0)
    assert _reader("step.device_ms.train")(rec) == pytest.approx(125.0)
    assert _reader("kernels.launches_per_step.train")(rec) == 10.0
    assert _reader("mfu_pct.train")(rec) == pytest.approx(2.5)
    assert _reader("segment_colsums_roofline.als")(rec) == pytest.approx(
        50.0)


def test_readers_find_nothing_and_say_so():
    rec = _records()
    for name in ("device.idle_pct.als", "step.device_ms.train",
                 "kernels.launches_per_step.train", "mfu_pct.als",
                 "segment_colsums_roofline.als"):
        assert _reader(name)(rec) is None
