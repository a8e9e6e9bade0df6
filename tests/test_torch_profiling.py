"""The port's profiling hooks (``utils/profiling.py``), after the JAX
package's ``utils/profiling.py``: the StepTimer's stats keys and sync
modes, a trace written to disk with an annotated range in it, the metric
line and the NaN-check switch. Times taken here are CPU times and are
only checked to exist."""

import json
import logging
import os

import pytest
import torch

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
    with profiling.trace(log_dir) as prof:
        with profiling.annotate("sfm_gather"):
            torch.ones(64).cumsum(0)
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "sfm_gather" for e in events)
    assert any(e.key == "sfm_gather" for e in prof.key_averages())


def test_log_metrics_line(caplog):
    with caplog.at_level(logging.INFO, logger="sparkfm_tpu_torch"):
        profiling.log_metrics(12, {"loss": 0.41, "auc": 0.78})
    assert "step=12 auc=0.78 loss=0.41" in caplog.text


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
