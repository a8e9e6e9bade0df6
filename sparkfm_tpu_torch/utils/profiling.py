"""Profiling hooks. Port of ``sparkfm_tpu/utils/profiling.py`` on
``torch.profiler``:

- :func:`trace`: a profiler trace of a block (host and, with a card,
  device timelines), written as a Chrome trace;
- :func:`annotate`: a named range that shows up in traces;
- :class:`StepTimer`: wall time per step with percentiles, waiting for
  the device by a CUDA event or by reading one scalar of the result;
- :func:`log_metrics`: one structured metric line;
- :func:`enable_nan_checks`: autograd's anomaly mode.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

log = logging.getLogger("sparkfm_tpu_torch")
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write its Chrome trace to
    ``log_dir/trace.json`` (chrome://tracing, Perfetto). Yields the
    ``torch.profiler.profile``, whose ``key_averages()`` sum the events::

        with profiling.trace("traces") as prof:
            for _ in range(10):
                state, aux = step(state, batch)
            torch.cuda.synchronize()
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def annotate(name: str):
    """A named range in traces: ``with annotate("gather"): ...``."""
    return record_function(name)


def enable_nan_checks(on: bool = True) -> None:
    """Autograd's anomaly mode (slow; dev only): a backward function that
    returns NaN raises, with the trace of the forward op that made it.
    Unlike the JAX package's ``jax_debug_nans``, which checks the output of
    every operation, it checks only the gradients autograd computes: the
    hybrid step's analytic backward, the kernels and the in-place updates
    are not checked."""
    torch.autograd.set_detect_anomaly(on)


def _first_tensor(result) -> Optional[torch.Tensor]:
    """The first tensor in a result of tensors, dicts, sequences and
    dataclasses."""
    if torch.is_tensor(result):
        return result
    if dataclasses.is_dataclass(result):
        result = [getattr(result, f.name)
                  for f in dataclasses.fields(result)]
    elif isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        for item in result:
            found = _first_tensor(item)
            if found is not None:
                return found
    return None


class StepTimer:
    """Wall time per step with percentile stats. ``sync`` says how
    :meth:`stop` waits for the step: "block" records a CUDA event on the
    current stream and waits for it (the step's work queued before it has
    ended), "fetch" reads one scalar of the result to the host, "none"
    measures the host's dispatch only. On the CPU "block" waits for
    nothing: the step has run when it returns."""

    def __init__(self, sync: str = "block"):
        if sync not in ("fetch", "block", "none"):
            raise ValueError(f"sync must be 'fetch', 'block' or 'none', "
                             f"got {sync!r}")
        self.sync = sync
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if self.sync == "fetch" and result is not None:
            t = _first_tensor(result)
            if t is not None:
                float(t.reshape(-1)[0])
        elif self.sync == "block" and torch.cuda.is_available():
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "steps": len(a)}


def log_metrics(step: int, metrics: Dict[str, float],
                logger: Optional[logging.Logger] = None) -> None:
    """One structured metric line: ``step=12 auc=0.78 loss=0.41``."""
    (logger or log).info(
        "step=%d %s", step,
        " ".join(f"{k}={v:.6g}" for k, v in sorted(metrics.items())))
