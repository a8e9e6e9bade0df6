"""Profiling hooks. Port of ``sparkfm_tpu/utils/profiling.py`` on
``torch.profiler``:

- :func:`trace`: a profiler trace of a block (host and, with a card,
  device timelines), written as a Chrome trace;
- :func:`annotate`: a named span of the program, and :func:`count`, a
  named counter, both recorded only while a ``torch.profiler`` session
  runs; :func:`recorded` reduces what they recorded, :func:`clear`
  empties it;
- :func:`to_device` and :func:`count_h2d`: host-to-device copies with
  their bytes counted;
- :class:`StepTimer`: wall time per step with percentiles, waiting for
  the device by a CUDA event or by reading one scalar of the result;
- :func:`enable_nan_checks`: autograd's anomaly mode.

Spans and counters cost one read of torch's profiler flag when no
session runs. In a session a span is a range in the trace (a
RecordFunction, beside the device's kernels and copies, on the trace's
clock) and a record of its own: host start and end, its parent (the span
enclosing it on the same thread) and, with ``device=True``, CUDA timing
events on the current stream. The record holds spans of every thread;
the trace holds ranges only of threads the profiler follows (a thread
started by the program, such as ``data/batching.py::prefetch``'s, is not
one).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as autograd_profiler
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


def session() -> bool:
    """Whether a ``torch.profiler`` session runs: one read of torch's own
    flag, set on all threads."""
    return autograd_profiler._is_profiler_enabled


_OFF = contextlib.nullcontext()     # the one span of every call made off
# a span's range in the trace: torch's light RecordFunction (the one its
# compiled graphs open per node) costs the host about a quarter of
# ``record_function``'s, whose dispatcher op the profiler records too; a
# traced ALS sweep opens ~330 spans. Private: ``record_function`` where
# a torch lacks it
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)


class _Thread(threading.local):
    def __init__(self):
        self.stack: List["_Span"] = []  # the thread's open spans
        self.mark = None    # (end event, parent) of its last device span


_local = _Thread()
_lock = threading.Lock()
# per span closed in a session: [name, parent, host start ns, host end
# ns, self host ns, device (None, a (start, end) pair of events, or
# seconds once resolved)]
_spans: List[list] = []
_counters: Dict[str, int] = defaultdict(int)


def _event(stream) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class _Span:
    __slots__ = ("name", "device", "parent", "range", "stream", "start",
                 "t0", "child_ns")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device
        self.child_ns = 0

    def __enter__(self):
        stack = _local.stack
        up = stack[-1] if stack else None
        self.parent = up.name if up is not None else None
        stack.append(self)
        self.range = _RANGE(self.name)
        self.range.__enter__()
        if self.device:
            # torch.cuda.current_stream() costs the host more than an
            # event: a device span inside one takes its stream
            self.stream = (up.stream if up is not None and up.device
                           else torch.cuda.current_stream())
            mark = _local.mark
            self.start = (mark[0] if mark is not None and up is not None
                          and mark[1] is up else _event(self.stream))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        dur = t1 - self.t0
        events = None
        if self.device:
            events = (self.start, _event(self.stream))
        self.range.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        up = stack[-1] if stack else None
        if up is not None:
            up.child_ns += dur
        if events is not None:
            _local.mark = (events[1], up)
        _spans.append([self.name, self.parent, self.t0, t1,
                       dur - self.child_ns, events])
        return False


def annotate(name: str, *, device: bool = False):
    """A named span of the program: ``with annotate("plan.host_dedup"):``.

    With no profiler session it is one shared no-op context. In a session
    it is a RecordFunction range in the trace and a record: host time,
    the enclosing span of the same thread and, with ``device`` (the
    block's work runs on the card), CUDA timing events around the block
    on the current stream, or on its enclosing device span's stream. A
    device span that follows a device span of the same parent starts at
    that one's end event, one event fewer (the ALS sweep's phases run
    back to back): work queued between the two counts to the second.
    :func:`recorded` reads the record."""
    if not session():
        return _OFF
    return _Span(name, device)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``, while a profiler session runs."""
    if session():
        with _lock:
            _counters[name] += n


def count_h2d(t: torch.Tensor, device) -> None:
    """Count a copy of the host tensor ``t`` to ``device``, while a
    profiler session runs and ``device`` is a card: its bytes go to
    ``copy.h2d_pinned_bytes`` from pinned memory, to
    ``copy.h2d_pageable_bytes`` from any other."""
    if not session():
        return
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        count("copy.h2d_pinned_bytes" if t.is_pinned()
              else "copy.h2d_pageable_bytes", t.nbytes)


def to_device(x, device, *, non_blocking: bool = False,
              copy: bool = False) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) as a tensor on ``device``, as
    ``torch.as_tensor(x).to(device, ...)``; a copy from the host to a card
    is counted by :func:`count_h2d`."""
    t = torch.as_tensor(x)
    count_h2d(t, device)
    return t.to(device, non_blocking=non_blocking, copy=copy)


def recorded() -> dict:
    """What the spans and counters recorded since the process started (or
    :func:`clear`): ``{"spans": {name: {"calls", "host_s", "self_s",
    "device_s", "parent"}}, "counters": {name: total}}``. ``self_s`` is
    the host time less what the span's children on its thread cover;
    ``device_s`` the time between its CUDA events, summed (read after a
    sync; None for spans without them); ``parent`` the enclosing span of
    the name's first call (None at the top)."""
    entries = list(_spans)
    if any(isinstance(e[5], tuple) for e in entries):
        torch.cuda.synchronize()
        for e in entries:
            if isinstance(e[5], tuple):
                e[5] = 1e-3 * e[5][0].elapsed_time(e[5][1])
    spans: Dict[str, dict] = {}
    for name, parent, t0, t1, self_ns, dev in entries:
        s = spans.setdefault(name, {"calls": 0, "host_s": 0.0, "self_s": 0.0,
                                    "device_s": None, "parent": parent})
        s["calls"] += 1
        s["host_s"] += (t1 - t0) * 1e-9
        s["self_s"] += self_ns * 1e-9
        if dev is not None:
            s["device_s"] = (s["device_s"] or 0.0) + dev
    with _lock:
        counters = dict(_counters)
    return {"spans": spans, "counters": counters}


def clear() -> None:
    """Forget every recorded span and counter."""
    with _lock:
        _spans.clear()
        _counters.clear()


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
