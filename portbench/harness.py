"""Find a cell's files by name, run it, judge it and build its result line.

``BENCHMARK.json`` names every cell (``workloads``), configuration and
metric. Everything that belongs to one of them is a file found by name:

- ``configs/<config>.json``  (through the configuration's ``file`` key)
- ``traffic/<traffic>.json`` the mix's parameters and its ``entry``
- ``entries/<entry>.py``     the driver of one entry point of the port:
                             ``run(ctx) -> Outcome``
- ``limits/<cell>.json``     the limit of each number the check compares
- ``metrics/<metric>.py``    a per-layer metric's reader: ``read(rec)``,
                             returning a number or None (nothing to read)

so a later cell, mix or metric is a new file and a new entry in
``BENCHMARK.json``. Lookups try the bench directory given first, then this
package's own, so a mix in another directory can reuse these entries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
SPEC_FILE = "BENCHMARK.json"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sparkfm_tpu")
TRACE_WINDOW_S = 10.0   # a traced run traces a window of at most this


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dirs: tuple


@dataclasses.dataclass
class Outcome:
    """What an entry returns once its window has closed and the reference
    has judged it: the end-to-end values it measured, the attempts and
    failures, the numbers compared (each against ``limits/<cell>.json``),
    the work done in a traced run's untraced window as counted by
    ``counts/`` and the calls it recorded into the port for the readers."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    readings: Dict[str, float]
    work: Dict[str, float] = dataclasses.field(default_factory=dict)
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


def load_spec(root: str) -> dict:
    with open(os.path.join(root, SPEC_FILE)) as f:
        return json.load(f)


def _named(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"{SPEC_FILE} has no {what} named {name!r}")


def find_file(bench_dirs, sub: str, name: str, ext: str) -> str:
    """The first ``<dir>/<sub>/<name><ext>`` that exists."""
    for d in bench_dirs:
        path = os.path.join(d, sub, name + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {sub}/{name}{ext} under {list(bench_dirs)}")


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_of_cell


def resolve_cell(spec: dict, name: str, root: str,
                 bench_dir: Optional[str] = None) -> Cell:
    """The cell ``name`` of ``spec`` with its configuration, mix and limits
    read from their files; ``bench_dir`` (default: this package) is
    searched before this package for the mix, limits, entry and readers."""
    dirs = tuple(dict.fromkeys(d for d in (bench_dir, PACKAGE_DIR) if d))
    w = _named(spec["workloads"], name, "workload")
    cfg_entry = _named(spec["configs"], w["config"], "config")
    config = _read_json(os.path.join(root, cfg_entry["file"]))
    traffic = _read_json(find_file(dirs, "traffic", w["traffic"], ".json"))
    limits = _read_json(find_file(dirs, "limits", name, ".json"))
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _applies(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, bench_dirs=dirs)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def entry_of(cell: Cell):
    path = find_file(cell.bench_dirs, "entries", cell.traffic["entry"], ".py")
    return load_module(path, "portbench_entry_" + cell.traffic["entry"])


def reader_of(cell: Cell, metric: str) -> Callable:
    path = find_file(cell.bench_dirs, "metrics", metric, ".py")
    return load_module(path, "portbench_metric_" + metric.replace(".", "_")
                       .replace("-", "_")).read


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of a run (data, weights, pool),
    the same for the same run seed on every machine."""
    words = [int(seed) % (1 << 64), *stream.encode()]
    return int(np.random.SeedSequence(words).generate_state(
        1, dtype=np.uint64)[0]) >> 1


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Context:
    """A run's clock, window, spans and counters, handed to the entry.

    ``begin_window`` ends set-up (``setup_s`` counts from the process
    start the caller gives). ``end_window`` waits for the device and stops
    the clock. A traced run has two windows of ``seconds`` each: the first
    runs untraced and gives the rate at which the shares of the card's
    peak are read, so that the profiler's cost does not lower them; its
    ``end_window`` starts the profiler and returns True, and the entry
    runs on to the second. The last ``end_window`` stops the profiler,
    reads the memory peak and returns False, before the entry frees the
    program's state and runs the reference. ``span`` times a call into
    the port."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: torch.device, t_process: float):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        # the per-layer readings of a traced run need no long window, and
        # reducing a long trace would cost more than the window itself
        self.seconds = (min(float(seconds), TRACE_WINDOW_S) if trace
                        else float(seconds))
        self.trace = bool(trace)
        self.device = device
        self.t_process = t_process
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.counters: Dict[str, float] = defaultdict(float)
        self.steps = 0                  # steps or sweeps timed, all windows
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.rate_window_s: Optional[float] = None  # traced: the untraced
        self.rate_steps = 0                         # window and its steps
        self.memory_peak_bytes: Optional[int] = None
        self.trace_summary = None
        self._t_window = None
        self._profiler = None

    @property
    def tracing(self) -> bool:
        """Whether the profiler runs (a traced run's second window)."""
        return self._profiler is not None

    def seed_for(self, stream: str) -> int:
        return sub_seed(self.seed, stream)

    def log(self, msg: str) -> None:
        """A progress line on standard error, stamped with the seconds since
        the process started."""
        print(f"[{time.perf_counter() - self.t_process:8.3f}s] {msg}",
              file=sys.stderr, flush=True)

    def begin_window(self) -> None:
        synchronize(self.device)
        now = time.perf_counter()
        self.setup_s = now - self.t_process
        self._t_window = time.perf_counter()

    def in_window(self) -> float:
        """Seconds since the window began."""
        return time.perf_counter() - self._t_window

    def end_window(self) -> bool:
        """Close the window; True where a traced run's untraced window
        closed and its traced one began."""
        synchronize(self.device)
        elapsed = time.perf_counter() - self._t_window
        if self.trace and self.rate_window_s is None:
            self.rate_window_s, self.rate_steps = elapsed, self.steps
            from portbench import tracing
            self._profiler = tracing.start(self.device)
            self._t_window = time.perf_counter()
            return True
        self.window_s = elapsed
        if self._profiler is not None:
            from portbench import tracing
            self.trace_summary = tracing.stop(self._profiler, self.window_s,
                                              self.spans)
            self._profiler = None
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))
        else:
            self.memory_peak_bytes = 0
        return False

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        if self._profiler is not None:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.spans[name].append(time.perf_counter() - t)


@dataclasses.dataclass
class Records:
    """What a per-layer reader reads in a traced run: the traced window,
    its steps, spans and counters and the trace; the untraced window
    before it (``rate_window_s``) and the work counted in that one."""

    window_s: float
    steps: int
    rate_window_s: float
    spans: Dict[str, List[float]]
    counters: Dict[str, float]
    work: Dict[str, float]
    notes: Dict[str, object]
    trace: object           # tracing.Summary
    peaks: dict


def peaks_for(kind: str) -> dict:
    """The published peaks of the card named ``kind`` (``counts/peaks.json``;
    an unknown name takes the H100 SXM's, the card this benchmark is for)."""
    table = _read_json(os.path.join(PACKAGE_DIR, "counts", "peaks.json"))
    return table["cards"].get(kind, table["cards"][table["default"]])


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every limited number must be read, finite and at
    most its limit; ``checks`` maps each to its value and limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": (None if v is None else float(v)),
                        "limit": float(limit)}
    return ok, checks


def forbidden_loaded(modules: dict) -> List[str]:
    """Top-level names of the loaded ``modules`` (``sys.modules``) that are
    JAX or the JAX package, compared whole (``sparkfm_tpu_torch`` is not
    ``sparkfm_tpu``); an entry set to None blocks an import, loads none."""
    tops = {m.split(".")[0] for m, mod in modules.items() if mod is not None}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float) -> dict:
    """Run ``cell`` once on ``device`` and return its result line as a
    dict (``checks`` last). The entry measures; this judges and reads."""
    ctx = Context(cell, seed, seconds, trace, device, t_process)
    outcome = entry_of(cell).run(ctx)
    correct, checks = judge(outcome.readings, cell.limits)
    if outcome.failed:
        correct = False
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
    else:
        kind = "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": cell.chips,
           "memory_peak_bytes": ctx.memory_peak_bytes}
    line = {"correct": bool(correct), "attempted": int(outcome.attempted),
            "failed": int(outcome.failed)}
    metrics = {}
    if not trace:
        values = dict(outcome.e2e, setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            if m["name"] in values and values[m["name"]] is not None:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    else:
        s = ctx.trace_summary
        dev["busy_s"] = s.busy_s
        dev["window_s"] = s.window_s
        rec = Records(window_s=ctx.window_s,
                      steps=ctx.steps - ctx.rate_steps,
                      rate_window_s=ctx.rate_window_s,
                      spans=dict(ctx.spans),
                      counters=dict(ctx.counters), work=outcome.work,
                      notes=outcome.notes, trace=s, peaks=peaks_for(kind))
        for m in cell.per_layer:
            v = reader_of(cell, m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        line["breakdown"] = {"device_ops": s.device_ops,
                             "idle_gaps": s.idle_gaps}
    line["metrics"] = metrics
    line["device"] = dev
    line["checks"] = checks
    return line
