"""The traced window: torch.profiler over the device and the host, reduced
to the numbers the per-layer readers take.

Device time is the union of the intervals in which a kernel, copy or
memset ran (CUDA activity only: the CPU ops that launch them would count
their time twice, and the device-side mirrors of ``record_function``
ranges are no work). Launches are the host's runtime calls that start a
kernel or a graph (a graph replay is one). Idle gaps are named by the
innermost host op, or span of the harness, that was running at the gap's
middle.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaLaunchCooperativeKernel")
TOP = 10
NAME_CHARS = 160            # a kernel's name in the breakdown, cut here


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    kernels: Dict[str, Tuple[float, int]]   # name -> (seconds, count)
    launches: int
    device_ops: List[list]                  # [[name, seconds]], top 10
    idle_gaps: List[list]                   # [[host op, seconds]], top 10


def start(device: torch.device):
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _annotation(ev) -> bool:
    """A span of the harness mirrored on the device's timeline (a
    ``record_function`` range): no work of the device."""
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def summarize(events, window_s: float, spans=()) -> Summary:
    """Reduce kineto events (``name()``, ``device_type()``, ``start_ns()``,
    ``duration_ns()``) to a :class:`Summary`; ``spans`` names the harness's
    ranges, whose device-side mirrors are left out as annotations are."""
    dev, host = [], []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    launches = 0
    for ev in events:
        name = ev.name()
        s, d = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if _annotation(ev) or name in spans:
                continue
            dev.append((s, s + d))
            k = kernels[name]
            k[0] += d * 1e-9
            k[1] += 1
        else:
            if name in LAUNCH_CALLS:
                launches += 1
            elif d > 0:
                host.append((s, s + d, name))
    busy = _union(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    device_ops = [[n[:NAME_CHARS], v[0]] for n, v in top]
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    host.sort()
    starts = [h[0] for h in host]
    idle = []
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        best = None
        for h in host[:bisect.bisect_right(starts, mid)][-2000:]:
            if h[1] >= mid and (best is None or h[1] - h[0]
                                < best[1] - best[0]):
                best = h
        idle.append([best[2] if best else "(host code outside torch ops)",
                     (g1 - g0) * 1e-9])
    return Summary(busy_s=busy_s, window_s=float(window_s),
                   kernels={n: (v[0], v[1]) for n, v in kernels.items()},
                   launches=launches, device_ops=device_ops, idle_gaps=idle)


def stop(prof, window_s: float, spans=()) -> Summary:
    prof.__exit__(None, None, None)
    return summarize(prof.profiler.kineto_results.events(), window_s,
                     set(spans))
