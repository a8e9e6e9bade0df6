"""ctypes bridge to the native dedup-plan builder (``native/dedup_plan.cpp``).

The library is compiled from the repository's source with ``g++`` at first
use, into ``sparkfm_tpu_torch/build/``. It is built without
``-march=native``: the tracked ``native/build/dedup_plan.so`` is compiled
for the CPU of the host that built it and may stop a process on another
CPU with an illegal instruction, which no ``except`` can catch, so the port
never loads it. When no compiler is present, or ``SPARKFM_NO_NATIVE=1`` is
set, :func:`dedup_plan_native` returns None and
``ops.embedding.host_dedup`` takes its numpy path, which has the same
semantics.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from sparkfm_tpu_torch.utils.build import (REPO_ROOT, BuildError,
                                           build_shared_library)

SOURCE = os.path.join(REPO_ROOT, "native", "dedup_plan.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")

_lock = threading.Lock()
_lib = None
_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    if os.environ.get("SPARKFM_NO_NATIVE"):
        return None
    with _lock:
        if _lib is None and not _failed:
            try:
                path = build_shared_library("dedup_plan", [SOURCE],
                                            os.environ.get("CXX", "g++"),
                                            CXX_FLAGS, timeout=120)
            except BuildError:
                _failed = True
                return None
            lib = ctypes.CDLL(path)
            i32p = ctypes.POINTER(ctypes.c_int32)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.dp_build.restype = ctypes.c_int
            lib.dp_build.argtypes = [
                i32p, f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, i32p, i32p, i32p, i32p, f32p, i32p, i32p]
            _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def dedup_plan_native(ids: np.ndarray, budget: int, fill: int,
                      vals: Optional[np.ndarray] = None):
    """Native twin of ``ops.embedding.host_dedup``'s numpy path.

    Returns (uids, ranks, count, overflow, order, seg, svals, sex) as numpy
    arrays (svals/sex None when vals is None), or None when the library is
    unavailable or the batch is empty.
    """
    lib = _load()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, np.int32)
    shape = ids.shape
    flat = ids.reshape(-1)
    n = flat.shape[0]
    if n == 0:
        return None
    if budget <= 0:
        raise ValueError(f"budget must be positive, got {budget}")
    order = np.empty((n,), np.int32)
    ranks = np.empty((n,), np.int32)
    seg = np.empty((n,), np.int32)
    uids = np.empty((budget,), np.int32)
    out2 = np.zeros((2,), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    if vals is not None:
        vflat = np.ascontiguousarray(vals, np.float32).reshape(-1)
        if vflat.shape[0] != n:
            raise ValueError(f"vals {np.shape(vals)} != ids {shape}")
        svals = np.empty((n,), np.float32)
        sex = np.empty((n,), np.int32)
        vp = vflat.ctypes.data_as(f32p)
        sp = svals.ctypes.data_as(f32p)
        xp = sex.ctypes.data_as(i32p)
    else:
        svals = sex = None
        vp = ctypes.cast(None, f32p)
        sp = ctypes.cast(None, f32p)
        xp = ctypes.cast(None, i32p)
    rc = lib.dp_build(
        flat.ctypes.data_as(i32p), vp, n, int(shape[-1]), int(budget),
        int(fill), order.ctypes.data_as(i32p),
        ranks.ctypes.data_as(i32p), seg.ctypes.data_as(i32p),
        uids.ctypes.data_as(i32p), sp, xp,
        out2.ctypes.data_as(i32p))
    if rc != 0:
        raise RuntimeError(f"dp_build failed with code {rc}")
    return (uids, ranks.reshape(shape), np.int32(out2[0]),
            np.bool_(bool(out2[1])), order, seg, svals, sex)
