"""ctypes bridges to the native host-side builders: the dedup-plan
builder (``native/dedup_plan.cpp``) and the libFM parser
(``native/libfm_parser.cpp``).

Each library is compiled from the repository's source with ``g++`` at
first use, into ``sparkfm_tpu_torch/build/``. It is built without
``-march=native``: the tracked ``native/build/*.so`` are compiled for the
CPU of the host that built them and may stop a process on another CPU
with an illegal instruction, which no ``except`` can catch, so the port
never loads them. When no compiler is present, or ``SPARKFM_NO_NATIVE=1``
is set, :func:`dedup_plan_native` and :func:`parse_libfm_padded` return
None and their callers (``ops.embedding.host_dedup``,
``data.libfm.load_libfm``) take their numpy / Python paths, which have the
same semantics.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from sparkfm_tpu_torch.utils.build import (REPO_ROOT, BuildError,
                                           build_shared_library)

SOURCE = os.path.join(REPO_ROOT, "native", "dedup_plan.cpp")
PARSER_SOURCE = os.path.join(REPO_ROOT, "native", "libfm_parser.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")

_lock = threading.Lock()
_libs = {}                  # library name -> CDLL, or None if it failed
_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "dedup_plan": (SOURCE, {"dp_build": (ctypes.c_int, [
        _I32P, _F32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, _I32P, _I32P, _I32P, _I32P, _F32P, _I32P,
        _I32P])}),
    "libfm_parser": (PARSER_SOURCE, {
        "lf_scan": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int64, _I64P,
                                   _I64P, _I64P]),
        "lf_fill": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int64, _F32P, _I32P,
                                     _F32P])}),
}


def _load(name: str = "dedup_plan") -> Optional[ctypes.CDLL]:
    """The native library ``name``, built at first use; None when it
    cannot be built or ``SPARKFM_NO_NATIVE`` is set."""
    if os.environ.get("SPARKFM_NO_NATIVE"):
        return None
    with _lock:
        if name not in _libs:
            source, functions = _SIGNATURES[name]
            try:
                path = build_shared_library(name, [source],
                                            os.environ.get("CXX", "g++"),
                                            CXX_FLAGS, timeout=120)
            except BuildError:
                _libs[name] = None
                return None
            lib = ctypes.CDLL(path)
            for fn, (restype, argtypes) in functions.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return _libs[name]


def available(name: str = "dedup_plan") -> bool:
    return _load(name) is not None


def parse_libfm_padded(path: str, max_nnz: Optional[int] = None
                       ) -> Optional[Tuple]:
    """Parse a libFM file straight into padded-CSR numpy arrays.

    Returns (y, ids, vals, max_index), or None when the library is
    unavailable or refuses the file. Two native passes: scan (sizes), then
    fill (into zeroed arrays owned here); no per-row Python objects.
    """
    lib = _load("libfm_parser")
    if lib is None:
        return None
    with open(path, "rb") as f:
        buf = f.read()
    n = len(buf)
    rows, mnnz, midx = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    if lib.lf_scan(buf, n, ctypes.byref(rows), ctypes.byref(mnnz),
                   ctypes.byref(midx)) != 0:
        return None
    r = rows.value
    if r == 0:
        return (np.zeros((0,), np.float32), np.zeros((0, 1), np.int32),
                np.zeros((0, 1), np.float32), -1)
    width = max(1, mnnz.value if max_nnz is None else max_nnz)
    y = np.zeros((r,), np.float32)
    ids = np.zeros((r, width), np.int32)
    vals = np.zeros((r, width), np.float32)
    filled = lib.lf_fill(buf, n, width, y.ctypes.data_as(_F32P),
                         ids.ctypes.data_as(_I32P),
                         vals.ctypes.data_as(_F32P))
    if filled != r:
        return None
    return y, ids, vals, int(midx.value)


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
    i32p, f32p = _I32P, _F32P
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
