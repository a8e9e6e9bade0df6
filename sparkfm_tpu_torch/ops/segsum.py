"""Segmented sums over sorted slots: the hybrid train step's backward and
the ALS sweep's per-feature sums.

Port of the parts of ``sparkfm_tpu/ops/pallas_segsum.py`` that the ported
paths run:

- :func:`fm_grad_segsum_factored` (kernel B3) takes the (U, k+1) unique
  rows ``vw_u`` and the per-slot example pack; its kernel is CUDA C++ for
  Hopper (``csrc/segsum.cu``), compiled with ``nvcc`` at first use and
  bound with ctypes. A CUDA tensor always goes to the kernel; only CPU
  tensors take the plain version,
  :func:`fm_grad_segsum_factored_reference`.
- :func:`fm_grad_segsum_reference` is the plain version of
  ``fm_grad_segsum`` (TPU kernel B4) from per-slot rows: exactly the JAX
  package's XLA branch, and the parity oracle of B3. Its kernel comes in a
  later slice.
- :func:`segment_colsums` (kernel B7) sums up to 16 one-dimensional
  streams per rank, for the ALS sweep (``solvers/als.py``); its kernel is
  in the same CUDA source, its plain version
  :func:`segment_colsums_reference`.

All keep the JAX signatures and contract: ``seg`` holds the sorted rank of
each sorted slot in [0, num_segments), and ranks that no slot has come out
zero. The backward's output is (U, 2k+2) float32
``[Σg_v | Σg_w | Σg_v² | Σg_w²]`` per rank, with

    g_v = ds·x·(s − v·x) + cv·a·v,   g_w = ds·x + cw·w·a,   a = wt·[x ≠ 0]

for each slot's example pack ``ex_srt = [s (k) | ds | wt]``, value ``x``
and unique row ``(v, w)``. ``cv``/``cw`` are the per-batch L2
coefficients, Python floats or 0-d tensors (tensors stay on the device:
the kernel reads them there).
"""

from __future__ import annotations

import ctypes
import os

import torch

from sparkfm_tpu_torch.utils.build import PACKAGE_DIR, CudaKernel

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "segsum.cu")
MAX_FACTORS = 128          # the kernel's largest k
MAX_STREAMS = 16           # segment_colsums' largest S
FACTORED = CudaKernel(
    "segsum", SOURCE, "sfm_fm_grad_segsum_factored",
    [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3)
COLSUMS = CudaKernel(
    "segsum", SOURCE, "sfm_segment_colsums",
    [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 3
    + [ctypes.c_int64] * 2)


def fm_grad_segsum_reference(vw_srt: torch.Tensor, ex_srt: torch.Tensor,
                             x: torch.Tensor, seg: torch.Tensor,
                             num_segments: int, cv, cw) -> torch.Tensor:
    """Plain version of B4 from per-slot rows ``vw_srt`` (N, k+1): the
    gradient pack and its square, summed per rank by ``index_add_``."""
    k = vw_srt.shape[1] - 1
    v_srt, w_srt = vw_srt[:, :k], vw_srt[:, k]
    s_srt, ds_srt, wt_srt = ex_srt[:, :k], ex_srt[:, k], ex_srt[:, k + 1]
    active = torch.where(x != 0, wt_srt, 0.0)
    dsx = ds_srt * x
    g_v = dsx[:, None] * (s_srt - v_srt * x[:, None]) \
        + (cv * active)[:, None] * v_srt
    g_w = dsx + cw * w_srt * active
    gpack = torch.cat([g_v, g_w[:, None]], dim=1)
    packed = torch.cat([gpack, gpack.square()], dim=1)
    out = torch.zeros((num_segments, 2 * k + 2), dtype=packed.dtype,
                      device=vw_srt.device)
    return out.index_add_(0, seg.long(), packed)


def fm_grad_segsum_factored_reference(vw_u: torch.Tensor,
                                      ex_srt: torch.Tensor, x: torch.Tensor,
                                      seg: torch.Tensor, num_segments: int,
                                      cv, cw) -> torch.Tensor:
    """Plain version of B3: B4's plain version on the per-slot rows
    ``vw_u[seg]``, as the JAX package's own fallback does."""
    return fm_grad_segsum_reference(vw_u.index_select(0, seg.long()),
                                    ex_srt, x, seg, num_segments, cv, cw)


def _check(vw_u, ex_srt, x, seg, num_segments) -> None:
    tensors = {"vw_u": vw_u, "ex_srt": ex_srt, "x": x}
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fm_grad_segsum_factored takes contiguous "
                             f"float32 {name}, got {t.dtype}")
    if seg.dtype != torch.int32 or not seg.is_contiguous():
        raise ValueError("fm_grad_segsum_factored takes contiguous int32 "
                         f"seg, got {seg.dtype}")
    if vw_u.dim() != 2 or vw_u.shape[0] != num_segments:
        raise ValueError(f"vw_u must be (num_segments={num_segments}, k+1),"
                         f" got {tuple(vw_u.shape)}")
    k = vw_u.shape[1] - 1
    n = seg.shape[0]
    if (k < 1 or ex_srt.shape != (n, k + 2) or x.shape != (n,)
            or seg.dim() != 1):
        raise ValueError(
            f"shapes: vw_u {tuple(vw_u.shape)}, ex_srt "
            f"{tuple(ex_srt.shape)}, x {tuple(x.shape)}, seg "
            f"{tuple(seg.shape)}; want (U, k+1), (N, k+2), (N,), (N,)")
    devices = {t.device for t in (vw_u, ex_srt, x, seg)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    device = vw_u.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fm_grad_segsum_factored has no kernel for "
                         f"{device}")
    if device.type == "cuda" and k > MAX_FACTORS:
        raise ValueError(f"the kernel takes k <= {MAX_FACTORS}, got {k}")


def fm_grad_segsum_factored(vw_u: torch.Tensor, ex_srt: torch.Tensor,
                            x: torch.Tensor, seg: torch.Tensor,
                            num_segments: int, cv, cw) -> torch.Tensor:
    """(U, 2k+2) ``[Σg_v | Σg_w | Σg_v² | Σg_w²]`` per rank from the
    unique rows ``vw_u`` (U, k+1) aligned with seg's ranks, the example
    pack ``ex_srt`` (N, k+2), values ``x`` (N,) and sorted ranks ``seg``
    (N,) int32. CUDA tensors run the kernel (which traps on a rank outside
    [0, U)); its sums are deterministic. CPU tensors run the plain
    version."""
    _check(vw_u, ex_srt, x, seg, num_segments)
    device = vw_u.device
    if device.type == "cpu":
        return fm_grad_segsum_factored_reference(vw_u, ex_srt, x, seg,
                                                 num_segments, cv, cw)
    k = vw_u.shape[1] - 1
    n = seg.shape[0]
    out = torch.zeros((num_segments, 2 * k + 2), dtype=torch.float32,
                      device=device)
    if n == 0:
        return out
    coef = torch.stack([torch.as_tensor(c, dtype=torch.float32,
                                        device=device).reshape(())
                        for c in (cv, cw)])
    partial_rows = FACTORED.build().sfm_fm_grad_partial_rows
    partial_rows.restype, partial_rows.argtypes = ctypes.c_int64, [
        ctypes.c_int64]
    rows = partial_rows(n)
    partials = torch.empty((rows, 2 * k + 2), dtype=torch.float32,
                           device=device)
    FACTORED.launch(device, vw_u.data_ptr(), ex_srt.data_ptr(), x.data_ptr(),
                    seg.data_ptr(), coef.data_ptr(), out.data_ptr(),
                    partials.data_ptr(), n, num_segments, k)
    return out


def segment_colsums_reference(streams, seg: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """Plain version of B7: one ``index_add_`` per stream into (U,),
    stacked to (U, S), as the JAX package's XLA branch sums one stream at
    a time. Keeps the streams' dtype (the card's checks run it in
    float64)."""
    seg_l = seg.long()
    return torch.stack(
        [torch.zeros((num_segments,), dtype=s.dtype,
                     device=s.device).index_add_(0, seg_l, s)
         for s in streams], dim=1)


def _check_colsums(streams, seg, num_segments) -> None:
    if not 1 <= len(streams) <= MAX_STREAMS:
        raise ValueError(f"segment_colsums takes 1 to {MAX_STREAMS} "
                         f"streams, got {len(streams)}")
    if seg.dtype != torch.int32 or seg.dim() != 1 or not seg.is_contiguous():
        raise ValueError("segment_colsums takes a contiguous 1-D int32 seg, "
                         f"got {seg.dtype} {tuple(seg.shape)}")
    for j, t in enumerate(streams):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"segment_colsums takes contiguous float32 "
                             f"streams, stream {j} is {t.dtype}")
        if t.shape != seg.shape:
            raise ValueError(f"stream {j} has shape {tuple(t.shape)}, seg "
                             f"{tuple(seg.shape)}")
    devices = {t.device for t in (seg, *streams)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if seg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_colsums has no kernel for {seg.device}")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")


def segment_colsums(streams, seg: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """(U, S) float32 per-rank sums of the S float32 streams (each (N,))
    over the sorted int32 ranks ``seg`` (N,): column j is stream j summed
    per rank, and ranks no slot has are zero. CUDA tensors run the kernel
    (which traps on a rank outside [0, U)); its sums are deterministic.
    CPU tensors run the plain version."""
    streams = list(streams)
    _check_colsums(streams, seg, num_segments)
    device = seg.device
    if device.type == "cpu":
        return segment_colsums_reference(streams, seg, num_segments)
    s, n = len(streams), seg.shape[0]
    out = torch.zeros((num_segments, s), dtype=torch.float32, device=device)
    if n == 0:
        return out
    partial_rows = COLSUMS.build().sfm_colsums_partial_rows
    partial_rows.restype, partial_rows.argtypes = ctypes.c_int64, [
        ctypes.c_int64]
    partials = torch.empty((partial_rows(n), s), dtype=torch.float32,
                           device=device)
    ptrs = (ctypes.c_void_p * s)(*[t.data_ptr() for t in streams])
    COLSUMS.launch(device, ctypes.cast(ptrs, ctypes.c_void_p), s,
                   seg.data_ptr(), out.data_ptr(), partials.data_ptr(), n,
                   num_segments)
    return out
