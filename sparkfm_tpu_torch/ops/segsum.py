"""Segmented sums over sorted slots: the SGD steps' per-unique gradient
sums and the ALS sweep's per-feature sums.

Port of ``sparkfm_tpu/ops/pallas_segsum.py``. Every function has a CUDA
C++ kernel for Hopper (``csrc/segsum.cu``), compiled with ``nvcc`` at
first use and bound with ctypes; a CUDA tensor always goes to the kernel,
and only CPU tensors take the plain version (``*_reference``):

- :func:`fm_grad_segsum_factored` (kernel B3), the hybrid step's backward,
  from the (U, k+1) unique rows ``vw_u`` and the per-slot example pack;
- :func:`fm_grad_segsum` (kernel B4), the same backward from per-slot
  rows ``vw_srt`` (N, k+1); its plain version
  :func:`fm_grad_segsum_reference` is exactly the JAX package's XLA branch
  and also B3's oracle;
- :func:`segment_rowsum` (kernel B5), per-rank sums of (N, W) rows, the
  fused step's ``accumulate="segsum"`` and the sorted step
  (``solvers/sgd_fused.py``, ``solvers/sgd_sorted.py``);
- :func:`segment_rowsum_sq` (kernel B6), ``[Σg | Σg²]`` per rank with the
  squares formed in the kernel;
- :func:`segment_colsums` (kernel B7) sums up to 16 one-dimensional
  streams per rank, for the ALS sweep (``solvers/als.py``).

All keep the JAX signatures and contract: ``seg`` holds the sorted rank of
each sorted slot in [0, num_segments), and ranks that no slot has come out
zero. The JAX ``tile``/``subtile``/``force`` knobs have no counterpart;
``bf16x2`` is accepted and the sums stay float32. The backward's output is
(U, 2k+2) float32 ``[Σg_v | Σg_w | Σg_v² | Σg_w²]`` per rank, with

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
MAX_FACTORS = 128          # the backward kernels' largest k
MAX_ROW_WIDTH = 1 << 16    # segment_rowsum's largest W on the card
MAX_STREAMS = 16           # segment_colsums' largest S
_FM_GRAD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3
_ROWSUM_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
FACTORED = CudaKernel("segsum", SOURCE, "sfm_fm_grad_segsum_factored",
                      _FM_GRAD_ARGS)
FM_GRAD = CudaKernel("segsum", SOURCE, "sfm_fm_grad_segsum", _FM_GRAD_ARGS)
ROWSUM = CudaKernel("segsum", SOURCE, "sfm_segment_rowsum", _ROWSUM_ARGS)
ROWSUM_SQ = CudaKernel("segsum", SOURCE, "sfm_segment_rowsum_sq",
                       _ROWSUM_ARGS)
COLSUMS = CudaKernel(
    "segsum", SOURCE, "sfm_segment_colsums",
    [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 3
    + [ctypes.c_int64] * 2)


def _partials(kernel: CudaKernel, symbol: str, width: int, device,
              *args) -> torch.Tensor:
    """The pass-1 partial rows a kernel needs, as the library's
    ``symbol(*args)`` counts them (integer arguments), each ``width``
    floats."""
    count = getattr(kernel.build(), symbol)
    count.restype = ctypes.c_int64
    count.argtypes = [ctypes.c_int64] * len(args)
    return torch.empty((count(*args), width), dtype=torch.float32,
                       device=device)


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


def _check(name, vw, vw_name, rows, rows_name, ex_srt, x, seg) -> None:
    tensors = {vw_name: vw, "ex_srt": ex_srt, "x": x}
    for tname, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 {tname}, "
                             f"got {t.dtype}")
    if seg.dtype != torch.int32 or not seg.is_contiguous():
        raise ValueError(f"{name} takes contiguous int32 seg, got "
                         f"{seg.dtype}")
    if vw.dim() != 2 or vw.shape[0] != rows:
        raise ValueError(f"{vw_name} must be ({rows_name}={rows}, k+1), "
                         f"got {tuple(vw.shape)}")
    k = vw.shape[1] - 1
    n = seg.shape[0]
    if (k < 1 or ex_srt.shape != (n, k + 2) or x.shape != (n,)
            or seg.dim() != 1):
        raise ValueError(
            f"shapes: {vw_name} {tuple(vw.shape)}, ex_srt "
            f"{tuple(ex_srt.shape)}, x {tuple(x.shape)}, seg "
            f"{tuple(seg.shape)}; want ({rows_name}, k+1), (N, k+2), (N,), "
            "(N,)")
    devices = {t.device for t in (vw, ex_srt, x, seg)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    device = vw.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no kernel for {device}")
    if device.type == "cuda" and k > MAX_FACTORS:
        raise ValueError(f"the kernel takes k <= {MAX_FACTORS}, got {k}")


def _fm_grad(kernel: CudaKernel, vw, ex_srt, x, seg, num_segments, cv,
             cw) -> torch.Tensor:
    """Launch B3 or B4 (``kernel``) on checked CUDA tensors. The kernel
    writes every row of the output, zeros for the ranks no slot has."""
    device = vw.device
    k = vw.shape[1] - 1
    n = seg.shape[0]
    if n == 0:
        return torch.zeros((num_segments, 2 * k + 2), dtype=torch.float32,
                           device=device)
    out = torch.empty((num_segments, 2 * k + 2), dtype=torch.float32,
                      device=device)
    cv_t, cw_t = (torch.as_tensor(c, dtype=torch.float32,
                                  device=device).reshape(()) for c in (cv, cw))
    partials = _partials(kernel, "sfm_fm_grad_partial_rows", 2 * k + 2,
                         device, n, k, kernel.num_sms(device))
    kernel.launch(device, vw.data_ptr(), ex_srt.data_ptr(), x.data_ptr(),
                  seg.data_ptr(), cv_t.data_ptr(), cw_t.data_ptr(),
                  out.data_ptr(), partials.data_ptr(), n, num_segments, k)
    return out


def fm_grad_segsum_factored(vw_u: torch.Tensor, ex_srt: torch.Tensor,
                            x: torch.Tensor, seg: torch.Tensor,
                            num_segments: int, cv, cw) -> torch.Tensor:
    """(U, 2k+2) ``[Σg_v | Σg_w | Σg_v² | Σg_w²]`` per rank from the
    unique rows ``vw_u`` (U, k+1) aligned with seg's ranks, the example
    pack ``ex_srt`` (N, k+2), values ``x`` (N,) and sorted ranks ``seg``
    (N,) int32. CUDA tensors run the kernel (which traps on a rank outside
    [0, U)); its sums are deterministic. CPU tensors run the plain
    version."""
    _check("fm_grad_segsum_factored", vw_u, "vw_u", num_segments,
           "num_segments", ex_srt, x, seg)
    if vw_u.device.type == "cpu":
        return fm_grad_segsum_factored_reference(vw_u, ex_srt, x, seg,
                                                 num_segments, cv, cw)
    return _fm_grad(FACTORED, vw_u, ex_srt, x, seg, num_segments, cv, cw)


def fm_grad_segsum(vw_srt: torch.Tensor, ex_srt: torch.Tensor,
                   x: torch.Tensor, seg: torch.Tensor, num_segments: int,
                   cv, cw, *, bf16x2: bool = True) -> torch.Tensor:
    """B3's output from per-slot rows ``vw_srt`` (N, k+1), one per sorted
    slot, instead of the unique rows. ``bf16x2`` (a TPU matrix-unit
    option) is accepted; the sums are float32 either way. CUDA tensors run
    the kernel (which traps on a rank outside [0, U)); its sums are
    deterministic. CPU tensors run the plain version."""
    del bf16x2
    _check("fm_grad_segsum", vw_srt, "vw_srt", seg.shape[0], "N", ex_srt,
           x, seg)
    if vw_srt.device.type == "cpu":
        return fm_grad_segsum_reference(vw_srt, ex_srt, x, seg,
                                        num_segments, cv, cw)
    return _fm_grad(FM_GRAD, vw_srt, ex_srt, x, seg, num_segments, cv, cw)


def segment_rowsum_reference(g: torch.Tensor, seg: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """Plain version of B5: ``index_add_`` of the rows into (U, W), in
    g's dtype (the card's checks run it in float64)."""
    out = torch.zeros((num_segments, g.shape[1]), dtype=g.dtype,
                      device=g.device)
    return out.index_add_(0, seg.long(), g)


def segment_rowsum_sq_reference(g: torch.Tensor, seg: torch.Tensor,
                                num_segments: int) -> torch.Tensor:
    """Plain version of B6: B5's on ``[g | g²]``."""
    return segment_rowsum_reference(torch.cat([g, g.square()], dim=1), seg,
                                    num_segments)


def _check_rows(name, g, seg, num_segments) -> None:
    if g.dim() != 2 or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"{name} takes a contiguous 2-D float32 g, got "
                         f"{tuple(g.shape)} {g.dtype}")
    if seg.dtype != torch.int32 or seg.dim() != 1 or not seg.is_contiguous():
        raise ValueError(f"{name} takes a contiguous 1-D int32 seg, got "
                         f"{seg.dtype} {tuple(seg.shape)}")
    if seg.shape[0] != g.shape[0]:
        raise ValueError(f"g has {g.shape[0]} rows, seg {seg.shape[0]}")
    if g.device != seg.device:
        raise ValueError(f"inputs on several devices: {g.device}, "
                         f"{seg.device}")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no kernel for {g.device}")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    if g.device.type == "cuda" and not 1 <= g.shape[1] <= MAX_ROW_WIDTH:
        raise ValueError(f"the kernel takes 1 <= W <= {MAX_ROW_WIDTH}, got "
                         f"W={g.shape[1]}")


def _rowsum(kernel: CudaKernel, g, seg, num_segments, out_width):
    """Launch B5 or B6 (``kernel``) on checked CUDA tensors. The kernels
    write every row of the output, zeros for the ranks no slot has."""
    n = seg.shape[0]
    if n == 0:
        return torch.zeros((num_segments, out_width), dtype=torch.float32,
                           device=g.device)
    out = torch.empty((num_segments, out_width), dtype=torch.float32,
                      device=g.device)
    partials = _partials(kernel, "sfm_chunk_partial_rows", out_width,
                         g.device, n)
    kernel.launch(g.device, g.data_ptr(), seg.data_ptr(), out.data_ptr(),
                  partials.data_ptr(), n, num_segments, g.shape[1])
    return out


def segment_rowsum(g: torch.Tensor, seg: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """(U, W) float32 per-rank sums of the rows of ``g`` (N, W) over the
    sorted int32 ranks ``seg`` (N,); ranks no slot has are zero. CUDA
    tensors run the kernel, for any 1 <= W <= 65536 (it traps on a rank
    outside [0, U)); its sums are deterministic. CPU tensors run the plain
    version."""
    _check_rows("segment_rowsum", g, seg, num_segments)
    if g.device.type == "cpu":
        return segment_rowsum_reference(g, seg, num_segments)
    return _rowsum(ROWSUM, g, seg, num_segments, g.shape[1])


def segment_rowsum_sq(g: torch.Tensor, seg: torch.Tensor, num_segments: int,
                      *, bf16x2: bool = True) -> torch.Tensor:
    """(U, 2W) float32 ``[Σg | Σg²]`` per rank, the squares formed in the
    kernel, so ``[g | g²]`` never exists in memory. ``bf16x2`` (a TPU
    matrix-unit option) is accepted; the sums are float32 either way.
    Otherwise as :func:`segment_rowsum`."""
    del bf16x2
    _check_rows("segment_rowsum_sq", g, seg, num_segments)
    if g.device.type == "cpu":
        return segment_rowsum_sq_reference(g, seg, num_segments)
    return _rowsum(ROWSUM_SQ, g, seg, num_segments, 2 * g.shape[1])


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
    ``seg`` and the streams may be views at any element offset (the ALS
    sweep passes ``col_rank[b*N:(b+1)*N]``): the kernel's bulk copies start
    at the 16-byte boundary below each array and never read an unaligned
    float4. CPU tensors run the plain version."""
    streams = list(streams)
    _check_colsums(streams, seg, num_segments)
    device = seg.device
    if device.type == "cpu":
        return segment_colsums_reference(streams, seg, num_segments)
    s, n = len(streams), seg.shape[0]
    out = torch.zeros((num_segments, s), dtype=torch.float32, device=device)
    if n == 0:
        return out
    partials = _partials(COLSUMS, "sfm_colsums_partial_rows", s, device, n)
    ptrs = (ctypes.c_void_p * s)(*[t.data_ptr() for t in streams])
    COLSUMS.launch(device, ctypes.cast(ptrs, ctypes.c_void_p), s,
                   seg.data_ptr(), out.data_ptr(), partials.data_ptr(), n,
                   num_segments)
    return out
