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
- :func:`segment_rowsum` (kernel B5), per-rank sums of (N, W) rows: the
  fused step's adagrad_row pack and the direct step's per-slot momentum
  and adam terms (``solvers/sgd_fused.py``, ``solvers/sgd.py``), at the
  layout :func:`rowsum_layout` picks: B6's staged tiles without the
  squares for rows of up to ROWSUM_TILE_WIDTH floats (every path's), the
  chunked kernel for wider ones;
- :func:`segment_rowsum_sq` (kernel B6), ``[Σg | Σg²]`` per rank with the
  squares formed in the kernel, at the layout :func:`tile_layout` picks:
  the direct and dedup steps' ``[g_v | g_w]`` (``ops/embedding.py``) and,
  under adagrad and sgd, the fused and sorted steps';
- :func:`segment_colsums` (kernel B7) sums up to 16 one-dimensional
  streams per rank, for the ALS, MCMC and BS-ALS sweeps;
- :func:`als_stream_sums`, B7 over the five product streams of a (factor,
  block) of the compact ALS sweep (``solvers/als.py``), formed in the
  kernel from the (e, q) pairs of one (N, 2) array (gathered by the
  block's rows, one 8-byte load a slot) and x;
- :func:`als_patch`, no sum but the same sweep's patch of those pairs, in
  place, after a (factor, block) of a column-pure block, one streaming
  pass.

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
from typing import Optional

import torch

from sparkfm_tpu_torch.utils import profiling
from sparkfm_tpu_torch.utils.build import PACKAGE_DIR, CudaKernel

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "segsum.cu")
MAX_FACTORS = 128          # the backward kernels' largest k
MAX_ROW_WIDTH = 1 << 16    # segment_rowsum's largest W on the card
MAX_SQ_WIDTH = 1 << 15     # segment_rowsum_sq's: a row fits the tile
MAX_STREAMS = 16           # segment_colsums' largest S
TILE_THREADS = 512         # B6: most threads a block
TILE_BYTES = 64 << 10      # B6: a chunk's rows and ranks in shared memory
CHUNKS_PER_SM = 4          # B6 at small N: chunks an SM at least
ROWSUM_TILE_WIDTH = 64     # B5: the widest rows it sums on B6's tiles
ROWSUM_CHUNK = 256         # B5 on wider rows: slots a warp (kChunk)
_FM_GRAD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3
_ROWSUM_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
FACTORED = CudaKernel("segsum", SOURCE, "sfm_fm_grad_segsum_factored",
                      _FM_GRAD_ARGS)
FM_GRAD = CudaKernel("segsum", SOURCE, "sfm_fm_grad_segsum", _FM_GRAD_ARGS)
ROWSUM = CudaKernel("segsum", SOURCE, "sfm_segment_rowsum",
                    _ROWSUM_ARGS + [ctypes.c_int64] * 2)
ROWSUM_SQ = CudaKernel("segsum", SOURCE, "sfm_segment_rowsum_sq",
                       _ROWSUM_ARGS + [ctypes.c_int64] * 2)
COLSUMS = CudaKernel(
    "segsum", SOURCE, "sfm_segment_colsums",
    [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 3
    + [ctypes.c_int64] * 2)
STREAM_SUMS = CudaKernel("segsum", SOURCE, "sfm_als_stream_sums",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3)
ALS_PATCH = CudaKernel("segsum", SOURCE, "sfm_als_patch",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2)


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


def _rowsum(g, seg, num_segments):
    """Launch B5 on checked CUDA tensors, at :func:`rowsum_layout`. The
    kernel writes every row of the output, zeros for the ranks no slot
    has."""
    n, w = g.shape
    if n == 0:
        return torch.zeros((num_segments, w), dtype=torch.float32,
                           device=g.device)
    layout = rowsum_layout(n, w, ROWSUM.num_sms(g.device))
    chunk, groups = layout[1:3] if layout[0] == "tiles" else (0, 0)
    out = torch.empty((num_segments, w), dtype=torch.float32,
                      device=g.device)
    partials = torch.empty((layout[-1], w), dtype=torch.float32,
                           device=g.device)
    ROWSUM.launch(g.device, g.data_ptr(), seg.data_ptr(), out.data_ptr(),
                  partials.data_ptr(), n, num_segments, w, chunk, groups)
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
    return _rowsum(g, seg, num_segments)


def tile_layout(n: int, w: int, num_sms: int) -> tuple:
    """The staged tiles' layout (``csrc/segsum.cu``, rowsum_tiles_kernel:
    B6, and B5 on narrow rows) of N sorted slots of W floats on a card of
    ``num_sms`` SMs: ``(chunk, groups, partial_rows)``, the slots a block
    stages in shared memory and sums (one chunk each), the row groups its
    threads form and the pass-1 partial rows to allocate, two a chunk. A
    chunk holds the rows and ranks that fit in TILE_BYTES, but no more
    than N over CHUNKS_PER_SM chunks an SM, so a small N still spreads
    over the card; ``groups`` fills TILE_THREADS threads with groups of
    min(W, TILE_THREADS) columns, and the chunk is a multiple of it."""
    chunk = max(1, TILE_BYTES // (4 * (w + 1)))
    chunk = min(chunk, max(1, -(-n // (CHUNKS_PER_SM * num_sms))))
    groups = max(1, min(TILE_THREADS // min(w, TILE_THREADS), chunk))
    chunk = chunk // groups * groups
    return chunk, groups, 2 * -(-n // chunk)


def rowsum_layout(n: int, w: int, num_sms: int) -> tuple:
    """B5's layout of N sorted slots of W floats on a card of ``num_sms``
    SMs (``csrc/segsum.cu``): rows of at most ROWSUM_TILE_WIDTH floats go
    to B6's staged tiles without the squares, ``("tiles", chunk, groups,
    partial_rows)`` as :func:`tile_layout` gives them; wider rows to the
    chunked kernel (lanes over columns, ROWSUM_CHUNK slots a warp),
    ``("chunks", partial_rows)``. Either way two partial rows a chunk."""
    if w <= ROWSUM_TILE_WIDTH:
        return ("tiles", *tile_layout(n, w, num_sms))
    return ("chunks", 2 * -(-n // ROWSUM_CHUNK))


def _rowsum_sq(g, seg, num_segments):
    """Launch B6 on checked CUDA tensors, at :func:`tile_layout`. The
    kernel writes every row of the output, zeros for the ranks no slot
    has."""
    n, w = g.shape
    if w > MAX_SQ_WIDTH:
        raise ValueError(f"the kernel takes W <= {MAX_SQ_WIDTH}, got W={w}")
    if n == 0:
        return torch.zeros((num_segments, 2 * w), dtype=torch.float32,
                           device=g.device)
    chunk, groups, rows = tile_layout(n, w, ROWSUM_SQ.num_sms(g.device))
    out = torch.empty((num_segments, 2 * w), dtype=torch.float32,
                      device=g.device)
    partials = torch.empty((rows, 2 * w), dtype=torch.float32,
                           device=g.device)
    ROWSUM_SQ.launch(g.device, g.data_ptr(), seg.data_ptr(), out.data_ptr(),
                     partials.data_ptr(), n, num_segments, w, chunk, groups)
    return out


def segment_rowsum_sq(g: torch.Tensor, seg: torch.Tensor, num_segments: int,
                      *, bf16x2: bool = True) -> torch.Tensor:
    """(U, 2W) float32 ``[Σg | Σg²]`` per rank, the squares formed in the
    kernel, so ``[g | g²]`` never exists in memory. ``bf16x2`` (a TPU
    matrix-unit option) is accepted; the sums are float32 either way.
    CUDA tensors run the kernel for 1 <= W <= 32768 (a row must fit its
    shared-memory tile). Otherwise as :func:`segment_rowsum`."""
    del bf16x2
    _check_rows("segment_rowsum_sq", g, seg, num_segments)
    if g.device.type == "cpu":
        return segment_rowsum_sq_reference(g, seg, num_segments)
    return _rowsum_sq(g, seg, num_segments)


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


def als_stream_sums_reference(eq: torch.Tensor, x: torch.Tensor,
                              row: Optional[torch.Tensor],
                              seg: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """Plain version of :func:`als_stream_sums`: the (e, q) pairs gathered
    into CSC order, the five streams formed in torch, each product in the
    order the kernel forms it, then :func:`segment_colsums_reference`.
    Keeps the inputs' dtype (the card's checks run it in float64)."""
    eq_c = eq if row is None else eq.index_select(0, row)
    e_c, q_c = eq_c[:, 0], eq_c[:, 1]
    x2 = x * x
    return segment_colsums_reference(
        [e_c * x * q_c, e_c * x2, x2 * q_c * q_c, x2 * x * q_c, x2 * x2],
        seg, num_segments)


def _check_pairs(name, eq) -> None:
    """eq must be a contiguous, 8-byte-aligned (R, 2) float32 array."""
    if (eq.dtype != torch.float32 or eq.dim() != 2 or eq.shape[1] != 2
            or not eq.is_contiguous() or eq.data_ptr() % 8):
        raise ValueError(f"{name} takes a contiguous 8-byte-aligned (R, 2) "
                         f"float32 eq, got {eq.dtype} {tuple(eq.shape)}")


def _check_stream_sums(eq, x, row, seg, num_segments) -> None:
    _check_pairs("als_stream_sums", eq)
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"als_stream_sums takes a contiguous 1-D float32 "
                         f"x, got {x.dtype} {tuple(x.shape)}")
    for name, t in (("seg", seg), ("row", row)):
        if t is not None and (t.dtype != torch.int32 or t.dim() != 1
                              or not t.is_contiguous()):
            raise ValueError(f"als_stream_sums takes a contiguous 1-D int32 "
                             f"{name}, got {t.dtype} {tuple(t.shape)}")
    n = seg.shape[0]
    rows = n if row is None else eq.shape[0]
    if (x.shape[0] != n or (row is not None and row.shape[0] != n)
            or eq.shape[0] != rows):
        raise ValueError(
            f"lengths: eq {eq.shape[0]}, x {x.shape[0]}, row "
            f"{None if row is None else row.shape[0]}, seg {n}; want x, row "
            "and seg of one length, and eq of seg's when row is None")
    devices = {t.device for t in (eq, x, row, seg) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if seg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"als_stream_sums has no kernel for {seg.device}")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}")
    if rows >= 1 << 31:
        raise ValueError(f"eq holds {rows} pairs; the kernel takes fewer "
                         "than 2^31")


def als_stream_sums(eq: torch.Tensor, x: torch.Tensor,
                    row: Optional[torch.Tensor], seg: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """(U, 5) float32 per-rank sums of the compact ALS sweep's five
    streams, ``segment_colsums([e_c x q_c, e_c x², x² q_c², x³ q_c, x⁴],
    seg, U)`` with ``(e_c, q_c) = eq[row]``, without forming the streams
    or the gathered pairs in memory. ``eq`` (R, 2) holds each example's
    residual e and factor sum q side by side (float32, contiguous, 8-byte
    aligned), so one 8-byte load fetches both; ``x`` (N,) is float32;
    ``row`` (N,) int32 indexes eq, or is None when eq is already in seg's
    order (R = N); ``seg`` (N,) holds the sorted int32 ranks. x, row and
    seg may be views at any element offset, as for
    :func:`segment_colsums`. CUDA tensors run the kernel, whose sums equal
    B7's over the streams torch forms, bit for bit (it traps on a row
    outside [0, R) or a rank outside [0, U)); CPU tensors run the plain
    version. A call with rows counts its N slots on
    ``als.paired_gather_slots`` (``utils/profiling.py::count``)."""
    _check_stream_sums(eq, x, row, seg, num_segments)
    n = seg.shape[0]
    if row is not None:
        profiling.count("als.paired_gather_slots", n)
    device = seg.device
    if device.type == "cpu":
        return als_stream_sums_reference(eq, x, row, seg, num_segments)
    out = torch.zeros((num_segments, 5), dtype=torch.float32, device=device)
    if n == 0:
        return out
    partials = _partials(STREAM_SUMS, "sfm_colsums_partial_rows", 5, device,
                         n)
    STREAM_SUMS.launch(device, eq.data_ptr(), x.data_ptr(),
                       None if row is None else row.data_ptr(),
                       seg.data_ptr(), out.data_ptr(), partials.data_ptr(), n,
                       eq.shape[0], num_segments)
    return out


def als_patch_bytes(n: int, num_ranks: int, q_next: bool = False) -> int:
    """Bytes one :func:`als_patch` call must move: rank, vals and the (e,
    q) pairs read once and the pairs written once (24 bytes an example),
    q_next read once when given (4 more), and the (U, 2) table read
    once."""
    return (28 if q_next else 24) * n + 8 * num_ranks


def als_patch_reference(eq: torch.Tensor, table: torch.Tensor,
                        rank: torch.Tensor, vals: torch.Tensor,
                        q_next: Optional[torch.Tensor] = None) -> None:
    """Plain version of :func:`als_patch`: the compact sweep's torch lines
    for a column-pure block, in their order, on eq's two columns, copied
    into them."""
    e, q = eq[:, 0], eq[:, 1]
    delta, dsq = table[:, 0], table[:, 1]
    q_new = q + delta.index_select(0, rank) * vals
    e_new = (e + 0.5 * (q_new.square() - q.square())
             - 0.5 * (dsq.index_select(0, rank) * vals.square()))
    e.copy_(e_new)
    q.copy_(q_new if q_next is None else q_next)


def _check_patch(eq, table, rank, vals, q_next) -> None:
    _check_pairs("als_patch", eq)
    for name, t in (("vals", vals), ("rank", rank), ("q_next", q_next)):
        dtype = "int32" if name == "rank" else "float32"
        if t is not None and (t.dtype != getattr(torch, dtype)
                              or t.dim() != 1 or not t.is_contiguous()):
            raise ValueError(f"als_patch takes a contiguous 1-D {dtype} "
                             f"{name}, got {t.dtype} {tuple(t.shape)}")
    if (table.dtype != torch.float32 or table.dim() != 2
            or table.shape[1] != 2 or not table.is_contiguous()
            or table.data_ptr() % 8):
        raise ValueError(f"als_patch takes a contiguous 8-byte-aligned "
                         f"(U, 2) float32 table, got {table.dtype} "
                         f"{tuple(table.shape)}")
    n = eq.shape[0]
    if not (rank.shape[0] == vals.shape[0] == n
            and (q_next is None or q_next.shape[0] == n)):
        raise ValueError(f"lengths: eq {n}, rank {rank.shape[0]}, vals "
                         f"{vals.shape[0]}, q_next "
                         f"{None if q_next is None else q_next.shape[0]}; "
                         "want one")
    devices = {t.device for t in (eq, table, rank, vals, q_next)
               if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if eq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"als_patch has no kernel for {eq.device}")
    for name, t in (("table", table), ("rank", rank), ("vals", vals),
                    ("q_next", q_next)):
        if t is not None and n and _overlap(eq, t):
            raise ValueError(f"als_patch writes eq: it overlaps {name}")


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the memory of contiguous ``a`` and ``b`` overlaps."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.nbytes and b0 < a0 + a.nbytes


def als_patch(eq: torch.Tensor, table: torch.Tensor, rank: torch.Tensor,
              vals: torch.Tensor,
              q_next: Optional[torch.Tensor] = None) -> None:
    """Patches the (e, q) pairs ``eq`` in place after a (factor, block) of
    the compact ALS sweep whose block is column-pure: ``q' = q +
    delta[rank] vals`` and ``e' = (e + 0.5 (q'² - q²)) - 0.5 dsq[rank]
    vals²``, with ``(delta, dsq)`` the rows of the float32 (U, 2)
    ``table`` (the per-rank change of the factor and of its square). The
    q column then holds q', or ``q_next`` where given: the next factor's
    q, which the sweep loads with the factor's last patch, since nothing
    reads q' after it. ``eq`` is a contiguous 8-byte-aligned (N, 2)
    float32 array; ``vals``, ``q_next`` (N,) are float32 and ``rank``
    (N,) int32; rank, vals and q_next may be views at any element offset
    (the sweep passes rows of its (L, N) view and of its q bank). CUDA
    tensors run the kernel, whose results equal the plain version's torch
    lines bit for bit (it traps on a rank outside [0, U)); CPU tensors run
    the plain version. A call with q_next counts on
    ``als.q_next_patches``."""
    _check_patch(eq, table, rank, vals, q_next)
    if q_next is not None:
        profiling.count("als.q_next_patches", 1)
    if eq.device.type == "cpu":
        als_patch_reference(eq, table, rank, vals, q_next)
    elif eq.shape[0]:
        ALS_PATCH.launch(eq.device, eq.data_ptr(), table.data_ptr(),
                         rank.data_ptr(), vals.data_ptr(),
                         None if q_next is None else q_next.data_ptr(),
                         eq.shape[0], table.shape[0])
