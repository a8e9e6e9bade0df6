"""ALS (blocked coordinate descent) for plain FM on one device. Port of
``sparkfm_tpu/solvers/als.py``: the workspace, its structure checks, the
compact sweep and ``train_als``.

Each sweep updates w0, then every block of linear weights, then every
(factor, block), each coordinate by the exact minimizer of the squared
loss plus its L2 term:

    theta* = (theta * sum(h^2) - sum(e * h)) / (reg + sum(h^2))

with h = x for a linear weight and h = x (q - x v) for a factor, kept
only where it is finite and the column is not empty. Within a block the
updates are Jacobi, across blocks Gauss-Seidel: after each block the
residual e and the factor sums q are patched exactly. With slot-aligned
blocks (:func:`slot_blocks`) no two features of a block share an example,
so within-block Jacobi is exact coordinate descent. ALS fits squared loss
only: classification and FFM train with SGD.

The compact sweep keeps the JAX package's algorithm:

- per-feature state lives in the rank space of the features present in
  the data (``present``); absent features never change;
- the per-feature sums are five example-derived streams per (factor,
  block), num = Σexq − v·Σex² and den = Σx²q² − 2v·Σx³q + v²·Σx⁴,
  summed per rank over the feature-sorted CSC view by
  ``ops/segsum.py::als_stream_sums``, which gathers e and q into CSC order
  and forms the streams inside its kernel (B7's design, its sums B7's
  over the streams torch would form, bit for bit); one stream per block
  for w, summed by kernel B7 (``segment_colsums``);
- per-example quantities (q, the score, the e/q patches) are column sums
  of the (L, N) rank-space view;
- ``csc_uniform``: when every block owns one contiguous N-run of the CSC
  view, each block's streams cover only that run (1/L of the stream work);
  ``column_pure``: when block b is exactly slot b, a patch reads one row of
  the (L, N) view, and a (factor, block)'s patch of q and e is one kernel
  that reads each stream once (``ops/segsum.py::als_patch``);
  ``slice_identity``: a block whose CSC run is the example
  order itself (block 0 after :func:`build_workspace`'s reorder) skips its
  e/q gathers.

Left out on purpose, since they work around the TPU and not the problem:
the ``paired_minor`` (nnz, 2) and (L, N, 2) gathers and
``_PAIRED_MINOR_MAX_BYTES`` (TPU tiling; every gather here is 1-D); the
K+1 dispatch split ``als_sweep_compact_dispatched`` (a TPU runtime killed
dispatches over ~60 s; torch launches op by op); and the 1 GiB threshold
between the batched (L, N, K) forward and the per-factor one (a TPU
compile-time OOM). Here the forward is always per factor and banks each
factor's q in a (K, N) tensor for the factor loop: a row of it is a
contiguous view on the card, where the TPU lowered it to padded copies;
the transient is two (L, N) tensors instead of (L, N, K) ones (6.4 GB each
at BASELINE config 2); and the bank spares the factor loop K passes that
would recompute q.

:func:`als_sweep` is the JAX package's reference sweep
(``_sweep_impl``) in its direct form: per-feature state in the full F
space, every per-feature sum over the feature-sorted CSC view by kernel B7
with the feature ids as its ranks, every per-example sum an ``index_add_``
by example (XLA scatters in the JAX package, not Pallas). With ``allr`` it
is the sharded sweep (``parallel/sharded_als.py``): each per-feature and
example-space sum is summed over the ranks that hold the examples.
:func:`train_als` runs the compact sweep; a dataset with no entries
leaves its parameters unchanged, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from sparkfm_tpu_torch.config import ALSConfig, FMConfig, Task
from sparkfm_tpu_torch.data.batching import SparseDataset
from sparkfm_tpu_torch.models import fm as fm_model
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import segsum
from sparkfm_tpu_torch.training.trainer import TrainResult, evaluate
from sparkfm_tpu_torch.utils import device as device_util
from sparkfm_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass
class ALSWorkspace:
    """The dataset views the sweep reads, as tensors on one device.

    slot_rank, slot_val: (L, N) int32 / f32, the examples in rank space,
        slot by slot (the JAX workspace's repurposed ``ids`` / ``vals``):
        per-example sums are column sums over L.
    y: (N,) f32 labels, examples in :func:`sort_examples` order.
    col_row, col_val, col_rank: (nnz,) the feature-sorted CSC view: each
        entry's example, value and feature rank (sorted; the B7 ``seg``).
    present: (Fp,) int32 feature id of each rank.
    block_of_feat: (F,) int32 feature -> block; den_w: (F,) f32 Σx² per
        feature.

    Every array equals the JAX workspace's. The JAX workspace also stores
    ``col_feat`` and an all-ones example ``mask``; here both are derived
    when read (:attr:`col_feat`, :attr:`mask`), since no sweep of the port
    needs them on the card.
    """

    slot_rank: torch.Tensor
    slot_val: torch.Tensor
    y: torch.Tensor
    col_row: torch.Tensor
    col_val: torch.Tensor
    col_rank: torch.Tensor
    present: torch.Tensor
    block_of_feat: torch.Tensor
    den_w: torch.Tensor

    @property
    def col_feat(self) -> torch.Tensor:
        """(nnz,) int32 feature id of each CSC entry: present[col_rank]."""
        return self.present.index_select(0, self.col_rank)

    @property
    def mask(self) -> torch.Tensor:
        """(N,) f32 example mask: all ones on one device."""
        return torch.ones_like(self.y)


def feature_blocks_of(num_features: int, als_cfg: ALSConfig) -> tuple:
    """(block_of_feat (F,) int32 numpy, num_blocks): ``feature_blocks`` if
    given, else contiguous blocks of ``block_size`` features."""
    if als_cfg.feature_blocks is not None:
        bof = np.asarray(als_cfg.feature_blocks, np.int32)
        if bof.shape != (num_features,):
            raise ValueError(f"feature_blocks has shape {bof.shape}, want "
                             f"({num_features},)")
    else:
        bs = max(1, als_cfg.block_size)
        bof = (np.arange(num_features) // bs).astype(np.int32)
    return bof, int(bof.max()) + 1


def sort_examples(ds: SparseDataset) -> tuple:
    """(ids, vals, y) with the examples reordered by their slot-0 feature,
    stably. ALS is full-batch, so the order changes only the order of f32
    sums; with slot-aligned blocks it makes block 0's CSC run the example
    order itself (:func:`csc_slice_identity`)."""
    order = np.argsort(np.asarray(ds.ids[:, 0]), kind="stable")
    return (np.asarray(ds.ids)[order], np.asarray(ds.vals)[order],
            np.asarray(ds.y)[order])


def csc_view(ids: np.ndarray, vals: np.ndarray) -> tuple:
    """(col_feat, col_row, col_val): every (example, slot) entry, sorted
    stably by feature."""
    n, l = ids.shape
    col_feat = ids.reshape(-1).astype(np.int32)
    col_row = np.repeat(np.arange(n, dtype=np.int32), l)
    col_val = vals.reshape(-1).astype(np.float32)
    order = np.argsort(col_feat, kind="stable")
    return col_feat[order], col_row[order], col_val[order]


def to_device(arrays: dict, device) -> dict:
    """Each numpy array copied once to ``device``."""
    return {k: torch.as_tensor(a, device=device) for k, a in arrays.items()}


def build_workspace(ds: SparseDataset, cfg: FMConfig, als_cfg: ALSConfig,
                    *, device) -> tuple:
    """Host numpy prep, then one copy of each array to ``device``. Returns
    (workspace, num_blocks)."""
    f = cfg.num_features
    ids_s, vals_s, y_s = sort_examples(ds)
    col_feat, col_row, col_val = csc_view(ids_s, vals_s)
    block_of_feat, num_blocks = feature_blocks_of(f, als_cfg)

    den_w = np.zeros((f,), np.float32)
    np.add.at(den_w, col_feat, col_val ** 2)

    # dense rank of each sorted CSC entry among the present features, and
    # the examples in rank space
    boundary = np.empty(col_feat.shape[0], bool)
    boundary[:1] = True
    boundary[1:] = col_feat[1:] != col_feat[:-1]
    col_rank = (np.cumsum(boundary) - 1).astype(np.int32)
    present = col_feat[boundary].astype(np.int32)
    rank_of_feat = np.zeros((f,), np.int32)
    rank_of_feat[present] = np.arange(len(present), dtype=np.int32)
    slot_rank = rank_of_feat[ids_s]

    t = to_device(dict(
        slot_rank=np.ascontiguousarray(slot_rank.T),
        slot_val=np.ascontiguousarray(vals_s.astype(np.float32).T),
        y=y_s, col_row=col_row, col_val=col_val, col_rank=col_rank,
        present=present, block_of_feat=block_of_feat, den_w=den_w), device)
    return ALSWorkspace(**t), num_blocks


def blocks_are_column_pure(ds: SparseDataset, block_of_feat) -> bool:
    """True iff block b's features appear exactly in slot b of every
    example (the slot_blocks layout): a patch for block b then reads one
    slot instead of all L."""
    bof = np.asarray(block_of_feat)
    ids = np.asarray(ds.ids)
    vals = np.asarray(ds.vals)
    if int(bof.max()) + 1 != ids.shape[1]:
        return False
    for l in range(ids.shape[1]):
        feats = ids[:, l][vals[:, l] != 0]
        if feats.size and not np.all(bof[feats] == l):
            return False
    return True


def csc_blocks_uniform(ds: SparseDataset, block_of_feat) -> bool:
    """True iff the feature-sorted CSC view splits into num_blocks
    contiguous runs of exactly N entries, run b holding block b's entries:
    then each block's streams cover one static N-slice. Sort-free: block
    ids must be monotone over the features that appear, and every block
    must own exactly N entries."""
    bof = np.asarray(block_of_feat)
    ids = np.asarray(ds.ids)
    n = ids.shape[0]
    nb = int(bof.max()) + 1
    if nb * n != ids.size:
        return False
    occur = np.bincount(ids.reshape(-1), minlength=len(bof))
    present_blocks = bof[occur > 0]
    if not bool(np.all(np.diff(present_blocks) >= 0)):
        return False
    counts = np.bincount(bof[ids.reshape(-1)], minlength=nb)
    return bool(np.all(counts == n))


def csc_slice_identity(ws: ALSWorkspace, num_blocks: int,
                       n_examples: int) -> tuple:
    """Per block: True iff its CSC run col_row[b*N:(b+1)*N] is arange(N),
    so its e/q gathers are the identity. Compared on the workspace's
    device; meaningful only under :func:`csc_blocks_uniform`."""
    cr = ws.col_row
    if cr.shape[0] != num_blocks * n_examples:
        return tuple([False] * num_blocks)
    ar = torch.arange(n_examples, dtype=cr.dtype, device=cr.device)
    return tuple(bool(torch.equal(cr[b * n_examples:(b + 1) * n_examples],
                                  ar))
                 for b in range(num_blocks))


def slot_blocks(ds: SparseDataset) -> tuple:
    """Slot-aligned feature blocks: each feature goes to the first slot it
    appears in. Features sharing a slot never share an example, so
    within-block Jacobi is exact Gauss-Seidel; features that drift across
    slots (multi-hot, hash collisions) get mild within-block Jacobi."""
    ids = np.asarray(ds.ids)
    vals = np.asarray(ds.vals)
    blocks = np.zeros((ds.num_features,), np.int32)
    seen = np.zeros((ds.num_features,), bool)
    for l in range(ids.shape[1]):
        feats = np.unique(ids[:, l][vals[:, l] != 0])
        fresh = feats[~seen[feats]]
        blocks[fresh] = l
        seen[fresh] = True
    return tuple(int(b) for b in blocks)


def _guarded_theta(theta, num, den, reg):
    """theta* = (theta*den - num) / (reg + den), kept only where it is
    finite and the column is not empty."""
    new = (theta * den - num) / (reg + den)
    return torch.where(torch.isfinite(new) & (den > 0), new, theta)


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src[idx] for a 1-D ``src`` and an int32 index of any shape."""
    return src.index_select(0, idx.reshape(-1)).view(idx.shape)


def _compact(reg, present: torch.Tensor):
    """A per-feature (F,) strength in rank space; a scalar as it is."""
    if torch.is_tensor(reg) and reg.dim():
        return reg.index_select(0, present)
    return reg


@dataclasses.dataclass(frozen=True)
class BlockViews:
    """How a compact sweep reads block b of a workspace of ``n`` examples:
    ``column_pure`` (host-checked by :func:`blocks_are_column_pure`),
    ``csc_uniform`` (:func:`csc_blocks_uniform`, requires column_pure) and
    ``slice_identity`` (:func:`csc_slice_identity`) select the faster
    forms of the same sums. The ALS and MCMC sweeps share it."""

    n: int
    column_pure: bool = False
    csc_uniform: bool = False
    slice_identity: tuple = ()

    def __post_init__(self):
        if self.csc_uniform and not self.column_pure:
            raise ValueError("csc_uniform requires column_pure")

    def csc(self, arr: torch.Tensor, b: int) -> torch.Tensor:
        """Block b's part of a CSC array: its N-run, or all of it."""
        return arr[b * self.n:(b + 1) * self.n] if self.csc_uniform else arr

    def rows(self, col_row: torch.Tensor, b: int) -> Optional[torch.Tensor]:
        """Block b's CSC rows (the example of each entry), or None when
        its CSC run is the example order itself."""
        if (self.csc_uniform and b < len(self.slice_identity)
                and self.slice_identity[b]):
            return None
        return self.csc(col_row, b)

    def to_csc(self, ex: torch.Tensor, col_row: torch.Tensor,
               b: int) -> torch.Tensor:
        """An example vector in block b's CSC order."""
        rows = self.rows(col_row, b)
        return ex if rows is None else ex.index_select(0, rows)

    def patch(self, arr_c: torch.Tensor, rank_csr: torch.Tensor,
              vals: torch.Tensor, b: int) -> torch.Tensor:
        """Per-example sum over block b's slots of arr_c[rank] * vals."""
        if self.column_pure:
            return _take(arr_c, rank_csr[b]) * vals[b]
        return (_take(arr_c, rank_csr) * vals).sum(0)


def compact_forward(ws: ALSWorkspace, w0: torch.Tensor, w_c: torch.Tensor,
                    v_t: torch.Tensor, use_bias: bool = True,
                    use_linear: bool = True) -> tuple:
    """(score (N,), q_bank (K, N)) from rank-space parameters, one factor
    at a time; q of each factor is banked for its turn in the factor
    loop (``v_t``: (K, Fp) factors by rank)."""
    rank_csr, vals_csr = ws.slot_rank, ws.slot_val
    k, n = v_t.shape[0], ws.y.shape[0]
    score = torch.zeros_like(ws.y)
    q_bank = torch.empty((k, n), dtype=torch.float32, device=ws.y.device)
    for f in range(k):
        vr = _take(v_t[f], rank_csr) * vals_csr                 # (L, N)
        q_bank[f] = vr.sum(0)
        score += 0.5 * (q_bank[f].square() - vr.square().sum(0))
    if use_linear:
        score = score + (_take(w_c, rank_csr) * vals_csr).sum(0)
    if use_bias:
        score = score + w0
    return score, q_bank


def als_sweep_compact(params: FMParams, ws: ALSWorkspace, num_blocks: int,
                      num_ranks: int, reg0: float, reg_w, reg_v,
                      use_bias: bool = True, use_linear: bool = True,
                      column_pure: bool = False, csc_uniform: bool = False,
                      slice_identity: tuple = ()) -> FMParams:
    """One compact sweep: w0, every w block, every (factor, block). Returns
    new parameters; ``params`` is not changed.

    ``reg_w`` / ``reg_v`` are scalars or per-feature (F,) tensors.
    ``column_pure``, ``csc_uniform`` and ``slice_identity`` select the
    faster forms of the same updates (:class:`BlockViews`).

    Spans (``utils/profiling.py::annotate``, timed on the card too): the
    sweep is ``als.sweep``; in it the forward is ``als.forward``, the w
    blocks ``als.linear``, and each (factor, block) is
    ``als.stream_sums`` (the five per-rank sums), ``als.solve`` (num, den,
    the new factors) and ``als.patch`` (q and e patched; in place by
    ``segsum.als_patch`` when ``column_pure``).

    From the factor loop on, e and the current factor's q live as the two
    columns of one (N, 2) array, so the stream sums fetch both by one
    8-byte load a slot; the factor's last patch writes the next factor's
    q into the q column."""
    on_card = ws.y.is_cuda
    with annotate("als.sweep", device=on_card):
        return _sweep_compact(params, ws, num_blocks, num_ranks, reg0, reg_w,
                              reg_v, use_bias, use_linear,
                              BlockViews(ws.y.shape[0], column_pure,
                                         csc_uniform, slice_identity),
                              on_card)


def _sweep_compact(params, ws, num_blocks, num_ranks, reg0, reg_w, reg_v,
                   use_bias, use_linear, views, on_card):
    k = params.v.shape[1]
    present = ws.present
    rank_csr, vals_csr = ws.slot_rank, ws.slot_val
    # a column-pure block's patch is one kernel that squares vals itself
    vals_sq = None if views.column_pure else vals_csr.square()
    col_row, x, col_rank = ws.col_row, ws.col_val, ws.col_rank
    w_c = params.w.index_select(0, present)
    v_t = params.v.index_select(0, present).t().contiguous()    # (K, Fp)
    den_w_c = ws.den_w.index_select(0, present)
    block_c = ws.block_of_feat.index_select(0, present)
    in_block = [block_c == b for b in range(num_blocks)]
    rw_c, rv_c = _compact(reg_w, present), _compact(reg_v, present)
    csc = views.csc
    # each (factor, block)'s delta and dsq are written as the two columns
    # of the table whose rows the patch kernel gathers
    table = torch.empty((num_ranks, 2), dtype=torch.float32,
                        device=ws.y.device)
    zero = table.new_zeros(())

    with annotate("als.forward", device=on_card):
        score, q_bank = compact_forward(ws, params.w0, w_c, v_t, use_bias,
                                        use_linear)
    e = score - ws.y

    w0_new = params.w0.clone()
    if use_bias:
        w0_new = _guarded_theta(params.w0, e.sum(),
                                torch.tensor(float(ws.y.shape[0]),
                                             device=e.device), reg0)
        e = e + (w0_new - params.w0)

    if use_linear:
        with annotate("als.linear", device=on_card):
            for b in range(num_blocks):
                num = segsum.segment_colsums(
                    [views.to_csc(e, col_row, b) * csc(x, b)],
                    csc(col_rank, b), num_ranks)[:, 0]
                theta = _guarded_theta(w_c, num, den_w_c, rw_c)
                delta = torch.where(in_block[b], theta - w_c, 0.0)
                e = e + views.patch(delta, rank_csr, vals_csr, b)
                w_c = w_c + delta

    # the factor loop keeps e and the current factor's q side by side, one
    # (N, 2) pair an example, which the stream sums gather by one 8-byte
    # load; a factor's last patch writes the next factor's q in place of
    # its own, which nothing reads after it
    eq = torch.stack([e, q_bank[0]], dim=1) if k else None
    del e
    for f in range(k):
        vf = v_t[f]
        q_next = q_bank[f + 1] if f + 1 < k else None
        for b in range(num_blocks):
            with annotate("als.stream_sums", device=on_card):
                sums = segsum.als_stream_sums(
                    eq, csc(x, b), views.rows(col_row, b), csc(col_rank, b),
                    num_ranks)                                  # (Fp, 5)
            with annotate("als.solve", device=on_card):
                num = sums[:, 0] - vf * sums[:, 1]
                den = (sums[:, 2] - 2.0 * vf * sums[:, 3]
                       + vf.square() * sums[:, 4]).clamp_min(0.0)
                theta = _guarded_theta(vf, num, den, rv_c)
                delta = torch.where(in_block[b], theta - vf, zero,
                                    out=table[:, 0])
                vf_new = vf + delta
                dsq = torch.where(in_block[b],
                                  vf_new.square() - vf.square(), zero,
                                  out=table[:, 1])
            with annotate("als.patch", device=on_card):
                nxt = q_next if b == num_blocks - 1 else None
                if views.column_pure:               # eq in place
                    segsum.als_patch(eq, table, rank_csr[b], vals_csr[b],
                                     nxt)
                else:       # eq's columns in place, no whole-column copy
                    e, q = eq[:, 0], eq[:, 1]
                    q_sq = q.square()
                    q.add_(views.patch(delta, rank_csr, vals_csr, b))
                    torch.sub(e + 0.5 * (q.square() - q_sq),
                              0.5 * views.patch(dsq, rank_csr, vals_sq, b),
                              out=e)
                    if nxt is not None:
                        q.copy_(nxt)
            vf = vf_new
        v_t[f] = vf

    return scatter_compact(params, present, w0_new,
                           w_c if use_linear else None, v_t)


class DirectViews:
    """How the reference sweeps (:func:`als_sweep`,
    ``mcmc.mcmc_sweep_direct``) read a workspace ``ws`` that provides
    ``y``, ``mask`` (N,), the feature-sorted CSC view ``col_feat``,
    ``col_row``, ``col_val`` (nnz,), ``block_of_feat`` and ``den_w`` (F,):
    an :class:`ALSWorkspace`, or one rank's shard
    (``parallel/sharded_als.py::ShardedWorkspace``). Per-feature sums are
    kernel B7 over the sorted feature ids as ranks, then ``allr`` (the
    sharded sweep's psum over the ranks holding the examples, in place;
    none on one device); per-example sums are ``index_add_``."""

    def __init__(self, ws, num_features: int, allr=None):
        self.ws, self.num_features = ws, num_features
        self.allr = allr or (lambda t: t)
        self.col_feat = ws.col_feat.contiguous()
        self.feat = self.col_feat.long()
        self.row = ws.col_row.long()
        self.x = ws.col_val
        self.x_sq = self.x.square()

    def by_row(self, t: torch.Tensor) -> torch.Tensor:
        """(nnz,) CSC values summed per example: (N,)."""
        return torch.zeros_like(self.ws.y).index_add_(0, self.row, t)

    def by_feat(self, *streams) -> torch.Tensor:
        """(F, S): each (nnz,) CSC stream summed per feature (B7)."""
        return self.allr(segsum.segment_colsums(streams, self.col_feat,
                                                self.num_features))

    def score(self, params: FMParams, use_bias: bool,
              use_linear: bool) -> torch.Tensor:
        """(N,) FM scores from the CSC view alone."""
        x, feat = self.x, self.feat
        score = torch.zeros_like(self.ws.y)
        if use_bias:
            score = score + params.w0
        if use_linear:
            score = score + self.by_row(params.w.index_select(0, feat) * x)
        for f in range(params.v.shape[1]):
            vx = params.v[:, f].index_select(0, feat) * x
            score = score + 0.5 * (self.by_row(vx).square()
                                   - self.by_row(vx.square()))
        return score

    def h(self, q: torch.Tensor, vf: torch.Tensor) -> torch.Tensor:
        """A factor's h = x (q - x v) at each CSC entry."""
        x = self.x
        return x * (q.index_select(0, self.row)
                    - x * vf.index_select(0, self.feat))

    def patch(self, e, q, vf, delta, in_block) -> tuple:
        """(vf + delta, q, e) after a block's factor step: q patched by
        Σ delta x, e by the full quadratic change of the factor's term."""
        vf_new = vf + delta
        q_new = q + self.by_row(delta.index_select(0, self.feat) * self.x)
        dsq = torch.where(in_block, vf_new.square() - vf.square(), 0.0)
        e = (e + 0.5 * (q_new.square() - q.square())
             - 0.5 * self.by_row(dsq.index_select(0, self.feat) * self.x_sq))
        return vf_new, q_new, e


def als_sweep(params: FMParams, ws, num_blocks: int, num_features: int,
              reg0: float, reg_w, reg_v, use_bias: bool = True,
              use_linear: bool = True, allr=None) -> FMParams:
    """One reference sweep (JAX ``solvers/als.py::_sweep_impl`` /
    ``als_sweep``): w0, every w block, every (factor, block), in the full
    F space, reading ``ws`` through :class:`DirectViews` (B7 one stream a
    w block, two a (factor, block)). Returns new parameters; ``params``
    is not changed. With ``allr`` it is the sharded sweep: every
    per-feature sum, den_w and the bias sums are summed over the ranks;
    parameters stay replicated and the e/q patches local.
    ``reg_w``/``reg_v`` are scalars or per-feature (F,) tensors."""
    d = DirectViews(ws, num_features, allr)
    mask, bof = ws.mask, ws.block_of_feat
    den_w_g = d.allr(ws.den_w.clone())
    e = d.score(params, use_bias, use_linear) - ws.y

    w0_new = params.w0.clone()
    if use_bias:
        w0_new = _guarded_theta(params.w0, d.allr((e * mask).sum()),
                                d.allr(mask.sum()), reg0)
        e = e + (w0_new - params.w0)

    w = params.w.clone()
    if use_linear:
        for b in range(num_blocks):
            num = d.by_feat(e.index_select(0, d.row) * d.x)[:, 0]
            theta = _guarded_theta(w, num, den_w_g, reg_w)
            delta = torch.where(bof == b, theta - w, 0.0)
            w = w + delta
            e = e + d.by_row(delta.index_select(0, d.feat) * d.x)

    v = params.v.clone()
    for f in range(v.shape[1]):
        vf = v[:, f].clone()
        q = d.by_row(vf.index_select(0, d.feat) * d.x)
        for b in range(num_blocks):
            h = d.h(q, vf)
            sums = d.by_feat(e.index_select(0, d.row) * h, h * h)
            theta = _guarded_theta(vf, sums[:, 0], sums[:, 1], reg_v)
            in_block = bof == b
            vf, q, e = d.patch(e, q, vf, torch.where(in_block, theta - vf,
                                                     0.0), in_block)
        v[:, f] = vf
    return FMParams(w0=w0_new, w=w, v=v)


def scatter_compact(params: FMParams, present: torch.Tensor,
                    w0: torch.Tensor, w_c: Optional[torch.Tensor],
                    v_t: torch.Tensor) -> FMParams:
    """New parameters: copies of ``params`` with the present features'
    rows replaced by the rank-space ``w_c`` (None: w unchanged) and ``v_t``
    (K, Fp)."""
    idx = present.long()
    w_new = params.w.clone()
    if w_c is not None:
        w_new[idx] = w_c
    v_new = params.v.clone()
    v_new[idx] = v_t.t()
    return FMParams(w0=w0, w=w_new, v=v_new)


def workspace_hbm_bytes(ds: SparseDataset, cfg: FMConfig) -> int:
    """Upper-bound device bytes of training: the workspace (CSC view 3 x
    nnz, rank-space view and its squares 3 x nnz), a block's transients
    (gathered e and q, five streams, x², products: 8 x nnz), the example
    vectors and the (K, N) q bank, and parameters with their compact and
    returned copies."""
    nnz = ds.ids.size
    n = ds.num_examples
    f, k = cfg.num_features, cfg.num_factors
    workspace = 6 * nnz * 4 + n * 4 + 3 * f * 4
    transients = 8 * nnz * 4
    ex_vecs = (k + 6) * n * 4                 # q bank, e, q, score, patches
    params = 3 * f * (k + 1) * 4
    return workspace + transients + ex_vecs + params


def _device_memory_limit(device: torch.device) -> int:
    """Bytes the sweep may use on ``device``; 0 = unknown (no check). The
    environment variable SPARKFM_HBM_BUDGET overrides, as in the JAX
    package."""
    env = os.environ.get("SPARKFM_HBM_BUDGET")
    if env:
        return int(env)
    if device.type != "cuda":
        return 0
    free, _ = torch.cuda.mem_get_info(device)
    # memory that torch's allocator holds but no tensor uses is free too
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int(free + cached)


def _check_hbm(ds: SparseDataset, cfg: FMConfig, device) -> None:
    need = workspace_hbm_bytes(ds, cfg)
    limit = _device_memory_limit(torch.device(device))
    if limit and need > 0.9 * limit:
        raise ValueError(
            f"ALS workspace needs ~{need / 2**30:.1f} GiB but the device "
            f"has {limit / 2**30:.1f} GiB HBM free. Subsample, or shard the "
            "examples over a mesh (FM(mesh=...), parallel/sharded_als.py). "
            "Set SPARKFM_HBM_BUDGET to override the detected limit.")


def train_als(cfg: FMConfig, als_cfg: ALSConfig, train: SparseDataset,
              eval_ds: Optional[SparseDataset] = None, eval_every: int = 1,
              generator: Optional[torch.Generator] = None,
              params: Optional[FMParams] = None, *,
              device=device_util.DEFAULT) -> TrainResult:
    """ALS training on ``device`` (default: the card; without one it
    raises, ``utils/device.py``): ``als_cfg.epochs`` compact sweeps.

    ``params`` warm-starts (copied to ``device``; the caller's tensors are
    not changed); otherwise V is drawn from ``generator`` (default: seeded
    from ``cfg.seed``). Each history record holds the epoch and, every
    ``eval_every`` sweeps and after the last, ``eval_*`` metrics of
    ``eval_ds``. ``max_seconds`` is checked after each sweep.
    ``examples_per_sec`` counts swept examples over the sweeps' and evals'
    wall time; the workspace, its structure checks and the kernel build
    come before the clock starts.
    """
    if cfg.task != Task.REGRESSION:
        raise ValueError("ALS optimizes squared loss; use SGD for "
                         "classification (the reference never implemented "
                         "classification training either: Task stored but "
                         "unused, impl/FactorizationMachines.scala:12)")
    if cfg.num_fields > 0:
        raise ValueError("ALS supports plain FM (not FFM); use SGD for FFM")
    device = device_util.resolve(device)
    if params is None:
        params = fm_model.init_params(cfg, generator, device=device)
    else:
        params = FMParams(*(t.detach().to(device, copy=True)
                            for t in (params.w0, params.w, params.v)))
    _check_hbm(train, cfg, device)
    ws, num_blocks = build_workspace(train, cfg, als_cfg, device=device)
    reg_w, reg_v = (torch.as_tensor(r, device=device)
                    for r in cfg.reg_vectors())
    n_ranks = ws.present.shape[0]
    block_of_feat, _ = feature_blocks_of(cfg.num_features, als_cfg)
    cpure = bool(n_ranks) and blocks_are_column_pure(train, block_of_feat)
    uniform = cpure and csc_blocks_uniform(train, block_of_feat)
    ident = (csc_slice_identity(ws, num_blocks, train.num_examples)
             if uniform else ())
    if device.type == "cuda" and n_ranks:
        segsum.COLSUMS.build()
        segsum.STREAM_SUMS.build()
        segsum.ALS_PATCH.build()

    history = []
    n_examples = 0
    t0 = time.perf_counter()
    for epoch in range(als_cfg.epochs):
        if n_ranks:     # a dataset with no entries: nothing to update
            params = als_sweep_compact(
                params, ws, num_blocks, n_ranks, cfg.reg0, reg_w, reg_v,
                cfg.use_bias, cfg.use_linear, column_pure=cpure,
                csc_uniform=uniform, slice_identity=ident)
        n_examples += train.num_examples
        rec = {"epoch": epoch}
        if eval_ds is not None and (epoch % eval_every == 0
                                    or epoch == als_cfg.epochs - 1):
            rec.update({f"eval_{k}": v for k, v in evaluate(
                params, cfg, eval_ds).items()})
        history.append(rec)
        if als_cfg.max_seconds and (time.perf_counter() - t0
                                    >= als_cfg.max_seconds):
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    eps = n_examples / max(time.perf_counter() - t0, 1e-9)
    return TrainResult(params=params, history=history, examples_per_sec=eps)
