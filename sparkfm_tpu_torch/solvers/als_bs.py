"""Block-structure (BS) relational ALS: coordinate descent on a
``data/relational.py::RelationalDataset`` without materializing the
joined design matrix. Port of ``sparkfm_tpu/solvers/als_bs.py``.

When many examples share one relation row, the per-feature sums of an
ALS update aggregate per key first (over examples) and then over the
relation's own nonzeros (Rendle, *Scaling Factorization Machines to
Relational Data*). With x_kj relation row k's value of local feature j and
every example i with key k sharing it:

  linear  num_j = sum_k x_kj E_k,                E_k = sum_{i in k} e_i
          den_j = sum_k x_kj^2 n_k               (constant)
  factor  num_j = sum_k x_kj (EQ_k - x_kj v_j E_k),   EQ_k = sum e_i q_i
          den_j = sum_k x_kj^2 (Q2_k - 2 x_kj v_j Q1_k + n_k x_kj^2 v_j^2)
  patches dq_i = dmain_i + sum_r dqk_r[key_i],  dqk_k = sum_j dv_j x_kj
          de_i = (q_new^2 - q^2) / 2 - (dsq_main_i + sum_r dsqk_r[key_i]) / 2

Blocks partition the global feature space (Jacobi within, Gauss-Seidel
across, as ``solvers/als.py``); without ``feature_blocks``, one block per
main slot and per relation column (:func:`_prep`), within which no two
features share an example. The sweep is the ALS sweep on the materialized
matrix, the same updates with f32 sums in another order; nothing of size
N x (Lm + sum Lr) is built, on the host or the card.

On the card every per-feature and per-key sum is kernel B7
(``ops/segsum.py::segment_colsums``) over ranks sorted once in
:func:`_prep`: the main block's entries sorted by feature (S = 2 a factor
block: Σ e h, Σ h^2 with h = x (q - x v); S = 1 a w block), each
relation's examples sorted by key (E_k, EQ_k, Q1_k, Q2_k: S = 4; E_k alone
in a w block) and each relation's nonzeros sorted by feature (num and den:
S = 2; S = 1 in a w block). Per-key sums over a relation's own rows (its
partial q, sq, w·x and the patches) are row sums of its padded table.
Each block's sums cover only the entries of its features (the sorted span
that holds them; none for a side without them), which leaves every kept
update as it is. The feature space is not compacted: sums land on all F
features (B7 writes zeros where a feature has no entry). No sum uses
atomic adds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from sparkfm_tpu_torch.config import ALSConfig, FMConfig, Task
from sparkfm_tpu_torch.models import fm as fm_model
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import segsum
from sparkfm_tpu_torch.solvers.als import _guarded_theta, _take
from sparkfm_tpu_torch.training.trainer import TrainResult, evaluate
from sparkfm_tpu_torch.utils import device as device_util

Span = Optional[Tuple[int, int]]    # [lo, hi) in a sorted view, or none


@dataclasses.dataclass
class RelArrays:
    """One relation on the device. ``gids``/``vals``/``vals_sq`` (K+1, Lr)
    its table with global ids; ``keys`` (N,) each example's row;
    ``key_order`` (N,) the examples sorted by key (None when they already
    are) and ``key_seg`` (N,) the sorted keys; ``col_feat`` (sorted),
    ``col_key``, ``col_val`` its nonzeros sorted by feature; ``n_k``
    (K+1,) the examples per key."""

    gids: torch.Tensor
    vals: torch.Tensor
    vals_sq: torch.Tensor
    keys: torch.Tensor
    key_order: Optional[torch.Tensor]
    key_seg: torch.Tensor
    col_feat: torch.Tensor
    col_key: torch.Tensor
    col_val: torch.Tensor
    n_k: torch.Tensor


@dataclasses.dataclass
class BSArrays:
    """The sweep's device arrays. Examples are sorted by their first main
    slot's feature (stably, as ``solvers/als.py::sort_examples``).
    ``main_ids``/``main_vals``/``main_vals_sq`` (Lm, N) the main block
    slot by slot; ``y`` (N,); ``col_feat`` (sorted), ``col_row``,
    ``col_val`` the main entries sorted by feature; ``block_of_feat`` (F,);
    ``den_w`` (F,) Σx² of each feature over the joined rows; ``rels`` one
    :class:`RelArrays` per relation."""

    main_ids: torch.Tensor
    main_vals: torch.Tensor
    main_vals_sq: torch.Tensor
    y: torch.Tensor
    col_feat: torch.Tensor
    col_row: torch.Tensor
    col_val: torch.Tensor
    block_of_feat: torch.Tensor
    den_w: torch.Tensor
    rels: List[RelArrays]


@dataclasses.dataclass(frozen=True)
class BSStatics:
    """Host facts per block b: ``main_span[b]`` the span of the sorted main
    entries holding its features (None: no nonzero main entry has one),
    ``main_identity[b]`` whether that span's examples are the example
    order itself (no gather), ``main_slots[b]`` the main slots where its
    features appear; ``rel_span[r][b]`` and ``rel_cols[r][b]`` the same
    for relation r's nonzeros and table columns."""

    num_blocks: int
    main_span: Tuple[Span, ...]
    main_identity: Tuple[bool, ...]
    main_slots: Tuple[Tuple[int, ...], ...]
    rel_span: Tuple[Tuple[Span, ...], ...]
    rel_cols: Tuple[Tuple[Tuple[int, ...], ...], ...]


def _occurring(ids: np.ndarray, vals: np.ndarray, num_features: int):
    """Sorted distinct ids whose value is nonzero."""
    return np.flatnonzero(np.bincount(ids[vals != 0],
                                      minlength=num_features))


def slot_blocks_bs(rds, num_features: int) -> np.ndarray:
    """(F,) int32 slot-aligned blocks from the BS structure: one block per
    main slot, then per column of each relation table, in that order; a
    feature in several slots takes the last one's block, a feature in
    none block 0 (as the JAX package's ``_prep``)."""
    bof = np.zeros((num_features,), np.int32)
    nb = 0
    for l in range(rds.main_ids.shape[1]):
        bof[_occurring(rds.main_ids[:, l], rds.main_vals[:, l],
                       num_features)] = nb
        nb += 1
    for t in rds.tables:
        tid, tval = np.asarray(t.ids), np.asarray(t.vals)
        for l in range(tid.shape[1]):
            bof[_occurring(tid[:, l] + t.offset, tval[:, l],
                           num_features)] = nb
            nb += 1
    return bof


def _spans(sorted_feat: np.ndarray, vals: np.ndarray, bof: np.ndarray,
           nb: int) -> Tuple[Span, ...]:
    """Per block, the [lo, hi) span of the feature-sorted entries that
    holds all its features' nonzero entries; None where it has none."""
    f = bof.shape[0]
    feats = np.arange(f)
    starts = np.searchsorted(sorted_feat, feats, "left")
    ends = np.searchsorted(sorted_feat, feats, "right")
    live = np.zeros((f,), bool)
    live[sorted_feat[vals != 0]] = True
    lo = np.full((nb,), np.iinfo(np.int64).max, np.int64)
    hi = np.zeros((nb,), np.int64)
    np.minimum.at(lo, bof[live], starts[live])
    np.maximum.at(hi, bof[live], ends[live])
    return tuple((int(lo[b]), int(hi[b])) if hi[b] > 0 else None
                 for b in range(nb))


def _slots_of_blocks(ids: np.ndarray, vals: np.ndarray, bof: np.ndarray,
                     nb: int) -> Tuple[Tuple[int, ...], ...]:
    """Per block, the columns of the (rows, L) ``ids`` where one of its
    features has a nonzero value."""
    out = [[] for _ in range(nb)]
    for l in range(ids.shape[1]):
        live = np.bincount(bof[ids[:, l][vals[:, l] != 0]], minlength=nb)
        for b in np.flatnonzero(live):
            out[int(b)].append(l)
    return tuple(tuple(s) for s in out)


def _feature_sorted(feat: np.ndarray, *rest: np.ndarray) -> tuple:
    order = np.argsort(feat, kind="stable")
    return (feat[order],) + tuple(a[order] for a in rest)


def _prep(rds, cfg: FMConfig, als_cfg: ALSConfig, *,
          device) -> Tuple[BSArrays, BSStatics]:
    """Host numpy prep of ``rds`` (a RelationalDataset), then one copy of
    each array to ``device``. Blocks: ``als_cfg.feature_blocks``, else
    slot-aligned from the BS structure (:func:`slot_blocks_bs`)."""
    f = cfg.num_features
    if als_cfg.feature_blocks is not None:
        bof = np.asarray(als_cfg.feature_blocks, np.int32)
        if bof.shape != (f,):
            raise ValueError(f"feature_blocks has shape {bof.shape}, want "
                             f"({f},)")
    else:
        bof = slot_blocks_bs(rds, f)
    nb = int(bof.max()) + 1
    order = np.argsort(rds.main_ids[:, 0], kind="stable")
    main_ids = np.asarray(rds.main_ids, np.int32)[order]
    main_vals = np.asarray(rds.main_vals, np.float32)[order]
    keys = np.asarray(rds.keys, np.int32)[order]
    n, lm = main_ids.shape

    col_feat, col_row, col_val = _feature_sorted(
        main_ids.reshape(-1), np.repeat(np.arange(n, dtype=np.int32), lm),
        main_vals.reshape(-1))
    main_span = _spans(col_feat, col_val, bof, nb)
    ident = np.arange(n, dtype=np.int32)
    main_identity = tuple(
        s is not None and s[1] - s[0] == n
        and bool(np.array_equal(col_row[s[0]:s[1]], ident))
        for s in main_span)
    main_slots = _slots_of_blocks(main_ids, main_vals, bof, nb)
    den_w = np.bincount(col_feat, weights=np.square(col_val, dtype=np.float64),
                        minlength=f)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    rels, rel_span, rel_cols = [], [], []
    for r, t in enumerate(rds.tables):
        tid = np.asarray(t.ids, np.int32) + np.int32(t.offset)
        tval = np.asarray(t.vals, np.float32)
        krows, lr = tid.shape
        k_r = keys[:, r]
        n_k = np.bincount(k_r, minlength=krows).astype(np.float32)
        rfeat, rkey, rval = _feature_sorted(
            tid.reshape(-1), np.repeat(np.arange(krows, dtype=np.int32), lr),
            tval.reshape(-1))
        den_w += np.bincount(rfeat, weights=(np.square(rval, dtype=np.float64)
                                             * n_k[rkey]), minlength=f)
        key_order = None
        key_seg = k_r
        if not bool(np.all(k_r[1:] >= k_r[:-1])):
            key_order = np.argsort(k_r, kind="stable").astype(np.int32)
            key_seg = k_r[key_order]
        rel_span.append(_spans(rfeat, rval, bof, nb))
        rel_cols.append(_slots_of_blocks(tid, tval, bof, nb))
        rels.append(RelArrays(
            gids=dev(tid), vals=dev(tval), vals_sq=dev(np.square(tval)),
            keys=dev(k_r),
            key_order=None if key_order is None else dev(key_order),
            key_seg=dev(key_seg), col_feat=dev(rfeat), col_key=dev(rkey),
            col_val=dev(rval), n_k=dev(n_k)))
    arrs = BSArrays(
        main_ids=dev(main_ids.T), main_vals=dev(main_vals.T),
        main_vals_sq=dev(np.square(main_vals).T),
        y=dev(np.asarray(rds.y, np.float32)[order]), col_feat=dev(col_feat),
        col_row=dev(col_row), col_val=dev(col_val),
        block_of_feat=dev(bof), den_w=dev(den_w.astype(np.float32)),
        rels=rels)
    statics = BSStatics(num_blocks=nb, main_span=main_span,
                        main_identity=main_identity, main_slots=main_slots,
                        rel_span=tuple(rel_span), rel_cols=tuple(rel_cols))
    return arrs, statics


def make_bs_sweep(cfg: FMConfig, statics: BSStatics):
    """The one-sweep function ``sweep(params, arrs, reg_w, reg_v) ->
    FMParams`` over :func:`_prep`'s arrays (``reg_w``/``reg_v``: scalars
    or (F,) tensors). It returns new parameters; ``params`` is not
    changed."""
    F = cfg.num_features
    nb = statics.num_blocks

    def add(acc, x):
        """acc + x, where acc None is nothing yet."""
        return x if acc is None else acc + x

    def main_patch(arrs, d, vals, b):
        """Per-example sum over block b's main slots of d[id] * x."""
        out = None
        for l in statics.main_slots[b]:
            out = add(out, _take(d, arrs.main_ids[l]) * vals[l])
        return out

    def rel_rows(rl, d, vals, cols):
        """Per key: the sum over the table columns ``cols`` of d[id] * x;
        None when ``cols`` is empty."""
        out = None
        for j in cols:
            out = add(out, _take(d, rl.gids[:, j].contiguous()) * vals[:, j])
        return out

    def patch(arrs, d, main_vals, rel_vals, b):
        """Per-example change from a per-feature change ``d`` nonzero only
        in block b: its main slots, then each relation's rows by key;
        None when no entry of the block is nonzero."""
        out = main_patch(arrs, d, main_vals, b)
        for r, rl in enumerate(arrs.rels):
            rows = rel_rows(rl, d, getattr(rl, rel_vals),
                            statics.rel_cols[r][b])
            if rows is not None:
                out = add(out, rows.index_select(0, rl.keys))
        return out

    def by_key(rl, ex):
        """An example vector in the relation's key order."""
        return ex if rl.key_order is None else ex.index_select(0,
                                                               rl.key_order)

    def main_run(arrs, ex, b):
        """(example vector at the span's entries, x, feature seg) of block
        b's main span."""
        lo, hi = statics.main_span[b]
        ex_c = ex if statics.main_identity[b] else ex.index_select(
            0, arrs.col_row[lo:hi])
        return ex_c, arrs.col_val[lo:hi], arrs.col_feat[lo:hi]

    def sweep(params: FMParams, arrs: BSArrays, reg_w, reg_v) -> FMParams:
        y = arrs.y
        n = y.shape[0]
        k = params.v.shape[1]
        dev = y.device
        v_t = params.v.t().contiguous()                         # (K, F)
        w = params.w.clone()
        rels = arrs.rels

        # forward: each factor's q (banked) and sq from the main block
        # and the relations' per-key partials
        score = torch.zeros_like(y)
        q_bank = torch.empty((k, n), dtype=torch.float32, device=dev)
        for f in range(k):
            vr = _take(v_t[f], arrs.main_ids) * arrs.main_vals   # (Lm, N)
            q, sq = vr.sum(0), vr.square().sum(0)
            for rl in rels:
                vx = _take(v_t[f], rl.gids) * rl.vals            # (K+1, Lr)
                q = q + vx.sum(1).index_select(0, rl.keys)
                sq = sq + vx.square().sum(1).index_select(0, rl.keys)
            q_bank[f] = q
            score += 0.5 * (q.square() - sq)
        if cfg.use_linear:
            score = score + (_take(w, arrs.main_ids) * arrs.main_vals).sum(0)
            for rl in rels:
                wrow = (_take(w, rl.gids) * rl.vals).sum(1)
                score = score + wrow.index_select(0, rl.keys)
        if cfg.use_bias:
            score = score + params.w0
        e = score - y

        w0_new = params.w0.clone()
        if cfg.use_bias:
            w0_new = _guarded_theta(params.w0, e.sum(),
                                    torch.tensor(float(n), device=dev),
                                    cfg.reg0)
            e = e + (w0_new - params.w0)

        if cfg.use_linear:
            for b in range(nb):
                num = None
                if statics.main_span[b] is not None:
                    e_c, x, seg = main_run(arrs, e, b)
                    num = segsum.segment_colsums([e_c * x], seg, F)[:, 0]
                for r, rl in enumerate(rels):
                    span = statics.rel_span[r][b]
                    if span is None:
                        continue
                    e_k = segsum.segment_colsums(
                        [by_key(rl, e)], rl.key_seg, rl.n_k.shape[0])[:, 0]
                    lo, hi = span
                    num = add(num, segsum.segment_colsums(
                        [rl.col_val[lo:hi] * e_k.index_select(
                            0, rl.col_key[lo:hi])],
                        rl.col_feat[lo:hi], F)[:, 0])
                if num is None:     # no nonzero entry: nothing moves
                    continue
                theta = _guarded_theta(w, num, arrs.den_w, reg_w)
                delta = torch.where(arrs.block_of_feat == b, theta - w, 0.0)
                w = w + delta
                e = e + patch(arrs, delta, arrs.main_vals, "vals", b)

        for f in range(k):
            vf, q = v_t[f], q_bank[f]
            for b in range(nb):
                num = den = None
                if statics.main_span[b] is not None:
                    e_c, x, seg = main_run(arrs, e, b)
                    q_c, _, _ = main_run(arrs, q, b)
                    h = x * (q_c - x * vf.index_select(0, seg))
                    sums = segsum.segment_colsums([e_c * h, h * h], seg, F)
                    num, den = sums[:, 0], sums[:, 1]
                for r, rl in enumerate(rels):
                    span = statics.rel_span[r][b]
                    if span is None:
                        continue
                    e_k, q_k = by_key(rl, e), by_key(rl, q)
                    per_key = segsum.segment_colsums(
                        [e_k, e_k * q_k, q_k, q_k * q_k], rl.key_seg,
                        rl.n_k.shape[0])                         # (K+1, 4)
                    lo, hi = span
                    key = rl.col_key[lo:hi]
                    x, seg = rl.col_val[lo:hi], rl.col_feat[lo:hi]
                    at = per_key.index_select(0, key)            # (nnz, 4)
                    xv = x * vf.index_select(0, seg)
                    sums = segsum.segment_colsums(
                        [x * (at[:, 1] - xv * at[:, 0]),
                         x * x * (at[:, 3] - 2.0 * xv * at[:, 2]
                                  + rl.n_k.index_select(0, key) * xv * xv)],
                        seg, F)
                    num, den = add(num, sums[:, 0]), add(den, sums[:, 1])
                if num is None:
                    continue
                theta = _guarded_theta(vf, num, den, reg_v)
                in_block = arrs.block_of_feat == b
                delta = torch.where(in_block, theta - vf, 0.0)
                vf_new = vf + delta
                dsq = torch.where(in_block, vf_new.square() - vf.square(),
                                  0.0)
                q_new = q + patch(arrs, delta, arrs.main_vals, "vals", b)
                e = (e + 0.5 * (q_new.square() - q.square())
                     - 0.5 * patch(arrs, dsq, arrs.main_vals_sq, "vals_sq",
                                   b))
                vf, q = vf_new, q_new
            v_t[f] = vf
        return FMParams(w0=w0_new, w=w, v=v_t.t().contiguous())

    return sweep


def train_als_relational(cfg: FMConfig, als_cfg: ALSConfig, train,
                         eval_ds=None, eval_every: int = 1,
                         generator: Optional[torch.Generator] = None,
                         params: Optional[FMParams] = None, *,
                         device=device_util.DEFAULT) -> TrainResult:
    """ALS on a RelationalDataset on ``device`` (default: the card;
    without one it raises): ``als_cfg.epochs`` BS sweeps; ``train`` is
    never materialized. ``params`` warm-starts (copied to ``device``);
    otherwise V is drawn from ``generator`` (default: seeded from
    ``cfg.seed``). Each history record holds the epoch and, every
    ``eval_every`` sweeps and after the last, ``eval_*`` metrics of
    ``eval_ds`` (a RelationalDataset, materialized once, or a
    SparseDataset). ``max_seconds`` is checked after each sweep. The host
    prep and the kernel build come before the clock starts."""
    if cfg.task != Task.REGRESSION:
        raise ValueError("ALS optimizes squared loss; use SGD for "
                         "classification")
    if cfg.num_fields > 0:
        raise ValueError("ALS supports plain FM (not FFM)")
    device = device_util.resolve(device)
    if params is None:
        params = fm_model.init_params(cfg, generator, device=device)
    else:
        params = FMParams(*(t.detach().to(device, copy=True)
                            for t in (params.w0, params.w, params.v)))
    arrs, statics = _prep(train, cfg, als_cfg, device=device)
    sweep = make_bs_sweep(cfg, statics)
    reg_w, reg_v = (torch.as_tensor(r, device=device)
                    for r in cfg.reg_vectors())
    if eval_ds is not None and hasattr(eval_ds, "materialize"):
        eval_ds = eval_ds.materialize()
    if device.type == "cuda":
        segsum.COLSUMS.build()

    history = []
    n_examples = 0
    t0 = time.perf_counter()
    for epoch in range(als_cfg.epochs):
        params = sweep(params, arrs, reg_w, reg_v)
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
