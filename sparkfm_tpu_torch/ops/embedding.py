"""Dedup plans: touch each unique row of a big table once per batch.

Port of the plan builders of ``sparkfm_tpu/ops/embedding.py``. A plan
sorts a batch's flat ids, compacts them to a budget of U unique ids and
maps every slot to its unique row, so scoring reads the big table U times
(``ops/rowio.py::gather_rows``) instead of once per slot, and spreads the
rows to slots from the small (U, K) matrix.

Plans are built on the host (:func:`host_dedup`, in the input pipeline) or,
when none is given, on the device (:func:`dedup_ids`). Both give the same
arrays element for element. The sorted SGD path's plan,
:func:`sorted_plan`, is built on the device. The unique-row helpers
(:func:`gather_unique`, :func:`spread`, the accumulates and
:func:`scatter_set_unique`) go through the kernels of ``ops/rowio.py`` and
``ops/segsum.py``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from sparkfm_tpu_torch.ops import rowio, segsum


class DedupBatch(NamedTuple):
    """Deduplicated lookup plan for one batch of flat ids.

    uids:   (U,) int32 — unique ids, ascending; unused budget slots hold
            ``fill`` (the table's last row, so the list stays sorted).
    ranks:  same shape as the ids — position of each slot's id in uids.
    count:  () int32 — number of distinct ids (may exceed U; see overflow).
    overflow: () bool — True if distinct ids exceeded the budget U; slots
            whose id ranked >= U alias the last budget slot.
    order:  optional (N,) int32 — the stable id-sort permutation of flat
            slots (flat_ids[order] is non-decreasing).
    seg:    optional (N,) int32 — dense rank of each sorted slot's id,
            clipped to [0, U): sorted, step <= 1.
    svals:  optional (N,) f32 — slot values in id-sorted order.
    sex:    optional (N,) int32 — each sorted slot's example index.

    Host plans hold numpy arrays; :func:`plan_to_device` moves the per-slot
    arrays to a device and keeps count/overflow on the host. Device plans
    from :func:`dedup_ids` hold tensors.
    """

    uids: Any
    ranks: Any
    count: Any
    overflow: Any
    order: Any = None
    seg: Any = None
    svals: Any = None
    sex: Any = None


class SortedPlan(NamedTuple):
    """Slot-sorted lookup plan of the sorted SGD path
    (``solvers/sgd_sorted.py``): slots reordered by id, so per-unique
    reductions are sums over contiguous runs, with the values and example
    indices carried through the sort.

    svals: (N,) f32 — slot values in sorted order.
    sex:   (N,) int32 — each sorted slot's example index.
    seg:   (N,) int32 — dense rank of each sorted slot's id, clipped to
           [0, budget).
    uids:  (U,) int32 — unique ids, ascending; unused slots hold ``fill``.
    count / overflow: as DedupBatch, 0-d tensors on the device.
    order: (N,) int32 — each sorted slot's flat natural position (the
           stable id-sort permutation; ``sex == order // L``), which puts
           per-slot terms back in natural order without atomics.
    """

    svals: torch.Tensor
    sex: torch.Tensor
    seg: torch.Tensor
    uids: torch.Tensor
    count: torch.Tensor
    overflow: torch.Tensor
    order: torch.Tensor


def _sorted_runs(flat: torch.Tensor, budget: int, fill: int):
    """One stable sort of flat int32 ids, then the runs of equal ids:
    (sorted position of each slot, clipped dense ranks, count, overflow,
    uids). No table access and no host round trip."""
    n = flat.shape[0]
    sid, spos = torch.sort(flat, stable=True)
    boundary = torch.ones((n,), dtype=torch.bool, device=flat.device)
    boundary[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(boundary, 0, dtype=torch.int32) - 1
    count = seg[-1] + 1
    # A stable sort of the "not a boundary" flags brings the first slot of
    # every run to the front, in ascending id order.
    firsts = torch.sort((~boundary).to(torch.int32), stable=True).indices
    take = min(budget, n)
    uids = torch.full((budget,), fill, dtype=torch.int32, device=flat.device)
    uids[:take] = sid[firsts[:take]]
    slot = torch.arange(budget, device=flat.device)
    uids = torch.where(slot < torch.clamp(count, max=budget), uids,
                       torch.full_like(uids, fill))
    return spos, seg.clamp(max=budget - 1), count, count > budget, uids


def dedup_ids(ids: torch.Tensor, budget: int, fill: int) -> DedupBatch:
    """Build a DedupBatch on ``ids``' device from (possibly multi-dim)
    int32 ids: one stable sort of the ids, one of the boundary flags, no
    table access and no host round trip."""
    spos, seg_c, count, overflow, uids = _sorted_runs(ids.reshape(-1),
                                                      budget, fill)
    ranks = torch.empty_like(seg_c)
    ranks[spos] = seg_c                          # unsort to natural order
    return DedupBatch(uids=uids, ranks=ranks.reshape(ids.shape), count=count,
                      overflow=overflow, order=spos.to(torch.int32),
                      seg=seg_c)


def sorted_plan(ids: torch.Tensor, vals: torch.Tensor, budget: int,
                fill: int) -> SortedPlan:
    """Sort the (B, L) batch's slots by id on the device, carrying each
    slot's value and position; derive the dense ranks and the unique ids.
    The sort is stable, so equal ids keep their slots' natural order."""
    spos, seg_c, count, overflow, uids = _sorted_runs(ids.reshape(-1),
                                                      budget, fill)
    return SortedPlan(svals=vals.reshape(-1)[spos],
                      sex=(spos // ids.shape[1]).to(torch.int32), seg=seg_c,
                      uids=uids, count=count, overflow=overflow,
                      order=spos.to(torch.int32))


def gather_unique(table: torch.Tensor, plan) -> torch.Tensor:
    """(U, W) rows of the plan's unique ids from the (R, W) float32 table:
    the only read of the big table, through the row-gather kernel B1."""
    return rowio.gather_rows(table, plan.uids)


def spread(rows_u: torch.Tensor, plan: DedupBatch) -> torch.Tensor:
    """Per-slot rows in natural order from the small unique matrix:
    (U, ...) -> ranks.shape + (...)."""
    flat = plan.ranks.reshape(-1).long()
    return rows_u.index_select(0, flat).view(*plan.ranks.shape,
                                             *rows_u.shape[1:])


def accumulate_to_unique(g_slots: torch.Tensor, plan: DedupBatch,
                         budget: int) -> torch.Tensor:
    """Per-slot gradients summed per unique row (the transpose of
    :func:`spread`) by ``index_add_`` over the ranks. On the card its
    atomic adds land in an order that changes from run to run, so the sums
    do not repeat bit for bit (:func:`accumulate_to_unique_sorted`'s do)."""
    flat = plan.ranks.reshape(-1)
    g2 = g_slots.reshape(flat.shape[0], *g_slots.shape[plan.ranks.dim():])
    out = torch.zeros((budget, *g2.shape[1:]), dtype=g2.dtype,
                      device=g2.device)
    return out.index_add_(0, flat.long(), g2)


def accumulate_to_unique_sorted(g_slots: torch.Tensor, plan: DedupBatch,
                                budget: int) -> torch.Tensor:
    """:func:`accumulate_to_unique` by another route: the per-slot
    gradients permuted into id-sorted order (``plan.order``), then summed
    over contiguous runs (``plan.seg``) by kernel B5
    (``ops/segsum.py::segment_rowsum``). The same sums up to float
    summation order. Per-slot scalars ride as a width-1 column."""
    if plan.order is None or plan.seg is None:
        raise ValueError("the sorted accumulate needs plan.order/plan.seg")
    n = plan.order.shape[0]
    flat = g_slots.reshape(n, *g_slots.shape[plan.ranks.dim():])
    scalar = flat.dim() == 1
    if scalar:
        flat = flat[:, None]
    elif flat.dim() > 2:
        raise ValueError("sorted accumulate supports (N,) or (N, W) "
                         f"payloads, got trailing shape {flat.shape[1:]}")
    srt = flat.index_select(0, plan.order.long())
    out = segsum.segment_rowsum(srt, plan.seg, budget)
    return out[:, 0] if scalar else out


def accumulate_sq_to_unique_sorted(g_slots: torch.Tensor, plan: DedupBatch,
                                   budget: int) -> torch.Tensor:
    """(U, 2W) per-unique ``[Σg | Σg²]`` of the per-slot rows ``g_slots``
    (ranks.shape + (W,), or (N, W)): the rows permuted into id-sorted
    order (``plan.order``), then summed over contiguous runs
    (``plan.seg``) by kernel B6 (``ops/segsum.py::segment_rowsum_sq``),
    which forms the squares itself. The sums of the JAX package's four
    scatter-adds of g and g² (``sparkfm_tpu/solvers/sgd.py:370-373``) up
    to float summation order, in a fixed order, so they repeat bit for
    bit on the card."""
    if plan.order is None or plan.seg is None:
        raise ValueError("the sorted accumulate needs plan.order/plan.seg")
    n = plan.order.shape[0]
    srt = g_slots.reshape(n, -1).index_select(0, plan.order.long())
    return segsum.segment_rowsum_sq(srt, plan.seg, budget)


def scatter_set_unique(table: torch.Tensor, plan,
                       rows_u: torch.Tensor) -> torch.Tensor:
    """Write the updated unique rows back in place through the row-write
    kernel B2. Unused budget slots point at the fill row, which gets the
    row of the first of them (B2 writes the first slot of a run of equal
    ids, ``ops/rowio.py``)."""
    return rowio.scatter_set_rows(table, plan.uids, rows_u)


def host_dedup(ids, budget: int, fill: int, vals=None) -> DedupBatch:
    """Numpy plan for the host input pipeline; same arrays as
    :func:`dedup_ids`.

    With ``vals`` (same shape as ids) the plan also carries ``svals`` and
    ``sex``. Runs the native radix-sort builder (``data/native_io.py``)
    when it is available and the numpy code below otherwise; both give
    the same arrays (``SPARKFM_NO_NATIVE=1`` forces numpy).
    """
    from sparkfm_tpu_torch.data import native_io
    nat = native_io.dedup_plan_native(
        np.asarray(ids), budget, fill,
        None if vals is None else np.asarray(vals))
    if nat is not None:
        uids, ranks, count, overflow, order, seg, svals, sex = nat
        return DedupBatch(uids=uids, ranks=ranks, count=count,
                          overflow=overflow, order=order, seg=seg,
                          svals=svals, sex=sex)
    shape = np.shape(ids)
    flat = np.asarray(ids, np.int32).reshape(-1)
    n = flat.shape[0]
    order = np.argsort(flat, kind="stable")
    sid = flat[order]
    boundary = np.empty(n, bool)
    boundary[0] = True
    boundary[1:] = sid[1:] != sid[:-1]
    seg = np.cumsum(boundary, dtype=np.int64) - 1
    count = int(seg[-1]) + 1
    seg_c = np.minimum(seg, budget - 1).astype(np.int32)
    ranks = np.empty(n, np.int32)
    ranks[order] = seg_c
    uids = np.full((budget,), fill, np.int32)
    m = min(count, budget)
    uids[:m] = sid[boundary][:m]
    svals = sex = None
    if vals is not None:
        svals = np.asarray(vals, np.float32).reshape(-1)[order]
        sex = (order // shape[-1]).astype(np.int32)
    return DedupBatch(uids=uids, ranks=ranks.reshape(shape),
                      count=np.int32(count), overflow=np.bool_(count > budget),
                      order=order.astype(np.int32), seg=seg_c,
                      svals=svals, sex=sex)


def stack_plans(ids, num_shards: int, budget: int, fill: int) -> DedupBatch:
    """Per-data-shard host plans of a global (B, L) id block, stacked: the
    block split into ``num_shards`` equal row chunks, :func:`host_dedup`
    on each; uids (D, U), ranks (B, L) concatenated like the ids, count
    and overflow (D,). order/seg are dropped. The sharded "unique"
    exchange (``parallel/sharded_sgd.py``) reads them."""
    b = ids.shape[0]
    if b % num_shards:
        raise ValueError(f"{b} rows not divisible by {num_shards} shards")
    chunk = b // num_shards
    plans = [host_dedup(ids[d * chunk:(d + 1) * chunk], budget, fill)
             for d in range(num_shards)]
    return DedupBatch(
        uids=np.stack([p.uids for p in plans]),
        ranks=np.concatenate([p.ranks for p in plans], axis=0),
        count=np.asarray([p.count for p in plans], np.int32),
        overflow=np.asarray([p.overflow for p in plans], bool))


def stack_hybrid_extras(ranks, vals, num_shards: int,
                        u_cap: int = 0) -> tuple:
    """Per-data-shard sorted-backward extras of a GLOBAL plan's (B, L)
    ranks: each of ``num_shards`` row chunks sorts its slots by global
    rank, so the analytic backward (kernel B3) runs per shard on dense
    local ranks. Returns (seg, svals, sex, gmap, u_cap): seg (D, N_loc)
    the local dense ranks, sorted; svals (D, N_loc) the slot values in
    that order; sex (D, N_loc) each sorted slot's shard-local example;
    gmap (D, u_cap) local unique -> global rank, unused entries 0 (their
    rows are exact zeros, harmless adds). ``u_cap`` is a minimum: the
    stack is padded to at least the ladder rung above the largest
    per-shard unique count, so a caller can keep it from shrinking."""
    b, l = ranks.shape
    if b % num_shards:
        raise ValueError(f"{b} rows not divisible by {num_shards} shards")
    chunk = b // num_shards
    per = []
    max_u = 1
    for d in range(num_shards):
        gr = np.asarray(ranks[d * chunk:(d + 1) * chunk],
                        np.int64).reshape(-1)
        order = np.argsort(gr, kind="stable")
        sgr = gr[order]
        boundary = np.empty(len(sgr), bool)
        boundary[0] = True
        boundary[1:] = sgr[1:] != sgr[:-1]
        seg = (np.cumsum(boundary) - 1).astype(np.int32)
        u_d = int(seg[-1]) + 1
        max_u = max(max_u, u_d)
        sv = np.asarray(vals[d * chunk:(d + 1) * chunk],
                        np.float32).reshape(-1)[order]
        per.append((seg, sv, (order // l).astype(np.int32),
                    sgr[boundary].astype(np.int32), u_d))
    u_cap = max(ladder_budget(max_u), u_cap)
    gmaps = []
    for _, _, _, guniq, u_d in per:
        gm = np.zeros((u_cap,), np.int32)
        gm[:u_d] = guniq
        gmaps.append(gm)
    return (np.stack([p[0] for p in per]), np.stack([p[1] for p in per]),
            np.stack([p[2] for p in per]), np.stack(gmaps), u_cap)


def plan_to_device(plan: DedupBatch, device) -> DedupBatch:
    """A host plan with its per-slot arrays as tensors on ``device``;
    count and overflow stay host numbers, for the host to branch on."""
    def move(x):
        return None if x is None else torch.as_tensor(x, device=device)
    return plan._replace(uids=move(plan.uids), ranks=move(plan.ranks),
                         order=move(plan.order), seg=move(plan.seg),
                         svals=move(plan.svals), sex=move(plan.sex))


def auto_budget(n_slots: int, cap: int = 1 << 18) -> int:
    """Static unique budget: next power of two >= n_slots, capped. With
    budget >= n_slots overflow is impossible."""
    b = 1
    while b < n_slots:
        b *= 2
    return min(b, cap)


def ladder_budget(count: int, cap: int = 1 << 18) -> int:
    """Smallest ladder rung >= count; rungs are m * 2^k for m in 4..7
    (quarter-octave steps, <= 25% padding).

    The host knows each batch's exact unique count before the device
    runs, so a plan is padded to a tight rung instead of a worst-case
    power of two, while the bounded set of rungs keeps the number of
    distinct shapes small.
    """
    if count <= 0:
        return 1
    if count <= 4:
        return min(count, cap)
    b = 1
    while (b << 3) < count:
        b <<= 1
    for m in (4, 5, 6, 7, 8):
        if m * b >= count:
            return min(m * b, cap)
    raise AssertionError("unreachable")
