#!/usr/bin/env python3
"""Device times of the port's hand-written kernels at the smoke's main-path
shapes, for one or more checkouts of the repository, taken in turns on one
card.

    python3 kernel_times.py ROOT [ROOT ...] [--order 0,1,1,0]
        [--als | --sweeps | --paths | --ffm]

Each ROOT is a checkout (the repository root, or a ``git archive`` of
another commit unpacked somewhere). For each entry of ``--order`` (default:
each root once) a child process imports that root's ``sparkfm_tpu_torch``,
builds its kernels, checks them against their plain versions (exactly for
the gathers, in float64 at max |a - b| / (1 + |b|) < 1e-4 for the sums),
and prints one JSON line of device times in microseconds per call (the
fullest of 3 torch.profiler traces of 10 calls each, since a trace can
lose kernel records; split by kernel name), with the inputs made from a
seed, so every root sees the same data:

- B3, the factored backward, and B4, the same from per-slot rows, at N =
  638,976 slots, k = 32 (a bench-recipe plan: 16384 x 39 zipf(1.3) ids
  hashed into 2^24): in all, pass 1 and pass 2;
- B6, the row sums with squares, at W = 33 on the same plan, at W = 9 on
  a plan of BASELINE config 1's direct step (4096 user-item pairs, 2,625
  features), at W = 177 on a plan of config 4's fused FFM step (8192 x 22
  ``synth_ctr`` ids in 2^22) and at W = 17 on a ladder plan of config 5's
  DeepFM batch (8192 x 39 field-major zipf ids in 2^20): in all, pass 1
  and pass 2, and in all by CUDA events behind a spin kernel; where the
  root stages B6's rows in shared-memory tiles, also at tiles of 32, 44
  and 96 KB;
- B5, the row sums, at the shapes its paths give it: the fused
  adagrad_row pack (W = 35) on the main plan, the direct step's per-slot
  terms over plans of budget N (W = 33 on the main batch's ids, W = 17 on
  config 5's) and config 1's direct step (W = 9, U = 2,625); then at W =
  9, 17, 33, 35, 66, 177 and 354 on the main plan and at 354 on the FFM
  plan, on both layouts where the root has two (``segsum.rowsum_layout``),
  the crossover's evidence: each by CUDA events behind a spin kernel,
  split into pass 1 and pass 2 by torch.profiler, beside the plain
  version, ``index_add_`` and the bound (bytes at 3.35 TB/s), and held to
  float64 (< 2.5e-4 past W = 177, where the head run gives W draws of its
  error);
- B1, the gather: one serving chunk's V (W = 32) and w (W = 1) by two
  calls, and by the two-table form where the root has it, at U = 40,960;
  the fused record (W = 68) at U = 40,960 (each of these one call per
  plan over 8 bench-recipe plans, so the rows are not all in L2 from the
  call before) and at a device plan's 2^18 slots.
- the ALS sweep's per-rank sums (alone with ``--als``) at the
  ``ml25m-als-sweep`` cell's shapes
  (``portbench/configs/ml25m-als-r32.json``, ratings from seed 0 by
  ``portbench/gen/ratings.py``: N = 25,000,095 slots a block, U =
  221,588): B7 at S = 5 and S = 1 on the user block (ranks in example
  order) and the movie block (its slice of the CSC ranks at offset N),
  and, where the root has ``segsum.als_stream_sums``, the stream sums on
  each block (the user block without rows, the movie block with them),
  held equal to B7 over the streams torch forms, bit for bit; each by CUDA
  events behind a spin kernel, split into pass 1 and pass 2 by
  torch.profiler, beside the sequence the stream sums replace (the
  gathers, the five torch products and B7) and the byte bound; and, where
  the root has ``segsum.als_patch``, the patch of q and e on each block's
  row of the rank-space view (the movie block's 12 bytes past a 16-byte
  bound), in place on a (U, 2) table as the sweep runs it, held equal to
  its plain version (the torch lines it replaces) bit for bit and timed
  beside it, with its bound (``segsum.als_patch_bytes``: 24 bytes an
  example and the table, 602 MB, 180 us) and its share of it. Where the
  root's kernels take e and q as one (N, 2) array of pairs (its
  ``als_stream_sums`` has an ``eq`` argument), both kernels run on such
  an array, and the patch is also timed with the next factor's q loaded
  into the q column (28 bytes an example), beside the patch followed by
  a strided copy of that q into the column.

With ``--ffm`` each child instead times the slot-major FFM's loss and
row gradients at the ``ffm-train-criteo`` cell's shape (B = 65,536, F =
39, K = 4: 2,555,904 slots) and at BASELINE config 4's (B = 8,192, F =
22, K = 8), on per-slot rows made from a seed: the fused step's former
route (``_batch_loss_from_rows``, ``torch.autograd.grad`` and the update's
``cat`` of ``[g_v | g_w]``) and, where the root has
``ops/interaction.py::ffm_slot_major_loss_grad``, its kernel, held to the
former route's float64 twin on the first 8,192 examples (max error over
the largest entry < 1e-5)
and timed beside its bound (``portbench/counts/ffm_sgd.py::
interaction_bytes`` at 3.35 TB/s) and its share of it; each by CUDA
events behind a spin kernel, and by torch.profiler split into the
kernel's own time.

With ``--sweeps`` each child instead runs whole ALS sweeps on the
``ml25m-als-sweep`` cell's ratings and weights (seed 0) as ``train_als``
runs them with its default ``ALSConfig``: contiguous blocks of 4,096
features (55 blocks, not column-pure, so every block gathers in the stream
sums and patches by the torch lines). One warm sweep, then three timed on
the host's clock behind a sync and one under torch.profiler for the
sweep's spans (CUDA-event ms); it prints the sha256 of the parameters
after each sweep, which must agree between roots whose sums and patch
keep their order.

With ``--paths`` each child instead trains one epoch (after a warm-up
epoch) of BASELINE config 3 (2^24 buckets, rank 32, ``synth_ctr`` 16384 x
20) on the fused path with device and with host plans and on the sorted
path, and of config 4's FFM (22 fields, rank 8, 2^22 buckets, 8192 x 20)
on the fused path, and prints each epoch's trained ex/s and wall time
untraced, then its device busy time, the time in ``torch.cat``'s kernels
and the top device events from a torch.profiler trace.

The parent lines show how far the card drifts between turns; compare two
roots only within one run. Needs one CUDA card; prints the card's
``nvidia-smi`` name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
COMMON = r"""
import dataclasses, json, sys
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ROOT)
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.ops import rowio, segsum

dev = torch.device("cuda", 0)
rng = np.random.default_rng(0)
gen = torch.Generator(device=dev).manual_seed(0)
BUCKETS, RANK, SLOTS, BATCH = 1 << 24, 32, 39, 16384


def zipf_ids():
    raw = rng.zipf(1.3, size=(BATCH, SLOTS)).astype(np.int64)
    return ((raw * 2654435761) % BUCKETS).astype(np.int32)


def device_us(fn, reps=10, tries=3):
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                by[e.key] = (by.get(e.key, 0.0)
                             + e.self_device_time_total / reps)
        total = sum(by.values())
        # a trace can lose kernel records but never adds any: keep the
        # fullest
        if total and (best is None or total > best[0]):
            best = (total, by)
    return best


def spun_us(fn, reps=10, windows=3, spin=20_000_000):
    # device us of one call: CUDA events around reps calls queued behind a
    # spin kernel (~10 ms), so the host's launch cost stays off the clock;
    # best of windows
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return 1e3 * best


def config5_ids():
    # BASELINE config 5's batch: 8192 x 39 zipf(1.3) ids, each field's slot
    # hashed into its own range of 2^20 buckets
    raw = rng.zipf(1.3, size=(8192, 39)).astype(np.int64)
    per = (1 << 20) // 39
    return (((raw * 2654435761) % (1 << 20)) % per
            + per * np.arange(39)[None, :]).astype(np.int32)


def split(res, *names):
    if res is None:                 # no trace saw device time
        return None
    total, by = res
    return [total] + [sum(v for k, v in by.items() if n in k) for n in names]


def rel(got, want):
    return float(((got.double() - want).abs() / (1 + want.abs())).max())


out = {}
"""

KERNELS = r"""
cap = E.auto_budget(BATCH * SLOTS)
plan = E.host_dedup(zipf_ids(), cap, fill=BUCKETS)
seg = torch.as_tensor(plan.seg, device=dev)
n, u = seg.shape[0], E.ladder_budget(int(plan.count), cap=cap)
vw_u = 0.01 * torch.randn((u, RANK + 1), generator=gen, device=dev)
ex = torch.randn((n, RANK + 2), generator=gen, device=dev)
ex[:, RANK + 1] = (torch.rand(n, generator=gen, device=dev) < 0.9)
x = torch.randn(n, generator=gen, device=dev)
cv = torch.tensor(2e-6 / BATCH, device=dev)
want = segsum.fm_grad_segsum_factored_reference(
    vw_u.double(), ex.double(), x.double(), seg, u, cv.double(), cv.double())
got = segsum.fm_grad_segsum_factored(vw_u, ex, x, seg, u, cv, cv)
err = rel(got, want)
assert err < 1e-4, ("B3", err)
assert torch.equal(got, segsum.fm_grad_segsum_factored(
    vw_u, ex, x, seg, u, cv, cv)), "B3 repeat"
out["B3"] = split(device_us(lambda: segsum.fm_grad_segsum_factored(
    vw_u, ex, x, seg, u, cv, cv)), "fm_grad", "crossing")
vw_srt = vw_u.index_select(0, seg.long())
got = segsum.fm_grad_segsum(vw_srt, ex, x, seg, u, cv, cv)
assert rel(got, want) < 1e-4, "B4"
out["B4"] = split(device_us(lambda: segsum.fm_grad_segsum(
    vw_srt, ex, x, seg, u, cv, cv)), "fm_grad", "crossing")
del vw_srt, want


def rowsums(label, w, seg, u, sweep=False):
    # B6 at width w on seg: checked against float64, then timed; where the
    # root stages B6's rows in shared memory (segsum.TILE_BYTES), also at
    # other tile sizes
    fn, plain = segsum.segment_rowsum_sq, segsum.segment_rowsum_sq_reference
    g = torch.randn((seg.shape[0], w), generator=gen, device=dev)
    err = rel(fn(g, seg, u), plain(g.double(), seg, u))
    assert err < 1e-4, (label, err)
    out[label] = {"profiled": split(device_us(lambda: fn(g, seg, u)),
                                    "rowsum", "crossing"),
                  "err": err, "spun_us": spun_us(lambda: fn(g, seg, u))}
    if sweep and hasattr(segsum, "TILE_BYTES"):
        keep = segsum.TILE_BYTES
        for tile in (32 << 10, 44 << 10, 96 << 10):
            segsum.TILE_BYTES = tile
            assert rel(fn(g, seg, u), plain(g.double(), seg, u)) < 1e-4
            out[f"{label} tile {tile >> 10} KB"] = split(device_us(
                lambda: fn(g, seg, u)), "rowsum", "crossing")
        segsum.TILE_BYTES = keep


def forced(kind):
    # segsum.rowsum_layout pinned to one of B5's two layouts
    if kind == "tiles":
        return lambda n, w, num_sms: ("tiles",
                                      *segsum.tile_layout(n, w, num_sms))
    return lambda n, w, num_sms: ("chunks",
                                  2 * -(-n // segsum.ROWSUM_CHUNK))


def b5_entry(label, w, seg, u, both=False):
    # B5 at width w on seg: held to float64 (max rel < 1e-4, < 2.5e-4 at W
    # > 177, where the ~162k-slot head run gives W draws of its error) and
    # bit for bit, then timed by CUDA events behind a spin kernel (spun),
    # split into pass 1 and pass 2 by torch.profiler, beside the plain
    # version, index_add_ and the bound; with both, also on each layout
    n = seg.shape[0]
    g = torch.randn((n, w), generator=gen, device=dev)
    want = segsum.segment_rowsum_reference(g.double(), seg, u)
    lib_out = torch.zeros((u, w), device=dev)
    seg_l = seg.long()
    bound_us = 1e6 * 4 * (n * w + n + u * w) / 3.35e12
    has_layouts = hasattr(segsum, "rowsum_layout")
    layout = (segsum.rowsum_layout(n, w, segsum.ROWSUM.num_sms(dev))[0]
              if has_layouts else "chunks")
    rec = {"n": n, "w": w, "u": u, "layout": layout, "bound_us": bound_us}

    def timed(key):
        got = segsum.segment_rowsum(g, seg, u)
        err = rel(got, want)
        assert err < (2.5e-4 if w > 177 else 1e-4), (label, key, err)
        assert torch.equal(got, segsum.segment_rowsum(g, seg, u)), label
        spun = spun_us(lambda: segsum.segment_rowsum(g, seg, u))
        rec[key] = {"spun_us": spun, "share": bound_us / spun, "err": err,
                    "profiled": split(device_us(
                        lambda: segsum.segment_rowsum(g, seg, u)), "rowsum",
                        "crossing")}
    timed(layout)
    if both and has_layouts:
        keep = segsum.rowsum_layout
        for kind in ("tiles", "chunks"):
            if kind != layout:
                segsum.rowsum_layout = forced(kind)
                timed(kind)
        segsum.rowsum_layout = keep
    rec["plain_us"] = spun_us(
        lambda: segsum.segment_rowsum_reference(g, seg, u))
    rec["index_add_us"] = spun_us(lambda: lib_out.index_add_(0, seg_l, g))
    out[label] = rec


rowsums("B6", 33, seg, u, sweep=True)
# BASELINE config 1's direct step: 4096 (user, item) pairs of 2,625
# features, a device plan with budget 2,625
ids1 = np.stack([rng.integers(0, 943, 4096),
                 943 + rng.integers(0, 1682, 4096)], 1).astype(np.int32)
plan1 = E.dedup_ids(torch.as_tensor(ids1, device=dev), 2625, fill=2624)
rowsums("B6 W=9", 9, plan1.seg, 2625)
# BASELINE config 4's fused FFM step: 8192 x 22 field-hashed ids into
# 2^22, a ladder plan
from sparkfm_tpu_torch.data import synth
ids4 = synth.synth_ctr(num_examples=8192, num_fields=22,
                       num_buckets=1 << 22, seed=0).ids
plan4 = E.host_dedup(ids4, E.auto_budget(ids4.size), fill=1 << 22)
seg4 = torch.as_tensor(plan4.seg, device=dev)
u4 = E.ladder_budget(int(plan4.count), cap=E.auto_budget(ids4.size))
out["FFM plan"] = [seg4.shape[0], u4]
rowsums("B6 W=177", 177, seg4, u4, sweep=True)
# BASELINE config 5's DeepFM step: 8192 x 39 field-major zipf ids in 2^20
ids5 = config5_ids()
plan5 = E.host_dedup(ids5, E.auto_budget(ids5.size), fill=1 << 20)
seg5 = torch.as_tensor(plan5.seg, device=dev)
u5 = E.ladder_budget(int(plan5.count), cap=E.auto_budget(ids5.size))
rowsums("B6 W=17", 17, seg5, u5)

# B5 at the shapes its paths give it: the fused step's adagrad_row pack
# (W = k + 3) on the ladder plan; the direct step's per-slot momentum and
# adam terms (W = vk + 1) over a dedup_ids plan of budget N (config 3's
# width; config 5's DeepFM under momentum), and config 1's budget of F
N3 = BATCH * SLOTS
dplan3 = E.dedup_ids(torch.as_tensor(zipf_ids(), device=dev), N3,
                     fill=BUCKETS - 1)
dplan5 = E.dedup_ids(torch.as_tensor(config5_ids(), device=dev), ids5.size,
                     fill=(1 << 20) - 1)
b5_paths = (("fused adagrad_row W=35", RANK + 3, seg, u),
            ("direct W=33 U=N", RANK + 1, dplan3.seg, N3),
            ("DeepFM direct W=17 U=N", 17, dplan5.seg, ids5.size),
            ("config 1 direct W=9", 9, plan1.seg, 2625))
for label, w, s, uu in b5_paths:
    b5_entry(f"B5 {label}", w, s, uu)
# the crossover's evidence: both layouts (where the root has two) at each
# width on the ladder plan, and on config 4's FFM plan at W = 354
for w in (9, 17, 33, 35, 66, 177, 354):
    b5_entry(f"B5 W={w} ladder", w, seg, u, both=True)
b5_entry("B5 W=354 FFM plan", 354, seg4, u4, both=True)
del dplan3, dplan5

# B1 at the serving chunk, the record and a device plan, each call on
# another plan's uids (8 plans), as the smoke times them; the tables have
# the plans' fill row, BUCKETS
plans = [E.host_dedup(zipf_ids(), cap, fill=BUCKETS) for _ in range(8)]
uidss = [torch.as_tensor(p.uids[:u], device=dev) for p in plans]


def per_plan(fn):
    res = device_us(lambda: [fn(x) for x in uidss], reps=1)
    return None if res is None else [res[0] / len(uidss)]


v_tab = torch.randn((BUCKETS + 1, RANK), generator=gen, device=dev)
w_tab = torch.randn((BUCKETS + 1,), generator=gen, device=dev)
w_col = w_tab.view(-1, 1)
for t in (v_tab, w_col):
    assert torch.equal(rowio.gather_rows(t, uidss[0]),
                       rowio.gather_rows_reference(t, uidss[0])), "B1"
out["B1 V"] = per_plan(lambda x: rowio.gather_rows(v_tab, x))
out["B1 w"] = per_plan(lambda x: rowio.gather_rows(w_col, x))
if hasattr(rowio, "gather_vw_rows"):
    assert torch.equal(rowio.gather_vw_rows(v_tab, w_tab, uidss[0]),
                       rowio.gather_vw_rows_reference(v_tab, w_tab, uidss[0]))
    out["B1 V+w one launch"] = per_plan(
        lambda x: rowio.gather_vw_rows(v_tab, w_tab, x))
del v_tab, w_tab, w_col
rec = torch.randn((BUCKETS + 1, 68), generator=gen, device=dev)
assert torch.equal(rowio.gather_rows(rec, uidss[0]),
                   rowio.gather_rows_reference(rec, uidss[0])), "B1 record"
out["B1 record"] = per_plan(lambda x: rowio.gather_rows(rec, x))
dplan = E.dedup_ids(torch.as_tensor(zipf_ids(), device=dev), cap,
                    fill=BUCKETS)
assert torch.equal(rowio.gather_rows(rec, dplan.uids),
                   rowio.gather_rows_reference(rec, dplan.uids))
out["B1 device plan"] = split(device_us(
    lambda: rowio.gather_rows(rec, dplan.uids)))
out["main plan"] = [n, u]
del rec, dplan, plans, uidss
"""

ALS = r"""

# the ALS sweep's per-rank sums at the ml25m-als-sweep cell's shapes: the
# cell's ratings (every user and movie rated, so a feature's rank is its
# id), examples sorted by user; the CSC view is the user block (example
# order) then the movie block (stably sorted by movie, its rows the
# examples), x all ones, as build_workspace makes it
sys.path.append(HERE)
from portbench.gen import ratings as R
cfg2 = json.load(open(f"{HERE}/portbench/configs/ml25m-als-r32.json"))
ids2 = torch.as_tensor(R.ratings(cfg2, 0, dev)[0], device=dev)
ids2 = ids2[torch.sort(ids2[:, 0], stable=True)[1]]
n2 = ids2.shape[0]
u2 = int(cfg2["num_users"]) + int(cfg2["num_movies"])
order = torch.sort(ids2[:, 1], stable=True)[1]
col_rank = torch.cat([ids2[:, 0], ids2[order, 1]]).contiguous()
col_row = torch.cat([torch.arange(n2, device=dev), order]).int()
col_val = torch.ones(2 * n2, device=dev)
assert int(torch.unique(col_rank).numel()) == u2
slot_rank = ids2.t().contiguous().int()     # the (L, N) rank-space view
del ids2, order
e2 = torch.randn(n2, generator=gen, device=dev)
q2 = torch.randn(n2, generator=gen, device=dev)
qn2 = torch.randn(n2, generator=gen, device=dev)
# a root whose ALS kernels take e and q as the two columns of one (N, 2)
# array of pairs, as its sweep holds them; else two vectors
import inspect
PAIRS = (hasattr(segsum, "als_stream_sums") and "eq" in
         inspect.signature(segsum.als_stream_sums).parameters)
eq2 = torch.stack([e2, q2], dim=1) if PAIRS else None


def stream_passes(fn, *names):
    total = spun_us(fn, reps=5, windows=3)
    res = split(device_us(fn, reps=5), *names)
    return {"spun_us": total, "profiled": res}


def patch_entry(b):
    # the patch of q and e after a (factor, block) on block b's row of the
    # rank-space view (x all ones, as the cell's), in place, beside its
    # plain version: the torch lines it replaces, which here also square
    # vals (the sweep hoisted that) and copy the results into e and q (on
    # a root with pairs, into eq's columns); there also the factor's last
    # patch, which loads the next factor's q into the q column, beside the
    # patch and a strided copy of that q into the column, the alternative
    rank_b, vals_b = slot_rank[b], torch.ones(n2, device=dev)
    table = torch.randn((u2, 2), generator=gen, device=dev)
    if PAIRS:
        k_args, p_args = (eq2.clone(),), (eq2.clone(),)
    else:
        k_args, p_args = (e2.clone(), q2.clone()), (e2.clone(), q2.clone())

    def kernel():
        segsum.als_patch(*k_args, table, rank_b, vals_b)

    def plain():
        segsum.als_patch_reference(*p_args, table, rank_b, vals_b)
    kernel(), plain()
    assert all(torch.equal(k, p) for k, p in zip(k_args, p_args)), (
        "patch", b)
    nbytes = segsum.als_patch_bytes(n2, u2)
    rec = {"rank_offset_bytes": rank_b.data_ptr() % 16,
           "kernel": stream_passes(kernel, "als_patch_kernel"),
           "plain": stream_passes(plain), "bound_mb": nbytes / 1e6,
           "bound_us": 1e6 * nbytes / 3.35e12}
    rec["share"] = rec["bound_us"] / rec["kernel"]["spun_us"]
    if PAIRS:
        eqk, eqp = eq2.clone(), eq2.clone()

        def with_next():
            segsum.als_patch(eqk, table, rank_b, vals_b, qn2)

        def then_copy():
            segsum.als_patch(eqp, table, rank_b, vals_b)
            eqp[:, 1].copy_(qn2)
        with_next(), then_copy()
        assert torch.equal(eqk, eqp), ("patch with q_next", b)
        nb = segsum.als_patch_bytes(n2, u2, q_next=True)
        rec["with q_next"] = {
            "kernel": stream_passes(with_next, "als_patch_kernel"),
            "bound_us": 1e6 * nb / 3.35e12,
            "patch then copy": stream_passes(then_copy, "als_patch_kernel")}
        rec["with q_next"]["share"] = (rec["with q_next"]["bound_us"]
                                       / rec["with q_next"]["kernel"]
                                       ["spun_us"])
    return rec


for label, b, gather in (("user block", 0, False), ("movie block", 1, True)):
    seg_b = col_rank[b * n2:(b + 1) * n2]
    x_b = col_val[b * n2:(b + 1) * n2]
    row_b = col_row[b * n2:(b + 1) * n2] if gather else None

    def torch_streams():
        e_c = e2 if row_b is None else e2.index_select(0, row_b)
        q_c = q2 if row_b is None else q2.index_select(0, row_b)
        x2 = x_b * x_b
        return segsum.segment_colsums(
            [e_c * x_b * q_c, e_c * x2, x2 * q_c * q_c, x2 * x_b * q_c,
             x2 * x2], seg_b, u2)
    streams = [torch.randn(n2, generator=gen, device=dev) for _ in range(5)]
    rec2 = {"n": n2, "u": u2, "seg_offset_bytes": seg_b.data_ptr() % 16}
    for s in (5, 1):
        got = segsum.segment_colsums(streams[:s], seg_b, u2)
        err = rel(got, segsum.segment_colsums_reference(
            [t.double() for t in streams[:s]], seg_b, u2))
        assert err < 1e-4, ("B7", label, s, err)
        rec2[f"B7 S={s}"] = dict(stream_passes(
            lambda s=s: segsum.segment_colsums(streams[:s], seg_b, u2),
            "colsums_chunks", "colsums_crossing"), err=err,
            bound_us=1e6 * 4 * ((s + 1) * n2 + u2 * s) / 3.35e12)
    del streams
    rec2["gathers, streams and B7"] = stream_passes(torch_streams)
    if hasattr(segsum, "als_stream_sums"):
        ins = (eq2,) if PAIRS else (e2, q2)

        def fused():
            return segsum.als_stream_sums(*ins, x_b, row_b, seg_b, u2)
        got = fused()
        assert torch.equal(got, torch_streams()), ("stream sums", label)
        assert torch.equal(got, fused()), ("stream sums repeat", label)
        err = rel(got, segsum.als_stream_sums_reference(
            *(t.double() for t in ins), x_b.double(), row_b, seg_b, u2))
        assert err < 1e-4, ("stream sums", label, err)
        rec2["stream sums"] = dict(stream_passes(
            fused, "als_stream_sums_kernel", "als_stream_sums_crossing"),
            err=err, bound_us=1e6 * 4 * ((5 if gather else 4) * n2
                                         + 5 * u2) / 3.35e12)
    if hasattr(segsum, "als_patch"):
        rec2["patch"] = patch_entry(b)
    out[f"ALS {label}"] = rec2
print(json.dumps({"root": ROOT, "us": out}))
"""

FFM = r"""
sys.path.append(HERE)
from portbench.counts import ffm_sgd
from sparkfm_tpu_torch.config import FMConfig, Task
from sparkfm_tpu_torch.data.batching import SparseBatch
from sparkfm_tpu_torch.ops import interaction as I
from sparkfm_tpu_torch.solvers import sgd as S

ONE_PASS = hasattr(I, "ffm_slot_major_loss_grad")


def former_route(cfg, batch, vw_rows):
    # the fused step's interaction before the kernel, and the update's cat
    vk = vw_rows.shape[-1] - 1
    w0 = torch.zeros((), dtype=vw_rows.dtype, device=dev).requires_grad_()
    w_rows = vw_rows[..., vk].detach().requires_grad_()
    v_rows = vw_rows[..., :vk].detach().requires_grad_()
    with torch.enable_grad():
        total, _ = S._batch_loss_from_rows(w0, w_rows, v_rows, batch, cfg)
        _, g_w, g_v = torch.autograd.grad(total, (w0, w_rows, v_rows))
    return torch.cat([g_v.reshape(-1, vk), g_w.reshape(-1, 1)], 1)


for label, b, f, k in (("cell", 65536, 39, 4), ("config 4", 8192, 22, 8)):
    cfg = FMConfig(num_features=1 << 20, num_factors=k, num_fields=f,
                   slot_major_fields=True, use_bias=False, use_linear=False,
                   task=Task.CLASSIFICATION, reg_v=1e-5)
    vw_rows = 0.5 * torch.rand((b, f, f * k + 1), generator=gen, device=dev)
    vals = torch.full((b, f), f ** -0.5, device=dev)
    y = torch.randint(0, 2, (b,), generator=gen, device=dev).float()
    ids = torch.zeros((b, f), dtype=torch.int32, device=dev)
    batch = SparseBatch(ids=ids, vals=vals, y=y)
    nbytes = ffm_sgd.interaction_bytes(b * f, f, k)
    rec = {"b": b, "fields": f, "k": k, "bound_mb": nbytes / 1e6,
           "bound_us": 1e6 * nbytes / 3.35e12}
    rec["former route"] = {
        "spun_us": spun_us(lambda: former_route(cfg, batch, vw_rows), reps=3),
        "profiled": split(device_us(
            lambda: former_route(cfg, batch, vw_rows), reps=3))}
    if ONE_PASS:
        w0 = torch.zeros((), device=dev)

        def one_pass(n=b):
            return I.ffm_slot_major_loss_grad(
                w0, vw_rows[:n], vals[:n], y[:n], None, Task.CLASSIFICATION,
                use_bias=False, use_linear=False, reg0=0.0, reg_w=0.0,
                reg_v=1e-5)
        assert torch.equal(one_pass()[3], one_pass()[3]), ("repeat", label)
        # the check on the first 8,192 examples (float64 autograd over the
        # whole cell's batch would take ~40 GB)
        n = min(b, 8192)
        got = one_pass(n)[3]
        b64 = SparseBatch(ids=ids[:n], vals=vals[:n].double(),
                          y=y[:n].double())
        want = former_route(dataclasses.replace(cfg, compute_dtype="float64"),
                            b64, vw_rows[:n].double())
        err = float((got.double() - want).abs().max() / want.abs().max())
        assert err < 1e-5, ("one pass", label, err)
        del got, want
        torch.cuda.empty_cache()
        rec["kernel"] = {"spun_us": spun_us(one_pass),
                         "profiled": split(device_us(one_pass),
                                           "ffm_slot_major"),
                         "err": err}
        rec["share"] = rec["bound_us"] / rec["kernel"]["spun_us"]
    out[f"FFM {label}"] = rec
    del vw_rows
    torch.cuda.empty_cache()
print(json.dumps({"root": ROOT, "us": out}))
"""

SWEEPS = r"""
import hashlib, json, sys, time
import torch
from torch.profiler import profile
sys.path.insert(0, ROOT)
sys.path.append(HERE)
from portbench.gen import ratings as R
from portbench.gen import weights as W
from sparkfm_tpu_torch.config import ALSConfig, FMConfig
from sparkfm_tpu_torch.data.batching import SparseDataset
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.solvers import als as A
from sparkfm_tpu_torch.utils import profiling

dev = torch.device("cuda", 0)
c = json.load(open(f"{HERE}/portbench/configs/ml25m-als-r32.json"))
ids, vals, y = R.ratings(c, 0, dev)
nf, k = int(c["num_users"]) + int(c["num_movies"]), int(c["num_factors"])
ds = SparseDataset(ids=ids, vals=vals, y=y, num_features=nf)
cfg = FMConfig(num_features=nf, num_factors=k, reg0=c["reg0"],
               reg_w=c["reg_w"], reg_v=c["reg_v"], init_stdev=c["init_stdev"])
als_cfg = ALSConfig()
params = FMParams(*W.fm_weights(nf, k, 0, dev, v_stdev=c["init_stdev"]))
# train_als's set-up, step for step
ws, nb = A.build_workspace(ds, cfg, als_cfg, device=dev)
reg_w, reg_v = (torch.as_tensor(r, device=dev) for r in cfg.reg_vectors())
nr = ws.present.shape[0]
bof, _ = A.feature_blocks_of(nf, als_cfg)
cpure = bool(nr) and A.blocks_are_column_pure(ds, bof)
uni = cpure and A.csc_blocks_uniform(ds, bof)
ident = A.csc_slice_identity(ws, nb, ds.num_examples) if uni else ()


def sweep(p):
    return A.als_sweep_compact(p, ws, nb, nr, cfg.reg0, reg_w, reg_v,
                               cfg.use_bias, cfg.use_linear,
                               column_pure=cpure, csc_uniform=uni,
                               slice_identity=ident)


def digest(p):
    h = hashlib.sha256()
    for t in (p.w0, p.w, p.v):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


params = sweep(params)
torch.cuda.synchronize()
hashes, wall = [digest(params)], []
for _ in range(3):
    t0 = time.perf_counter()
    params = sweep(params)
    torch.cuda.synchronize()
    wall.append(1e3 * (time.perf_counter() - t0))
    hashes.append(digest(params))
profiling.clear()
with profile():
    sweep(params)
    torch.cuda.synchronize()
spans = {name: 1e3 * rec["device_s"]
         for name, rec in profiling.recorded()["spans"].items()
         if rec["device_s"] is not None}
print(json.dumps({"root": ROOT, "blocks": nb, "column_pure": cpure,
                  "sweep_ms": wall, "sha256_after_sweeps": hashes,
                  "traced_sweep_span_ms": spans}))
"""

PATHS = r"""
import json, sys, time
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ROOT)
from sparkfm_tpu_torch import FMConfig, SGDConfig, Task, train_sgd
from sparkfm_tpu_torch.data import synth

dev = torch.device("cuda", 0)
out = {}


def epoch(label, cfg, sgd, ds):
    # a warm-up epoch, an untraced one (wall, ex/s), then a traced one:
    # device busy time, torch.cat's kernels and the top device events
    train_sgd(cfg, sgd, ds, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_sgd(cfg, sgd, ds, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_sgd(cfg, sgd, ds, device=dev)
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA),
                key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in ev)
    cat = sum(e.self_device_time_total for e in ev if "CatArray" in e.key)
    out[label] = {"ex_per_s": res.examples_per_sec, "wall_ms": 1e3 * wall,
                  "busy_ms": busy / 1e3, "idle": 1 - busy / 1e6 / wall,
                  "cat_ms": cat / 1e3,
                  "top_us": [[e.key[:48], e.count,
                              round(e.self_device_time_total)]
                             for e in ev[:6]]}
    torch.cuda.empty_cache()


cfg3 = FMConfig(num_features=1 << 24, num_factors=32,
                task=Task.CLASSIFICATION, reg_w=1e-6, reg_v=1e-6, seed=0)
ds3 = synth.synth_ctr(num_examples=16384 * 20, num_fields=39,
                      num_buckets=1 << 24, seed=0)
for label, kw in (("fused, device plans", dict(host_plan=False)),
                  ("fused, host plans", {}), ("sorted", {})):
    path = "sorted" if label == "sorted" else "fused"
    epoch(label, cfg3, SGDConfig(batch_size=16384, learning_rate=0.05,
                                 epochs=1, update_path=path, **kw), ds3)
del ds3
cfg4 = FMConfig(num_features=1 << 22, num_factors=8, num_fields=22,
                task=Task.CLASSIFICATION, reg_v=1e-6, seed=0,
                slot_major_fields=True)
ds4 = synth.synth_ctr(num_examples=8192 * 20, num_fields=22,
                      num_buckets=1 << 22, seed=0)
epoch("FFM, fused", cfg4, SGDConfig(batch_size=8192, learning_rate=0.05,
                                    epochs=1), ds4)
print(json.dumps({"root": ROOT, "epochs": out}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--order", default=None,
                    help="comma-separated indices into the roots, in turn")
    ap.add_argument("--paths", action="store_true",
                    help="profile one epoch of each SGD path instead")
    ap.add_argument("--als", action="store_true",
                    help="time only the ALS sweep's per-rank sums")
    ap.add_argument("--ffm", action="store_true",
                    help="time the slot-major FFM's loss and row gradients "
                         "instead")
    ap.add_argument("--sweeps", action="store_true",
                    help="time whole ALS sweeps on train_als's default "
                         "blocks instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device; this script runs only on a "
                 "GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)
    roots = [os.path.abspath(r) for r in args.roots]
    order = ([int(i) for i in args.order.split(",")] if args.order
             else range(len(roots)))
    for i in order:
        child = subprocess.run(
            [sys.executable, "-c",
             f"ROOT = {roots[i]!r}\nHERE = {HERE!r}\n"
             + (PATHS if args.paths else SWEEPS if args.sweeps
                else COMMON + FFM if args.ffm
                else COMMON + ALS if args.als else COMMON + KERNELS + ALS)],
            capture_output=True, text=True, timeout=900)
        if child.returncode != 0:
            sys.exit(f"kernel_times: {roots[i]} failed:\n{child.stdout}"
                     f"{child.stderr[-4000:]}")
        print(child.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
