#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparkfm_tpu_torch``) on one GPU.

Drives the port's paths once, with random weights and data from a seed:
FM serving and SGD training (hybrid, fused and sorted) at the full width
of BASELINE config 3 (Criteo-shape logistic FM: 2^24 hashed buckets, rank
32, 39 slots), then ALS training at the full size of BASELINE config 2
(ML-25M-shape regression FM: 221,588 features, rank 32, 25M ratings) and
the ``FM`` facade.

  1. builds every kernel library from ``sparkfm_tpu_torch/csrc/`` at once,
     one nvcc per source in parallel (``rowio.cu``: row gathers and row
     write; ``segsum.cu``: the two backwards, row sums and per-rank stream
     sums), and prints ptxas's registers and spills per kernel;
  2. holds the gathers against their plain versions on the card, with
     exact equality (a gather is a copy): the serving path's two-table
     gather ``[v | w]`` against two ``index_select``s and a ``cat``, and
     the tile gather of V and of the w column against ``index_select``, at
     the main path's shapes (ladder plans, U = 40,960, and a 2^18-slot
     device plan), at W = 1, 32, 33, 68, 128 and on misaligned tables;
     times the two-table gather against its plain version and against two
     tile gathers with CUDA events;
  3. shows, in a child process, that an id out of range traps the kernel;
  4. checks scores on a small input against a float64 numpy reference;
  5. serves a few dozen requests through ``MicroBatcher`` and one
     16384-row batch through ``FMModel.predict_dataset``, with the launch
     counts set to 0 just before and read just after (one two-table gather
     per scoring chunk, no one-table gather), and holds the outputs
     against the same requests scored with the plain gather;
  6. profiles where the time goes: device time per gather call (the
     two-table gather, its plain version, and V and w apart by the tile
     gather and by ``index_select``), the
     device's busy share of the serving run, the host wall time of the
     run split into plan building, plan copy and the scoring call, and
     the host plan alone at both batch shapes. The plans must come from
     the native builder (``native/dedup_plan.cpp``); the smoke fails if
     it did not build;
  7. holds the row-write kernel against its plain version (exact, every
     row, the plan's fill row included: a run of equal ids writes its first
     row) on a (2^24+1, 68) fused-record table with the uids of real
     bench-recipe ladder plans and of a ``dedup_ids`` device plan (budget
     2^18, ~40k uniques, a ~222k-slot fill tail), at odd widths and on a
     misaligned table, and the gather at the record's width; times the
     write beside ``index_copy_`` over each plan's distinct ids (at the
     device plan also over all its slots) and the gather beside
     ``index_select`` at both plan shapes;
  8. holds the factored-backward kernel against its plain version on a
     bench-recipe plan (N = 638,976 slots, one run of ~162k) and on a
     ``synth_ctr`` plan, at k = 32, 4 and 33 (f32 sums in another order:
     max |a - b| / (1 + |b|) < 1e-4), and shows its sums repeat exactly;
     on ranks with gaps and empty ranks at both ends, whose zero rows the
     kernel writes; times it per call, and pass 1 and pass 2 apart;
  9. trains BASELINE config 3 with ``train_sgd`` (``synth_ctr`` of 20
     batches of 16384, 2 epochs, adagrad, lr 0.05), with the three
     kernels' launch counts set to 0 just before and read just after:
     each must equal the number of steps, every loss must be finite and
     the second epoch's below the first's. Then runs 5 hybrid steps on
     bench-recipe batches twice from one initial table, with the kernels
     and with their plain versions swapped in, and holds tables and
     losses against each other;
 10. profiles training: device time per call of each kernel against its
     plain version, the device's busy share of a one-epoch run with its
     top device events, and the host wall time per step split into the
     host plan, its copy to the card and the step's host side;
 11. frees the SGD tables, makes BASELINE config 2's data with
     ``benchmarks/bench_configs.py::bench_als``'s recipe (seed 0, 25M
     ratings, 162,541 uniform users, zipf(1.3) movies hashed into 59,047)
     and its ALS workspace, and holds the stream-sum kernel
     (``segment_colsums``) against its plain version in float64 (max |a -
     b| / (1 + |b|) < 1e-4) on the movie block's real ranks (25M slots, a
     6.4M-slot head run) and the user block's at S = 5 and 1, on a seg
     view 4 bytes short of a 16-byte bound, and at odd shapes; shows that
     its sums repeat exactly and, in a child process, that a rank out of
     range traps; times each block's call, pass 1 and pass 2, against its
     bound;
 12. trains BASELINE config 2 with ALS: the structure flags must be
     column_pure / csc_uniform / slice_identity = True / True / (True,
     False); one sweep with the kernel and one with the float64 plain
     version swapped in, from the same parameters, must agree; then
     ``train_als`` runs 3 sweeps with the kernel's launch count set to 0
     just before and read just after (3 x 33 x 2 = 198), and the
     regularized squared loss, in float64 from the parameters, must fall
     after sweep 1 and again by sweep 3;
 13. fits ``FM(solver="als")`` on the card on ``synth_movielens`` and
     checks its eval RMSE;
 14. profiles ALS: the device's busy share of one sweep with its top
     device events and the stream sums' passes 1 and 2, and the host time
     of the workspace build, part by part;
 15. holds the row-sum kernel B5 (``segment_rowsum``) against its plain
     version in float64 (max |a - b| / (1 + |b|) < 1e-4) on a bench-recipe
     plan (N = 638,976, a ~162k-slot head run) at W = 66 and 35 (the fused
     and sorted payloads) and 1, 3, 130, 354, with seg[0] > 0, with gaps
     and at N = 100,003; its sums repeat exactly, ranks without slots are
     zero, and an out-of-range rank traps in a child process;
 16. trains BASELINE config 3 on the fused path with the default
     ``accumulate="auto"``, which sums by B5 on the card (``train_sgd``, as
     phase 9), the launch counts set to 0 just before: B1 = B2 = B5 =
     steps, B3 = 0; runs 5 fused steps against the plain versions as phase
     9 does; runs 3 steps on plans built on the card (``host_plan=False``)
     under each accumulate mode ("auto" and "segsum" launch B5 and give
     the same table bit for bit, "scatter" launches none);
 17. the same on the sorted path: ``train_sgd(update_path="sorted")``
     (B1 = B2 = B5 = steps) and 5 steps against the plain versions;
 18. holds B6 (``segment_rowsum_sq``) and B4 (``fm_grad_segsum``) against
     their plain versions in float64 on phase 15's plan at k = 32, 4 and
     33, and B4 against B3 on the rows it expands (< 1e-6); sums repeat,
     out-of-range ranks trap; then profiles B4, B5 and B6 per call against
     their plain versions, and one epoch of each SGD path (hybrid, fused
     on host plans, fused on device plans, sorted): trained ex/s, the
     device's busy share and its top events.

Every phase raises on failure. Needs one CUDA card; without one it exits
non-zero and prints no result. Run from the repository root:

    python3 chip_smoke.py

The line before the last is the kernels' JSON (``ms``/``plain_ms``/
``library_ms``: one call at the main path's shape, back to back under CUDA
events: for the gather the training record (W = 68), for the two-table
gather one plan's serving V+w, where the host's launch cost sets the
pace; ``device_ms``/``plain_device_ms``/
``library_device_ms``: the device time of one call, from torch.profiler
for B1-B3 and by CUDA events around calls queued behind a spin kernel for
B4-B7, whose phases come late in the run, where profiler traces lose
kernel records;
``library``: the one PyTorch call that computes the same function, where
there is one (null times where there is none); ``bound_ms``/``bound_us``:
the least time the card could take, from the bytes the call must move at
3.35 TB/s and its float32 operations at 67 TFLOP/s, ``bound_by`` which,
``share_of_bound`` = bound / device time; ``launches``: the count from the
main paths' runs, serving and training; B4 and B6, which no path runs,
count one call each at the main path's shapes, as their ``path`` field
says), the last line the result.
"""

import collections
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

BUCKETS = 1 << 24       # BASELINE config 3
RANK = 32
SLOTS = 39
BATCH = 16384           # bench.py's score batch
MAX_BATCH = 4096        # MicroBatcher default
SEED = 0
ALS_N = 25_000_000      # BASELINE config 2: ML-25M shape
ALS_USERS, ALS_MOVIES = 162541, 59047
ALS_SWEEPS = 3


def zipf_ids(rng, rows):
    """bench.py's id recipe: zipf(1.3) hashed into the buckets."""
    raw = rng.zipf(1.3, size=(rows, SLOTS)).astype(np.int64)
    return ((raw * 2654435761) % BUCKETS).astype(np.int32)


def time_ms(fn, args, reps=20, windows=5):
    """Best over ``windows`` of the mean time of one call, by CUDA events,
    cycling through ``args`` after one warm-up pass."""
    for a in args:
        fn(*a)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(*args[i % len(args)])
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def spun_ms(fn, reps=10, windows=3, spin=20_000_000):
    """Device time of one call (ms): CUDA events around ``reps`` calls
    queued behind a spin kernel of ``spin`` cycles (~10 ms), so the host
    has queued them all before the first runs and its launch cost stays
    off the clock; best of ``windows``. Unlike a torch.profiler trace it
    cannot lose a kernel's record, which traces late in this run do."""
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
    return best


def device_us(fn, tries=3):
    """All device time (us) that torch.profiler records while ``fn`` runs:
    the sum over device-side events (kernels, copies) only, since a CPU
    op's entry repeats the device time of the kernels it launched. Also
    the device events, sorted by time. A trace can lose kernel records
    (seen late in a run) but never adds any, so of ``tries`` traces the
    one with the most device time is kept; 0 if none saw any."""
    best = (0, [])
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: -e.self_device_time_total)
        total = sum(e.self_device_time_total for e in events)
        if total > best[0]:
            best = (total, events)
    return best


def pct(share):
    """A share of the bound for printing."""
    return "not measured" if share is None else f"{100 * share:.1f}%"


TRAP_CHILD = """
import sys, torch
from sparkfm_tpu_torch.ops import rowio
table = torch.zeros((10, 4), device="cuda")
ids = torch.tensor([0, 10], dtype=torch.int32, device="cuda")
try:
    {call}
    torch.cuda.synchronize()
except RuntimeError as e:
    if "unspecified launch failure" not in str(e):   # not the trap
        raise
    print("trapped:", str(e).splitlines()[0])
    sys.exit(3)
print("no trap")
"""
GATHER_TRAP_CALLS = {
    "gather_rows": "rowio.gather_rows(table, ids)",
    "gather_vw_rows": "rowio.gather_vw_rows(table, table[:, 0].contiguous(), "
                      "ids)"}


@contextlib.contextmanager
def timed_calls(targets, spent):
    """Add the host wall time of every call to ``module.name`` to
    ``spent[label]``, for each (label, module, name) of ``targets``, while
    the block runs; the functions are restored after it."""
    originals = []
    for label, mod, name in targets:
        fn = getattr(mod, name)
        originals.append((mod, name, fn))

        def timed(*a, _fn=fn, _label=label, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                spent[_label] += time.perf_counter() - t0
        setattr(mod, name, timed)
    try:
        yield spent
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


@contextlib.contextmanager
def swapped(targets):
    """Replace ``module.name`` by ``fn`` for each (module, name, fn) of
    ``targets`` while the block runs."""
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    for mod, name, fn in targets:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def build_all(kernels):
    """Build the kernels' libraries at once, one compiler process per
    library; returns the seconds it took. Raises the first build error."""
    errors = []

    def build(kernel):
        try:
            kernel.build()
        except Exception as e:          # re-raised below, in this thread
            errors.append(e)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(k,)) for k in kernels]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0


def ptxas_summary(lib_path):
    """'kernel: N registers, S spill bytes' per kernel from the build log
    that nvcc -Xptxas -v left beside the library."""
    out = []
    name = None
    spill = 0
    with open(lib_path[:-len(".so")] + ".log") as log:
        for line in log:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                mangled = m.group(1)
                k = re.search(r"([a-z][a-z_]*_kernel)(I\w*?E)?E", mangled)
                name = (k.group(1) + (k.group(2) or "")) if k else mangled
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out.append(f"{name}: {m.group(1)} registers, {spill} "
                           "spill bytes")
                name = None
    return "; ".join(out)


# NVIDIA H100 SXM's data sheet: HBM rate and float32 rate outside the
# tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound(nbytes, ops, device_ms):
    """A kernel's bound fields: the least time the card could take for the
    call (the larger of the bytes it must move, each input read once and
    each output written once, over the HBM rate, and its float32
    operations over the float32 rate), which of the two sets it, and the
    share of that bound the measured device time reaches."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    ms = 1e3 * max(t_bytes, t_ops)
    return {"bound_ms": ms, "bound_us": 1e3 * ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes,
            "share_of_bound": ms / device_ms if device_ms else None}


def per_call_ms(fn, reps=5):
    """Device ms of one call of ``fn`` by torch.profiler, over ``reps``
    calls (``fn`` warmed up first); None if no trace saw device time."""
    fn()
    torch.cuda.synchronize()
    us = device_us(lambda: [fn() for _ in range(reps)])[0]
    return us / reps / 1e3 if us else None


def max_rel_err(got, want):
    """max |a - b| / (1 + |b|)."""
    return float(((got.double() - want).abs() / (1 + want.abs())).max())


def plain64(vw_u, ex_srt, x, seg, num_segments, cv, cw):
    """The factored backward's plain version evaluated in float64 and
    rounded to float32: the oracle for both f32 versions. At the main
    path's 162k-slot run the f32 plain version's own sums (atomic adds in
    any order) are off by a few 1e-4, more than the kernel's chunked
    sums."""
    from sparkfm_tpu_torch.ops import segsum
    return segsum.fm_grad_segsum_factored_reference(
        vw_u.double(), ex_srt.double(), x.double(), seg, num_segments,
        cv, cw).float()


COLSUMS_TRAP_CHILD = """
import sys, torch
from sparkfm_tpu_torch.ops import segsum
seg = torch.tensor([0, 1, 1, 5], dtype=torch.int32, device="cuda")
streams = [torch.ones(4, device="cuda")]
try:
    segsum.segment_colsums(streams, seg, 5)
    torch.cuda.synchronize()
except RuntimeError as e:
    if "unspecified launch failure" not in str(e):   # not the trap
        raise
    print("trapped:", str(e).splitlines()[0])
    sys.exit(3)
print("no trap")
"""


def assert_close_rows(a, b, rtol, atol, what, rows=1 << 22):
    """np.allclose semantics over two big tables, a block of rows at a
    time (the temporaries of one call would take several GB)."""
    for r0 in range(0, a.shape[0], rows):
        x, y = a[r0:r0 + rows], b[r0:r0 + rows]
        bad = ((x - y).abs() > atol + rtol * y.abs()).sum().item()
        if bad:
            raise AssertionError(f"{what}: {bad} entries differ beyond rtol "
                                 f"{rtol}, atol {atol} in rows {r0}..")


def steps_against_plain(step, state, batches, swaps, kernels, label):
    """Run ``step`` over ``batches`` from ``state`` (updated in place).
    Each step runs twice from the same state, with the kernels and with
    the plain versions ``swaps`` (module, name, fn) swapped in, and the
    run goes on from the kernels' result: losses must agree at rtol 1e-5,
    tables [:F, :2k+2] at rtol 1e-4, atol 1e-6, and the plain step must
    launch none of ``kernels``. Run freely, the two would drift apart
    beyond any tolerance for a reason that is no fault of either: on
    random labels at lr 0.05 the loss grows by orders of magnitude within
    a few steps, and that growth amplifies the f32 rounding of the sums.
    Returns the losses and the number of rows the run changed."""
    kernels = list(kernels)
    used = 2 * RANK + 2
    first = state.table[:BUCKETS, :used].clone()
    losses = []
    for b in batches:
        plain_in = dataclasses.replace(state, table=state.table.clone())
        state, aux = step(state, b)
        counts = [k.launches for k in kernels]
        with swapped(swaps):
            plain_out, plain_aux = step(plain_in, b)
        if [k.launches for k in kernels] != counts:
            raise AssertionError(f"the plain {label} step launched a kernel")
        losses.append(float(aux["loss"]))
        np.testing.assert_allclose(losses[-1], float(plain_aux["loss"]),
                                   rtol=1e-5)
        assert_close_rows(state.table[:BUCKETS, :used],
                          plain_out.table[:BUCKETS, :used], 1e-4, 1e-6,
                          f"{label} step {len(losses)} tables")
        np.testing.assert_allclose(float(state.w0), float(plain_out.w0),
                                   rtol=1e-5)
        del plain_in, plain_out
    moved = int((state.table[:BUCKETS, :used] != first).any(dim=1).sum())
    return losses, moved


def train_phases(dev, cfg, gen, rng, card):
    """Phases 7-10, the training path; returns the kernels' JSON entries
    for the row write and the factored backward, and the gather's numbers
    at the record's width."""
    from sparkfm_tpu_torch import SGDConfig, train_sgd
    from sparkfm_tpu_torch.data import synth
    from sparkfm_tpu_torch.data.batching import (SparseDataset,
                                                 batch_iterator)
    from sparkfm_tpu_torch.ops import embedding as E
    from sparkfm_tpu_torch.ops import rowio, segsum
    from sparkfm_tpu_torch.solvers import sgd_fused, sgd_hybrid

    width = sgd_fused.record_width(RANK)
    used = 2 * RANK + 2
    cap = E.auto_budget(BATCH * SLOTS)
    ones = np.ones((BATCH, SLOTS), np.float32)
    plans = [E.host_dedup(zipf_ids(rng, BATCH), cap, fill=BUCKETS,
                          vals=ones) for _ in range(4)]
    rung = max(E.ladder_budget(int(p.count), cap=cap) for p in plans)
    uids = [torch.as_tensor(p.uids[:rung], device=dev) for p in plans]

    # 7. the row write (and the gather at the record's width) against
    # their plain versions on a full-size record table: every row, the
    # fill row included (the write keeps the first row of a run of ids)
    table = torch.randn((BUCKETS + 1, width), generator=gen, device=dev)
    errs = {"gather": 0.0, "write": 0.0}
    for u in uids:
        got = rowio.gather_rows(table, u)
        ref = rowio.gather_rows_reference(table, u)
        errs["gather"] = max(errs["gather"], float((got - ref).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"gather kernel wrong at W={width}")
        rows = torch.randn((rung, width), generator=gen, device=dev)
        want = rowio.scatter_set_rows_reference(table.clone(), u, rows)
        if rowio.scatter_set_rows(table, u, rows) is not table:
            raise AssertionError("scatter_set_rows did not write in place")
        written = u.long()
        errs["write"] = max(errs["write"], float(
            (table[written] - want[written]).abs().max()))
        if not torch.equal(table, want):
            raise AssertionError(f"row write kernel != plain at "
                                 f"{tuple(table.shape)}, U={rung}")
        del want
    odd = [(100003, 1, 1001), (100003, 33, 1001), (100003, 128, 1001)]
    for r, w, n in odd:
        t = torch.randn((r, w), generator=gen, device=dev)
        ids = torch.as_tensor(rng.permutation(r - 1)[:n].astype(np.int32),
                              device=dev)
        ids[-n // 10:] = r - 1                     # repeated fill row
        new = torch.randn((n, w), generator=gen, device=dev)
        want = rowio.scatter_set_rows_reference(t.clone(), ids, new)
        if not torch.equal(rowio.scatter_set_rows(t, ids, new), want):
            raise AssertionError(f"row write kernel wrong at {(r, w, n)}")
    t = torch.randn(1000 * 4 + 1, device=dev, generator=gen)[1:].view(1000, 4)
    ids = torch.arange(999, -1, -3, dtype=torch.int32, device=dev)
    new = torch.randn((ids.numel(), 4), generator=gen, device=dev)
    want = rowio.scatter_set_rows_reference(t.clone(), ids, new)
    if not torch.equal(rowio.scatter_set_rows(t, ids, new), want):
        raise AssertionError("row write kernel wrong on a misaligned table")
    # a device plan: dedup_ids of a bench-recipe batch on the card, at the
    # static budget the fused and sorted paths use (2^18 slots for ~40k
    # uniques: a fill tail of ~222k slots), by the shipped route and both
    dplan = E.dedup_ids(torch.as_tensor(zipf_ids(rng, BATCH), device=dev),
                        cap, fill=BUCKETS)
    dcount = int(dplan.count)
    drows = torch.randn((cap, width), generator=gen, device=dev)
    want = rowio.scatter_set_rows_reference(table.clone(), dplan.uids, drows)
    t = table.clone()
    rowio.scatter_set_rows(t, dplan.uids, drows)
    if not torch.equal(t, want) or not torch.equal(t[BUCKETS],
                                                   drows[dcount]):
        raise AssertionError(f"row write != plain on a device plan "
                             f"(U={cap}, {dcount} uniques)")
    del t, want
    torch.cuda.synchronize()
    print(f"check: row write kernel == plain version (every row, the fill "
          f"row included) on the record table {tuple(table.shape)} with "
          f"U={rung} (4 bench-recipe ladder plans, counts "
          f"{[int(p.count) for p in plans]}) and on a dedup_ids device plan "
          f"(U={cap}, {dcount} uniques, fill tail {cap - dcount}), at (R, "
          f"W, U) {odd} and on a misaligned table; gather kernel == "
          f"index_select at W={width}", flush=True)
    rows = [torch.randn((rung, width), generator=gen, device=dev)
            for _ in uids]
    wargs = list(zip(uids, rows))
    # the one library call of the write's function: index_copy_ over each
    # plan's distinct ids (the uniques and the fill row's first slot)
    longs = [(u[:d].long(), r[:d]) for (u, r), d in zip(
        wargs, [min(int(p.count) + 1, rung) for p in plans])]

    def index_copy(u_long, r):
        return table.index_copy_(0, u_long, r)

    times = {
        "gather": (time_ms(lambda u: rowio.gather_rows(table, u),
                           [(u,) for u in uids]),
                   time_ms(lambda u: rowio.gather_rows_reference(table, u),
                           [(u,) for u in uids])),
        "write": (time_ms(lambda u, r: rowio.scatter_set_rows(table, u, r),
                          wargs),
                  time_ms(lambda u, r: rowio.scatter_set_rows_reference(
                      table, u, r), wargs),
                  time_ms(index_copy, longs))}
    dev_us = {
        "gather": tuple(device_us(lambda: [g(table, u) for u in uids])[0]
                        / len(uids) for g in (
                            rowio.gather_rows, rowio.gather_rows_reference)),
        "write": tuple(device_us(lambda: [w(table, *a) for a in args])[0]
                       / len(args) for w, args in (
                           (rowio.scatter_set_rows, wargs),
                           (rowio.scatter_set_rows_reference, wargs),
                           (lambda t, u, r: t.index_copy_(0, u, r), longs)))}
    # everything at the device plan's shape; index_copy_ over all its
    # slots writes the fill row ~222k times and leaves which of them lands
    # unspecified, another function, timed for the record
    dlong = dplan.uids.long()
    dkeep = slice(0, min(dcount + 1, cap))
    device_plan = {
        "count": dcount, "budget": cap,
        "write_device_ms": per_call_ms(
            lambda: rowio.scatter_set_rows(table, dplan.uids, drows)),
        "write_plain_device_ms": per_call_ms(
            lambda: rowio.scatter_set_rows_reference(table, dplan.uids,
                                                     drows)),
        "write_library_device_ms": per_call_ms(
            lambda: table.index_copy_(0, dlong[dkeep], drows[dkeep])),
        "library": "index_copy_ over the plan's distinct ids",
        "index_copy_all_slots_device_ms": per_call_ms(
            lambda: table.index_copy_(0, dlong, drows)),
        "write_ms": time_ms(lambda: rowio.scatter_set_rows(
            table, dplan.uids, drows), [()]),
        "gather_device_ms": per_call_ms(
            lambda: rowio.gather_rows(table, dplan.uids)),
        "gather_library_device_ms": per_call_ms(
            lambda: table.index_select(0, dlong))}

    def us(ms):
        return "not measured" if ms is None else f"{ms * 1e3:.2f} us"
    print(f"time: row write at a device plan (U={cap}, {dcount} uniques, "
          f"W={width}): device {us(device_plan['write_device_ms'])} vs "
          f"plain (keep-first + index_copy_) "
          f"{us(device_plan['write_plain_device_ms'])}, index_copy_ over "
          f"the plan's distinct ids "
          f"{us(device_plan['write_library_device_ms'])} (over all {cap} "
          f"slots, the fill id repeated: "
          f"{us(device_plan['index_copy_all_slots_device_ms'])}); gather at "
          f"that shape {us(device_plan['gather_device_ms'])} vs "
          f"index_select {us(device_plan['gather_library_device_ms'])} "
          f"(torch.profiler); {card}", flush=True)
    del table, rows, wargs, longs, dplan, drows, dlong
    torch.cuda.empty_cache()

    # 8. the factored backward against its plain version: the main path's
    # plan (a bench-recipe batch), a synth_ctr plan, and other widths
    sds = synth.synth_ctr(num_examples=BATCH, num_fields=SLOTS,
                          num_buckets=BUCKETS, seed=SEED + 1)
    sp = E.host_dedup(sds.ids, cap, fill=BUCKETS, vals=sds.vals)
    cv = torch.tensor(2e-6 / BATCH, device=dev)
    cw = torch.tensor(2e-6 / BATCH, device=dev)

    def case(plan, k):
        n = plan.seg.shape[0]
        u = E.ladder_budget(int(plan.count), cap=cap)
        seg = torch.as_tensor(plan.seg, device=dev)
        vw_u = 0.01 * torch.randn((u, k + 1), generator=gen, device=dev)
        ex = torch.randn((n, k + 2), generator=gen, device=dev)
        ex[:, k + 1] = (torch.rand(n, generator=gen, device=dev) < 0.9)
        x = torch.randn(n, generator=gen, device=dev)
        return vw_u, ex, x, seg, u

    runs = {}
    checked = []
    main_case = None
    for label, plan, k in (("bench", plans[0], RANK), ("synth_ctr", sp, RANK),
                           ("bench", plans[1], 4), ("synth_ctr", sp, 33)):
        seg = plan.seg
        edges = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1], True])
        runs[label] = int(np.diff(edges).max())
        args = case(plan, k)
        want = segsum.fm_grad_segsum_factored_reference(*args, cv, cw)
        exact = plain64(*args, cv, cw)
        got = segsum.fm_grad_segsum_factored(*args, cv, cw)
        err, plain_err = max_rel_err(got, exact), max_rel_err(want, exact)
        gap = max_rel_err(got, want)
        if not (err < 1e-4 and gap < plain_err + 1e-4):
            raise AssertionError(
                f"factored backward kernel off at {label}, k={k}: "
                f"{err:.3g} from the float64 sums, {gap:.3g} from the f32 "
                f"plain version (itself {plain_err:.3g} off)")
        if not torch.equal(got, segsum.fm_grad_segsum_factored(*args, cv,
                                                                cw)):
            raise AssertionError("factored backward sums do not repeat")
        checked.append(f"{label} k={k} N={seg.shape[0]} U={args[4]}: "
                       f"kernel {err:.3g}, plain {plain_err:.3g}, kernel vs "
                       f"plain {gap:.3g}")
        if main_case is None:
            main_case, main_err, main_plain_err = args, err, plain_err
            main_abs = float((got - exact).abs().max())
    print(f"check: factored backward kernel against the plain version in "
          f"float64, max |a-b|/(1+|b|) (kernel < 1e-4; kernel vs the f32 "
          f"plain version within the plain version's own error + 1e-4): "
          f"{'; '.join(checked)}; sums repeat exactly; longest run: "
          f"bench-recipe {runs['bench']} slots, synth_ctr "
          f"{runs['synth_ctr']}", flush=True)
    # the kernel writes the rows of ranks without slots (before the first,
    # in gaps, after the last) as zeros: the output is not filled first
    gseg = main_case[3] + 3 + torch.cumsum(
        (torch.rand(main_case[3].shape[0], generator=gen, device=dev)
         < 0.05).int(), 0, dtype=torch.int32)
    gu = int(gseg[-1]) + 5
    gargs = (0.01 * torch.randn((gu, RANK + 1), generator=gen, device=dev),
             *main_case[1:3], gseg, gu)
    got = segsum.fm_grad_segsum_factored(*gargs, cv, cw)
    gap_err = max_rel_err(got, plain64(*gargs, cv, cw))
    empty = torch.ones(gu, dtype=torch.bool, device=dev)
    empty[gseg.long()] = False
    if not gap_err < 1e-4 or got[empty].any():
        raise AssertionError(f"factored backward with gaps in seg: "
                             f"{gap_err:.3g} from float64, or a rank "
                             f"without slots is not zero")
    print(f"check: factored backward with seg[0] = 3, gaps and 4 empty "
          f"ranks at the end (U={gu}): {gap_err:.3g} from float64, "
          f"{int(empty.sum())} ranks without slots zero", flush=True)
    del gseg, gargs, got, empty
    times["backward"] = (
        time_ms(lambda: segsum.fm_grad_segsum_factored(*main_case, cv, cw),
                [()]),
        time_ms(lambda: segsum.fm_grad_segsum_factored_reference(
            *main_case, cv, cw), [()]))
    dev_us["backward"] = tuple(
        device_us(lambda: [f(*main_case, cv, cw) for _ in range(5)])[0] / 5
        for f in (segsum.fm_grad_segsum_factored,
                  segsum.fm_grad_segsum_factored_reference))

    # B3's passes apart: device us per call (5 calls), in all, pass 1 and
    # pass 2
    total, events = device_us(lambda: [segsum.fm_grad_segsum_factored(
        *main_case, cv, cw) for _ in range(5)])
    by = {e.key: e.self_device_time_total / 5 for e in events}
    b3_passes = {"all": total / 5,
                 "pass 1": sum(v for k, v in by.items() if "fm_grad" in k),
                 "pass 2": sum(v for k, v in by.items() if "crossing" in k)}
    print(f"time: factored backward at the main path's shape, device us "
          f"per call (torch.profiler): {b3_passes['all']:.2f} (pass 1 "
          f"{b3_passes['pass 1']:.2f}, pass 2 {b3_passes['pass 2']:.2f}); "
          f"{card}", flush=True)
    # what the calls must move: the ladder plans' ids, each distinct row
    # once (the uniques and the fill row) read and written, for the write
    # rows[r] read and table[ids[r]] written; B3 reads vw_u, ex, x and seg
    # and writes (U, 2k+2), ~8 float32 operations per slot and column
    distinct = np.mean([min(int(p.count) + 1, rung) for p in plans])
    call_bytes = {"gather": rung * 4 + distinct * width * 4 + rung * width * 4,
             "write": rung * 4 + 2 * distinct * width * 4,
             "backward": sum(t.numel() * 4 for t in main_case[:4])
             + main_case[4] * (2 * RANK + 2) * 4}
    b3_ops = 8 * main_case[3].numel() * (RANK + 1)
    del main_case
    for name, (ms, plain, *library) in times.items():
        share = bound(call_bytes[name], 0, dev_us[name][0] / 1e3)
        print(f"time: {name} per call at the main path's shape (U={rung}, "
              f"W={width}, N={BATCH * SLOTS}): kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms"
              + (f", library {library[0]:.4f} ms" if library else "")
              + f" back to back (CUDA events, best of 5 windows of 20); "
              f"device {dev_us[name][0]:.2f} us vs {dev_us[name][1]:.2f} us"
              + (f", library {dev_us[name][2]:.2f} us" if library else "")
              + f" (torch.profiler); bound {share['bound_us']:.2f} us "
              f"({call_bytes[name] / 1e6:.2f} MB), "
              f"{pct(share['share_of_bound'])} of it; {card}",
              flush=True)

    # 9. train BASELINE config 3 through train_sgd: the training path's run
    ds = synth.synth_ctr(num_examples=BATCH * 20, num_fields=SLOTS,
                         num_buckets=BUCKETS, seed=SEED)
    sgd = SGDConfig(batch_size=BATCH, learning_rate=0.05,
                    optimizer="adagrad", epochs=2)
    kernels = {"gather_rows": rowio.GATHER, "scatter_set_rows": rowio.SCATTER,
               "fm_grad_segsum_factored": segsum.FACTORED}
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = train_sgd(cfg, sgd, ds, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    steps = sgd.epochs * 20
    if any(n != steps for n in launches.values()):
        raise AssertionError(f"training launches {launches}, expected "
                             f"{steps} of each kernel")
    losses = [h["train_loss"] for h in res.history]
    if not (np.all(np.isfinite(losses)) and losses[1] < losses[0]):
        raise AssertionError(f"training losses {losses}")
    if res.params.v.shape != (BUCKETS, RANK) or not bool(
            torch.isfinite(res.params.v).all()):
        raise AssertionError("trained V is not finite at full shape")
    print(f"train: train_sgd BASELINE config 3, {ds.num_examples} examples "
          f"x {sgd.epochs} epochs = {steps} steps of {BATCH}: epoch losses "
          f"{losses}, {res.examples_per_sec:.0f} ex/s (first step left out)"
          f", {train_s:.3f} s wall in all; launches {launches}; {card}",
          flush=True)
    del res

    # 5 hybrid steps on bench-recipe batches, kernels against plain
    bds = SparseDataset(ids=np.concatenate([zipf_ids(rng, BATCH)
                                            for _ in range(5)]),
                        vals=np.ones((5 * BATCH, SLOTS), np.float32),
                        y=rng.integers(0, 2, 5 * BATCH).astype(np.float32),
                        num_features=BUCKETS)
    batches = list(batch_iterator(bds, BATCH, device=dev,
                                  dedup_budget="ladder", dedup_fill=BUCKETS))
    state = sgd_fused.init_fused_state(cfg, torch.Generator(
        device=dev).manual_seed(SEED + 2), device=dev)
    step = sgd_hybrid.make_hybrid_train_step(cfg, sgd)
    losses, moved = steps_against_plain(
        step, state, batches,
        [(rowio, "gather_rows", rowio.gather_rows_reference),
         (rowio, "scatter_set_rows", rowio.scatter_set_rows_reference),
         (segsum, "fm_grad_segsum_factored", plain64)],
        kernels.values(), "hybrid")
    print(f"check: 5 hybrid steps on bench-recipe batches (uniques "
          f"{[int(b.plan.count) for b in batches]}), each from the same "
          f"state with the kernels and with the plain versions: losses "
          f"{losses} equal (rtol 1e-5), tables [:F, :{used}] equal (rtol "
          f"1e-4, atol 1e-6), {moved} rows updated in all", flush=True)
    torch.cuda.empty_cache()

    # 10. where a training step's time goes
    one = SGDConfig(batch_size=BATCH, learning_rate=0.05, epochs=1)
    t0 = time.perf_counter()
    train_sgd(cfg, one, ds, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, events = device_us(lambda: train_sgd(cfg, one, ds, device=dev))
    top = "; ".join(f"{e.key[:50]} x{e.count} {e.self_device_time_total:.0f}"
                    for e in events[:8])
    print(f"profile: one-epoch train_sgd (20 steps, state init included): "
          f"device busy {busy / 1e3:.3f} ms of {wall * 1e3:.3f} ms untraced "
          f"wall ({100 * (1 - busy / 1e6 / wall):.1f}% idle); top device "
          f"events (us): {top}; {card}", flush=True)
    # the host side of a step, phase by phase, in a loop without prefetch
    spent = collections.defaultdict(float)
    state = sgd_fused.init_fused_state(cfg, device=dev)
    it = batch_iterator(ds, BATCH, device=dev, dedup_budget="ladder",
                        dedup_fill=BUCKETS)
    torch.cuda.synchronize()
    with timed_calls((("host_dedup", E, "host_dedup"),
                      ("plan_to_device", E, "plan_to_device")), spent):
        t0 = time.perf_counter()
        n = 0
        while True:
            tb = time.perf_counter()
            b = next(it, None)
            spent["batch (with plan)"] += time.perf_counter() - tb
            if b is None:
                break
            ts = time.perf_counter()
            state, aux = step(state, b)
            spent["step (host)"] += time.perf_counter() - ts
            n += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    parts = ", ".join(f"{k} {v * 1e3 / n:.3f} ms ({100 * v / wall:.1f}%)"
                      for k, v in spent.items())
    print(f"profile: host wall per step without prefetch "
          f"{wall * 1e3 / n:.3f} ms over {n} steps: {parts} (host_dedup and "
          f"plan_to_device lie inside 'batch'); {card}", flush=True)

    dp_bytes = cap * 4 + 2 * min(dcount + 1, cap) * width * 4
    entries = [
        {"name": "scatter_set_rows", "route": "cuda",
         "source": "sparkfm_tpu_torch/csrc/rowio.cu",
         "replaces": "sparkfm_tpu/ops/pallas_rowio.py:74",
         "launches": launches["scatter_set_rows"],
         "max_abs_err": errs["write"],
         "ms": times["write"][0], "plain_ms": times["write"][1],
         "library_ms": times["write"][2],
         "library": "index_copy_ over the plan's distinct ids",
         "device_ms": dev_us["write"][0] / 1e3,
         "plain_device_ms": dev_us["write"][1] / 1e3,
         "library_device_ms": dev_us["write"][2] / 1e3,
         **bound(call_bytes["write"], 0, dev_us["write"][0] / 1e3),
         "device_plan": {**device_plan, **bound(
             dp_bytes, 0, device_plan["write_device_ms"])}},
        {"name": "fm_grad_segsum_factored", "route": "cuda",
         "source": "sparkfm_tpu_torch/csrc/segsum.cu",
         "replaces": "sparkfm_tpu/ops/pallas_segsum.py:613",
         "launches": launches["fm_grad_segsum_factored"],
         "max_abs_err": main_abs, "max_rel_err": main_err,
         "plain_f32_max_rel_err": main_plain_err,
         "err_against": "plain version in float64",
         "ms": times["backward"][0], "plain_ms": times["backward"][1],
         "library_ms": None, "library": "none (the gradient is formed in "
         "the kernel)", "device_ms": dev_us["backward"][0] / 1e3,
         "plain_device_ms": dev_us["backward"][1] / 1e3,
         "library_device_ms": None,
         **bound(call_bytes["backward"], b3_ops,
                 dev_us["backward"][0] / 1e3),
         "pass1_device_ms": b3_passes["pass 1"] / 1e3,
         "pass2_device_ms": b3_passes["pass 2"] / 1e3}]
    gather_record = {
        "launches_training": launches["gather_rows"],
        "record_max_abs_err": errs["gather"],
        "record_ms": times["gather"][0],
        "record_plain_ms": times["gather"][1],
        "record_device_ms": dev_us["gather"][0] / 1e3,
        "record_plain_device_ms": dev_us["gather"][1] / 1e3,
        "record_bound": bound(call_bytes["gather"], 0,
                              dev_us["gather"][0] / 1e3),
        "device_plan_device_ms": device_plan["gather_device_ms"],
        "device_plan_library_device_ms":
            device_plan["gather_library_device_ms"],
        "device_plan_bound": bound(
            cap * 4 + (min(dcount + 1, cap) + cap) * width * 4, 0,
            device_plan["gather_device_ms"])}
    return entries, gather_record


def als_data():
    """BASELINE config 2's ratings by bench_als's recipe at seed 0: uniform
    users, zipf(1.3) movies hashed into the catalogue, half-star labels."""
    from sparkfm_tpu_torch.data.batching import SparseDataset
    rng = np.random.default_rng(SEED)
    uid = rng.integers(0, ALS_USERS, ALS_N).astype(np.int32)
    mid = ((rng.zipf(1.3, size=ALS_N).astype(np.int64) * 2654435761)
           % ALS_MOVIES).astype(np.int32)
    ids = np.stack([uid, ALS_USERS + mid], axis=1)
    y = (rng.integers(1, 11, ALS_N) * 0.5).astype(np.float32)
    return SparseDataset(ids=ids, vals=np.ones((ALS_N, 2), np.float32), y=y,
                         num_features=ALS_USERS + ALS_MOVIES)


def als_loss(params, ws, cfg):
    """The objective ALS descends, in float64 from the parameters:
    sum (yhat - y)^2 + reg0 w0^2 + reg_w |w|^2 + reg_v |V|^2."""
    present = ws.present.long()
    rank, val = ws.slot_rank.long(), ws.slot_val.double()
    w0 = params.w0.double()
    score = w0 + (params.w.double()[present][rank] * val).sum(0)
    v_c = params.v.double()[present]
    for f in range(v_c.shape[1]):
        vr = v_c[:, f][rank] * val
        score += 0.5 * (vr.sum(0).square() - vr.square().sum(0))
    return float((score - ws.y.double()).square().sum()
                 + cfg.reg0 * w0.square()
                 + cfg.reg_w * params.w.double().square().sum()
                 + cfg.reg_v * params.v.double().square().sum())


def colsums64(streams, seg, num_segments):
    """The stream sums' plain version evaluated in float64 and rounded to
    float32: the oracle of both f32 versions (the f32 plain version's
    atomic adds into a 6.4M-slot run drift)."""
    from sparkfm_tpu_torch.ops import segsum
    return segsum.segment_colsums_reference(
        [s.double() for s in streams], seg, num_segments).float()


def als_phases(dev, gen, card):
    """Phases 11-14, the ALS path; returns the stream-sum kernel's JSON
    entry."""
    from sparkfm_tpu_torch import FM, ALSConfig, FMConfig, train_als
    from sparkfm_tpu_torch.data import split, synth
    from sparkfm_tpu_torch.models import fm as fm_model
    from sparkfm_tpu_torch.ops import segsum
    from sparkfm_tpu_torch.solvers import als as A

    root = os.path.dirname(os.path.abspath(__file__))
    # 11. the data, its workspace (the host parts timed for phase 14)
    t0 = time.perf_counter()
    ds = als_data()
    data_s = time.perf_counter() - t0
    movie_counts = np.bincount(ds.ids[:, 1] - ALS_USERS, minlength=ALS_MOVIES)
    cfg = FMConfig(num_features=ALS_USERS + ALS_MOVIES, num_factors=RANK,
                   reg_w=0.1, reg_v=1.0, seed=SEED)
    host = collections.defaultdict(float)
    parts = [(name, A, name) for name in (
        "slot_blocks", "sort_examples", "csc_view", "to_device",
        "blocks_are_column_pure", "csc_blocks_uniform",
        "csc_slice_identity")]
    with timed_calls(parts, host):
        als_cfg = ALSConfig(epochs=ALS_SWEEPS,
                            feature_blocks=A.slot_blocks(ds))
        t0 = time.perf_counter()
        ws, nb = A.build_workspace(ds, cfg, als_cfg, device=dev)
        torch.cuda.synchronize()
        host["build_workspace"] = time.perf_counter() - t0
        bof, _ = A.feature_blocks_of(cfg.num_features, als_cfg)
        cpure = A.blocks_are_column_pure(ds, bof)
        uniform = cpure and A.csc_blocks_uniform(ds, bof)
        ident = A.csc_slice_identity(ws, nb, ALS_N) if uniform else ()
    n_ranks = int(ws.present.shape[0])
    print(f"als: BASELINE config 2 data ({ALS_N} ratings, {ALS_USERS} users, "
          f"{int((movie_counts > 0).sum())} of {ALS_MOVIES} movies rated, "
          f"head movie {int(movie_counts.max())} ratings = "
          f"{movie_counts.max() / ALS_N:.4f}) made in {data_s:.2f} s; "
          f"{n_ranks} present features, {nb} slot blocks; column_pure "
          f"{cpure}, csc_uniform {uniform}, slice_identity {ident}",
          flush=True)
    if (cpure, uniform, ident) != (True, True, (True, False)):
        raise AssertionError("BASELINE config 2 must sweep as column_pure, "
                             "csc_uniform, slice_identity (True, False)")

    # the stream-sum kernel against its plain version in float64: the
    # movie block's real ranks, the user block's, odd shapes
    checked = []

    def hold(streams, seg, u, label):
        exact = segsum.segment_colsums_reference(
            [x.double() for x in streams], seg, u)
        got = segsum.segment_colsums(streams, seg, u)
        err = max_rel_err(got, exact)
        plain_err = max_rel_err(
            segsum.segment_colsums_reference(streams, seg, u), exact)
        if not err < 1e-4:
            raise AssertionError(f"stream-sum kernel off at {label}: {err:.3g}"
                                 f" from the float64 sums (plain f32 "
                                 f"{plain_err:.3g})")
        if not torch.equal(got, segsum.segment_colsums(streams, seg, u)):
            raise AssertionError(f"stream sums do not repeat at {label}")
        empty = torch.ones(u, dtype=torch.bool, device=dev)
        empty[seg.long()] = False
        if got[empty].any():
            raise AssertionError(f"a rank without slots is not zero at "
                                 f"{label}")
        checked.append(f"{label}: kernel {err:.3g}, plain f32 {plain_err:.3g}")
        return float((got.double() - exact).abs().max()), err, plain_err

    seg_user, seg_movie = ws.col_rank[:ALS_N], ws.col_rank[ALS_N:]
    # the CSC ranks from the user block's last slot on: a view 4 bytes
    # short of a 16-byte bound, as the sweep's block slices are when N % 4
    # != 0 (still sorted: every user rank is below every movie rank)
    seg_odd = ws.col_rank[ALS_N - 1:2 * ALS_N - 1]
    if seg_odd.data_ptr() % 16 == 0:
        raise AssertionError("the offset seg slice is 16-byte aligned")
    streams = [torch.randn(ALS_N, generator=gen, device=dev)
               for _ in range(5)]
    main_abs, main_err, main_plain_err = hold(
        streams, seg_movie, n_ranks, f"movie block N={ALS_N} S=5")
    hold(streams[:1], seg_movie, n_ranks, "movie block S=1")
    hold(streams, seg_user, n_ranks, "user block S=5")
    hold(streams[:1], seg_user, n_ranks, "user block S=1")
    hold(streams, seg_odd, n_ranks,
         f"seg at byte offset {seg_odd.data_ptr() % 16} past a 16-byte bound "
         f"S=5")
    rng = np.random.default_rng(SEED + 3)
    for n, width, kind in ((1, 1, "runs"), (1000, 16, "runs"),
                           (3073, 5, "runs"), (1 << 20, 5, "one run"),
                           (4097, 16, "unique"), (100003, 1, "unique")):
        if kind == "runs":                   # seg[0] > 0 and gaps
            seg = 3 + np.cumsum(rng.integers(0, 3, n) * (rng.random(n) < 0.4))
        elif kind == "one run":
            seg = np.full(n, 2)
        else:
            seg = np.arange(n)
        seg = torch.as_tensor(seg.astype(np.int32), device=dev)
        hold([torch.randn(n, generator=gen, device=dev) for _ in range(width)],
             seg, int(seg[-1]) + 3, f"N={n} S={width} {kind}")
    child = subprocess.run([sys.executable, "-c", COLSUMS_TRAP_CHILD],
                           cwd=root, capture_output=True, text=True,
                           timeout=300)
    if child.returncode != 3:
        raise AssertionError("out-of-range rank did not trap: rc "
                             f"{child.returncode}\n{child.stdout}"
                             f"{child.stderr[-2000:]}")
    print(f"check: stream-sum kernel against the plain version in float64, "
          f"max |a-b|/(1+|b|) < 1e-4: {'; '.join(checked)}; sums repeat "
          f"exactly; ranks without slots are zero; out-of-range rank -> "
          f"{child.stdout.strip()}", flush=True)
    # device time per call by kernel, pass 1 and pass 2, against the bound:
    # S + 1 arrays of N read once, (U, S) written once, S adds per slot
    def passes(fn):
        """Device us per call of ``fn``: in all (``spun_ms``), and pass 1
        and pass 2 as a torch.profiler trace of 5 calls splits them."""
        total = 1e3 * spun_ms(fn)
        _, events = device_us(lambda: [fn() for _ in range(5)])
        by = {e.key: e.self_device_time_total / 5 for e in events}
        return (total,
                sum(v for k, v in by.items() if "colsums_chunks" in k),
                sum(v for k, v in by.items() if "colsums_crossing" in k))

    def b7_bound(s, us):
        return bound(4 * ((s + 1) * ALS_N + n_ranks * s), s * ALS_N,
                     us / 1e3)

    args = (streams, seg_movie, n_ranks)
    ms = (time_ms(segsum.segment_colsums, [args], reps=10, windows=3),
          time_ms(segsum.segment_colsums_reference, [args], reps=10,
                  windows=3))
    blocks = {label: {s: passes(lambda: segsum.segment_colsums(
        streams[:s], sg, n_ranks)) for s in (5, 1)}
        for label, sg in (("movie", seg_movie), ("user", seg_user),
                          ("offset", seg_odd))}
    plain_us = tuple(1e3 * spun_ms(lambda sg=sg: segsum.segment_colsums_reference(
        streams, sg, n_ranks), reps=2, windows=2) for sg in (seg_movie, seg_user))
    lines = []
    for label, by_s in blocks.items():
        for s, (us, p1, p2) in by_s.items():
            share = b7_bound(s, us)
            lines.append(f"{label} S={s} {us:.2f} us (pass 1 {p1:.2f}, "
                         f"pass 2 {p2:.2f}), bound {share['bound_us']:.2f} "
                         f"us, {pct(share['share_of_bound'])}")
    print(f"time: stream sums per call (N={ALS_N}, head run "
          f"{int(movie_counts.max())}): kernel {ms[0]:.4f} ms, plain "
          f"{ms[1]:.4f} ms back to back at the movie block S=5 (CUDA events, "
          f"best of 3 windows of 10); device (CUDA events, the calls "
          f"queued behind a spin kernel; passes split by torch.profiler): "
          + "; ".join(lines) + f"; plain movie {plain_us[0]:.2f} us, user "
          f"{plain_us[1]:.2f} us; {card}", flush=True)
    del streams, args

    # 12. one sweep with the kernel and one with the float64 plain version
    # swapped in, from the same parameters
    p0 = fm_model.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), device=dev)
    rw, rv = (torch.as_tensor(r, device=dev) for r in cfg.reg_vectors())

    def sweep(p):
        return A.als_sweep_compact(p, ws, nb, n_ranks, cfg.reg0, rw, rv,
                                   column_pure=cpure, csc_uniform=uniform,
                                   slice_identity=ident)

    loss0 = als_loss(p0, ws, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_kernel = sweep(p0)
    torch.cuda.synchronize()
    first_sweep_s = time.perf_counter() - t0
    count = segsum.COLSUMS.launches
    with swapped([(segsum, "segment_colsums", colsums64)]):
        p_plain = sweep(p0)
    if segsum.COLSUMS.launches != count:
        raise AssertionError("the plain sweep launched the kernel")
    loss_k, loss_p = als_loss(p_kernel, ws, cfg), als_loss(p_plain, ws, cfg)
    if abs(loss_k - loss_p) > 1e-6 * abs(loss_p):
        raise AssertionError(f"sweep losses differ: kernel {loss_k}, plain "
                             f"{loss_p}")
    # Entries must agree at rtol 1e-3, atol 1e-4, except guard flips: a
    # feature rated once has den = (q - v)^2 formed from the factored sums
    # q^2 - 2vq + v^2, which rounds to <= 0 or just above it depending on
    # the last bits of the sums, and den > 0 decides whether the
    # coordinate moves at all. A flip leaves the entry at its initial
    # value on one side only; anything else beyond tolerance fails.
    flips = 0
    for name in ("w", "v"):
        a, b, a0 = (getattr(p, name) for p in (p_kernel, p_plain, p0))
        bad = (a - b).abs() > 1e-4 + 1e-3 * b.abs()
        flip = (a == a0) ^ (b == a0)
        if (bad & ~flip).any():
            raise AssertionError(f"sweep {name}: {int((bad & ~flip).sum())} "
                                 "entries differ beyond tolerance")
        flips += int((bad & flip).sum())
    if flips > 1e-4 * p0.v.numel():
        raise AssertionError(f"{flips} guard flips between the sweeps")
    np.testing.assert_allclose(float(p_kernel.w0), float(p_plain.w0),
                               rtol=1e-6)
    print(f"check: one sweep with the kernel vs with the float64 plain "
          f"version from the same parameters: losses {loss_k:.10g} vs "
          f"{loss_p:.10g} (rtol 1e-6); w, V equal at rtol 1e-3, atol 1e-4 "
          f"but for {flips} den > 0 guard flips (<= 1e-4 of V's entries); "
          f"first sweep {first_sweep_s:.3f} s", flush=True)
    del p_plain

    # train_als, 3 sweeps: the ALS path's run; the parameters after each
    # sweep are kept for the loss
    after = []
    sweep_fn = A.als_sweep_compact

    def keeping(*a, **k):
        out = sweep_fn(*a, **k)
        after.append(tuple(t.detach().clone() for t in (out.w0, out.w,
                                                        out.v)))
        return out

    torch.cuda.synchronize()
    segsum.COLSUMS.launches = 0
    with swapped([(A, "als_sweep_compact", keeping)]):
        t0 = time.perf_counter()
        res = train_als(cfg, als_cfg, ds, params=p0, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    launches = segsum.COLSUMS.launches
    expected = ALS_SWEEPS * (RANK + 1) * nb
    if launches != expected:
        raise AssertionError(f"train_als launched the stream-sum kernel "
                             f"{launches} times, expected {expected}")
    losses = [als_loss(fm_model.FMParams(*t), ws, cfg) for t in after]
    if not (np.all(np.isfinite(losses)) and losses[0] < loss0
            and losses[-1] < losses[0]):
        raise AssertionError(f"ALS losses {loss0} -> {losses}")
    if not all(bool(torch.isfinite(t).all()) for t in (
            res.params.w0, res.params.w, res.params.v)):
        raise AssertionError("ALS parameters are not finite")
    sweep_ms = 1e3 * ALS_N / res.examples_per_sec
    print(f"train: train_als BASELINE config 2, {ALS_SWEEPS} sweeps of "
          f"{ALS_N} ratings: regularized loss (float64) {loss0:.10g} -> "
          f"{' -> '.join(f'{x:.10g}' for x in losses)}; "
          f"{res.examples_per_sec:.0f} swept ex/s, {sweep_ms:.3f} ms per "
          f"sweep ({train_s:.3f} s wall with the workspace build and its "
          f"checks); launches {launches}; {card}", flush=True)
    del res, after

    # 13. the facade on the card
    mds = synth.synth_movielens(60, 80, 8000, rank=3, noise=0.1, seed=0)
    coll = split.split_by_random(mds, 0.8, 0.2, seed=0)
    count = segsum.COLSUMS.launches
    model = FM(num_factors=8, solver="als", max_iter=8, reg_w=0.1,
               reg_v=0.5).fit(coll.training, eval_ds=coll.test, device=dev)
    facade_launches = segsum.COLSUMS.launches - count
    rmses = [h["eval_rmse"] for h in model.history]
    base = float(np.std(coll.test.y))
    if not (model.device == dev and facade_launches == 8 * 9 * 2
            and rmses[-1] < 0.7 * base and rmses[-1] < rmses[0]):
        raise AssertionError(f"FM(solver='als') on the card: eval RMSE "
                             f"{rmses} against std {base}, "
                             f"{facade_launches} launches")
    print(f"check: FM(solver='als').fit on the card (synth_movielens 60x80, "
          f"8000 ratings, 8 sweeps): eval RMSE {rmses[0]:.4f} -> "
          f"{rmses[-1]:.4f} < 0.7 x std {base:.4f}; {facade_launches} "
          f"launches", flush=True)

    # 14. where an ALS sweep's time goes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep(p0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, events = device_us(lambda: sweep(p0))
    top = "; ".join(f"{e.key[:50]} x{e.count} {e.self_device_time_total:.0f}"
                    for e in events[:8])
    sweep_b7 = {name: (sum(e.self_device_time_total for e in events
                           if key in e.key),
                       sum(e.count for e in events if key in e.key))
                for name, key in (("pass 1", "colsums_chunks"),
                                  ("pass 2", "colsums_crossing"))}
    print(f"profile: one ALS sweep: device busy {busy / 1e3:.3f} ms of "
          f"{wall * 1e3:.3f} ms untraced wall ({100 * (1 - busy / 1e6 / wall):.1f}"
          f"% idle); stream sums "
          + ", ".join(f"{k} {v[0] / 1e3:.3f} ms x{v[1]}"
                      for k, v in sweep_b7.items())
          + f"; top device events (us): {top}; {card}", flush=True)
    build = host["build_workspace"]
    inner = ("sort_examples", "csc_view", "to_device")
    rest = build - sum(host[k] for k in inner)
    print(f"profile: host time of the ALS set-up: slot_blocks "
          f"{host['slot_blocks']:.3f} s; build_workspace {build:.3f} s = "
          + ", ".join(f"{k} {host[k]:.3f} s" for k in inner)
          + f", other (block map, den_w, ranks) {rest:.3f} s; structure "
          f"checks: " + ", ".join(f"{k} {host[k]:.3f} s" for k in (
              "blocks_are_column_pure", "csc_blocks_uniform",
              "csc_slice_identity")) + " (host CPU)", flush=True)
    return {"name": "segment_colsums", "route": "cuda",
            "source": "sparkfm_tpu_torch/csrc/segsum.cu",
            "replaces": "sparkfm_tpu/ops/pallas_segsum.py:808",
            "launches": launches, "launches_facade": facade_launches,
            "max_abs_err": main_abs, "max_rel_err": main_err,
            "plain_f32_max_rel_err": main_plain_err,
            "err_against": "plain version in float64",
            "ms": ms[0], "plain_ms": ms[1], "library_ms": None,
            "library": "none (S separate streams summed per rank)",
            "device_ms": blocks["movie"][5][0] / 1e3,
            "plain_device_ms": plain_us[0] / 1e3, "library_device_ms": None,
            **b7_bound(5, blocks["movie"][5][0]),
            "device_us_by_block": {
                f"{label} S={s}": {"all": t[0], "pass 1": t[1], "pass 2": t[2],
                                   "share_of_bound": b7_bound(
                                       s, t[0])["share_of_bound"]}
                for label, by_s in blocks.items() for s, t in by_s.items()},
            "plain_device_us_user": plain_us[1],
            "sweep_device_ms": {k: v[0] / 1e3 for k, v in sweep_b7.items()},
            "sweep_launches": {k: v[1] for k, v in sweep_b7.items()}}


SEGSUM_TRAP_CHILD = """
import sys, torch
from sparkfm_tpu_torch.ops import segsum
seg = torch.tensor([0, 1, 1, 5], dtype=torch.int32, device="cuda")
ones = lambda *shape: torch.ones(shape, device="cuda")
try:
    {call}
    torch.cuda.synchronize()
except RuntimeError as e:
    if "unspecified launch failure" not in str(e):   # not the trap
        raise
    print("trapped:", str(e).splitlines()[0])
    sys.exit(3)
print("no trap")
"""
SEGSUM_TRAP_CALLS = {
    "segment_rowsum": "segsum.segment_rowsum(ones(4, 3), seg, 5)",
    "segment_rowsum_sq": "segsum.segment_rowsum_sq(ones(4, 3), seg, 5)",
    "fm_grad_segsum": "segsum.fm_grad_segsum(ones(4, 5), ones(4, 6), "
                      "ones(4), seg, 5, 1e-3, 1e-3)"}


def traps(names, root):
    """Run each named kernel on a rank outside [0, U) in a child process
    (a trap leaves the CUDA context of its process unusable), all children
    at once; returns each child's report. Raises if one did not trap."""
    children = {name: subprocess.Popen(
        [sys.executable, "-c",
         SEGSUM_TRAP_CHILD.format(call=SEGSUM_TRAP_CALLS[name])], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in names}
    out = {}
    for name, child in children.items():
        stdout, stderr = child.communicate(timeout=300)
        if child.returncode != 3:
            raise AssertionError(f"{name}: out-of-range rank did not trap: "
                                 f"rc {child.returncode}\n{stdout}"
                                 f"{stderr[-2000:]}")
        out[name] = stdout.strip()
    return out


def rowsum64(g, seg, num_segments):
    """B5's plain version evaluated in float64 and rounded to float32: the
    plain step's reduce (the f32 plain version's atomic adds into the
    162k-slot head run drift, as B3's do)."""
    from sparkfm_tpu_torch.ops import segsum
    return segsum.segment_rowsum_reference(g.double(), seg,
                                           num_segments).float()


def as64(a):
    return a.double() if torch.is_tensor(a) and a.is_floating_point() else a


def segsum_phases(dev, cfg, gen, rng, card):
    """Phases 15-18: the row sums (B5), the fused and sorted SGD paths on
    them, the unfactored backward (B4) and the row sums with squares (B6);
    and where the time of the four SGD paths goes. Returns the kernels'
    JSON entries for B4, B5 and B6."""
    from sparkfm_tpu_torch import SGDConfig, train_sgd
    from sparkfm_tpu_torch.data import synth
    from sparkfm_tpu_torch.data.batching import (SparseDataset,
                                                 batch_iterator)
    from sparkfm_tpu_torch.ops import embedding as E
    from sparkfm_tpu_torch.ops import rowio, segsum
    from sparkfm_tpu_torch.solvers import sgd_fused, sgd_sorted

    root = os.path.dirname(os.path.abspath(__file__))
    cap = E.auto_budget(BATCH * SLOTS)
    plan = E.host_dedup(zipf_ids(rng, BATCH), cap, fill=BUCKETS,
                        vals=np.ones((BATCH, SLOTS), np.float32))
    u = E.ladder_budget(int(plan.count), cap=cap)
    seg = torch.as_tensor(plan.seg, device=dev)
    n = seg.shape[0]
    edges = np.flatnonzero(np.r_[True, plan.seg[1:] != plan.seg[:-1], True])
    head = int(np.diff(edges).max())

    def hold(fn, plain, args, label, checked):
        """``fn`` against ``plain`` in float64 on ``args`` (max |a - b| /
        (1 + |b|) < 1e-4), repeated bitwise, ranks without slots zero;
        returns (max abs error, max rel error, the f32 plain version's)."""
        exact = plain(*[as64(a) for a in args])
        got = fn(*args)
        err = max_rel_err(got, exact)
        plain_err = max_rel_err(plain(*args), exact)
        if not err < 1e-4:
            raise AssertionError(f"{label}: kernel {err:.3g} from the float64 "
                                 f"sums (plain f32 {plain_err:.3g})")
        if not torch.equal(got, fn(*args)):
            raise AssertionError(f"{label}: sums do not repeat")
        ranks = args[3] if len(args) > 3 else args[1]
        empty = torch.ones(got.shape[0], dtype=torch.bool, device=dev)
        empty[ranks.long()] = False
        if got[empty].any():
            raise AssertionError(f"{label}: a rank without slots is not zero")
        checked.append(f"{label}: kernel {err:.3g}, plain f32 "
                       f"{plain_err:.3g}")
        return float((got.double() - exact).abs().max()), err, plain_err

    # 15. B5 against its float64 plain version: the fused and sorted
    # payloads at the main path's plan, then odd shapes
    checked = []
    g66 = torch.randn((n, 2 * RANK + 2), generator=gen, device=dev)
    rowsum_main = hold(segsum.segment_rowsum,
                       segsum.segment_rowsum_reference, (g66, seg, u),
                       f"W=66 N={n} U={u}", checked)
    for w in (RANK + 3, 1, 3, 130, 354):
        g = torch.randn((n, w), generator=gen, device=dev)
        hold(segsum.segment_rowsum, segsum.segment_rowsum_reference,
             (g, seg, u), f"W={w}", checked)
    del g
    gaps = seg + torch.cumsum((torch.rand(n, generator=gen, device=dev)
                               < 0.05).int(), 0, dtype=torch.int32)
    odd = 100003
    for label, s in (("seg[0] = 5", seg + 5), ("gaps", gaps),
                     (f"N={odd}", seg[:odd])):
        hold(segsum.segment_rowsum, segsum.segment_rowsum_reference,
             (g66[:s.shape[0]], s, int(s[-1]) + 3), label, checked)
    trapped = traps(["segment_rowsum"], root)
    print(f"check: row-sum kernel (B5) against the plain version in float64, "
          f"max |a-b|/(1+|b|) < 1e-4, on a bench-recipe plan (head run "
          f"{head} slots): {'; '.join(checked)}; sums repeat exactly; ranks "
          f"without slots are zero; out-of-range rank -> "
          f"{trapped['segment_rowsum']}", flush=True)

    # 16. the fused path at BASELINE config 3: train_sgd, then 5 steps
    # against the plain versions, then steps on plans built on the card
    ds = synth.synth_ctr(num_examples=BATCH * 20, num_fields=SLOTS,
                         num_buckets=BUCKETS, seed=SEED)
    bds = SparseDataset(ids=np.concatenate([zipf_ids(rng, BATCH)
                                            for _ in range(5)]),
                        vals=np.ones((5 * BATCH, SLOTS), np.float32),
                        y=rng.integers(0, 2, 5 * BATCH).astype(np.float32),
                        num_features=BUCKETS)
    batches = list(batch_iterator(bds, BATCH, device=dev,
                                  dedup_budget="ladder", dedup_fill=BUCKETS))
    kernels = {"gather_rows": rowio.GATHER, "scatter_set_rows": rowio.SCATTER,
               "segment_rowsum": segsum.ROWSUM,
               "fm_grad_segsum_factored": segsum.FACTORED}
    plain_swaps = [(rowio, "gather_rows", rowio.gather_rows_reference),
                   (rowio, "scatter_set_rows",
                    rowio.scatter_set_rows_reference),
                   (segsum, "segment_rowsum", rowsum64)]
    steps = 2 * 20
    train_launches = {}

    def train(label, **kw):
        sgd = SGDConfig(batch_size=BATCH, learning_rate=0.05,
                        optimizer="adagrad", epochs=2, **kw)
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        res = train_sgd(cfg, sgd, ds, generator=torch.Generator(
            device=dev).manual_seed(SEED), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        want = dict.fromkeys(kernels, steps)
        want["fm_grad_segsum_factored"] = 0
        if launches != want:
            raise AssertionError(f"{label} training launches {launches}, "
                                 f"expected {want}")
        losses = [h["train_loss"] for h in res.history]
        if not (np.all(np.isfinite(losses)) and losses[1] < losses[0]):
            raise AssertionError(f"{label} training losses {losses}")
        if not bool(torch.isfinite(res.params.v).all()):
            raise AssertionError(f"{label}: trained V is not finite")
        print(f"train: train_sgd BASELINE config 3 on the {label} path, "
              f"{ds.num_examples} examples x 2 epochs = {steps} steps of "
              f"{BATCH}: epoch losses {losses}, {res.examples_per_sec:.0f} "
              f"ex/s (first step left out), {wall:.3f} s wall in all; "
              f"launches {launches}; {card}", flush=True)
        train_launches[label] = launches["segment_rowsum"]

    def init_state():
        return sgd_fused.init_fused_state(cfg, torch.Generator(
            device=dev).manual_seed(SEED + 2), device=dev)

    # accumulate="auto", the default: B5 on the card
    train("fused (auto)", update_path="fused")
    fused_cfg = SGDConfig(batch_size=BATCH, learning_rate=0.05,
                          update_path="fused")
    losses, moved = steps_against_plain(
        sgd_fused.make_fused_train_step(cfg, fused_cfg), init_state(),
        batches, plain_swaps, kernels.values(), "fused")
    print(f"check: 5 fused (auto) steps on bench-recipe batches, each from "
          f"the same state with the kernels and with the plain versions: "
          f"losses {losses} equal (rtol 1e-5), tables equal (rtol 1e-4, "
          f"atol 1e-6), {moved} rows updated in all", flush=True)
    torch.cuda.empty_cache()
    device_runs = []
    for accumulate in ("auto", "segsum", "scatter"):
        step = sgd_fused.make_fused_train_step(cfg, dataclasses.replace(
            fused_cfg, host_plan=False, accumulate=accumulate))
        state = init_state()
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        run = []
        for b in batches[:3]:
            state, aux = step(state, dataclasses.replace(b, plan=None))
            run.append(aux)
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        want = {"gather_rows": 3, "scatter_set_rows": 3,
                "segment_rowsum": 0 if accumulate == "scatter" else 3,
                "fm_grad_segsum_factored": 0}
        run_losses = [float(a["loss"]) for a in run]
        if launches != want or not np.all(np.isfinite(run_losses)) or any(
                bool(a["unique_overflow"]) for a in run):
            raise AssertionError(f"device-plan fused steps ({accumulate}): "
                                 f"launches {launches}, losses {run_losses}")
        # "auto" is B5 on the card: the same steps as "segsum", bit for bit
        if accumulate == "auto":
            first = state.table.clone()
        elif accumulate == "segsum" and not torch.equal(first, state.table):
            raise AssertionError("accumulate='auto' and 'segsum' differ on "
                                 "the card")
        # the first step starts from the host-plan run's initial state
        np.testing.assert_allclose(run_losses[0], losses[0], rtol=1e-5)
        device_runs.append(f"{accumulate}: losses {run_losses}, uniques "
                           f"{[int(a['unique_count']) for a in run]} of a "
                           f"{cap}-slot budget, launches {launches}")
        del state
    del first
    print(f"check: 3 fused steps on plans built on the card (host_plan=False)"
          f": {'; '.join(device_runs)}; first losses equal the host-plan "
          f"step's (rtol 1e-5); 'auto' and 'segsum' tables equal bit for "
          f"bit", flush=True)
    torch.cuda.empty_cache()

    # 17. the sorted path: train_sgd, then 5 steps against the plain
    # versions
    train("sorted", update_path="sorted")
    losses, moved = steps_against_plain(
        sgd_sorted.make_sorted_train_step(cfg, dataclasses.replace(
            fused_cfg, update_path="sorted")), init_state(),
        batches, plain_swaps, kernels.values(), "sorted")
    print(f"check: 5 sorted steps on bench-recipe batches, each from the "
          f"same state with the kernels and with the plain versions: losses "
          f"{losses} equal (rtol 1e-5), tables equal (rtol 1e-4, atol 1e-6)"
          f", {moved} rows updated in all", flush=True)
    torch.cuda.empty_cache()

    # 18. B6 and B4 against their float64 plain versions on the phase-15
    # plan, B4 against B3 on the rows B4's per-slot rows expand
    checked, gaps_b3 = [], []
    cv = torch.tensor(2e-6 / BATCH, device=dev)
    cw = torch.tensor(2e-6 / BATCH, device=dev)
    for k in (RANK, 4, 33):
        g = torch.randn((n, k + 1), generator=gen, device=dev)
        res_sq = hold(segsum.segment_rowsum_sq,
                      segsum.segment_rowsum_sq_reference, (g, seg, u),
                      f"B6 W={k + 1}", checked)
        vw_u = 0.01 * torch.randn((u, k + 1), generator=gen, device=dev)
        ex = torch.randn((n, k + 2), generator=gen, device=dev)
        ex[:, k + 1] = (torch.rand(n, generator=gen, device=dev) < 0.9)
        x = torch.randn(n, generator=gen, device=dev)
        args = (vw_u.index_select(0, seg.long()), ex, x, seg, u, cv, cw)
        res_b4 = hold(segsum.fm_grad_segsum, segsum.fm_grad_segsum_reference,
                      args, f"B4 k={k}", checked)
        factored = segsum.fm_grad_segsum_factored(vw_u, ex, x, seg, u, cv, cw)
        gap = max_rel_err(segsum.fm_grad_segsum(*args), factored.double())
        if not gap < 1e-6:
            raise AssertionError(f"B4 differs from B3 by {gap:.3g} at k={k}")
        gaps_b3.append(f"k={k} {gap:.3g}")
        if k == RANK:
            sq_res, b4_res = res_sq, res_b4
            main = {"sq": (g, seg, u), "b4": args}
    trapped = traps(["segment_rowsum_sq", "fm_grad_segsum"], root)
    # B4 and B6 have no production path in either package: their launch
    # counts come from one call each at the main path's shapes
    driven = {}
    for name, kernel, fn, args in (
            ("segment_rowsum_sq", segsum.ROWSUM_SQ, segsum.segment_rowsum_sq,
             main["sq"]),
            ("fm_grad_segsum", segsum.FM_GRAD, segsum.fm_grad_segsum,
             main["b4"])):
        torch.cuda.synchronize()
        kernel.launches = 0
        fn(*args)
        torch.cuda.synchronize()
        driven[name] = kernel.launches
    print(f"check: B6 and B4 against their plain versions in float64, max "
          f"|a-b|/(1+|b|) < 1e-4: {'; '.join(checked)}; sums repeat exactly; "
          f"B4 vs B3 on the same rows (< 1e-6): {', '.join(gaps_b3)}; "
          f"out-of-range rank -> {trapped}", flush=True)

    # profile: the three kernels per call, then one epoch of each SGD path
    timed = {
        "segment_rowsum": (segsum.segment_rowsum,
                           segsum.segment_rowsum_reference, (g66, seg, u)),
        "segment_rowsum_sq": (segsum.segment_rowsum_sq,
                              segsum.segment_rowsum_sq_reference,
                              main["sq"]),
        "fm_grad_segsum": (segsum.fm_grad_segsum,
                           segsum.fm_grad_segsum_reference, main["b4"])}
    # what each call must move and compute: its inputs read once, its
    # (U, width) output written once; float32 adds (B5), adds and squares
    # (B6), ~8 operations per slot and column (B4)
    sq_g, b4_args = main["sq"][0], main["b4"]
    cost = {"segment_rowsum": (4 * (g66.numel() + n + u * g66.shape[1]),
                               g66.numel()),
            "segment_rowsum_sq": (4 * (sq_g.numel() + n
                                       + 2 * u * sq_g.shape[1]),
                                  3 * sq_g.numel()),
            "fm_grad_segsum": (4 * (sum(t.numel() for t in b4_args[:4])
                                    + u * (2 * RANK + 2)),
                               8 * n * (RANK + 1))}
    # the one library call that computes B5's function: index_add_ of the
    # rows into a zeroed (U, W)
    lib_out = torch.zeros((u, g66.shape[1]), device=dev)
    seg_l = seg.long()

    def index_add():
        return lib_out.index_add_(0, seg_l, g66)
    times = {}
    for name, (fn, plain, args) in timed.items():
        ms = (time_ms(fn, [args]), time_ms(plain, [args]))
        us = tuple(1e3 * spun_ms(lambda f=f: f(*args)) for f in (fn, plain))
        library = (None, None)
        if name == "segment_rowsum":
            library = (time_ms(index_add, [()]), 1e3 * spun_ms(index_add))
        times[name] = ms + us + library
        share = bound(*cost[name], us[0] / 1e3)
        print(f"time: {name} per call (N={n}, U={u}, head run {head}): "
              f"kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms"
              + (f", index_add_ {library[0]:.4f} ms" if library[0] else "")
              + f" back to back (CUDA events, best of 5 windows of 20); "
              f"device {us[0]:.2f} us vs {us[1]:.2f} us"
              + (f", index_add_ {library[1]:.2f} us" if library[1] else "")
              + f" (CUDA events, the calls queued behind a spin kernel); "
              f"bound {share['bound_us']:.2f} us "
              f"({cost[name][0] / 1e6:.2f} MB), "
              f"{pct(share['share_of_bound'])} of it; {card}",
              flush=True)
    del lib_out, seg_l
    del g66, timed, main
    torch.cuda.empty_cache()
    for label, kw in (("hybrid", dict(update_path="hybrid")),
                      ("fused, host plans", dict(update_path="fused")),
                      ("fused, device plans", dict(update_path="fused",
                                                   host_plan=False)),
                      ("sorted", dict(update_path="sorted"))):
        one = SGDConfig(batch_size=BATCH, learning_rate=0.05, epochs=1, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_sgd(cfg, one, ds, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy, events = device_us(lambda: train_sgd(cfg, one, ds, device=dev))
        top = "; ".join(f"{e.key[:50]} x{e.count} "
                        f"{e.self_device_time_total:.0f}" for e in events[:8])
        print(f"profile: one-epoch train_sgd, {label} (20 steps, state init "
              f"included): {res.examples_per_sec:.0f} ex/s (first step left "
              f"out); device busy {busy / 1e3:.3f} ms of {wall * 1e3:.3f} ms "
              f"untraced wall ({100 * (1 - busy / 1e6 / wall):.1f}% idle); top "
              f"device events (us): {top}; {card}", flush=True)
        del res

    def entry(name, line, res, t, library, **extra):
        return {"name": name, "route": "cuda",
                "source": "sparkfm_tpu_torch/csrc/segsum.cu",
                "replaces": f"sparkfm_tpu/ops/pallas_segsum.py:{line}",
                **extra, "max_abs_err": res[0], "max_rel_err": res[1],
                "plain_f32_max_rel_err": res[2],
                "err_against": "plain version in float64",
                "ms": t[0], "plain_ms": t[1], "library_ms": t[4],
                "library": library, "device_ms": t[2] / 1e3 if t[2] else None,
                "plain_device_ms": t[3] / 1e3 if t[3] else None,
                "library_device_ms": t[5] / 1e3 if t[5] else None,
                **bound(*cost[name], t[2] / 1e3)}

    no_path = ("none in either package; launches are one call at the main "
               "path's shapes (phase 18)")
    in_kernel = "none (the gradient is formed in the kernel)"
    return [
        entry("fm_grad_segsum", 418, b4_res, times["fm_grad_segsum"],
              in_kernel, launches=driven["fm_grad_segsum"], path=no_path),
        entry("segment_rowsum", 101, rowsum_main, times["segment_rowsum"],
              "index_add_", launches=train_launches["fused (auto)"],
              launches_sorted=train_launches["sorted"],
              path="train_sgd fused, accumulate='auto' (B5 on the card, "
                   "phase 16), sorted (phase 17)"),
        entry("segment_rowsum_sq", 238, sq_res, times["segment_rowsum_sq"],
              "none (the squares are formed in the kernel)",
              launches=driven["segment_rowsum_sq"], path=no_path)]


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from sparkfm_tpu_torch import FMConfig, FMModel, MicroBatcher, Task
    from sparkfm_tpu_torch.data import native_io
    from sparkfm_tpu_torch.data.batching import SparseDataset
    from sparkfm_tpu_torch.models import fm as fm_model
    from sparkfm_tpu_torch.ops import embedding as E
    from sparkfm_tpu_torch.ops import interaction as I
    from sparkfm_tpu_torch.ops import rowio, segsum

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(f"device: {name}; nvidia-smi: {smi}", flush=True)

    # 1. build every kernel library at once, one nvcc per source
    build_s = build_all([rowio.GATHER, segsum.FACTORED])
    rowio.SCATTER.build()                      # the same library as GATHER
    for kernel in (segsum.FM_GRAD, segsum.ROWSUM, segsum.ROWSUM_SQ,
                   segsum.COLSUMS):
        kernel.build()                         # the same library as FACTORED
    for kernel in (rowio.GATHER, segsum.FACTORED):
        print(f"build: {os.path.relpath(kernel.source, root)} -> "
              f"{os.path.relpath(kernel.path, root)}; ptxas: "
              f"{ptxas_summary(kernel.path)}", flush=True)
    print(f"build: both CUDA sources in {build_s:.2f} s (in parallel)",
          flush=True)
    # every host plan below must come from the native builder: its numpy
    # path has the same semantics but is several times slower
    t0 = time.perf_counter()
    if not native_io.available():
        raise AssertionError("native dedup_plan.cpp did not build; host "
                             "plans would take the numpy path")
    print(f"build: native dedup_plan.cpp (g++) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # the model: BASELINE config 3 at full width, random weights
    cfg = FMConfig(num_features=BUCKETS, num_factors=RANK,
                   task=Task.CLASSIFICATION, reg_w=1e-6, reg_v=1e-6,
                   seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = fm_model.init_params(cfg, gen, device=dev)
    # a non-zero linear term, so the w column's gather matters
    params.w.normal_(0.0, 0.1, generator=gen)
    rng = np.random.default_rng(SEED)

    # 2. the gathers against their plain versions, exactly: the serving
    # path's two-table gather [v | w] and the tile gather of V and of the w
    # column by the uids of real ladder plans and of a 2^18-slot device
    # plan, then odd widths (1, 32, 33, 68, ...) and misaligned tables
    cap = E.auto_budget(BATCH * SLOTS)
    plans = [E.host_dedup(zipf_ids(rng, BATCH), cap, fill=BUCKETS - 1)
             for _ in range(8)]
    rung = max(E.ladder_budget(int(p.count), cap=cap) for p in plans)
    if any(p.overflow for p in plans):
        raise AssertionError("a 16384-row zipf plan overflowed its cap")
    uids = [torch.as_tensor(p.uids[:rung], device=dev) for p in plans]
    w_col = params.w.view(-1, 1)
    splan = E.dedup_ids(torch.as_tensor(zipf_ids(rng, BATCH), device=dev),
                        cap, fill=BUCKETS - 1)
    max_err = 0.0
    for u in [*uids, splan.uids]:
        got = rowio.gather_vw_rows(params.v, params.w, u)
        ref = rowio.gather_vw_rows_reference(params.v, params.w, u)
        if not torch.equal(got, ref):
            raise AssertionError(f"two-table gather != index_selects + cat "
                                 f"at U={u.numel()}")
        max_err = max(max_err, (got - ref).abs().max().item())
        for table in (params.v, w_col):
            if not torch.equal(rowio.gather_rows(table, u),
                               rowio.gather_rows_reference(table, u)):
                raise AssertionError("gather kernel != index_select at "
                                     f"{tuple(table.shape)}, U={u.numel()}")
    odd = [(100003, w, 1001) for w in (1, 32, 33, 68, 128)] + [(7, 5, 3)]
    for rows, width, n in odd:
        table = torch.randn((rows, width), device=dev, generator=gen)
        col = torch.randn((rows,), device=dev, generator=gen)
        ids = torch.as_tensor(rng.integers(0, rows, n, dtype=np.int32),
                              device=dev)
        if not (torch.equal(rowio.gather_rows(table, ids),
                            rowio.gather_rows_reference(table, ids))
                and torch.equal(rowio.gather_vw_rows(table, col, ids),
                                rowio.gather_vw_rows_reference(table, col,
                                                               ids))):
            raise AssertionError(f"gather kernels wrong at {(rows, width, n)}")
    # 16-byte-misaligned tables take the kernels' scalar route
    for width in (1, 4, 32, 33, 68):
        table = torch.randn(1000 * width + 1, device=dev,
                            generator=gen)[1:].view(1000, width)
        col = torch.randn(1001, device=dev, generator=gen)[1:]
        ids = torch.arange(999, -1, -1, dtype=torch.int32, device=dev)
        if not (torch.equal(rowio.gather_rows(table, ids),
                            rowio.gather_rows_reference(table, ids))
                and torch.equal(rowio.gather_vw_rows(table, col, ids),
                                rowio.gather_vw_rows_reference(table, col,
                                                               ids))):
            raise AssertionError(f"gather kernels wrong on a misaligned "
                                 f"table at W={width}")
    torch.cuda.synchronize()
    print(f"check: two-table gather == index_selects + cat and tile gather "
          f"== index_select at V {tuple(params.v.shape)} and w "
          f"{tuple(w_col.shape)} with U={rung} (8 zipf plans, counts "
          f"{[int(p.count) for p in plans]}) and U={cap} (a dedup_ids plan, "
          f"{int(splan.count)} uniques), at (R, W, U) {odd} and on misaligned "
          "tables at W = 1, 4, 32, 33, 68", flush=True)

    def pair(gather):
        def run(u):
            gather(params.v, u)
            gather(w_col, u)
        return run

    def vw_kernel(u):
        return rowio.gather_vw_rows(params.v, params.w, u)

    def vw_plain(u):
        return rowio.gather_vw_rows_reference(params.v, params.w, u)
    args = [(u,) for u in uids]
    kernel_ms = min(time_ms(vw_kernel, args), time_ms(vw_kernel, args))
    plain_ms = min(time_ms(vw_plain, args), time_ms(vw_plain, args))
    pair_ms = time_ms(pair(rowio.gather_rows), args)
    pair_plain_ms = time_ms(pair(rowio.gather_rows_reference), args)
    print(f"time: one plan's V+w gather (U={rung}): two-table kernel "
          f"{kernel_ms:.4f} ms, plain (two index_selects + cat) "
          f"{plain_ms:.4f} ms; as two tile gathers (V, then w) "
          f"{pair_ms:.4f} ms, two index_selects {pair_plain_ms:.4f} ms; per "
          f"call, back to back, CUDA events, best of 5 windows of 20; "
          f"{card}", flush=True)

    # 3. an id out of range traps (in a child: a trap leaves the CUDA
    # context of its process unusable)
    trapped = {}
    for kname, call in GATHER_TRAP_CALLS.items():
        child = subprocess.run(
            [sys.executable, "-c", TRAP_CHILD.format(call=call)], cwd=root,
            capture_output=True, text=True, timeout=300)
        if child.returncode != 3:
            raise AssertionError(f"{kname}: out-of-range id did not trap: rc "
                                 f"{child.returncode}\n{child.stdout}"
                                 f"{child.stderr[-2000:]}")
        trapped[kname] = child.stdout.strip()
    print(f"check: out-of-range id -> {trapped}", flush=True)

    # 4. small input against float64 numpy, on all three scoring paths
    for feats, plan_kind in ((1000, "direct"), (1 << 17, "device plan"),
                             (1 << 17, "host plan")):
        scfg = FMConfig(num_features=feats, num_factors=8, seed=SEED)
        w0 = np.float32(0.25)
        w = rng.normal(0, 0.5, feats).astype(np.float32)
        v = rng.normal(0, 0.3, (feats, 8)).astype(np.float32)
        ids = rng.integers(0, feats, (64, SLOTS), dtype=np.int32)
        vals = rng.normal(size=(64, SLOTS)).astype(np.float32)
        sp = fm_model.params_from_numpy(w0, w, v, device=dev)
        plan = None
        if plan_kind == "host plan":
            plan = E.plan_to_device(E.host_dedup(ids, 4096, feats - 1), dev)
        got = fm_model.scores(sp, scfg, torch.as_tensor(ids, device=dev),
                              torch.as_tensor(vals, device=dev),
                              plan=plan).cpu().numpy()
        vx = v[ids].astype(np.float64) * vals[..., None]
        ref = (w0 + (w[ids] * vals).sum(1, dtype=np.float64)
               + 0.5 * (np.square(vx.sum(1)).sum(1)
                        - np.square(vx).sum((1, 2))))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    print("check: scores == float64 numpy (rtol 1e-4, atol 1e-4) on the "
          "direct, device-plan and host-plan paths", flush=True)

    # 5. serve: a few dozen requests of mixed sizes, 1 to > max_batch
    sizes = [1] * 6 + list(rng.integers(2, 600, 30)) + [2000, 5000]
    reqs = [(zipf_ids(rng, int(n)), np.ones((int(n), SLOTS), np.float32))
            for n in sizes]
    n_req = sum(int(n) for n in sizes)
    ds = SparseDataset(ids=zipf_ids(rng, BATCH),
                       vals=np.ones((BATCH, SLOTS), np.float32),
                       y=np.zeros((BATCH,), np.float32),
                       num_features=BUCKETS)
    model = FMModel(params=params, cfg=cfg)
    mb = MicroBatcher(params, cfg, max_batch=MAX_BATCH)
    if not mb.use_plans:
        raise AssertionError("a 2^24-row table must serve through plans")

    def serve():
        for ids, vals in reqs:
            mb.submit(ids if ids.shape[0] > 1 else ids[0],
                      vals if vals.shape[0] > 1 else vals[0])
        return mb.flush()

    serve()                                    # warm-up, not counted
    model.predict_dataset(ds, batch_size=BATCH)
    torch.cuda.synchronize()
    rowio.GATHER.launches = rowio.GATHER_VW.launches = 0  # the main path
    t0_serve = time.perf_counter()
    outs = serve()
    t1 = time.perf_counter()
    preds = model.predict_dataset(ds, batch_size=BATCH)
    t2 = time.perf_counter()
    launches = rowio.GATHER_VW.launches
    if launches == 0:
        raise AssertionError("the serving path never launched the kernel")
    # one chunk of at most 4096 per flush call, one two-table gather each,
    # plus one for the predict_dataset batch; no one-table gather
    chunks = -(-n_req // MAX_BATCH)
    if launches != chunks + 1 or rowio.GATHER.launches:
        raise AssertionError(f"{launches} two-table and "
                             f"{rowio.GATHER.launches} one-table launches, "
                             f"expected {chunks + 1} and 0")

    # the same requests scored with the plain gather, per slot
    def plain(ids, vals):
        ids_t = torch.as_tensor(ids, device=dev).reshape(-1)
        v_rows = rowio.gather_rows_reference(params.v, ids_t).view(
            *ids.shape, RANK)
        w_rows = rowio.gather_rows_reference(w_col, ids_t).view(ids.shape)
        s = I.fm_scores_from_gathered(params.w0, w_rows, v_rows,
                                      torch.as_tensor(vals, device=dev))
        return torch.sigmoid(s).cpu().numpy()

    for (ids, vals), got in zip(reqs, outs):
        if got.shape != (ids.shape[0],) or not np.all(np.isfinite(got)):
            raise AssertionError(f"bad output {got.shape} for {ids.shape}")
        if not np.all((got > 0) & (got < 1)):
            raise AssertionError("probabilities outside (0, 1)")
        np.testing.assert_allclose(got, plain(ids, vals), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(preds, plain(ds.ids, ds.vals), rtol=1e-6,
                               atol=1e-7)
    print(f"serve: MicroBatcher {len(reqs)} requests, {n_req} examples, "
          f"{chunks} chunks: {t1 - t0_serve:.4f} s, "
          f"{n_req / (t1 - t0_serve):.0f} ex/s; "
          f"FMModel.predict_dataset {BATCH} rows: {t2 - t1:.4f} s, "
          f"{BATCH / (t2 - t1):.0f} ex/s; outputs finite, in (0, 1), equal "
          f"to plain gather (rtol 1e-6); {card}", flush=True)

    # 6. where the time goes: device time per gather call, the device's
    # busy share of the serving run, the host plan's time per chunk
    per_call = {}
    for label, fn in (("two-table kernel V+w", vw_kernel),
                      ("plain V+w (index_selects + cat)", vw_plain),
                      ("tile kernel V", lambda u: rowio.gather_rows(
                          params.v, u)),
                      ("tile kernel w", lambda u: rowio.gather_rows(
                          w_col, u)),
                      ("index_select V", lambda u: rowio.gather_rows_reference(
                          params.v, u)),
                      ("index_select w", lambda u: rowio.gather_rows_reference(
                          w_col, u))):
        ms = per_call_ms(lambda: [fn(u) for u in uids], reps=1)
        per_call[label] = 1e3 * ms / len(uids) if ms else None
    vw_us = per_call["two-table kernel V+w"]
    print(f"profile: device us per gather call (U={rung}): "
          + ", ".join(f"{k} {v:.2f}" if v else f"{k} not measured"
                      for k, v in per_call.items()) + f"; {card}", flush=True)
    t0 = time.perf_counter()
    busy, events = device_us(
        lambda: (serve(), model.predict_dataset(ds, batch_size=BATCH)))
    traced = time.perf_counter() - t0
    wall = t2 - t0_serve
    top = "; ".join(f"{e.key[:60]} x{e.count} "
                    f"{e.self_device_time_total:.0f}" for e in events[:8])
    n_ops = sum(e.count for e in events)
    print(f"profile: serving run device busy {busy / 1e3:.3f} ms of "
          f"{wall * 1e3:.3f} ms untraced wall "
          f"({100 * (1 - busy / 1e6 / wall):.1f}% idle; traced wall "
          f"{traced * 1e3:.3f} ms); {n_ops} device events for "
          f"{chunks + 1} scoring calls; top device events (us): {top}",
          flush=True)

    # the host side of the same run, phase by phase: the wall time of
    # each call to the plan builder, the plan's copy to the device and the
    # scoring call (which returns once its device work is queued); the
    # rest is the ids/vals copies, the wait for the results and Python
    for label, run in (("flush", serve),
                       ("predict_dataset",
                        lambda: model.predict_dataset(ds, batch_size=BATCH))):
        spent = collections.defaultdict(float)
        with timed_calls((("host_dedup", E, "host_dedup"),
                          ("plan_to_device", E, "plan_to_device"),
                          ("scores (host)", fm_model, "scores")), spent):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
        parts = ", ".join(f"{k} {v * 1e3:.3f} ms ({100 * v / wall:.1f}%)"
                          for k, v in spent.items())
        rest = wall - sum(spent.values())
        print(f"profile: {label} host wall {wall * 1e3:.3f} ms: {parts}, "
              f"rest {rest * 1e3:.3f} ms ({100 * rest / wall:.1f}%); "
              f"native plan builder: {native_io.available()}", flush=True)
    for rows in (MAX_BATCH, BATCH):
        chunk = zipf_ids(rng, rows)
        plan_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            E.host_dedup(chunk, E.auto_budget(chunk.size), fill=BUCKETS - 1)
            plan_s.append(time.perf_counter() - t0)
        print(f"profile: host_dedup of a {rows}x{SLOTS} batch: best "
              f"{min(plan_s) * 1e3:.3f} ms, median "
              f"{sorted(plan_s)[2] * 1e3:.3f} ms of 5 (host CPU; native "
              f"builder: {native_io.available()})", flush=True)

    # 7-10. the training path
    train_entries, gather_record = train_phases(dev, cfg, gen, rng, card)
    # 11-14. the ALS path, with the serving model's 2 GB table freed
    del params, model, mb, w_col, uids
    torch.cuda.empty_cache()
    als_entry = als_phases(dev, gen, card)
    # 15-18. the row sums, the fused and sorted SGD paths, B4 and B6
    torch.cuda.empty_cache()
    segsum_entries = segsum_phases(dev, cfg, gen, rng, card)

    print(smi)
    # one serving plan's [v | w] gather: the ids, each distinct row of V
    # and w (the uniques and the fill row) read once, U rows of 33 floats
    # written
    distinct = np.mean([min(int(p.count) + 1, rung) for p in plans])
    vw_bytes = rung * 4 + (distinct + rung) * (RANK + 1) * 4
    record = gather_record

    def ms_or_none(us):
        return None if us is None else us / 1e3
    print(json.dumps({"kernels": [{
        "name": "gather_rows", "route": "cuda",
        "source": "sparkfm_tpu_torch/csrc/rowio.cu",
        "replaces": "sparkfm_tpu/ops/pallas_rowio.py:140",
        "launches": record["launches_training"],
        "max_abs_err": record["record_max_abs_err"],
        "path": "the SGD steps' record gather, W = 68 (phases 9, 16, 17)",
        "ms": record["record_ms"], "plain_ms": record["record_plain_ms"],
        "library_ms": record["record_plain_ms"],
        "library": "index_select (the plain version)",
        "device_ms": record["record_device_ms"],
        "plain_device_ms": record["record_plain_device_ms"],
        "library_device_ms": record["record_plain_device_ms"],
        **record["record_bound"],
        "device_plan_device_ms": record["device_plan_device_ms"],
        "device_plan_library_device_ms":
            record["device_plan_library_device_ms"],
        "device_plan_bound": record["device_plan_bound"],
        "serving_device_us_per_call": per_call,
        "serving_two_launches_ms": pair_ms,
        "serving_two_index_selects_ms": pair_plain_ms}, {
        "name": "gather_vw_rows", "route": "cuda",
        "source": "sparkfm_tpu_torch/csrc/rowio.cu",
        "replaces": "sparkfm_tpu/ops/pallas_rowio.py:140",
        "launches": launches, "max_abs_err": max_err,
        "path": "serving: one launch per scoring chunk (phase 5)",
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
        "library": "none (two index_selects and a cat: the plain version)",
        "device_ms": ms_or_none(vw_us),
        "plain_device_ms": ms_or_none(
            per_call["plain V+w (index_selects + cat)"]),
        "library_device_ms": None,
        **bound(vw_bytes, 0, ms_or_none(vw_us))},
        *train_entries, als_entry, *segsum_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
