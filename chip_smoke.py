#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparkfm_tpu_torch``) on one GPU.

Drives the port's paths once, with random weights and data from a seed:
FM serving and SGD training (hybrid, fused and sorted) at the full width
of BASELINE config 3 (Criteo-shape logistic FM: 2^24 hashed buckets, rank
32, 39 slots), then ALS training at the full size of BASELINE config 2
(ML-25M-shape regression FM: 221,588 features, rank 32, 25M ratings) and
the ``FM`` facade, then BASELINE config 1 (ML-100K shape) on the direct
SGD path, the dedup path under adam and momentum at config 3's width,
BASELINE config 4 (Avazu-shape FFM) on the fused path and in serving,
grouped and checkpointed training, then BASELINE config 5 (Criteo-shape
DeepFM) in training and serving, and the command line; after the ALS
phases, on their data, MCMC, relational SGD and BS-ALS (phases 28-30).

  1. builds every kernel library from ``sparkfm_tpu_torch/csrc/`` at once,
     one nvcc per source in parallel (``rowio.cu``: row gathers and row
     write; ``segsum.cu``: the two backwards, row sums (with squares) and
     per-rank stream sums), and prints ptxas's registers and spills per
     kernel;
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
     version in float64 (max |a - b| / (1 + |b|) < 1e-4; 2.5e-4 at W = 354,
     also over 8 more seeds, see ``b5_wide_errors``) on a bench-recipe
     plan (N = 638,976, a ~162k-slot head run) at W = 66 and 35 (the fused
     and sorted payloads) and 1, 3, 130, 354, with seg[0] > 0, with gaps
     and at N = 100,003, on rows of the phase's own seed; its sums repeat exactly, ranks without slots are
     zero, and an out-of-range rank traps in a child process;
 16. trains BASELINE config 3 on the fused path with the default
     ``accumulate="auto"``, which sums by sorted runs on the card
     (``train_sgd``, as phase 9), the launch counts set to 0 just before:
     under adagrad B1 = B2 = B6 = steps (B6 sums ``[g_v | g_w]`` and forms
     the squares, so no ``[g_v | g_v² | g_w | g_w²]`` pack is built), B5 =
     B3 = 0; under adagrad_row B1 = B2 = B5 = steps (B5 sums its (N, k+3)
     pack), B6 = 0; runs 5 fused steps against the plain versions as phase
     9 does; runs 3 steps on plans built on the card (``host_plan=False``)
     under each accumulate mode ("auto" and "segsum" launch B6 and give
     the same table bit for bit, "scatter" launches none);
 17. the same on the sorted path: ``train_sgd(update_path="sorted")``
     (B1 = B2 = B6 = steps, B5 = 0) and 5 steps against the plain
     versions;
 18. holds B6 (``segment_rowsum_sq``) and B4 (``fm_grad_segsum``) against
     their plain versions in float64 on phase 15's plan at k = 32, 4 and
     33, and B4 against B3 on the rows it expands (< 1e-6); sums repeat,
     out-of-range ranks trap; then profiles B4, B5 and B6 per call against
     their plain versions, B6 also against the sequence it replaced on the
     fused and sorted steps (squares, ``cat``, B5), and one epoch of each
     SGD path (hybrid, fused on host plans, fused on device plans,
     sorted): trained ex/s, the device's busy share and its top events;
 19. trains BASELINE config 1 (``benchmarks/run_config.py``'s recipe:
     ``synth_movielens(943, 1682, 100,000)``, split 0.8/0.2, rank 8,
     reg_v 0.02, 15 epochs of 4096 at lr 0.1, adagrad) with ``train_sgd``
     under "auto", which takes the direct path: the test RMSE must beat the
     train-mean baseline, the launch counts (two-table gathers B1 2 a step
     plus the evals', row writes B2 4 a step, B6 one a step, its first
     production caller) must match the steps, and a second card run must
     give the same parameters bit for bit; then 5 direct steps against
     the plain versions (B5/B6 in float64) and B6 on the step's own
     payload against float64; profiles one epoch;
 20. the dedup path at BASELINE config 3's width (2^24 buckets, rank 32,
     bench-recipe batches with host ladder plans) under adam and under
     momentum: 3 steps twice from one state, bit for bit, with the launch
     counts per step; the first step's row writes exact on every written
     row; B6 on its payload (N = 638,976, W = 33) against float64; 5 steps
     against the plain versions; one profiled epoch each;
 21. BASELINE config 4 (``benchmarks/bench_configs.py::bench_ffm``: FFM,
     22 fields, rank 8, 2^22 buckets, slot-major, B = 8192, adagrad, lr
     0.05) on the fused path with the record at W = 356: B6 on its
     ``[g_v | g_w]`` (W = 177) against float64, B1 and B2 at W = 356
     against their plain versions on every row, 3 steps twice bit for bit,
     5 steps against the plain versions, one ``MicroBatcher`` flush with
     field_ids against the plain per-slot path, the kernels timed at these
     shapes (B6 beside the squares, ``cat`` and B5 it replaced), and one
     profiled epoch of ``train_sgd`` (20 steps: B1 = B2 = B6 = 20) with its
     peak device memory;
 22. grouped hybrid steps as CUDA graphs at BASELINE config 3's full
     width, on phase 9's data: ``train_sgd`` with ``steps_per_dispatch``
     = 1, 2 and 4 from one initial table must give the same tables and
     histories bit for bit, B1 = B2 = B3 = steps (replays included), and
     one graph per ladder rung that forms a full group (the rungs found
     again from host plans); ``make_hybrid_multi_step`` on 5 bench-recipe
     batches of one rung, captured then replayed, must equal 10 eager
     steps bit for bit; per G, in this call: trained ex/s, the device's
     busy and idle share of one epoch, its host-to-device copy time
     (pageable at G = 1, pinned above) and the host wall per step by
     ``utils/profiling.py::StepTimer`` on staged batches;
 23. ``make_fused_multi_step`` with G = 4 on device plans (B1, B6, B2)
     and on host plans of one rung, captured then replayed, against 8
     eager steps, bit for bit, with its launch counts, device busy and host
     wall per step, single against graph; and, in a child process, an id
     out of range inside a replayed graph must end it with the kernel's
     trap;
 24. checkpointed training (``checkpoint_dir``) at 2^20 rows (cut from
     2^24 to keep the run short), hybrid with G = 2: 2 epochs, then a new
     ``train_sgd`` that resumes to 4 must equal 4 straight epochs bit for
     bit; then one save and restore of config 3's fused state (2^24 x 68
     float32, 4.56 GB; 2^22 rows if the disk lacks the room, said so) in a
     scratch directory beside this script, timed as GB/s and removed;
 25-27. BASELINE config 5 (DeepFM) trained and served, and the command
     line (``deepfm_cli_phases``);
 28. (run after phase 14, on phase 11's data and workspace) MCMC at
     BASELINE config 2: one sweep with the stream sums and one with their
     float64 plain version from one state under one recorded draw source
     (the hyperparameters equal, the parameters as in phase 12), alpha
     within 1% of its conditional mean, two sweeps from one seed bit for
     bit; ``train_mcmc`` 3 sweeps with burn-in 1 and a 2^20-example
     posterior mean, B7's launches counted by S (66 a sweep);
 29. relational SGD at config 2's width: phase 11's ratings with a users
     table in ML-1M's users.dat schema (gender, age, occupation one-hot,
     162,541 rows and the null row, from the seed; F = 221,618), 128 steps
     of 16,384 by ``train_sgd_relational`` on "direct" and under "auto"
     (which takes "dedup"), 2 B1, 4 B2 and 1 B6 launches a step; composed
     scores equal to the materialized batch's; 5 steps against the plain
     versions;
 30. BS-ALS on all 25M examples of phase 29's data, 3 sweeps: the host
     ``_prep`` timed apart, B7's launches by S, peak device memory beside
     the materialized workspace's bytes; one sweep against its float64
     plain version; on 2^21 examples against ``train_als`` on
     ``materialize()`` with the same blocks (parameters after one sweep,
     the eval RMSE after 3 within 1e-3). B7 at these paths' shapes (S = 1,
     2, 4) and the relational step's B1, B2 and B6 are held against
     float64 or exactly and timed beside ``torch.segment_reduce`` (B7) or
     ``index_copy_`` (B2);
 31. (run after phase 30) the sharded SGD at config 3's width on a
     (1, 1) mesh of one real NCCL rank (``parallel/``): the global hybrid
     (B3 once a step), global, unique (B6 once a step) and dense (adam;
     the direct step's update: B5 once and B2 six times a step)
     exchanges, 5 bench-recipe steps each from one seeded init (lr 1e-3;
     1e-6 under adam, whose per-slot steps move a head id by lr times its
     slots), counts from 0 (B1, the masked lookup, once a step); a step
     timed against its one-device twin (hybrid, fused, dedup, direct);
     each step held against the twin from a copy of the sharded state,
     every table and slot (under adam on each step's change); B1, B2, B3
     (1 x 1 and a (2, 2) shard's shape), B5 and B6 against float64 or
     exactly, timed;
 32. a (2, 2) mesh as 4 processes on card 0 over gloo (NCCL refuses two
     ranks on one card): 5 global hybrid steps a rank held against phase
     31's one-rank run (losses, and every touched row on its owner), and
     2 steps of each other exchange;
 33. on phase 11's data: one sharded ALS and one sharded MCMC sweep on
     the one-rank mesh (the reference sweep in the full feature space, B7
     at S = 1 and 2 with the feature ids as ranks), against the compact
     sweeps and the float64-plain-B7 twin (guard flips as phase 12);
 34. config 5's DeepFM on the one-rank mesh, 5 steps with global host
     plans, each held against the one-device dedup step;
 35. the entry points: ``FM(mesh="1x1").fit`` for sgd, als and mcmc, the
     dry run of every sharded path at one rank, and ``python -m
     sparkfm_tpu_torch train --mesh 1x1 --distributed`` under
     ``torch.distributed.run``, each launching its kernels.

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
main paths' runs, serving and training; B4, which no path runs, counts
one call at the main path's shapes, as its ``path`` field says; B5's
count is the fused adagrad_row run's, B6's the fused (auto) run's, with
the sorted run's beside it; ``before_ms``/``before_device_ms`` on B6's
fused, sorted and FFM entries: the squares, ``cat`` and B5 that B6
replaced there), the last line the result. Entries named
``... (FFM record)``, ``... (direct, config 1)``, ``... (dedup, ...)``
time the same kernels at the shapes of phases 19-21, and ``... (config 5
record)`` / ``(config 5 DeepFM)`` at phase 25's, with their launches from
those runs.
"""

import collections
import contextlib
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
import types

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


def assert_close_rows(a, b, rtol, atol, what, allow=0, allow_atol=0.0):
    """np.allclose semantics over two big tables, a block of ~2^27 entries
    at a time (the temporaries of one call would take several GB). Up to
    ``allow`` entries may differ beyond the tolerance if each is within
    ``allow_atol``; returns how many did."""
    rows = max(1, (1 << 27) // max(1, a[0].numel()))
    excused = 0
    for r0 in range(0, a.shape[0], rows):
        x, y = a[r0:r0 + rows], b[r0:r0 + rows]
        diff = (x - y).abs()
        bad = diff > atol + rtol * y.abs()
        n_bad = int(bad.sum())
        if n_bad and (excused + n_bad > allow
                      or float(diff[bad].max()) > allow_atol):
            raise AssertionError(
                f"{what}: {n_bad} entries differ beyond rtol {rtol}, atol "
                f"{atol} in rows {r0}.. (max {float(diff[bad].max()):.3g}; "
                f"{allow} allowed within {allow_atol:.3g})")
        excused += n_bad
    return excused


def assert_close_changes(before, a, b, rtol, what, allow=0,
                         allow_atol=0.0):
    """Two tables ``a`` and ``b`` that one step moved from ``before``,
    held on the step's change: |a - b| <= rtol * |b - before| + one ulp
    of b + 1e-6 of the table's largest change (the float32 rounding of
    its longest sums), so an entry that moved by 1e-6 is held to its move
    and not to an absolute floor. Up to ``allow`` entries may differ
    further if each is within ``allow_atol``; returns how many did."""
    rows = max(1, (1 << 26) // max(1, a[0].numel()))
    floor = 1e-6 * max(float((b[r0:r0 + rows] - before[r0:r0 + rows])
                             .abs().max())
                       for r0 in range(0, a.shape[0], rows))
    excused = 0
    for r0 in range(0, a.shape[0], rows):
        x, y = a[r0:r0 + rows].double(), b[r0:r0 + rows]
        ulp = (torch.nextafter(y.abs(), torch.full_like(y, float("inf")))
               - y.abs()).double()
        y = y.double()
        diff = (x - y).abs()
        bad = diff > (rtol * (y - before[r0:r0 + rows].double()).abs()
                      + ulp + floor)
        n_bad = int(bad.sum())
        if n_bad and (excused + n_bad > allow
                      or float(diff[bad].max()) > allow_atol):
            raise AssertionError(
                f"{what}: {n_bad} entries differ beyond rtol {rtol} of the "
                f"step's change (+ ulp + {floor:.3g}) in rows {r0}.. (max "
                f"{float(diff[bad].max()):.3g}; {allow} allowed within "
                f"{allow_atol:.3g})")
        excused += n_bad
    return excused


def steps_against_plain(step, state, batches, swaps, kernels, label,
                        rows=BUCKETS, used=2 * RANK + 2, allow=0,
                        allow_atol=0.0):
    """Run ``step`` over ``batches`` from ``state`` (updated in place).
    Each step runs twice from the same state, with the kernels and with
    the plain versions ``swaps`` (module, name, fn) swapped in, and the
    run goes on from the kernels' result: losses must agree at rtol 1e-5,
    tables [:F, :2k+2] at rtol 1e-4, atol 1e-6, and the plain step must
    launch none of ``kernels``. Run freely, the two would drift apart
    beyond any tolerance for a reason that is no fault of either: on
    random labels at lr 0.05 the loss grows by orders of magnitude within
    a few steps, and that growth amplifies the f32 rounding of the sums.
    ``rows`` and ``used``: the table's F and 2vk+2 (BASELINE config 3's
    by default); ``allow``/``allow_atol`` as :func:`assert_close_rows`'s,
    per step. Returns the losses and the number of rows the run
    changed."""
    kernels = list(kernels)
    first = state.table[:rows, :used].clone()
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
        assert_close_rows(state.table[:rows, :used],
                          plain_out.table[:rows, :used], 1e-4, 1e-6,
                          f"{label} step {len(losses)} tables", allow,
                          allow_atol)
        np.testing.assert_allclose(float(state.w0), float(plain_out.w0),
                                   rtol=1e-5)
        del plain_in, plain_out
    moved = int((state.table[:rows, :used] != first).any(dim=1).sum())
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


def hold_colsums(streams, seg, u, label, checked):
    """B7 against its plain version in float64 on the same streams (max
    |a - b| / (1 + |b|) < 1e-4), its sums repeated bit for bit and ranks
    without slots zero; returns (max abs error, max rel error, the f32
    plain version's rel error)."""
    from sparkfm_tpu_torch.ops import segsum
    exact = segsum.segment_colsums_reference([x.double() for x in streams],
                                             seg, u)
    got = segsum.segment_colsums(streams, seg, u)
    err = max_rel_err(got, exact)
    plain_err = max_rel_err(
        segsum.segment_colsums_reference(streams, seg, u), exact)
    if not err < 1e-4:
        raise AssertionError(f"stream-sum kernel off at {label}: {err:.3g} "
                             f"from the float64 sums (plain f32 "
                             f"{plain_err:.3g})")
    if not torch.equal(got, segsum.segment_colsums(streams, seg, u)):
        raise AssertionError(f"stream sums do not repeat at {label}")
    empty = torch.ones(u, dtype=torch.bool, device=seg.device)
    empty[seg.long()] = False
    if got[empty].any():
        raise AssertionError(f"a rank without slots is not zero at {label}")
    checked.append(f"{label}: kernel {err:.3g}, plain f32 {plain_err:.3g}")
    return float((got.double() - exact).abs().max()), err, plain_err


def segment_reduce_call(streams, seg, u):
    """B7's library yardstick: one ``torch.segment_reduce`` over the
    stacked streams, with the per-rank lengths counted beforehand."""
    lengths = torch.bincount(seg.long(), minlength=u)

    def call():
        return torch.segment_reduce(torch.stack(streams, 1), "sum",
                                    lengths=lengths)
    return call


def colsums_entry(label, streams, seg, u, launches, path, checked, card):
    """B7's kernel entry at one path's shape: held against float64, timed
    beside its plain version and ``torch.segment_reduce`` (2 windows of 2
    calls: on a block with the 6.4M-rating run it takes ~0.2-0.6 s a
    call), with its bound (S + 1 arrays of N read, (U, S) written, S adds
    a slot)."""
    from sparkfm_tpu_torch.ops import segsum
    res = hold_colsums(streams, seg, u, label, checked)
    s, n = len(streams), seg.shape[0]
    library = segment_reduce_call(streams, seg, u)
    library_err = max_rel_err(library(), segsum.segment_colsums_reference(
        [x.double() for x in streams], seg, u))
    t = timed_kernel(f"B7 segment_colsums per call, {label} (N={n}, S={s}, "
                     f"U={u})", segsum.segment_colsums,
                     segsum.segment_colsums_reference, (streams, seg, u),
                     library, 4 * ((s + 1) * n + u * s), s * n, card,
                     library_reps=2)
    return {"name": f"segment_colsums ({label})", "route": "cuda",
            "source": "sparkfm_tpu_torch/csrc/segsum.cu",
            "replaces": "sparkfm_tpu/ops/pallas_segsum.py:808",
            "launches": launches, "path": path, "max_abs_err": res[0],
            "max_rel_err": res[1], "plain_f32_max_rel_err": res[2],
            "err_against": "plain version in float64",
            "library": "torch.segment_reduce(stack(streams, 1), 'sum', "
                       "lengths)", "library_max_rel_err": library_err, **t}


def als_phases(dev, gen, card):
    """Phases 11-14, the ALS path; returns the stream-sum kernel's JSON
    entry, and the data and workspace for phases 28-30 (``ctx``)."""
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
        return hold_colsums(streams, seg, u, label, checked)

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
    library = segment_reduce_call(*args)
    ms = (time_ms(segsum.segment_colsums, [args], reps=10, windows=3),
          time_ms(segsum.segment_colsums_reference, [args], reps=10,
                  windows=3),
          time_ms(library, [()], reps=2, windows=2))
    library_us = 1e3 * spun_ms(library, reps=2, windows=2)
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
          f"{ms[1]:.4f} ms, torch.segment_reduce {ms[2]:.4f} ms back to "
          f"back at the movie block S=5 (CUDA events, "
          f"best of 3 windows of 10); device (CUDA events, the calls "
          f"queued behind a spin kernel; passes split by torch.profiler): "
          + "; ".join(lines) + f"; plain movie {plain_us[0]:.2f} us, user "
          f"{plain_us[1]:.2f} us; segment_reduce movie {library_us:.2f} us; "
          f"{card}", flush=True)
    del streams, args, library

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
            "ms": ms[0], "plain_ms": ms[1], "library_ms": ms[2],
            "library": "torch.segment_reduce(stack(streams, 1), 'sum', "
                       "lengths)",
            "device_ms": blocks["movie"][5][0] / 1e3,
            "plain_device_ms": plain_us[0] / 1e3,
            "library_device_ms": library_us / 1e3,
            **b7_bound(5, blocks["movie"][5][0]),
            "device_us_by_block": {
                f"{label} S={s}": {"all": t[0], "pass 1": t[1], "pass 2": t[2],
                                   "share_of_bound": b7_bound(
                                       s, t[0])["share_of_bound"]}
                for label, by_s in blocks.items() for s, t in by_s.items()},
            "plain_device_us_user": plain_us[1],
            "sweep_device_ms": {k: v[0] / 1e3 for k, v in sweep_b7.items()},
            "sweep_launches": {k: v[1] for k, v in sweep_b7.items()}}, dict(
        ds=ds, ws=ws, nb=nb, cfg=cfg, feature_blocks=als_cfg.feature_blocks,
        flags=dict(column_pure=cpure, csc_uniform=uniform,
                   slice_identity=ident))


USERS_FIELDS = (2, 7, 21)   # ML-1M users.dat: gender, age, occupation
REL_BATCH, REL_STEPS = 16384, 128
MCMC_EVAL = 1 << 20         # examples scored for MCMC's posterior mean


class RecordedDraws:
    """A draw source that keeps every draw of ``draws``; ``replay()`` gives
    a source that hands the same tensors out again, in order."""

    def __init__(self, draws):
        self.draws, self.log = draws, []

    def normal(self, shape):
        self.log.append(self.draws.normal(shape))
        return self.log[-1]

    def gamma(self, shape_param):
        self.log.append(self.draws.gamma(shape_param))
        return self.log[-1]

    def replay(self):
        it = iter(self.log)

        class Replay:
            def normal(self, shape):
                return next(it)

            def gamma(self, shape_param):
                return next(it)
        return Replay()


def params_agree(got, want, start, label, w_tol=(1e-3, 1e-4),
                 v_tol=(1e-3, 1e-4), w0_rtol=1e-6, ids=None):
    """Phase 12's rule between two runs from ``start``: w and V within
    their (rtol, atol) but for den > 0 guard flips (an entry left at its
    start value on one side only), at most 1e-4 of V's entries; w0 at
    ``w0_rtol``. With ``ids`` (the (N, L) host ids of the data), an entry
    of a feature that shares an example with a flipped feature is excused
    too (the flip moved that example's residual). Returns (flips, entries
    excused as neighbours)."""
    masks = {}
    for name, (rtol, atol) in (("w", w_tol), ("v", v_tol)):
        a, b, a0 = (getattr(p, name) for p in (got, want, start))
        bad = (a - b).abs() > atol + rtol * b.abs()
        masks[name] = (bad, bad & ((a == a0) ^ (b == a0)))
    flips = sum(int(flip.sum()) for _, flip in masks.values())
    if flips > 1e-4 * start.v.numel():
        raise AssertionError(f"{label}: {flips} guard flips")
    near = torch.zeros(start.w.shape[0], dtype=torch.bool,
                       device=start.w.device)
    if ids is not None and flips:
        flipped = (masks["w"][1] | masks["v"][1].any(1)).cpu().numpy()
        rows = flipped[ids].any(1)
        near[torch.as_tensor(np.unique(ids[rows]), device=near.device)] = True
    neighbours = 0
    for name, (bad, flip) in masks.items():
        miss = bad & ~flip
        excused = miss & (near if miss.dim() == 1 else near[:, None])
        if (miss & ~excused).any():
            raise AssertionError(f"{label} {name}: "
                                 f"{int((miss & ~excused).sum())} entries "
                                 "differ beyond tolerance")
        neighbours += int(excused.sum())
    np.testing.assert_allclose(float(got.w0), float(want.w0), rtol=w0_rtol)
    return flips, neighbours


def profile_sweep(label, run, card):
    """One synchronized untraced run of ``run`` and one traced: device
    busy against the untraced wall, the stream sums' device time and the
    top device events."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, events = device_us(run, tries=1)
    b7 = sum(e.self_device_time_total for e in events if "colsums" in e.key)
    top = "; ".join(f"{e.key[:50]} x{e.count} {e.self_device_time_total:.0f}"
                    for e in events[:6])
    print(f"profile: {label}: device busy {busy / 1e3:.3f} ms of "
          f"{wall * 1e3:.3f} ms untraced wall "
          f"({100 * (1 - busy / 1e6 / wall):.1f}% idle); stream sums "
          f"{b7 / 1e3:.3f} ms; top device events (us): {top}; {card}",
          flush=True)


def users_relation(ds):
    """Phase 29's block-structure data: the main block is phase 11's (user,
    movie) ratings; a users table in ML-1M's users.dat schema as
    ``load_movielens_relational`` reads it (gender, age and occupation one
    hot, three nonzeros a row) for every user plus the null row, drawn
    from the seed, keyed by each rating's user."""
    from sparkfm_tpu_torch.data import relational as R
    rng = np.random.default_rng(SEED)
    starts = np.cumsum((0,) + USERS_FIELDS[:-1])
    demo = np.stack([s + rng.integers(0, k, ALS_USERS)
                     for s, k in zip(starts, USERS_FIELDS)], axis=1)
    ids = np.concatenate([demo, np.zeros((1, 3))]).astype(np.int32)
    vals = np.concatenate([np.ones((ALS_USERS, 3)),
                           np.zeros((1, 3))]).astype(np.float32)
    offset = ALS_USERS + ALS_MOVIES
    return R.RelationalDataset(
        main_ids=ds.ids, main_vals=ds.vals, y=ds.y, keys=ds.ids[:, :1],
        tables=(R.RelationTable(ids=ids, vals=vals, offset=offset),),
        num_features=offset + sum(USERS_FIELDS))


def mcmc_relational_phases(dev, card, ctx):
    """Phases 28-30 on phase 11's data and workspace: MCMC at BASELINE
    config 2, relational SGD and BS-ALS at its width with a users table.
    Their random tensors come from a generator of their own, so the
    phases after them see the same streams as before these ran. Returns
    the kernels' JSON entries at these paths' shapes."""
    from sparkfm_tpu_torch import (ALSConfig, FMConfig, MCMCConfig,
                                   SGDConfig, train_als)
    from sparkfm_tpu_torch.data import relational as R
    from sparkfm_tpu_torch.models import fm as fm_model
    from sparkfm_tpu_torch.ops import rowio, segsum
    from sparkfm_tpu_torch.solvers import als as A
    from sparkfm_tpu_torch.solvers import als_bs, mcmc
    from sparkfm_tpu_torch.solvers import sgd as sgd_solver
    from sparkfm_tpu_torch.training import trainer

    t_phases = time.perf_counter()
    ds, ws, nb, cfg = ctx["ds"], ctx["ws"], ctx["nb"], ctx["cfg"]
    flags = ctx["flags"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    n_ranks = int(ws.present.shape[0])
    n = ds.num_examples
    kernel_colsums = segsum.segment_colsums
    entries, checked = [], []
    by_s = collections.Counter()
    kept = {}

    def counting(*keep_segs):
        """B7 with its calls counted by S; the first call of each S over
        each of ``keep_segs`` kept, by (S, seg), with copies of its
        streams."""
        ptrs = {seg.data_ptr(): seg for seg in keep_segs}

        def call(streams, seg, u):
            s = len(streams)
            by_s[s] += 1
            key = (s, seg.data_ptr())
            if key[1] in ptrs and key not in kept:
                kept[key] = ([x.clone() for x in streams], seg, u)
            return kernel_colsums(streams, seg, u)
        return call

    # 28. MCMC at BASELINE config 2: one sweep with B7 and one with its
    # float64 plain version, from one state under one recorded draw source
    p0 = fm_model.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), device=dev)
    state0 = mcmc.init_mcmc_state(p0)

    def sweep(draws):
        return mcmc.mcmc_sweep(state0, ws, draws, nb, cfg.num_features,
                               **flags)

    seg_movie = ws.col_rank[n:]
    rec = RecordedDraws(mcmc.TorchDraws(torch.Generator(
        device=dev).manual_seed(SEED + 28)))
    with swapped([(segsum, "segment_colsums", counting(seg_movie))]):
        s_kernel = sweep(rec)
    count = segsum.COLSUMS.launches
    with swapped([(segsum, "segment_colsums", colsums64)]):
        s_plain = sweep(rec.replay())
    if segsum.COLSUMS.launches != count:
        raise AssertionError("the plain MCMC sweep launched the kernel")
    for name in ("alpha", "lam_w", "mu_w", "lam_v", "mu_v"):
        if not torch.equal(getattr(s_kernel, name), getattr(s_plain, name)):
            raise AssertionError(f"MCMC {name} differs between the sweeps")
    flips, _ = params_agree(s_kernel.params, s_plain.params, p0,
                            "MCMC sweep")
    # alpha against its conditional mean, from the sweep's residuals
    w_c = p0.w.index_select(0, ws.present)
    v_t = p0.v.index_select(0, ws.present).t().contiguous()
    score, _ = A.compact_forward(ws, p0.w0, w_c, v_t)
    sse = float((score - ws.y).double().square().sum())
    alpha_mean = (1.0 + 0.5 * n) / (1.0 + 0.5 * sse)
    alpha = float(s_kernel.alpha)
    if not (np.isfinite(alpha) and abs(alpha - alpha_mean) < 0.01
            * alpha_mean):
        raise AssertionError(f"MCMC alpha {alpha}, conditional mean "
                             f"{alpha_mean}")
    del s_plain, rec, score, v_t, w_c
    # two sweeps from one seed: bit for bit; their time is the sweep's
    runs, sweep_s = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(sweep(mcmc.TorchDraws(torch.Generator(
            device=dev).manual_seed(SEED + 7))))
        torch.cuda.synchronize()
        sweep_s.append(time.perf_counter() - t0)
    for name in ("w0", "w", "v"):
        if not torch.equal(getattr(runs[0].params, name),
                           getattr(runs[1].params, name)):
            raise AssertionError(f"two MCMC sweeps from one seed differ in "
                                 f"{name}")
    del runs
    profile_sweep("one MCMC sweep", lambda: sweep(mcmc.TorchDraws(
        torch.Generator(device=dev).manual_seed(SEED + 7))), card)
    print(f"check: MCMC sweep at BASELINE config 2 ({n} ratings, "
          f"{cfg.num_features} features, rank {RANK}, {nb} slot blocks), "
          f"with the kernel vs with the float64 plain version from one state "
          f"under one recorded draw source: hyperparameters equal, w and V "
          f"at rtol 1e-3, atol 1e-4 but for {flips} guard flips; alpha "
          f"{alpha:.6g} within 1% of its conditional mean {alpha_mean:.6g}; "
          f"two sweeps from one seed equal bit for bit", flush=True)
    # train_mcmc: 3 sweeps, burn-in 1, the posterior mean on 2^20 examples
    eval_ds = ds.slice(np.arange(MCMC_EVAL))
    mcfg = MCMCConfig(epochs=ALS_SWEEPS, burn_in=1,
                      feature_blocks=ctx["feature_blocks"])
    torch.cuda.synchronize()
    segsum.COLSUMS.launches = 0                     # the MCMC path
    by_s.clear()
    with swapped([(segsum, "segment_colsums", counting())]):
        t0 = time.perf_counter()
        res = mcmc.train_mcmc(cfg, mcfg, ds, eval_ds=eval_ds, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    mcmc_launches, mcmc_by_s = segsum.COLSUMS.launches, dict(by_s)
    expected = ALS_SWEEPS * (RANK + 1) * nb
    if mcmc_launches != expected or mcmc_by_s != {
            1: ALS_SWEEPS * nb, 2: ALS_SWEEPS * RANK * nb}:
        raise AssertionError(f"train_mcmc launched B7 {mcmc_launches} times "
                             f"by S {mcmc_by_s}, expected {expected}")
    hist = res.history
    if not (all(np.isfinite(h["alpha"]) and h["alpha"] > 0 for h in hist)
            and all(np.isfinite(h[k]) for h in hist[1:]
                    for k in ("eval_rmse_avg", "eval_rmse_sample"))
            and res.extras["avg_scores"].shape == (MCMC_EVAL,)
            and bool(torch.isfinite(res.params.v).all())):
        raise AssertionError(f"train_mcmc history {hist}")
    print(f"train: train_mcmc BASELINE config 2, {ALS_SWEEPS} sweeps (burn-in "
          f"1) of {n} ratings: one sweep {1e3 * min(sweep_s):.3f} ms "
          f"({n / min(sweep_s):.0f} swept ex/s; of 2 sweeps, synchronized); "
          f"train_mcmc {res.examples_per_sec:.0f} ex/s with its evals of "
          f"{MCMC_EVAL} examples, {train_s:.3f} s wall with the workspace build; B7 "
          f"launches {mcmc_launches} = {mcmc_launches // ALS_SWEEPS} a sweep "
          f"(expected (K + 1) x blocks = {(RANK + 1) * nb}), by S "
          f"{mcmc_by_s}; alpha {[round(h['alpha'], 6) for h in hist]}, mean "
          f"lam_w {[round(h['lam_w'], 6) for h in hist]}; eval_rmse_avg "
          f"{[round(h['eval_rmse_avg'], 6) for h in hist[1:]]} vs "
          f"eval_rmse_sample "
          f"{[round(h['eval_rmse_sample'], 6) for h in hist[1:]]}; {card}",
          flush=True)
    path28 = "train_mcmc, BASELINE config 2 (phase 28)"
    for s, what in ((1, "a w block"), (2, "a (factor, block)")):
        entries.append(colsums_entry(
            f"MCMC S = {s}, {what}", *kept[(s, seg_movie.data_ptr())],
            mcmc_by_s[s], path28, checked, card))
    del res, eval_ds
    kept.clear()
    torch.cuda.empty_cache()

    # 29. relational SGD at config 2's width: the users table joined on the
    # card, 128 steps of 16,384 on the direct path and under "auto"
    rel = users_relation(ds)
    f = rel.num_features
    part = rel.slice(np.arange(REL_BATCH * REL_STEPS))
    rcfg = FMConfig(num_features=f, num_factors=RANK, reg_w=1e-6,
                    reg_v=1e-6, seed=SEED)
    kernels = {"gather_vw_rows": rowio.GATHER_VW,
               "scatter_set_rows": rowio.SCATTER,
               "segment_rowsum_sq": segsum.ROWSUM_SQ}
    want = {"gather_vw_rows": 2 * REL_STEPS,
            "scatter_set_rows": 4 * REL_STEPS,
            "segment_rowsum_sq": REL_STEPS}
    rel_runs = {}
    for label in ("direct", "auto"):
        sgd_cfg = SGDConfig(batch_size=REL_BATCH, epochs=1,
                            learning_rate=0.05, update_path=label)
        path = R.relational_update_path(rcfg, sgd_cfg)
        if path != {"direct": "direct", "auto": "dedup"}[label]:
            raise AssertionError(f"relational {label} resolved to {path}")
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0                          # the relational path
        t0 = time.perf_counter()
        res = trainer.train_sgd_relational(rcfg, sgd_cfg, part, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: k.launches for name, k in kernels.items()}
        if got != want or not np.isfinite(res.history[0]["train_loss"]):
            raise AssertionError(f"relational {label}: launches {got}, "
                                 f"expected {want}; {res.history}")
        busy, _ = device_us(lambda: trainer.train_sgd_relational(
            rcfg, sgd_cfg, part, device=dev), tries=1)
        rel_runs[label] = got
        print(f"train: train_sgd_relational {label} -> {path} (F={f}, rank "
              f"{RANK}, users table {ALS_USERS + 1} x 3, {REL_STEPS} steps of "
              f"{REL_BATCH}, adagrad, lr 0.05): {res.examples_per_sec:.0f} "
              f"trained ex/s (first step left out), {wall:.3f} s wall; "
              f"device busy {busy / 1e3:.3f} ms of {wall * 1e3:.3f} ms "
              f"({100 * (1 - busy / 1e6 / wall):.1f}% idle, one traced run "
              f"against the untraced wall); loss "
              f"{res.history[0]['train_loss']:.5f}; launches {got}; {card}",
              flush=True)
        del res
    # composed scores against the materialized batch's
    tables = R.tables_to_device(rel.tables, device=dev)
    first = rel.slice(np.arange(REL_BATCH))
    params = fm_model.init_params(rcfg, gen, device=dev)
    params.w.normal_(0.0, 0.1, generator=gen)
    rb = next(R.relational_batch_iterator(first, REL_BATCH, device=dev))
    flat = first.materialize()
    composed = R.make_relational_score_fn(rcfg)(params, rb, tables)
    direct = fm_model.scores(params, rcfg, torch.as_tensor(flat.ids,
                                                           device=dev),
                             torch.as_tensor(flat.vals, device=dev))
    if not torch.equal(composed, direct):
        raise AssertionError("composed scores != materialized scores")
    # 5 direct steps against the plain versions, B6 held on the payload
    step = R.make_relational_train_step(rcfg, SGDConfig(
        batch_size=REL_BATCH, learning_rate=0.05, update_path="direct"))
    batches = list(R.relational_batch_iterator(part.slice(np.arange(
        5 * REL_BATCH)), REL_BATCH, device=dev))
    payload, vw_args = [], []
    plain_swaps = [(rowio, "gather_vw_rows", rowio.gather_vw_rows_reference),
                   (rowio, "scatter_set_rows",
                    rowio.scatter_set_rows_reference),
                   (segsum, "segment_rowsum_sq", rowsum_sq64)]
    with swapped([(segsum, "segment_rowsum_sq", capturing(
            segsum.segment_rowsum_sq, payload)),
                  (rowio, "gather_vw_rows", capturing(
                      rowio.gather_vw_rows, vw_args))]):
        losses, _ = state_steps_against_plain(
            lambda st, b: step(st, b, tables), sgd_solver.init_state(
                params, optimizer="adagrad"), batches, plain_swaps,
            kernels.values(), "relational direct", f)
    print(f"check: composed scores == materialized scores bit for bit "
          f"(16,384 examples, F={f}); 5 relational direct steps, each from "
          f"the same state with the kernels and with the plain versions: "
          f"losses {losses} equal (rtol 1e-5), every table and slot equal "
          f"(rtol 1e-4, atol 1e-6)", flush=True)
    path29 = ("train_sgd_relational direct at config 2's width (phase 29); "
              f"launches of the 'auto' (dedup) run: {rel_runs['auto']}")
    res6 = hold64(segsum.segment_rowsum_sq, segsum.segment_rowsum_sq_reference,
                  tuple(payload), "B6 on the relational step's payload",
                  checked)
    entries.append(rowsum_sq_entry_of(
        "relational, config 2 width", res6, payload,
        rel_runs["direct"]["segment_rowsum_sq"], path29, card))
    v, w, uids = vw_args
    u = uids.shape[0]
    distinct = int(torch.unique(uids).numel())
    if not torch.equal(rowio.gather_vw_rows(v, w, uids),
                       rowio.gather_vw_rows_reference(v, w, uids)):
        raise AssertionError("two-table gather wrong at the relational shape")
    t = timed_kernel(f"B1 gather_vw_rows per call, relational [v | w] "
                     f"(U={u}, W={RANK + 1})", rowio.gather_vw_rows,
                     rowio.gather_vw_rows_reference, (v, w, uids), None,
                     u * 4 + (distinct + u) * (RANK + 1) * 4, 0, card)
    entries.append({"name": "gather_vw_rows (relational, config 2 width)",
                    "route": "cuda",
                    "source": "sparkfm_tpu_torch/csrc/rowio.cu",
                    "replaces": "sparkfm_tpu/ops/pallas_rowio.py:140",
                    "launches": rel_runs["direct"]["gather_vw_rows"],
                    "path": path29, "max_abs_err": 0.0,
                    "library": "none (two index_selects and a cat: the "
                               "plain version)", **t})
    rows = torch.randn((u, RANK), device=dev, generator=gen)
    table = params.v
    keep = torch.ones(u, dtype=torch.bool, device=dev)
    keep[1:] = uids[1:] != uids[:-1]
    rowio.scatter_set_rows(table, uids, rows)
    if not torch.equal(table[uids[keep].long()], rows[keep]):
        raise AssertionError("row write wrong at the relational shape")
    firsts = uids[keep].long()
    t = timed_kernel(f"B2 scatter_set_rows per call, relational V (U={u}, "
                     f"W={RANK})", rowio.scatter_set_rows,
                     rowio.scatter_set_rows_reference, (table, uids, rows),
                     lambda: table.index_copy_(0, firsts, rows[keep]),
                     u * 4 + (u + distinct) * RANK * 4, 0, card)
    entries.append({"name": "scatter_set_rows (relational, config 2 width)",
                    "route": "cuda",
                    "source": "sparkfm_tpu_torch/csrc/rowio.cu",
                    "replaces": "sparkfm_tpu/ops/pallas_rowio.py:74",
                    "launches": rel_runs["direct"]["scatter_set_rows"],
                    "path": path29, "max_abs_err": 0.0,
                    "library": "index_copy_ over the plan's distinct ids",
                    **t})
    del payload, vw_args, batches, params, v, w, uids, rows, table
    torch.cuda.empty_cache()

    # 30. BS-ALS on all 25M examples of phase 29's data, 3 sweeps
    bcfg = FMConfig(num_features=f, num_factors=RANK, reg_w=0.1, reg_v=1.0,
                    seed=SEED)
    pb = fm_model.init_params(bcfg, torch.Generator(device=dev).manual_seed(
        SEED), device=dev)
    prep_out, host = [], collections.defaultdict(float)
    prep = als_bs._prep

    def keeping_prep(*a, **k):
        prep_out.append(prep(*a, **k))
        return prep_out[-1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    segsum.COLSUMS.launches = 0                     # the BS-ALS path
    by_s.clear()
    with swapped([(segsum, "segment_colsums", counting()),
                  (als_bs, "_prep", keeping_prep)]), \
            timed_calls([("_prep", als_bs, "_prep")], host):
        t0 = time.perf_counter()
        res = als_bs.train_als_relational(bcfg, ALSConfig(epochs=ALS_SWEEPS),
                                          rel, params=pb, device=dev)
        torch.cuda.synchronize()
        bs_wall = time.perf_counter() - t0
    bs_launches, bs_by_s = segsum.COLSUMS.launches, dict(by_s)
    peak = torch.cuda.max_memory_allocated(dev)
    arrs, statics = prep_out[0]
    blocks = statics.num_blocks
    main_blocks = sum(s is not None for s in statics.main_span)
    rel_blocks = blocks - main_blocks
    want_s = {1: ALS_SWEEPS * (main_blocks + 2 * rel_blocks),
              2: ALS_SWEEPS * RANK * (main_blocks + rel_blocks),
              4: ALS_SWEEPS * RANK * rel_blocks}
    if bs_by_s != want_s or bs_launches != sum(want_s.values()):
        raise AssertionError(f"BS-ALS B7 launches {bs_launches} by S "
                             f"{bs_by_s}, expected {want_s}")
    if not all(bool(torch.isfinite(t).all())
               for t in (res.params.w0, res.params.w, res.params.v)):
        raise AssertionError("BS-ALS parameters are not finite")
    flat_bytes = A.workspace_hbm_bytes(types.SimpleNamespace(
        ids=types.SimpleNamespace(size=n * rel.total_nnz_per_example),
        num_examples=n), bcfg)
    print(f"train: train_als_relational (BS-ALS) on {n} examples, F={f}, "
          f"rank {RANK}, {blocks} slot blocks ({main_blocks} main, "
          f"{rel_blocks} users columns), {ALS_SWEEPS} sweeps: host _prep "
          f"{host['_prep']:.3f} s; {1e3 * n / res.examples_per_sec:.3f} ms a "
          f"sweep ({res.examples_per_sec:.0f} swept ex/s), {bs_wall:.3f} s "
          f"wall with the prep; B7 launches {bs_launches} = "
          f"{bs_launches // ALS_SWEEPS} a sweep, by S "
          f"{ {k: v // ALS_SWEEPS for k, v in bs_by_s.items()} } a sweep; "
          f"peak device memory {peak / 2**30:.2f} GiB (the workspace of "
          f"train_als on materialize() would need "
          f"{flat_bytes / 2**30:.2f} GiB by workspace_hbm_bytes); {card}",
          flush=True)
    del res
    # one BS sweep with B7 and one with its float64 plain version
    rw, rv = (torch.as_tensor(r, device=dev) for r in bcfg.reg_vectors())
    bs_sweep = als_bs.make_bs_sweep(bcfg, statics)
    key_seg = arrs.rels[0].key_seg
    lo, hi = statics.main_span[1]             # the movie slot's entries
    movie_seg = arrs.col_feat[lo:hi]
    with swapped([(segsum, "segment_colsums", counting(key_seg,
                                                       movie_seg))]):
        p_kernel = bs_sweep(pb, arrs, rw, rv)
    count = segsum.COLSUMS.launches
    with swapped([(segsum, "segment_colsums", colsums64)]):
        p_plain = bs_sweep(pb, arrs, rw, rv)
    if segsum.COLSUMS.launches != count:
        raise AssertionError("the plain BS sweep launched the kernel")
    bs_flips, _ = params_agree(p_kernel, p_plain, pb, "BS-ALS sweep")
    del p_plain
    profile_sweep("one BS-ALS sweep", lambda: bs_sweep(pb, arrs, rw, rv),
                  card)
    path30 = "train_als_relational, config 2 width (phase 30)"
    for s, seg, what in ((4, key_seg, "per key over the users relation"),
                         (2, movie_seg, "the movie slot's main entries"),
                         (1, key_seg, "per key over the users relation")):
        entries.append(colsums_entry(
            f"BS-ALS S = {s}, {what}", *kept[(s, seg.data_ptr())],
            bs_by_s[s], path30, checked, card))
    kept.clear()
    del arrs, p_kernel, key_seg, movie_seg
    torch.cuda.empty_cache()
    # on 2^21 examples: BS-ALS against train_als on materialize(), the
    # same blocks, the JAX test's tolerances. The parameters are held after
    # one sweep: a feature rated once has a den that train_als forms from
    # factored sums, (q - v)^2 as q^2 - 2qv + v^2, which can round to <= 0
    # and keep the feature (a guard flip), where BS-ALS forms h = q - v
    # and moves it; over more sweeps each flip moves its examples' other
    # features, so there the RMSE is held (the JAX test's gate)
    sl = rel.slice(np.arange(REL_BATCH * REL_STEPS))
    flat = sl.materialize()
    blocks_sl = tuple(int(b) for b in als_bs.slot_blocks_bs(sl, f))
    runs = {}
    for sweeps in (1, ALS_SWEEPS):
        acfg = ALSConfig(epochs=sweeps, feature_blocks=blocks_sl)
        runs[sweeps] = (
            als_bs.train_als_relational(bcfg, acfg, sl, eval_ds=flat,
                                        eval_every=sweeps, params=pb,
                                        device=dev),
            train_als(bcfg, acfg, flat, eval_ds=flat, eval_every=sweeps,
                      params=pb, device=dev))
    bs, fl = runs[1]
    flat_flips, flat_near = params_agree(
        bs.params, fl.params, pb, "BS-ALS vs train_als", w_tol=(5e-2, 1e-3),
        v_tol=(5e-2, 5e-3), w0_rtol=1e-4, ids=flat.ids)
    r_bs, r_fl = (x.history[-1]["eval_rmse"] for x in runs[ALS_SWEEPS])
    if not abs(r_bs - r_fl) < 1e-3:
        raise AssertionError(f"BS-ALS RMSE {r_bs} vs train_als {r_fl}")
    apart = int(((runs[ALS_SWEEPS][0].params.v - runs[ALS_SWEEPS][1].params.v
                  ).abs() > 5e-3 + 5e-2 * runs[ALS_SWEEPS][1].params.v.abs()
                 ).sum())
    del runs, bs, fl
    print(f"check: one BS sweep with the kernel vs with the float64 plain "
          f"version: w, V at rtol 1e-3, atol 1e-4 but for {bs_flips} guard "
          f"flips; on {sl.num_examples} examples BS-ALS vs train_als on "
          f"materialize() with the same {len(set(blocks_sl))} blocks: after "
          f"one sweep w0 rtol 1e-4, w rtol 5e-2 / atol 1e-3, V rtol 5e-2 / "
          f"atol 5e-3 but for {flat_flips} guard flips and {flat_near} "
          f"entries of features sharing an example with one; after "
          f"{ALS_SWEEPS} "
          f"sweeps eval RMSE {r_bs:.6f} vs {r_fl:.6f} (within 1e-3; {apart} "
          f"entries of V then apart beyond rtol 5e-2 / atol 5e-3); B7 held "
          f"to float64: {'; '.join(checked)}", flush=True)
    print(f"time: phases 28-30 in {time.perf_counter() - t_phases:.1f} s "
          "(host wall)", flush=True)
    return entries


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


def rowsum_sq64(g, seg, num_segments):
    """B6's plain version in float64, rounded to float32: the plain
    direct and dedup steps' reduce."""
    from sparkfm_tpu_torch.ops import segsum
    return segsum.segment_rowsum_sq_reference(g.double(), seg,
                                              num_segments).float()


REPLACED_BY_B6 = ("the squares of [g_v | g_w], their cat into [g_v | g_v² | "
                  "g_w | g_w²] and B5: the fused and sorted steps' sums "
                  "before B6 took them")


def replaced_by_b6(g, seg, num_segments):
    """What B6 replaced on the fused and sorted steps, on B6's input
    ``g`` = [g_v | g_w] (N, k+1): the squares, the (N, 2k+2) pack by
    ``cat``, and B5 over it."""
    from sparkfm_tpu_torch.ops import segsum
    gv, gw = g[:, :-1], g[:, -1:]
    return segsum.segment_rowsum(torch.cat([gv, gv.square(), gw,
                                            gw.square()], 1), seg,
                                 num_segments)


def as64(a):
    return a.double() if torch.is_tensor(a) and a.is_floating_point() else a


def hold64(fn, plain, args, label, checked, tol=1e-4):
    """``fn`` against ``plain`` in float64 on ``args`` (max |a - b| /
    (1 + |b|) < ``tol``), repeated bitwise, ranks without slots zero;
    returns (max abs error, max rel error, the f32 plain version's)."""
    exact = plain(*[as64(a) for a in args])
    got = fn(*args)
    err = max_rel_err(got, exact)
    plain_err = max_rel_err(plain(*args), exact)
    if not err < tol:
        raise AssertionError(f"{label}: kernel {err:.3g} from the float64 "
                             f"sums (plain f32 {plain_err:.3g})")
    if not torch.equal(got, fn(*args)):
        raise AssertionError(f"{label}: sums do not repeat")
    ranks = args[3] if len(args) > 3 else args[1]
    empty = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    empty[ranks.long()] = False
    if got[empty].any():
        raise AssertionError(f"{label}: a rank without slots is not zero")
    checked.append(f"{label}: kernel {err:.3g}, plain f32 "
                   f"{plain_err:.3g}")
    return float((got.double() - exact).abs().max()), err, plain_err


B5_WIDE = 354          # the widest row B5 is held at (an FFM record's)
B5_WIDE_TOL = 2.5e-4   # its bound: see b5_wide_errors
B5_WIDE_SEEDS = 8


def b5_wide_errors(dev, seg, u, seeds):
    """B5 at W = 354 on ``seg`` (phase 15's plan) over the rows of each of
    ``seeds``: [(kernel, plain f32)] max |a - b| / (1 + |b|) against
    float64. B5's rounding of one entry does not depend on W (fixed
    chunks of slots, then the chunks' partial sums in order), but the
    largest over W columns does: at W = 354 the ~162k-slot head run alone
    gives 354 draws of its error. ``B5_WIDE_TOL`` lies between the
    kernel's largest error and the f32 plain version's smallest on an
    H100: 1.52e-4 (1.87e-4 on other rows) and 3.26e-4 over 33 sets of
    rows on four plans (PERF.md)."""
    from sparkfm_tpu_torch.ops import segsum
    out = []
    for sd in seeds:
        g = torch.randn((seg.shape[0], B5_WIDE), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(sd))
        exact = segsum.segment_rowsum_reference(g.double(), seg, u)
        out.append((max_rel_err(segsum.segment_rowsum(g, seg, u), exact),
                    max_rel_err(segsum.segment_rowsum_reference(g, seg, u),
                                exact)))
        del g, exact
    return out


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

    # 15. B5 against its float64 plain version: the fused and sorted
    # payloads at the main path's plan, then odd shapes, on rows of this
    # phase's own seed
    checked = []
    gen15 = torch.Generator(device=dev).manual_seed(SEED + 15)
    g66 = torch.randn((n, 2 * RANK + 2), generator=gen15, device=dev)
    rowsum_main = hold64(segsum.segment_rowsum,
                       segsum.segment_rowsum_reference, (g66, seg, u),
                       f"W=66 N={n} U={u}", checked)
    for w in (RANK + 3, 1, 3, 130, B5_WIDE):
        g = torch.randn((n, w), generator=gen15, device=dev)
        hold64(segsum.segment_rowsum, segsum.segment_rowsum_reference,
               (g, seg, u), f"W={w}", checked,
               B5_WIDE_TOL if w == B5_WIDE else 1e-4)
    del g
    wide = b5_wide_errors(dev, seg, u, range(SEED + 1000,
                                             SEED + 1000 + B5_WIDE_SEEDS))
    if not max(k for k, _ in wide) < B5_WIDE_TOL:
        raise AssertionError(f"B5 at W={B5_WIDE} over {len(wide)} seeds: "
                             f"(kernel, plain f32) {wide}")
    checked.append(f"W={B5_WIDE} over {len(wide)} more seeds: kernel "
                   f"{min(k for k, _ in wide):.3g}.."
                   f"{max(k for k, _ in wide):.3g}, plain f32 "
                   f"{min(p for _, p in wide):.3g}.."
                   f"{max(p for _, p in wide):.3g} (bound {B5_WIDE_TOL:g})")
    gaps = seg + torch.cumsum((torch.rand(n, generator=gen15, device=dev)
                               < 0.05).int(), 0, dtype=torch.int32)
    odd = 100003
    for label, s in (("seg[0] = 5", seg + 5), ("gaps", gaps),
                     (f"N={odd}", seg[:odd])):
        hold64(segsum.segment_rowsum, segsum.segment_rowsum_reference,
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
               "segment_rowsum_sq": segsum.ROWSUM_SQ,
               "fm_grad_segsum_factored": segsum.FACTORED}
    plain_swaps = [(rowio, "gather_rows", rowio.gather_rows_reference),
                   (rowio, "scatter_set_rows",
                    rowio.scatter_set_rows_reference),
                   (segsum, "segment_rowsum", rowsum64),
                   (segsum, "segment_rowsum_sq", rowsum_sq64)]
    steps = 2 * 20
    train_launches = {}

    def train(label, sums="segment_rowsum_sq", optimizer="adagrad", **kw):
        """train_sgd of config 3 for 2 epochs on a path whose per-unique
        sums run ``sums``: B6 for adagrad's [g_v | g_w], B5 for
        adagrad_row's pack."""
        sgd = SGDConfig(batch_size=BATCH, learning_rate=0.05,
                        optimizer=optimizer, epochs=2, **kw)
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        res = train_sgd(cfg, sgd, ds, generator=torch.Generator(
            device=dev).manual_seed(SEED), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        want = dict.fromkeys(kernels, 0)
        want.update({"gather_rows": steps, "scatter_set_rows": steps,
                     sums: steps})
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
        train_launches[label] = launches[sums]

    def init_state():
        return sgd_fused.init_fused_state(cfg, torch.Generator(
            device=dev).manual_seed(SEED + 2), device=dev)

    # accumulate="auto", the default: sorted sums on the card, B6 for
    # adagrad (no [g_v | g_v² | g_w | g_w²] pack), B5 for adagrad_row's
    train("fused (auto)", update_path="fused")
    train("fused (auto), adagrad_row", sums="segment_rowsum",
          optimizer="adagrad_row", update_path="fused")
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
        want = {"gather_rows": 3, "scatter_set_rows": 3, "segment_rowsum": 0,
                "segment_rowsum_sq": 0 if accumulate == "scatter" else 3,
                "fm_grad_segsum_factored": 0}
        run_losses = [float(a["loss"]) for a in run]
        if launches != want or not np.all(np.isfinite(run_losses)) or any(
                bool(a["unique_overflow"]) for a in run):
            raise AssertionError(f"device-plan fused steps ({accumulate}): "
                                 f"launches {launches}, losses {run_losses}")
        # "auto" is B6 on the card: the same steps as "segsum", bit for bit
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
        res_sq = hold64(segsum.segment_rowsum_sq,
                      segsum.segment_rowsum_sq_reference, (g, seg, u),
                      f"B6 W={k + 1}", checked)
        vw_u = 0.01 * torch.randn((u, k + 1), generator=gen, device=dev)
        ex = torch.randn((n, k + 2), generator=gen, device=dev)
        ex[:, k + 1] = (torch.rand(n, generator=gen, device=dev) < 0.9)
        x = torch.randn(n, generator=gen, device=dev)
        args = (vw_u.index_select(0, seg.long()), ex, x, seg, u, cv, cw)
        res_b4 = hold64(segsum.fm_grad_segsum, segsum.fm_grad_segsum_reference,
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
    # B4 has no production path in either package: its launch count comes
    # from one call at the main path's shapes (B6's from phase 19's run)
    torch.cuda.synchronize()
    segsum.FM_GRAD.launches = 0
    segsum.fm_grad_segsum(*main["b4"])
    torch.cuda.synchronize()
    b4_launches = segsum.FM_GRAD.launches
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
    # what B6 replaced on the fused and sorted steps: the squares of
    # [g_v | g_w], their cat into [g_v | g_v² | g_w | g_w²] and B5
    sq_args = main["sq"]
    before_b6 = (time_ms(replaced_by_b6, [sq_args]),
                 1e3 * spun_ms(lambda: replaced_by_b6(*sq_args)))
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
    print(f"time: the sequence B6 replaced on the fused and sorted steps "
          f"(squares, cat, B5) at W=33 -> 66: {before_b6[0]:.4f} ms back to "
          f"back; device {before_b6[1]:.2f} us, against B6's "
          f"{times['segment_rowsum_sq'][2]:.2f} us (CUDA events, queued "
          f"behind a spin kernel); {card}", flush=True)
    del lib_out, seg_l
    del g66, timed, main, sq_args
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
              in_kernel, launches=b4_launches, path=no_path),
        entry("segment_rowsum", 101, rowsum_main, times["segment_rowsum"],
              "index_add_",
              launches=train_launches["fused (auto), adagrad_row"],
              path="train_sgd fused under adagrad_row, accumulate='auto' "
                   "(phase 16), its (N, k+3) pack; timed at W = 66"),
        entry("segment_rowsum_sq", 238, sq_res, times["segment_rowsum_sq"],
              "none (the squares are formed in the kernel)",
              launches=train_launches["fused (auto)"],
              launches_sorted=train_launches["sorted"],
              path="train_sgd fused, accumulate='auto' (phase 16), sorted "
                   "(phase 17): [g_v | g_w] at W = 33",
              before=REPLACED_BY_B6, before_ms=before_b6[0],
              before_device_ms=before_b6[1] / 1e3)]


# BASELINE config 1 (benchmarks/run_config.py:30-58: ML-100K shape) and
# config 4 (benchmarks/bench_configs.py:180-205: Avazu-shape FFM)
CONFIG1 = dict(num_users=943, num_items=1682, num_examples=100_000)
FFM_BUCKETS, FFM_FIELDS, FFM_RANK, FFM_BATCH = 1 << 22, 22, 8, 8192
SLOT_NAMES = ("slot_w0", "slot_w", "slot_v", "slot2_w0", "slot2_w",
              "slot2_v")


def clone_state(state):
    """A copy of an SGDState on its device."""
    from sparkfm_tpu_torch.models.fm import FMParams
    p = state.params
    return dataclasses.replace(
        state, params=FMParams(p.w0.clone(), p.w.clone(), p.v.clone()),
        **{n: getattr(state, n).clone() for n in SLOT_NAMES})


def state_tables(state):
    """An SGDState's tables by name (0-d slot2 placeholders left out)."""
    out = {"w": state.params.w, "v": state.params.v}
    out.update((n, getattr(state, n)) for n in SLOT_NAMES[1:]
               if getattr(state, n).dim())
    return out


def state_steps_against_plain(step, state, batches, swaps, kernels, label,
                              rows, allow=0, allow_atol=0.0):
    """:func:`steps_against_plain` for the direct and dedup steps'
    SGDState: every table and slot ``[:rows]`` at rtol 1e-4, atol 1e-6,
    losses and the bias at rtol 1e-5. ``allow``/``allow_atol``: entries
    per table and step that may differ further, each within
    ``allow_atol`` (adam's, see phase 20). Returns the losses and the
    number of entries excused."""
    kernels = list(kernels)
    losses = []
    excused = 0
    for b in batches:
        plain_in = clone_state(state)
        state, aux = step(state, b)
        counts = [k.launches for k in kernels]
        with swapped(swaps):
            plain_out, plain_aux = step(plain_in, b)
        if [k.launches for k in kernels] != counts:
            raise AssertionError(f"the plain {label} step launched a kernel")
        losses.append(float(aux["loss"]))
        np.testing.assert_allclose(losses[-1], float(plain_aux["loss"]),
                                   rtol=1e-5)
        plain_tables = state_tables(plain_out)
        for name, t in state_tables(state).items():
            excused += assert_close_rows(
                t[:rows], plain_tables[name][:rows], 1e-4, 1e-6,
                f"{label} step {len(losses)} {name}", allow, allow_atol)
        np.testing.assert_allclose(float(state.params.w0),
                                   float(plain_out.params.w0), rtol=1e-5)
        del plain_in, plain_out, plain_tables
    return losses, excused


def exact_writes(counts):
    """The row write, checked after each call: every row that a run's
    first slot names holds that slot's row exactly; appends the rows
    written to ``counts``."""
    from sparkfm_tpu_torch.ops import rowio
    kernel = rowio.scatter_set_rows

    def write(table, ids, rows):
        out = kernel(table, ids, rows)
        keep = torch.ones_like(ids, dtype=torch.bool)
        keep[1:] = ids[1:] != ids[:-1]
        if not torch.equal(table.index_select(0, ids[keep].long()),
                           rows[keep]):
            raise AssertionError(f"row write inexact at W={table.shape[1]}")
        counts.append(int(keep.sum()))
        return out
    return write


def capturing(fn, store):
    """``fn``, keeping a copy of the arguments of its first call."""
    def call(*args):
        if not store:
            store.extend(a.clone() if torch.is_tensor(a) else a
                         for a in args)
        return fn(*args)
    return call


def dedup_row_times(state, plan, timed):
    """The dedup step's row kernels at its shapes, on its state: the
    two-table gather of [v | w] (each is exact against its plain version
    first) and the writes of V (W = 32) and w (W = 1) rows. Returns
    name -> (source, TPU file:line, times, library)."""
    from sparkfm_tpu_torch.ops import rowio
    v, w = state.params.v, state.params.w
    uids = plan.uids
    u, k = uids.shape[0], v.shape[1]
    distinct = min(int(plan.count) + 1, u)
    if not torch.equal(rowio.gather_vw_rows(v, w, uids),
                       rowio.gather_vw_rows_reference(v, w, uids)):
        raise AssertionError("two-table gather wrong at the dedup shape")
    keep = uids[:distinct].long()
    out = {"gather_vw_rows (dedup, config 3 width)": (
        "rowio.cu", "pallas_rowio.py:140", timed(
            f"B1 gather_vw_rows per call, dedup [v | w] (U={u}, "
            f"W={k + 1})", rowio.gather_vw_rows,
            rowio.gather_vw_rows_reference, (v, w, uids), None,
            u * 4 + (distinct + u) * (k + 1) * 4, 0),
        "none (two index_selects and a cat: the plain version)")}
    for width, table in ((k, v), (1, w.view(-1, 1))):
        rows = torch.randn((u, width), device=v.device)
        rowio.scatter_set_rows(table, uids, rows)
        firsts = torch.ones(u, dtype=torch.bool, device=v.device)
        firsts[1:] = uids[1:] != uids[:-1]
        if not torch.equal(table[uids[firsts].long()], rows[firsts]):
            raise AssertionError(f"row write wrong at W={width}")
        out[f"scatter_set_rows (dedup, W = {width})"] = (
            "rowio.cu", "pallas_rowio.py:74", timed(
                f"B2 scatter_set_rows per call, dedup table (U={u}, "
                f"W={width})", rowio.scatter_set_rows,
                rowio.scatter_set_rows_reference, (table, uids, rows),
                lambda t=table, r=rows: t.index_copy_(0, keep,
                                                      r[:distinct]),
                u * 4 + (u + distinct) * width * 4, 0),
            "index_copy_ over the plan's distinct ids")
    return out


def timed_kernel(name, fn, plain, args, library, nbytes, ops, card,
                 library_reps=None):
    """Back-to-back and device times of ``fn``, its plain version and the
    library call (or None) on ``args``, and the bound. ``library_reps``:
    time the library call over 2 windows of that many calls (for one that
    takes a large part of a second)."""
    lib = {} if library_reps is None else dict(reps=library_reps, windows=2)
    t = {"ms": time_ms(fn, [args]), "plain_ms": time_ms(plain, [args]),
         "library_ms": library and time_ms(library, [()], **lib),
         "device_ms": spun_ms(lambda: fn(*args)),
         "plain_device_ms": spun_ms(lambda: plain(*args)),
         "library_device_ms": library and spun_ms(library, **lib)}
    t.update(bound(nbytes, ops, t["device_ms"]))
    print(f"time: {name}: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms"
          + (f", library {t['library_ms']:.4f} ms" if library else "")
          + f" back to back (CUDA events); device "
          f"{1e3 * t['device_ms']:.2f} us vs "
          f"{1e3 * t['plain_device_ms']:.2f} us"
          + (f", library {1e3 * t['library_device_ms']:.2f} us"
             if library else "")
          + f" (CUDA events, queued behind a spin kernel); bound "
          f"{t['bound_us']:.2f} us ({nbytes / 1e6:.2f} MB), "
          f"{pct(t['share_of_bound'])} of it; {card}", flush=True)
    return t


def rowsum_sq_entry_of(label, res, payload, launches, path, card):
    """B6's kernel entry at one path's payload (g, seg, U): its times and
    bound, and its errors against float64 ``res`` (from :func:`hold64`)."""
    from sparkfm_tpu_torch.ops import segsum
    g, seg, u = payload
    n, w = g.shape
    t = timed_kernel(f"B6 segment_rowsum_sq per call, {label} (N={n}, "
                     f"W={w} -> {2 * w}, U={u})", segsum.segment_rowsum_sq,
                     segsum.segment_rowsum_sq_reference, (g, seg, u), None,
                     4 * (n * w + n + 2 * u * w), 3 * n * w, card)
    return {"name": f"segment_rowsum_sq ({label})", "route": "cuda",
            "source": "sparkfm_tpu_torch/csrc/segsum.cu",
            "replaces": "sparkfm_tpu/ops/pallas_segsum.py:238",
            "launches": launches, "path": path,
            "max_abs_err": res[0], "max_rel_err": res[1],
            "plain_f32_max_rel_err": res[2],
            "err_against": "plain version in float64",
            "library": "none (the squares are formed in the kernel)",
            **t}


def direct_dedup_ffm_phases(dev, cfg, gen, rng, card):
    """Phases 19-21: BASELINE config 1 on the direct path, the dedup path
    at BASELINE config 3's width under adam and under momentum, and
    BASELINE config 4 (FFM) on the fused path. Returns the kernels' JSON
    entries at the shapes these paths give B1, B2, B5 and B6, and B6's
    launches in config 1's run."""
    from sparkfm_tpu_torch import (FMConfig, MicroBatcher, SGDConfig, Task,
                                   train_sgd)
    from sparkfm_tpu_torch.api import _detect_slot_major
    from sparkfm_tpu_torch.data import synth
    from sparkfm_tpu_torch.data.batching import (SparseDataset,
                                                 batch_iterator)
    from sparkfm_tpu_torch.data.split import split_by_random
    from sparkfm_tpu_torch.models import fm as fm_model
    from sparkfm_tpu_torch.ops import interaction as I
    from sparkfm_tpu_torch.ops import rowio, segsum
    from sparkfm_tpu_torch.solvers import sgd as sgd_solver
    from sparkfm_tpu_torch.solvers import sgd_fused

    kernels = {"gather_rows": rowio.GATHER, "gather_vw_rows": rowio.GATHER_VW,
               "scatter_set_rows": rowio.SCATTER,
               "segment_rowsum": segsum.ROWSUM,
               "segment_rowsum_sq": segsum.ROWSUM_SQ}
    plain_swaps = [(rowio, "gather_rows", rowio.gather_rows_reference),
                   (rowio, "gather_vw_rows", rowio.gather_vw_rows_reference),
                   (rowio, "scatter_set_rows",
                    rowio.scatter_set_rows_reference),
                   (segsum, "segment_rowsum", rowsum64),
                   (segsum, "segment_rowsum_sq", rowsum_sq64)]

    def zero_counts():
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {n: k.launches for n, k in kernels.items() if k.launches}

    def profile_epoch(label, fm_cfg, sgd_cfg, ds):
        """One epoch of train_sgd, its launches counted, then traced:
        trained ex/s, busy and idle share, top device events, peak
        memory. Returns the launches."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        res = train_sgd(fm_cfg, sgd_cfg, ds, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        eps = res.examples_per_sec
        del res
        busy, events = device_us(lambda: train_sgd(fm_cfg, sgd_cfg, ds,
                                                   device=dev), tries=2)
        top = "; ".join(f"{e.key[:50]} x{e.count} "
                        f"{e.self_device_time_total:.0f}" for e in events[:8])
        print(f"profile: one-epoch train_sgd, {label} "
              f"({-(-ds.num_examples // sgd_cfg.batch_size)} steps of "
              f"{sgd_cfg.batch_size}, state init included): {eps:.0f} ex/s "
              f"(first step left out); device busy {busy / 1e3:.3f} ms of "
              f"{wall * 1e3:.3f} ms untraced wall "
              f"({100 * (1 - busy / 1e6 / wall):.1f}% idle); peak device "
              f"memory {peak / 2**30:.2f} GiB; launches {launches}; top "
              f"device events (us): {top}; {card}", flush=True)
        return launches

    def timed(*args):
        return timed_kernel(*args, card)

    def rowsum_sq_entry(*args):
        return rowsum_sq_entry_of(*args, card)

    entries = []

    # 19. BASELINE config 1: the recipe of benchmarks/run_config.py, 15
    # epochs on the direct path, twice; then 5 direct steps against the
    # plain versions
    ml = synth.synth_movielens(seed=0, **CONFIG1)
    parts = split_by_random(ml, 0.8, 0.2, seed=0)
    cfg1 = FMConfig(num_features=ml.num_features, num_factors=8, reg_v=0.02,
                    seed=SEED)
    sgd1 = SGDConfig(batch_size=4096, epochs=15, learning_rate=0.1)
    if sgd_solver.resolve_update_path(cfg1, sgd1) != "direct":
        raise AssertionError("config 1 does not take the direct path")
    steps1 = sgd1.epochs * -(-parts.training.num_examples // 4096)
    evals = 2 * -(-parts.test.num_examples // 4096)    # epochs 0 and 14
    want = {"gather_vw_rows": 2 * steps1 + evals,
            "scatter_set_rows": 4 * steps1, "segment_rowsum_sq": steps1}
    runs = []
    for _ in range(2):
        zero_counts()
        t0 = time.perf_counter()
        res = train_sgd(cfg1, sgd1, parts.training, eval_ds=parts.test,
                        eval_every=14, generator=torch.Generator(
                            device=dev).manual_seed(SEED), device=dev)
        torch.cuda.synchronize()
        runs.append((res, read_counts(), time.perf_counter() - t0))
        if runs[-1][1] != want:
            raise AssertionError(f"config 1 launches {runs[-1][1]}, "
                                 f"expected {want}")
    res, launches1, wall1 = runs[0]
    for name in ("w0", "w", "v"):
        if not torch.equal(getattr(res.params, name),
                           getattr(runs[1][0].params, name)):
            raise AssertionError(f"config 1: two card runs differ in {name}")
    if res.history != runs[1][0].history:
        raise AssertionError("config 1: two card runs' histories differ")
    rmse = res.history[-1]["eval_rmse"]
    mean_base = float(np.sqrt(np.mean(
        (parts.test.y - float(np.mean(parts.training.y))) ** 2)))
    losses = [h["train_loss"] for h in res.history]
    if not (rmse < mean_base and np.all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"config 1: test RMSE {rmse} against the mean "
                             f"baseline {mean_base}, losses {losses}")
    print(f"train: BASELINE config 1 (synth_movielens {CONFIG1}, "
          f"{ml.num_features} features, split 0.8/0.2), train_sgd direct "
          f"path, {steps1} steps of 4096: test RMSE {rmse:.5f} (epoch 0 "
          f"{res.history[0]['eval_rmse']:.5f}) < train-mean baseline "
          f"{mean_base:.5f}; epoch losses {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; {res.examples_per_sec:.0f} ex/s (first step "
          f"left out), {wall1:.3f} s wall; launches {launches1} (two-table "
          f"gathers: 2 a step + {evals} for the evals; writes 4 a step); a "
          f"second card run equal bit for bit; {card}", flush=True)
    del runs
    step1 = sgd_solver.make_train_step(cfg1, sgd1)
    batches1 = list(batch_iterator(parts.training, 4096, device=dev))[:5]
    payload1 = []
    with swapped([(segsum, "segment_rowsum_sq", capturing(
            segsum.segment_rowsum_sq, payload1))]):
        losses, _ = state_steps_against_plain(
            step1, sgd_solver.init_state(fm_model.init_params(
                cfg1, gen, device=dev), optimizer="adagrad"),
            batches1, plain_swaps, kernels.values(), "direct",
            cfg1.num_features)
    print(f"check: 5 direct steps (config 1), each from the same state with "
          f"the kernels and with the plain versions: losses {losses} equal "
          f"(rtol 1e-5), every table and slot equal (rtol 1e-4, atol 1e-6)",
          flush=True)
    checked = []
    res1 = hold64(segsum.segment_rowsum_sq, segsum.segment_rowsum_sq_reference,
                  tuple(payload1), "B6 on config 1's payload", checked)
    profile_epoch("BASELINE config 1, direct", cfg1,
                  dataclasses.replace(sgd1, epochs=1), parts.training)
    entries.append(rowsum_sq_entry(
        "direct, config 1", res1, payload1,
        launches1["segment_rowsum_sq"],
        "train_sgd direct, BASELINE config 1 (phase 19)"))
    del payload1, batches1, ml, parts
    torch.cuda.empty_cache()

    # 20. the dedup path at BASELINE config 3's width (2^24 buckets, rank
    # 32, bench-recipe batches of 16384 x 39 with host ladder plans) under
    # adam and under momentum
    bds = SparseDataset(ids=np.concatenate([zipf_ids(rng, BATCH)
                                            for _ in range(5)]),
                        vals=np.ones((5 * BATCH, SLOTS), np.float32),
                        y=rng.integers(0, 2, 5 * BATCH).astype(np.float32),
                        num_features=BUCKETS)
    batches = list(batch_iterator(bds, BATCH, device=dev,
                                  dedup_budget="ladder", dedup_fill=BUCKETS))
    ds3 = synth.synth_ctr(num_examples=BATCH * 20, num_fields=SLOTS,
                          num_buckets=BUCKETS, seed=SEED)
    dedup_launches = {}
    for label, kw, per_step in (
            ("adam", dict(optimizer="adam", learning_rate=0.01),
             {"gather_vw_rows": 3, "scatter_set_rows": 6,
              "segment_rowsum_sq": 1}),
            ("momentum", dict(optimizer="sgd", momentum=0.9,
                              learning_rate=0.01),
             {"gather_vw_rows": 2, "scatter_set_rows": 4,
              "segment_rowsum_sq": 1})):
        sgd_d = SGDConfig(batch_size=BATCH, epochs=1, **kw)
        if sgd_solver.resolve_update_path(cfg, sgd_d) != "dedup":
            raise AssertionError(f"{label} does not take the dedup path")
        step = sgd_solver.make_train_step(cfg, sgd_d)
        state = sgd_solver.pad_state_for_dedup(sgd_solver.init_state(
            fm_model.init_params(cfg, torch.Generator(device=dev).manual_seed(
                SEED + 3), device=dev), optimizer=sgd_d.optimizer))
        # two card runs of 3 steps from one state; the first step's writes
        # checked exactly and its B6 payload kept
        written, payload = [], []
        run_a = clone_state(state)
        zero_counts()
        with swapped([(rowio, "scatter_set_rows", exact_writes(written)),
                      (segsum, "segment_rowsum_sq", capturing(
                          segsum.segment_rowsum_sq, payload))]):
            run_a, _ = step(run_a, batches[0])
        for b in batches[1:3]:
            run_a, _ = step(run_a, b)
        launches = read_counts()
        if launches != {k: 3 * v for k, v in per_step.items()}:
            raise AssertionError(f"dedup {label}: launches {launches} in 3 "
                                 f"steps, expected {per_step} a step")
        run_b = clone_state(state)
        for b in batches[:3]:
            run_b, _ = step(run_b, b)
        tables_b = state_tables(run_b)
        for name, t in state_tables(run_a).items():
            if not torch.equal(t, tables_b[name]):
                raise AssertionError(f"dedup {label}: two card runs differ "
                                     f"in {name}")
        del run_a, run_b, tables_b
        res_d = hold64(segsum.segment_rowsum_sq,
                       segsum.segment_rowsum_sq_reference, tuple(payload),
                       f"B6 on the dedup {label} payload", checked)
        # adam moves every entry it touches by about lr, whatever the size
        # of its summed gradient, so where a hot row's sum of ~10^5 terms
        # nearly cancels, the float32 rounding of the sum (held to float64
        # above) reaches the table as a move of up to 2 lr in either
        # direction (on an H100 one entry in 2^29 did so). Up to 64
        # entries a table and step may differ by at most 2 lr; any other
        # difference fails.
        allow = 64 if label == "adam" else 0
        losses, excused = state_steps_against_plain(
            step, state, batches, plain_swaps, kernels.values(),
            f"dedup {label}", BUCKETS, allow, 2 * sgd_d.learning_rate)
        print(f"check: dedup path, {label}, at config 3's width (state "
              f"{tuple(state.params.v.shape)} with "
              f"{len(state_tables(state))} tables): 3 steps twice from one "
              f"state equal bit for bit, launches {launches}; the first "
              f"step's {len(written)} writes exact on every written row "
              f"({written[:2]} rows); B6 on its payload "
              f"{tuple(payload[0].shape)} against float64: {checked[-1]}; 5 "
              f"steps against the plain versions: losses {losses} equal "
              f"(rtol 1e-5), every table and slot equal (rtol 1e-4, atol "
              f"1e-6) but {excused} entries within 2 lr (up to {allow} a "
              f"table and step allowed); {card}", flush=True)
        if label == "adam":
            dedup_times = dedup_row_times(state, batches[0].plan, timed)
        del state, step
        dedup_launches[label] = profile_epoch(
            f"dedup, {label}, BASELINE config 3 width", cfg, sgd_d, ds3)
        if label == "adam":
            entries.append(rowsum_sq_entry(
                "dedup, config 3 width", res_d, payload,
                dedup_launches[label]["segment_rowsum_sq"],
                "train_sgd dedup under adam at config 3's width (phase 20)"))
            for name, (src, line, t, lib) in dedup_times.items():
                entries.append({
                    "name": name, "route": "cuda",
                    "source": f"sparkfm_tpu_torch/csrc/{src}",
                    "replaces": f"sparkfm_tpu/ops/{line}",
                    "launches": dedup_launches[label][name.split()[0]],
                    "launches_counts": "every launch of the kernel in the "
                                       "epoch, all widths",
                    "path": "train_sgd dedup under adam at config 3's "
                            "width (phase 20)",
                    "max_abs_err": 0.0, "library": lib, **t})
        del payload
        torch.cuda.empty_cache()
    del batches, bds, ds3

    # 21. BASELINE config 4: FFM (22 fields, rank 8, 2^22 buckets) on the
    # fused path, record width 356
    cfg4 = FMConfig(num_features=FFM_BUCKETS, num_factors=FFM_RANK,
                    num_fields=FFM_FIELDS, task=Task.CLASSIFICATION,
                    reg_v=1e-6, seed=SEED, slot_major_fields=True)
    sgd4 = SGDConfig(batch_size=FFM_BATCH, learning_rate=0.05,
                     optimizer="adagrad", epochs=1)
    if sgd_solver.resolve_update_path(cfg4, sgd4) != "fused":
        raise AssertionError("config 4 does not take the fused path")
    width = sgd_fused.record_width(FFM_RANK, FFM_FIELDS)
    vk = FFM_RANK * FFM_FIELDS
    used = 2 * vk + 2
    ds4 = synth.synth_ctr(num_examples=FFM_BATCH * 20,
                          num_fields=FFM_FIELDS, num_buckets=FFM_BUCKETS,
                          seed=SEED)
    if not _detect_slot_major(ds4, FFM_FIELDS):
        raise AssertionError("synth_ctr's field_ids are not slot-major")
    batches4 = list(batch_iterator(ds4, FFM_BATCH, device=dev,
                                   dedup_budget="ladder",
                                   dedup_fill=FFM_BUCKETS))[:5]
    plan4 = batches4[0].plan
    u4, seg4 = plan4.uids.shape[0], plan4.seg
    n4 = seg4.shape[0]
    # the fused FFM step sums [g_v | g_w] (N, vk + 1) by B6
    g177 = torch.randn((n4, vk + 1), generator=gen, device=dev)
    res_b6 = hold64(segsum.segment_rowsum_sq,
                    segsum.segment_rowsum_sq_reference, (g177, seg4, u4),
                    f"B6 W={vk + 1} N={n4} U={u4}", checked)
    state4 = sgd_fused.init_fused_state(cfg4, torch.Generator(
        device=dev).manual_seed(SEED + 4), device=dev)
    if state4.table.shape != (FFM_BUCKETS + 1, width):
        raise AssertionError(f"FFM record table {tuple(state4.table.shape)}")
    scratch = state4.table.clone()
    write_err = 0.0
    for b in batches4[:2]:
        u = b.plan.uids
        if not torch.equal(rowio.gather_rows(scratch, u),
                           rowio.gather_rows_reference(scratch, u)):
            raise AssertionError(f"gather kernel wrong at W={width}")
        rows = torch.randn((u.shape[0], width), generator=gen, device=dev)
        want_t = rowio.scatter_set_rows_reference(scratch.clone(), u, rows)
        rowio.scatter_set_rows(scratch, u, rows)
        write_err = max(write_err, float((scratch - want_t).abs().max()))
        if not torch.equal(scratch, want_t):
            raise AssertionError(f"row write kernel != plain at W={width}")
        del want_t
    print(f"check: config 4 FFM: B6 at W={vk + 1} against float64: "
          f"{checked[-1]}; gather and row write at W={width} on the "
          f"{tuple(state4.table.shape)} record table equal their plain "
          f"versions on every row (U={[b.plan.uids.shape[0] for b in batches4[:2]]})",
          flush=True)
    # two card runs of 3 fused steps from one state, bit for bit
    step4 = sgd_fused.make_fused_train_step(cfg4, sgd4)
    outs = []
    for _ in range(2):
        s4 = dataclasses.replace(state4, table=state4.table.clone())
        for b in batches4[:3]:
            s4, _ = step4(s4, b)
        outs.append(s4.table)
        del s4
    if not torch.equal(*outs):
        raise AssertionError("config 4: two card runs of the fused FFM "
                             "step differ")
    del outs
    # adagrad moves an entry by lr * Σg / sqrt(Σg²): a float32 sum over a
    # run of n slots may differ from the float64 one by up to about
    # n * 2^-24 * max|g| <= n * 2^-24 * sqrt(Σg²), so the entry by up to
    # lr * n * 2^-24 (on an H100 one entry of 2^22 x 354 moved 1.79e-6,
    # past atol 1e-6): up to 64 entries a step may differ within that
    # bound at the longest run of the batches
    head4 = max(int(torch.unique_consecutive(
        b.plan.seg, return_counts=True)[1].max()) for b in batches4)
    flip_atol = sgd4.learning_rate * head4 * 2.0 ** -24
    losses, moved = steps_against_plain(
        step4, state4, batches4, plain_swaps, kernels.values(), "FFM fused",
        rows=FFM_BUCKETS, used=used, allow=64, allow_atol=flip_atol)
    print(f"check: 3 fused FFM steps twice from one state equal bit for "
          f"bit; 5 steps each from the same state with the kernels and with "
          f"the plain versions: losses {losses} equal (rtol 1e-5), tables "
          f"[:F, :{used}] equal (rtol 1e-4, atol 1e-6; up to 64 entries a "
          f"step within lr x {head4}-slot run x 2^-24 = {flip_atol:.3g}), "
          f"{moved} rows updated in all", flush=True)
    # serving: MicroBatcher with field_ids against the plain per-slot path
    params4 = sgd_fused.params_from_fused(state4, cfg4)
    mb = MicroBatcher(params4, cfg4, max_batch=MAX_BATCH)
    sizes = [1, 7, 300, 2000, 5000]
    starts = np.cumsum([0] + sizes)
    reqs = [(ds4.ids[a:b], ds4.vals[a:b], ds4.field_ids[a:b])
            for a, b in zip(starts[:-1], starts[1:])]
    for r in reqs:
        mb.submit(*r)
    zero_counts()
    t0 = time.perf_counter()
    outs = mb.flush()
    flush_s = time.perf_counter() - t0
    flush_launches = read_counts()
    chunks = -(-sum(sizes) // MAX_BATCH)
    if flush_launches != {"gather_vw_rows": chunks}:
        raise AssertionError(f"FFM flush launches {flush_launches}, expected "
                             f"{chunks} two-table gathers")
    for (ids, vals, fids), got in zip(reqs, outs):
        ids_t = torch.as_tensor(ids, device=dev)
        vw = rowio.gather_vw_rows_reference(
            params4.v, params4.w, ids_t.reshape(-1)).view(*ids.shape, vk + 1)
        want_p = torch.sigmoid(I.ffm_scores_from_gathered(
            params4.w0, vw[..., vk], vw[..., :vk],
            torch.as_tensor(vals, device=dev),
            torch.as_tensor(fids, device=dev), FFM_FIELDS)).cpu().numpy()
        np.testing.assert_allclose(got, want_p, rtol=1e-5, atol=1e-6)
    print(f"serve: config 4 FFM MicroBatcher, {len(reqs)} requests with "
          f"field_ids, {sum(sizes)} examples, {chunks} chunks: "
          f"{flush_s:.4f} s, {sum(sizes) / flush_s:.0f} ex/s; launches "
          f"{flush_launches}; outputs equal the plain per-slot path's in the "
          f"field-aggregated form (rtol 1e-5, atol 1e-6); {card}", flush=True)
    del params4, mb
    # the kernels at config 4's shapes, then one epoch of train_sgd: 20
    # fused steps, B1 = B2 = B6 = steps
    uids4 = plan4.uids
    distinct = min(int(plan4.count) + 1, u4)
    rows4 = torch.randn((u4, width), generator=gen, device=dev)
    keep = uids4[:distinct].long()
    t_gather = timed(f"B1 gather_rows per call, FFM record (U={u4}, "
                     f"W={width})", rowio.gather_rows,
                     rowio.gather_rows_reference, (state4.table, uids4),
                     lambda: state4.table.index_select(0, uids4.long()),
                     u4 * 4 + (distinct + u4) * width * 4, 0)
    t_write = timed(f"B2 scatter_set_rows per call, FFM record (U={u4}, "
                    f"W={width})", rowio.scatter_set_rows,
                    rowio.scatter_set_rows_reference,
                    (scratch, uids4, rows4),
                    lambda: scratch.index_copy_(0, keep, rows4[:distinct]),
                    u4 * 4 + (u4 + distinct) * width * 4, 0)
    before4 = (time_ms(replaced_by_b6, [(g177, seg4, u4)]),
               spun_ms(lambda: replaced_by_b6(g177, seg4, u4)))
    del scratch, rows4, state4, batches4
    torch.cuda.empty_cache()
    launches4 = profile_epoch("BASELINE config 4 FFM, fused", cfg4, sgd4, ds4)
    steps4 = -(-ds4.num_examples // FFM_BATCH)
    if launches4 != {"gather_rows": steps4, "scatter_set_rows": steps4,
                     "segment_rowsum_sq": steps4}:
        raise AssertionError(f"config 4 launches {launches4}, expected "
                             f"{steps4} of B1, B2 and B6")
    path4 = "train_sgd fused, BASELINE config 4 FFM (phase 21)"
    for name, line, src, t, err, lib in (
            ("gather_rows (FFM record)", "pallas_rowio.py:140", "rowio.cu",
             t_gather, 0.0, "index_select"),
            ("scatter_set_rows (FFM record)", "pallas_rowio.py:74",
             "rowio.cu", t_write, write_err,
             "index_copy_ over the plan's distinct ids")):
        entries.append({
            "name": name, "route": "cuda",
            "source": f"sparkfm_tpu_torch/csrc/{src}",
            "replaces": f"sparkfm_tpu/ops/{line}",
            "launches": launches4[name.split()[0]], "path": path4,
            "max_abs_err": err, "library": lib, **t})
    entries.append(rowsum_sq_entry(
        "FFM record", res_b6, (g177, seg4, u4),
        launches4["segment_rowsum_sq"], path4))
    entries[-1].update(before=REPLACED_BY_B6, before_ms=before4[0],
                       before_device_ms=before4[1])
    print(f"time: the sequence B6 replaced on the fused FFM step (squares, "
          f"cat, B5) at W={vk + 1} -> {2 * (vk + 1)}: {before4[0]:.4f} ms "
          f"back to back; device {1e3 * before4[1]:.2f} us, against B6's "
          f"{1e3 * entries[-1]['device_ms']:.2f} us (CUDA events, queued "
          f"behind a spin kernel); {card}", flush=True)
    del g177
    return entries


GRAPH_TRAP_CHILD = """
import sys, torch
from sparkfm_tpu_torch import FMConfig, SGDConfig
from sparkfm_tpu_torch.data.batching import SparseBatch
from sparkfm_tpu_torch.solvers import sgd_fused
dev = torch.device("cuda")
cfg = FMConfig(num_features=1000, num_factors=4)
multi = sgd_fused.make_fused_multi_step(
    cfg, SGDConfig(batch_size=64, unique_budget=512))
state = sgd_fused.init_fused_state(cfg, device=dev)
gen = torch.Generator(device=dev).manual_seed(0)

def stacked(bad):
    ids = torch.randint(0, 1000, (2, 64, 6), generator=gen, device=dev,
                        dtype=torch.int32)
    if bad:
        ids[1, 5, 2] = 1050          # the table has 1001 rows
    return SparseBatch(ids=ids, vals=torch.ones((2, 64, 6), device=dev),
                       y=torch.ones((2, 64), device=dev))

multi(state, stacked(False))         # runs eagerly, then is captured
multi(state, stacked(False))         # a replay
torch.cuda.synchronize()
assert multi.captures == 1, multi.captures
try:
    multi(state, stacked(True))      # a replay that meets the bad id
    torch.cuda.synchronize()
except RuntimeError as e:
    if "unspecified launch failure" not in str(e):   # not the trap
        raise
    print("trapped:", str(e).splitlines()[0])
    sys.exit(3)
print("no trap")
"""


def expected_graphs(ds, batch, seed, epochs, group, fill):
    """The ladder rungs on which the trainer's grouping forms a full group
    of ``group`` consecutive batches in ``epochs`` shuffled epochs of
    ``ds`` (its own host plans, built again here): the graphs a grouped
    train_sgd must capture, one per rung."""
    from sparkfm_tpu_torch.data.batching import batch_iterator
    rungs = set()
    for epoch in range(epochs):
        run, last = 0, None
        for b in batch_iterator(ds, batch, device="cpu", shuffle=True,
                                seed=seed, epoch=epoch,
                                dedup_budget="ladder", dedup_fill=fill):
            rung = b.plan.uids.shape[0]
            run = run + 1 if rung == last else 1
            last = rung
            if run == group:
                rungs.add(rung)
                run = 0
    return rungs


def graph_checkpoint_phases(dev, cfg, gen, rng, card, root):
    """Phases 22-24: grouped hybrid steps as CUDA graphs at BASELINE
    config 3's full width, the fused multi-step on device and host plans
    (and a trap inside a replayed graph), checkpointed and resumed
    training, and one full-size save and restore of config 3's state."""
    import shutil
    import tempfile
    from sparkfm_tpu_torch import FMConfig, SGDConfig, train_sgd
    from sparkfm_tpu_torch.data import synth
    from sparkfm_tpu_torch.data.batching import (SparseDataset,
                                                 batch_iterator)
    from sparkfm_tpu_torch.ops import rowio, segsum
    from sparkfm_tpu_torch.solvers import sgd_fused, sgd_hybrid
    from sparkfm_tpu_torch.utils import graphs, profiling
    from sparkfm_tpu_torch.utils.checkpoint import Checkpointer

    kernels = {"gather_rows": rowio.GATHER, "scatter_set_rows": rowio.SCATTER,
               "fm_grad_segsum_factored": segsum.FACTORED,
               "segment_rowsum_sq": segsum.ROWSUM_SQ}

    def zero_counts():
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {n: k.launches for n, k in kernels.items() if k.launches}

    def same_params(a, b):
        return all(torch.equal(getattr(a.params, n), getattr(b.params, n))
                   for n in ("w0", "w", "v"))

    # 22. train_sgd with steps_per_dispatch 1, 2 and 4 from one initial
    # table on phase 9's data: the same tables and histories bit for bit,
    # one launch of B1, B2 and B3 a step (replays included), one graph
    # per rung that forms a full group
    ds = synth.synth_ctr(num_examples=BATCH * 20, num_fields=SLOTS,
                         num_buckets=BUCKETS, seed=SEED)
    steps = 2 * 20

    def sgd_of(g, epochs=2):
        return SGDConfig(batch_size=BATCH, learning_rate=0.05,
                         optimizer="adagrad", epochs=epochs,
                         steps_per_dispatch=g)
    captured = []
    graphs_capture = graphs.capture

    def counting_capture(step, state, group, pool):
        captured.append((group.batches[0]["plan.uids"].shape[0],
                         len(group.batches)))
        return graphs_capture(step, state, group, pool)
    first = None
    for g in (1, 2, 4):
        captured.clear()
        zero_counts()
        with swapped([(graphs, "capture", counting_capture)]):
            t0 = time.perf_counter()
            res = train_sgd(cfg, sgd_of(g), ds, generator=torch.Generator(
                device=dev).manual_seed(SEED), device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_counts()
        want = {"gather_rows": steps, "scatter_set_rows": steps,
                "fm_grad_segsum_factored": steps}
        if launches != want:
            raise AssertionError(f"G={g}: launches {launches}, expected "
                                 f"{want}")
        rungs = (expected_graphs(ds, BATCH, cfg.seed, 2, g, BUCKETS)
                 if g > 1 else set())
        if sorted(captured) != sorted((r, g) for r in rungs):
            raise AssertionError(f"G={g}: graphs captured {captured}, "
                                 f"expected one per rung {sorted(rungs)}")
        if first is None:
            first = res
        elif not (same_params(res, first) and res.history == first.history):
            raise AssertionError(f"G={g}: tables or histories differ from "
                                 "G=1's")
        print(f"train: grouped hybrid train_sgd, BASELINE config 3, G={g}: "
              f"{steps} steps, {res.examples_per_sec:.0f} ex/s (first "
              f"dispatch left out), {wall:.3f} s wall; launches {launches}; "
              f"graphs captured {len(captured)} (rungs with a full group "
              f"{sorted(rungs)}); tables and history "
              f"{'the reference' if g == 1 else 'equal to G=1 bit for bit'}"
              f"; {card}", flush=True)
        del res
    losses = [h["train_loss"] for h in first.history]
    if not (np.all(np.isfinite(losses)) and losses[1] < losses[0]):
        raise AssertionError(f"grouped training losses {losses}")
    del first
    torch.cuda.empty_cache()

    # make_hybrid_multi_step on 5 bench-recipe batches of one rung (the
    # largest ladder rung of the five), twice (capture, then a replay),
    # against 10 eager steps from the same state: exact
    bds = SparseDataset(ids=np.concatenate([zipf_ids(rng, BATCH)
                                            for _ in range(5)]),
                        vals=np.ones((5 * BATCH, SLOTS), np.float32),
                        y=rng.integers(0, 2, 5 * BATCH).astype(np.float32),
                        num_features=BUCKETS)
    rung = max(b.plan.uids.shape[0] for b in batch_iterator(
        bds, BATCH, device="cpu", dedup_budget="ladder", dedup_fill=BUCKETS))
    batches = list(batch_iterator(bds, BATCH, device=dev, dedup_budget=rung,
                                  dedup_fill=BUCKETS))
    sgd = sgd_of(5, 1)
    step = sgd_hybrid.make_hybrid_train_step(cfg, sgd)
    multi = sgd_hybrid.make_hybrid_multi_step(cfg, sgd)
    stacked = sgd_hybrid.stack_batches(batches)

    def fresh():
        return sgd_fused.init_fused_state(cfg, torch.Generator(
            device=dev).manual_seed(SEED + 3), device=dev)
    eager, grouped = fresh(), fresh()
    for turn in ("captured", "replayed"):
        for b in batches:
            eager, aux = step(eager, b)
        zero_counts()
        _, maux = multi(grouped, stacked)
        launches = read_counts()
        if launches != {"gather_rows": 5, "scatter_set_rows": 5,
                        "fm_grad_segsum_factored": 5}:
            raise AssertionError(f"multi-step ({turn}) launches {launches}")
        for n in ("table", "w0", "slot_w0", "step"):
            if not torch.equal(getattr(eager, n), getattr(grouped, n)):
                raise AssertionError(f"multi-step ({turn}): {n} differs "
                                     "from 5 eager steps")
        if not torch.equal(maux["loss"], aux["loss"]):
            raise AssertionError(f"multi-step ({turn}): loss differs")
    print(f"check: make_hybrid_multi_step of 5 bench-recipe batches (N = "
          f"{BATCH * SLOTS} slots, one rung U={rung}, uniques "
          f"{[int(b.plan.count) for b in batches]}), captured then "
          f"replayed, == 10 eager steps bit for bit (table, bias, slots, "
          f"step, loss); launches 5 of B1, B2, B3 a call; graphs captured "
          f"{multi.captures}", flush=True)
    del eager, grouped, stacked
    torch.cuda.empty_cache()

    # where the time goes per G: ex/s, device busy and idle share, H2D
    # device time and host wall per step by StepTimer, all in this call;
    # the StepTimer runs on phase 9's batches staged with plans of one
    # rung (their largest ladder rung)
    one_rung = max(b.plan.uids.shape[0] for b in batch_iterator(
        ds, BATCH, device="cpu", dedup_budget="ladder", dedup_fill=BUCKETS))
    one = list(batch_iterator(ds, BATCH, device=dev, dedup_budget=one_rung,
                              dedup_fill=BUCKETS))
    for g in (1, 2, 4):
        t0 = time.perf_counter()
        res = train_sgd(cfg, sgd_of(g, 1), ds, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eps = res.examples_per_sec
        del res
        busy, events = device_us(lambda: train_sgd(cfg, sgd_of(g, 1), ds,
                                                   device=dev), tries=2)
        h2d = {e.key: e.self_device_time_total for e in events
               if "HtoD" in e.key}
        top = "; ".join(f"{e.key[:50]} x{e.count} "
                        f"{e.self_device_time_total:.0f}" for e in events[:6])
        # host wall per step of the step alone, on staged batches of one
        # rung: dispatch only ("none") and to the end of its device work
        # ("block")
        state = fresh()
        run = (step if g == 1 else multi)
        groups = ([(b,) for b in one] if g == 1 else
                  [sgd_hybrid.stack_batches(one[i:i + g])
                   for i in range(0, len(one) - g + 1, g)])
        timers = {}
        for sync in ("none", "block"):
            timer = profiling.StepTimer(sync=sync)
            for item in groups:
                torch.cuda.synchronize()
                timer.start()
                if g == 1:
                    state, aux = run(state, item[0])
                else:
                    state, aux = run(state, item)
                timer.stop(aux["loss"])
            timers[sync] = timer.stats()["p50_ms"] / g
        del state
        print(f"profile: one-epoch grouped hybrid train_sgd, G={g} (20 "
              f"steps, state init included): {eps:.0f} ex/s (first "
              f"dispatch left out); device busy {busy / 1e3:.3f} ms of "
              f"{wall * 1e3:.3f} ms untraced wall ({100 * (1 - busy / 1e6 / wall):.1f}"
              f"% idle); H2D device time {sum(h2d.values()) / 1e3:.3f} ms "
              f"({', '.join(f'{k} {v / 1e3:.3f}' for k, v in h2d.items())})"
              f"; host wall per step by StepTimer on staged batches "
              f"(median of {len(groups)} dispatches / G): dispatch "
              f"{timers['none']:.3f} ms, to the end of its device work "
              f"{timers['block']:.3f} ms; top device events (us): {top}; "
              f"{card}", flush=True)
    del one, multi, batches
    torch.cuda.empty_cache()

    # 23. the fused multi-step, G = 4, on device plans (B1, B6, B2) and on
    # host plans of one rung, against 4 eager steps: exact, captured then
    # replayed; device busy and host wall per step, single against graph
    fsgd = SGDConfig(batch_size=BATCH, learning_rate=0.05)
    fbatches = list(batch_iterator(bds, BATCH, device=dev, dedup_budget=rung,
                                   dedup_fill=BUCKETS))[:4]
    for label, group in (("device plans", [dataclasses.replace(b, plan=None)
                                           for b in fbatches]),
                         ("host plans", fbatches)):
        fstep = sgd_fused.make_fused_train_step(cfg, fsgd)
        fmulti = sgd_fused.make_fused_multi_step(cfg, fsgd)
        fstacked = sgd_hybrid.stack_batches(group)
        eager, grouped = fresh(), fresh()
        for turn in ("captured", "replayed"):
            for b in group:
                eager, aux = fstep(eager, b)
            zero_counts()
            _, maux = fmulti(grouped, fstacked)
            launches = read_counts()
            if launches != {"gather_rows": 4, "scatter_set_rows": 4,
                            "segment_rowsum_sq": 4}:
                raise AssertionError(f"fused multi-step, {label} ({turn}): "
                                     f"launches {launches}")
            for n in ("table", "w0", "slot_w0", "step"):
                if not torch.equal(getattr(eager, n), getattr(grouped, n)):
                    raise AssertionError(f"fused multi-step, {label} "
                                         f"({turn}): {n} differs")
            if not torch.equal(maux["loss"], aux["loss"]):
                raise AssertionError(f"fused multi-step, {label}: loss")
        single_us = device_us(lambda: [fstep(eager, b) for b in group],
                              tries=2)[0] / 4
        graph_us = device_us(lambda: fmulti(grouped, fstacked),
                             tries=2)[0] / 4
        walls = {}
        for name, fn in (("single", lambda: [fstep(eager, b)
                                             for b in group][-1]),
                         ("graph", lambda: fmulti(grouped, fstacked))):
            timer = profiling.StepTimer(sync="none")
            for _ in range(5):
                torch.cuda.synchronize()
                timer.start()
                fn()
                timer.stop()
            walls[name] = timer.stats()["p50_ms"] / 4
        torch.cuda.synchronize()
        print(f"check: make_fused_multi_step G=4 on {label} (budget "
              f"{fstacked.plan.uids.shape[1] if fstacked.plan else 'auto'}"
              f"), captured then replayed, == 8 eager steps bit for bit; "
              f"launches 4 of B1, B6, B2 a call; graphs captured "
              f"{fmulti.captures}; device busy per step single "
              f"{single_us:.1f} us, graph {graph_us:.1f} us "
              f"(torch.profiler); host wall per step (dispatch, median of "
              f"5) single {walls['single']:.3f} ms, graph "
              f"{walls['graph']:.3f} ms; {card}", flush=True)
        del eager, grouped, fstacked
        torch.cuda.empty_cache()
    child = subprocess.run([sys.executable, "-c", GRAPH_TRAP_CHILD],
                           cwd=root, capture_output=True, text=True,
                           timeout=300)
    if child.returncode != 3:
        raise AssertionError(f"an out-of-range id in a replayed graph did "
                             f"not trap: rc {child.returncode}\n"
                             f"{child.stdout}{child.stderr[-2000:]}")
    print(f"check: out-of-range id inside a replayed CUDA graph -> "
          f"{child.stdout.strip()}", flush=True)
    del bds, fbatches

    # 24. checkpointed training at 2^20 rows (cut from 2^24 to keep the
    # smoke short), hybrid with G = 2: 2 epochs into a checkpoint_dir,
    # then a new call that resumes to 4, against 4 straight epochs
    small = FMConfig(num_features=1 << 20, num_factors=RANK,
                     task=cfg.task, reg_w=cfg.reg_w, reg_v=cfg.reg_v,
                     seed=SEED)
    cds = synth.synth_ctr(num_examples=BATCH * 8, num_fields=SLOTS,
                          num_buckets=1 << 20, seed=SEED + 5)
    scratch = tempfile.mkdtemp(prefix="_ckpt_smoke_", dir=root)
    try:
        def run(epochs, **kw):
            return train_sgd(small, sgd_of(2, epochs), cds,
                             generator=torch.Generator(
                                 device=dev).manual_seed(SEED),
                             device=dev, **kw)
        straight = run(4)
        ckdir = os.path.join(scratch, "train")
        run(2, checkpoint_dir=ckdir)
        t0 = time.perf_counter()
        resumed = run(4, checkpoint_dir=ckdir)
        resume_s = time.perf_counter() - t0
        if not (same_params(resumed, straight)
                and resumed.history == straight.history):
            raise AssertionError("resumed run differs from the straight one")
        print(f"check: checkpointed grouped hybrid training (2^20 x rank "
              f"{RANK}, 8 steps of {BATCH} an epoch, G=2): 2 epochs into "
              f"checkpoint_dir, then a new train_sgd resumed to 4 "
              f"({resume_s:.3f} s) == 4 straight epochs bit for bit "
              f"(parameters and history; losses "
              f"{[round(h['train_loss'], 6) for h in resumed.history]}); "
              f"steps kept {Checkpointer(ckdir).all_steps()}", flush=True)
        del straight, resumed
        torch.cuda.empty_cache()

        # one save and restore of config 3's fused state, timed
        rows_full = BUCKETS
        need = (rows_full + 1) * sgd_fused.record_width(RANK) * 4
        free = shutil.disk_usage(scratch).free
        cut = ""
        if free < 1.5 * need + (1 << 30):
            rows_full = 1 << 22
            cut = (f" (cut to 2^22 rows: {free / 1e9:.1f} GB free on the "
                   f"disk, {need / 1e9:.2f} GB needed)")
        big = FMConfig(num_features=rows_full, num_factors=RANK, seed=SEED)
        state = sgd_fused.init_fused_state(big, gen, device=dev)
        nbytes = sum(t.numel() * t.element_size() for t in (
            state.table, state.w0, state.slot_w0, state.step))
        with Checkpointer(os.path.join(scratch, "full")) as ck:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(0, state, extra={"epoch": 0})
            t1 = time.perf_counter()
            ck.wait()
            t2 = time.perf_counter()
            restored, extra = ck.restore(template=state)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            on_disk = os.path.getsize(os.path.join(scratch, "full", "0",
                                                   "state.pt"))
        if not (torch.equal(restored.table, state.table)
                and extra == {"epoch": 0}):
            raise AssertionError("full-size restore differs")
        print(f"time: checkpoint of config 3's fused state "
              f"{tuple(state.table.shape)} f32, {nbytes / 1e9:.3f} GB "
              f"({on_disk / 1e9:.3f} GB on disk){cut}: save {t2 - t0:.3f} "
              f"s = {nbytes / (t2 - t0) / 1e9:.3f} GB/s (device-to-host "
              f"copy {t1 - t0:.3f} s, {nbytes / (t1 - t0) / 1e9:.3f} GB/s; "
              f"write {t2 - t1:.3f} s, {nbytes / (t2 - t1) / 1e9:.3f} "
              f"GB/s); restore to the card {t3 - t2:.3f} s = "
              f"{nbytes / (t3 - t2) / 1e9:.3f} GB/s; restored == saved; "
              f"{card}", flush=True)
        del state, restored
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    torch.cuda.empty_cache()


CONFIG5_BUCKETS, CONFIG5_FIELDS, CONFIG5_RANK = 1 << 20, 39, 16
CONFIG5_HIDDEN, CONFIG5_BATCH, CONFIG5_STEPS = (256, 128), 8192, 20


def ctr_batch_ids(rng, rows):
    """``benchmarks/bench_configs.py::_ctr_batches``'s field-major ids at
    config 5's shape: zipf(1.3) hashed, each slot offset into its own
    field's bucket range."""
    raw = rng.zipf(1.3, size=(rows, CONFIG5_FIELDS)).astype(np.int64)
    ids = ((raw * 2654435761) % CONFIG5_BUCKETS).astype(np.int32)
    per = CONFIG5_BUCKETS // CONFIG5_FIELDS
    return (ids % per) + per * np.arange(CONFIG5_FIELDS,
                                         dtype=np.int32)[None, :]


def clone_deepfm(state):
    """A copy of a DeepFMState (fused or separate tables) on its device."""
    return copy.deepcopy(state)


def deepfm_tensors_equal(a, b):
    from sparkfm_tpu_torch.utils.checkpoint import state_tensors
    tb = state_tensors(b)
    return all(torch.equal(t, tb[k]) for k, t in state_tensors(a).items())


def deepfm_cli_phases(dev, gen, rng, card, root):
    """Phases 25-27: BASELINE config 5 (Criteo-shape DeepFM) trained on
    the fused path at full width, DeepFM serving and the facade, and the
    command line on the card. Returns the kernels' JSON entries at config
    5's shapes."""
    import io
    import shutil

    from sparkfm_tpu_torch import FM, MicroBatcher, SGDConfig, Task, cli
    from sparkfm_tpu_torch.api import DeepFMModel, load_model
    from sparkfm_tpu_torch.config import FMConfig
    from sparkfm_tpu_torch.data import libfm, synth
    from sparkfm_tpu_torch.data.batching import (SparseDataset,
                                                 batch_iterator)
    from sparkfm_tpu_torch.models import deepfm as DF
    from sparkfm_tpu_torch.ops import rowio, segsum
    from sparkfm_tpu_torch.solvers import sgd_fused

    kernels = {"gather_rows": rowio.GATHER, "gather_vw_rows": rowio.GATHER_VW,
               "scatter_set_rows": rowio.SCATTER,
               "segment_rowsum": segsum.ROWSUM,
               "segment_rowsum_sq": segsum.ROWSUM_SQ,
               "fm_grad_segsum_factored": segsum.FACTORED,
               "segment_colsums": segsum.COLSUMS}
    plain_swaps = [(rowio, "gather_rows", rowio.gather_rows_reference),
                   (rowio, "gather_vw_rows", rowio.gather_vw_rows_reference),
                   (rowio, "scatter_set_rows",
                    rowio.scatter_set_rows_reference),
                   (segsum, "segment_rowsum_sq", rowsum_sq64)]

    def zero_counts():
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {n: k.launches for n, k in kernels.items() if k.launches}

    # 25. BASELINE config 5: bench_deepfm's recipe at full width on the
    # fused path, record W = 2 * 16 + 2 -> 36
    cfg5 = DF.DeepFMConfig(fm=FMConfig(
        num_features=CONFIG5_BUCKETS, num_factors=CONFIG5_RANK,
        num_fields=CONFIG5_FIELDS, task=Task.CLASSIFICATION, reg_v=1e-6,
        seed=SEED), hidden=CONFIG5_HIDDEN)
    sgd5 = SGDConfig(batch_size=CONFIG5_BATCH, learning_rate=0.05,
                     optimizer="adagrad", epochs=1)
    if DF.resolve_deepfm_path(cfg5, sgd5) != "fused":
        raise AssertionError("config 5 does not take the fused path")
    n5 = CONFIG5_BATCH * CONFIG5_STEPS
    ds5 = SparseDataset(ids=ctr_batch_ids(rng, n5),
                        vals=np.ones((n5, CONFIG5_FIELDS), np.float32),
                        y=rng.integers(0, 2, n5).astype(np.float32),
                        num_features=CONFIG5_BUCKETS)
    batches5 = list(batch_iterator(ds5, CONFIG5_BATCH, device=dev,
                                   dedup_budget="ladder",
                                   dedup_fill=CONFIG5_BUCKETS))[:5]
    state5 = DF.init_fused_deepfm_state(cfg5, torch.Generator(
        device=dev).manual_seed(SEED + 5), device=dev)
    width = sgd_fused.record_width(CONFIG5_RANK)
    used = 2 * CONFIG5_RANK + 2
    if state5.fm.table.shape != (CONFIG5_BUCKETS + 1, width) or width != 36:
        raise AssertionError(f"config 5 record {tuple(state5.fm.table.shape)}")
    # B1 and B2 at W = 36, exact on every row; B6 on a step's own
    # [g_v | g_w] (W = 17) against float64
    scratch = state5.fm.table.clone()
    write_err = 0.0
    for b in batches5[:2]:
        u = b.plan.uids
        if not torch.equal(rowio.gather_rows(scratch, u),
                           rowio.gather_rows_reference(scratch, u)):
            raise AssertionError(f"gather kernel wrong at W={width}")
        rows = torch.randn((u.shape[0], width), generator=gen, device=dev)
        want_t = rowio.scatter_set_rows_reference(scratch.clone(), u, rows)
        rowio.scatter_set_rows(scratch, u, rows)
        write_err = max(write_err, float((scratch - want_t).abs().max()))
        if not torch.equal(scratch, want_t):
            raise AssertionError(f"row write kernel != plain at W={width}")
        del want_t
    step5 = DF.make_train_step(cfg5, sgd5)
    payload, checked = [], []
    with swapped([(segsum, "segment_rowsum_sq", capturing(
            segsum.segment_rowsum_sq, payload))]):
        step5(clone_deepfm(state5), batches5[0])
    payload = tuple(payload)
    res_b6 = hold64(segsum.segment_rowsum_sq,
                    segsum.segment_rowsum_sq_reference, payload,
                    f"B6 W={payload[0].shape[1]} N={payload[0].shape[0]} "
                    f"U={payload[2]} (config 5)", checked)
    print(f"check: config 5 DeepFM: gather and row write at W={width} on the "
          f"{tuple(state5.fm.table.shape)} record table equal their plain "
          f"versions on every row (U="
          f"{[b.plan.uids.shape[0] for b in batches5[:2]]}); B6 on the "
          f"step's [g_v | g_w] {tuple(payload[0].shape)} against float64: "
          f"{checked[-1]}", flush=True)
    # 3 steps twice from one state, bit for bit, with their launches
    outs = []
    for _ in range(2):
        s5 = clone_deepfm(state5)
        zero_counts()
        for b in batches5[:3]:
            step5(s5, b)
        outs.append((s5, read_counts()))
    if not deepfm_tensors_equal(outs[0][0], outs[1][0]):
        raise AssertionError("config 5: two card runs of 3 steps differ")
    if outs[0][1] != {"gather_rows": 3, "scatter_set_rows": 3,
                      "segment_rowsum_sq": 3}:
        raise AssertionError(f"config 5 launches in 3 steps {outs[0][1]}")
    del outs
    # 5 steps, each from one state with the kernels and with the plain
    # versions (B6's in float64); tables [:F, :34] at rtol 1e-4, atol 1e-6
    # with up to 64 entries a step within adagrad's rounding bound (as
    # phase 21), the tower and the bias at rtol 1e-5
    head5 = max(int(torch.unique_consecutive(
        b.plan.seg, return_counts=True)[1].max()) for b in batches5)
    flip_atol = sgd5.learning_rate * head5 * 2.0 ** -24
    losses, excused = [], 0
    s5 = clone_deepfm(state5)
    for b in batches5:
        plain_in = clone_deepfm(s5)
        _, aux = step5(s5, b)
        counts = [k.launches for k in kernels.values()]
        with swapped(plain_swaps):
            _, plain_aux = step5(plain_in, b)
        if [k.launches for k in kernels.values()] != counts:
            raise AssertionError("the plain config 5 step launched a kernel")
        losses.append(float(aux["loss"]))
        np.testing.assert_allclose(losses[-1], float(plain_aux["loss"]),
                                   rtol=1e-5)
        excused += assert_close_rows(
            s5.fm.table[:CONFIG5_BUCKETS, :used],
            plain_in.fm.table[:CONFIG5_BUCKETS, :used], 1e-4, 1e-6,
            f"config 5 step {len(losses)} table", 64, flip_atol)
        for name in ("mlp_w", "mlp_b", "smw", "smb"):
            for a, p in zip(getattr(s5, name), getattr(plain_in, name)):
                np.testing.assert_allclose(a.cpu().numpy(),
                                           p.cpu().numpy(), rtol=1e-5,
                                           atol=1e-7, err_msg=name)
        np.testing.assert_allclose(float(s5.fm.w0), float(plain_in.fm.w0),
                                   rtol=1e-5)
        del plain_in
    print(f"check: 3 fused config 5 steps twice from one state equal bit "
          f"for bit, launches B1 = B2 = B6 = 3; 5 steps each from the same "
          f"state with the kernels and with the plain versions: losses "
          f"{losses} equal (rtol 1e-5), tables [:F, :{used}] equal (rtol "
          f"1e-4, atol 1e-6; {excused} entries within lr x {head5}-slot run "
          f"x 2^-24 = {flip_atol:.3g}), tower equal (rtol 1e-5)", flush=True)
    # the kernels at config 5's shapes
    plan5 = batches5[0].plan
    u5 = plan5.uids.shape[0]
    distinct = min(int(plan5.count) + 1, u5)
    rows5 = torch.randn((u5, width), generator=gen, device=dev)
    keep = plan5.uids[:distinct].long()
    uids5 = plan5.uids
    t_gather = timed_kernel(
        f"B1 gather_rows per call, config 5 record (U={u5}, W={width})",
        rowio.gather_rows, rowio.gather_rows_reference,
        (state5.fm.table, uids5),
        lambda: state5.fm.table.index_select(0, uids5.long()),
        u5 * 4 + (distinct + u5) * width * 4, 0, card)
    t_write = timed_kernel(
        f"B2 scatter_set_rows per call, config 5 record (U={u5}, "
        f"W={width})", rowio.scatter_set_rows,
        rowio.scatter_set_rows_reference, (scratch, uids5, rows5),
        lambda: scratch.index_copy_(0, keep, rows5[:distinct]),
        u5 * 4 + (u5 + distinct) * width * 4, 0, card)
    del scratch, rows5, s5, batches5
    # one epoch of train_deepfm (20 steps of 8192, host ladder plans):
    # launches counted, then traced
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    res5 = DF.train_deepfm(cfg5, sgd5, ds5, device=dev)
    torch.cuda.synchronize()
    wall5 = time.perf_counter() - t0
    launches5 = read_counts()
    peak5 = torch.cuda.max_memory_allocated(dev)
    want = {"gather_rows": CONFIG5_STEPS, "scatter_set_rows": CONFIG5_STEPS,
            "segment_rowsum_sq": CONFIG5_STEPS}
    if launches5 != want:
        raise AssertionError(f"config 5 epoch launches {launches5}, "
                             f"expected {want}")
    loss5 = res5.history[0]["train_loss"]
    if not np.isfinite(loss5):
        raise AssertionError(f"config 5 loss {loss5}")
    eps5 = res5.examples_per_sec
    params5 = res5.params
    del res5
    busy, events = device_us(lambda: DF.train_deepfm(cfg5, sgd5, ds5,
                                                     device=dev), tries=2)
    top = "; ".join(f"{e.key[:50]} x{e.count} "
                    f"{e.self_device_time_total:.0f}" for e in events[:8])
    print(f"profile: one-epoch train_deepfm, BASELINE config 5 fused "
          f"({CONFIG5_STEPS} steps of {CONFIG5_BATCH}, state init included): "
          f"{eps5:.0f} ex/s (first step left out); loss {loss5:.5f}; device "
          f"busy {busy / 1e3:.3f} ms of {wall5 * 1e3:.3f} ms untraced wall "
          f"({100 * (1 - busy / 1e6 / wall5):.1f}% idle); peak device "
          f"memory {peak5 / 2**30:.2f} GiB; launches {launches5}; top device "
          f"events (us): {top}; {card}", flush=True)
    # the dedup path for 3 steps with its launches; each step runs again
    # from the same state with the plain versions (B6's in float64) and the
    # run goes on from the kernels' result, as the fused steps above (run
    # freely, the exploding loss would amplify the f32 rounding of the
    # sums, see steps_against_plain): losses at rtol 1e-5, tables and slots
    # [:F] at rtol 1e-4, atol 1e-6 with up to 64 entries a step within
    # adagrad's rounding bound, the tower and the bias at rtol 1e-5
    sgd_d = dataclasses.replace(sgd5, update_path="dedup")
    step_d = DF.make_train_step(cfg5, sgd_d)
    state_d = DF.pad_deepfm_state_for_dedup(DF.init_state(DF.init_params(
        cfg5, torch.Generator(device=dev).manual_seed(SEED + 6),
        device=dev)))
    batches_d = list(batch_iterator(ds5, CONFIG5_BATCH, device=dev,
                                    dedup_budget="ladder",
                                    dedup_fill=CONFIG5_BUCKETS))[:3]
    head_d = max(int(torch.unique_consecutive(
        b.plan.seg, return_counts=True)[1].max()) for b in batches_d)
    flip_d = sgd_d.learning_rate * head_d * 2.0 ** -24
    dedup_losses, plain_losses, excused_d, launched = [], [], 0, {}
    for b in batches_d:
        plain_d = clone_deepfm(state_d)
        zero_counts()
        dedup_losses.append(float(step_d(state_d, b)[1]["loss"]))
        for n, c in read_counts().items():
            launched[n] = launched.get(n, 0) + c
        zero_counts()
        with swapped(plain_swaps):
            plain_losses.append(float(step_d(plain_d, b)[1]["loss"]))
        if read_counts():
            raise AssertionError("the plain config 5 dedup step launched a "
                                 "kernel")
        np.testing.assert_allclose(dedup_losses[-1], plain_losses[-1],
                                   rtol=1e-5)
        tables = [(n, getattr(state_d.fm.params, n), getattr(
            plain_d.fm.params, n)) for n in ("v", "w")]
        tables += [(n, getattr(state_d.fm, n), getattr(plain_d.fm, n))
                   for n in ("slot_v", "slot_w")]
        allow = 64
        for n, got, want in tables:
            e = assert_close_rows(
                got[:CONFIG5_BUCKETS], want[:CONFIG5_BUCKETS], 1e-4, 1e-6,
                f"config 5 dedup step {len(dedup_losses)} {n}", allow,
                flip_d)
            allow -= e
            excused_d += e
        for name in ("mlp_w", "mlp_b", "smw", "smb"):
            for a, p in zip(getattr(state_d, name), getattr(plain_d, name)):
                np.testing.assert_allclose(a.cpu().numpy(), p.cpu().numpy(),
                                           rtol=1e-5, atol=1e-7,
                                           err_msg=f"dedup {name}")
        np.testing.assert_allclose(float(state_d.fm.params.w0),
                                   float(plain_d.fm.params.w0), rtol=1e-5)
        del plain_d
    if launched != {"gather_vw_rows": 6, "scatter_set_rows": 12,
                    "segment_rowsum_sq": 3}:
        raise AssertionError(f"config 5 dedup launches {launched}")
    print(f"train: config 5 dedup path, 3 steps: losses {dedup_losses}, "
          f"launches {launched} (two-table gathers [v | w] and [slot_v | "
          f"slot_w], 4 table writes, B6 a step); each step from the same "
          f"state with the plain versions: losses {plain_losses} equal (rtol "
          f"1e-5), v, w, slots [:F] equal (rtol 1e-4, atol 1e-6; "
          f"{excused_d} entries within lr x {head_d}-slot run x 2^-24 = "
          f"{flip_d:.3g}), tower and bias equal (rtol 1e-5)", flush=True)
    del state_d, step_d, batches_d
    path5 = "train_deepfm fused, BASELINE config 5 DeepFM (phase 25)"
    entries = []
    for name, line, t, err, lib in (
            ("gather_rows (config 5 record)", "pallas_rowio.py:140",
             t_gather, 0.0, "index_select"),
            ("scatter_set_rows (config 5 record)", "pallas_rowio.py:74",
             t_write, write_err,
             "index_copy_ over the plan's distinct ids")):
        entries.append({
            "name": name, "route": "cuda",
            "source": "sparkfm_tpu_torch/csrc/rowio.cu",
            "replaces": f"sparkfm_tpu/ops/{line}",
            "launches": launches5[name.split()[0]], "path": path5,
            "max_abs_err": err, "library": lib, **t})
    entries.append(rowsum_sq_entry_of(
        "config 5 DeepFM", res_b6, payload,
        launches5["segment_rowsum_sq"], path5, card))
    del payload, state5
    torch.cuda.empty_cache()

    # 26. DeepFM serving at config 5's width: MicroBatcher with plans (one
    # two-table gather of the chunk's unique [v | w] rows) and without
    # (one of its slots' rows), against DeepFMModel.predict
    sizes = [1] * 4 + list(rng.integers(2, 600, 24)) + [3000, 5000]
    reqs = [ctr_batch_ids(rng, int(n)) for n in sizes]
    model5 = DeepFMModel(params=params5, cfg=cfg5)
    # the plain gather's predictions, which both flushes must equal
    zero_counts()
    with swapped(plain_swaps):
        want_p = [model5.predict(ids, np.ones(ids.shape, np.float32))
                  for ids in reqs]
    if read_counts():
        raise AssertionError("the plain DeepFM predict launched a kernel")
    serve = {}
    for use_plans in (True, None):
        mb = MicroBatcher(params5, cfg5, max_batch=MAX_BATCH,
                          use_plans=use_plans, model="deepfm")
        for ids in reqs:
            mb.submit(ids, np.ones(ids.shape, np.float32))
        zero_counts()
        t0 = time.perf_counter()
        outs = mb.flush()
        serve[bool(use_plans)] = (time.perf_counter() - t0, read_counts())
        chunks = -(-sum(sizes) // MAX_BATCH)
        if serve[bool(use_plans)][1] != {"gather_vw_rows": chunks}:
            raise AssertionError(f"DeepFM flush (use_plans={use_plans}) "
                                 f"launches {serve[bool(use_plans)][1]}, "
                                 f"expected {chunks} two-table gathers")
        for ids, got, want in zip(reqs, outs, want_p):
            if got.shape != (ids.shape[0],) or not np.all(np.isfinite(got)):
                raise AssertionError(f"bad DeepFM output {got.shape}")
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    print(f"serve: config 5 DeepFM MicroBatcher, {len(reqs)} requests, "
          f"{sum(sizes)} examples, {chunks} chunks: with plans "
          f"{serve[True][0]:.4f} s ({sum(sizes) / serve[True][0]:.0f} ex/s), "
          f"launches {serve[True][1]}; without {serve[False][0]:.4f} s "
          f"({sum(sizes) / serve[False][0]:.0f} ex/s), launches "
          f"{serve[False][1]}; both equal DeepFMModel.predict through the "
          f"plain gather (rtol 1e-5); "
          f"{card}", flush=True)
    del params5, model5, want_p
    # the facade: fit on a small synth_ctr, save, load by its tag
    ctr = synth.synth_ctr(num_examples=16384, num_fields=16,
                          num_buckets=1 << 18, seed=SEED)
    model = FM(num_factors=8, num_fields=16, model="deepfm", solver="sgd",
               max_iter=2, batch_size=4096, task="classification",
               reg_v=1e-6).fit(ctr, eval_ds=ctr)
    scratch_dir = os.path.join(root, f"_ckpt_smoke_deepfm_{os.getpid()}")
    try:
        model.save(os.path.join(scratch_dir, "model"))
        back = load_model(os.path.join(scratch_dir, "model"))
        if not (isinstance(back, DeepFMModel) and np.array_equal(
                back.predict(ctr.ids, ctr.vals),
                model.predict(ctr.ids, ctr.vals))):
            raise AssertionError("DeepFM save -> load changed predictions")
    finally:
        shutil.rmtree(scratch_dir, ignore_errors=True)
    print(f"train: FM(model='deepfm').fit on synth_ctr (16384 x 16, 2^18 "
          f"buckets) on the card: history {model.history}; saved and loaded "
          f"by its tag, predictions equal bit for bit", flush=True)
    del model, back

    # 27. the command line on the card, in this process, the launch counts
    # set to 0 before each command and read after; then one subprocess
    work = os.path.join(root, f"_ckpt_smoke_cli_{os.getpid()}")
    os.makedirs(work)
    ratings = os.path.join(root, "tests", "fixtures", "ml_fixture",
                           "ratings.dat")
    ml = os.path.join(work, "ml.libfm")
    ctr_file = os.path.join(work, "ctr.libfm")
    libfm.save_libfm(synth.synth_ctr(num_examples=20000, seed=0), ctr_file)
    deep_dir = os.path.join(work, "D")
    commands = [
        ("vectorize", ["vectorize", "--input", ratings, "--schema",
                       "identity,identity,target,ignored", "--output", ml],
         ()),
        ("train als", ["train", "--libfm", ml, "--solver", "als", "--iters",
                       "3", "--split", "0.8,0.2"], ("segment_colsums",)),
        ("train sgd", ["train", "--libfm", ml, "--solver", "sgd", "--iters",
                       "3", "--split", "0.8,0.2", "--batch-size", "2048"],
         ("gather_vw_rows", "scatter_set_rows")),
        ("train deepfm", ["train", "--model", "deepfm", "--fields", "16",
                          "--synth", "ctr", "--synth-examples", "20000",
                          "--solver", "sgd", "--task", "classification",
                          "--iters", "2", "--split", "0.8,0.2",
                          "--save-model", deep_dir],
         ("gather_rows", "scatter_set_rows", "segment_rowsum_sq")),
        ("eval deepfm", ["eval", "--model", deep_dir, "--libfm", ctr_file],
         ("gather_vw_rows",)),
        ("predict deepfm", ["predict", "--model", deep_dir, "--libfm",
                            ctr_file, "--output",
                            os.path.join(work, "p.txt")],
         ("gather_vw_rows",)),
        ("movielens-demo", ["movielens-demo"], ("segment_colsums",)),
    ]
    cli_runs = {}
    try:
        for label, argv, need in commands:
            out = io.StringIO()
            zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(argv)
            wall = time.perf_counter() - t0
            counts = read_counts()
            result = json.loads(out.getvalue().strip().splitlines()[-1])
            if rc != 0 or any(counts.get(k, 0) == 0 for k in need):
                raise AssertionError(f"cli {label}: rc {rc}, launches "
                                     f"{counts}, expected {need} > 0")
            cli_runs[label] = (wall, counts, result)
        for label, key in (("train als", "test_rmse"),
                           ("train sgd", "test_rmse"),
                           ("train deepfm", "test_auc"),
                           ("movielens-demo", "test_rmse")):
            got = cli_runs[label][2]
            if not all(np.isfinite(v) for k, v in got.items()
                       if k.startswith("test_")) or key not in got:
                raise AssertionError(f"cli {label}: {got}, expected a "
                                     f"finite {key}")
        # eval and predict of the saved DeepFM held against the same
        # model scored through the plain versions
        plain_model = load_model(deep_dir, device=dev)
        ctr_ds = libfm.load_libfm(
            ctr_file, num_features=plain_model.cfg.fm.num_features)
        zero_counts()
        with swapped(plain_swaps):
            want_pred = plain_model.predict_dataset(ctr_ds)
            want_eval = plain_model.evaluate(ctr_ds)
        if read_counts():
            raise AssertionError("the plain DeepFM eval launched a kernel")
        got_pred = np.loadtxt(os.path.join(work, "p.txt"))
        if got_pred.shape != (20000,):
            raise AssertionError("cli predict wrote the wrong row count")
        # predict writes 6 significant digits, eval rounds to 6 places
        np.testing.assert_allclose(got_pred, want_pred, rtol=1e-5, atol=1e-7)
        got_eval = cli_runs["eval deepfm"][2]
        if set(got_eval) != set(want_eval):
            raise AssertionError(f"cli eval keys {sorted(got_eval)}")
        for k, v in want_eval.items():
            np.testing.assert_allclose(got_eval[k], v, rtol=0, atol=1e-6,
                                       err_msg=f"cli eval {k}")
        del plain_model, ctr_ds
        child = subprocess.run(
            [sys.executable, "-m", "sparkfm_tpu_torch", "train", "--synth",
             "ctr", "--synth-examples", "20000", "--solver", "sgd",
             "--task", "classification", "--iters", "1"], cwd=root,
            capture_output=True, text=True, timeout=300)
        if child.returncode != 0:
            raise AssertionError(f"python -m sparkfm_tpu_torch train: rc "
                                 f"{child.returncode}\n"
                                 f"{child.stderr[-2000:]}")
        child_out = json.loads(child.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for label, (wall, counts, result) in cli_runs.items():
        print(f"cli: {label}: {wall:.3f} s, launches {counts}, "
              f"{json.dumps(result)}", flush=True)
    print("check: cli eval and predict of the saved DeepFM equal the model "
          "scored through the plain versions (metrics atol 1e-6, "
          "predictions rtol 1e-5); train and demo metrics finite",
          flush=True)
    print(f"cli: python -m sparkfm_tpu_torch train --synth ctr (no --device: "
          f"on the card by default) exited 0: {json.dumps(child_out)}; "
          f"{card}", flush=True)
    return entries


# ---------------------------------------------------------------------------
# Phases 31-35: the sharded paths (sparkfm_tpu_torch/parallel/)

SHARD_STEPS = 5
SHARD_LR = 1e-3      # a run that stays well conditioned, so two runs that
#                      differ only in their order of summation stay within
#                      the tables' tolerance after 5 free steps; adam
#                      adds every slot's step (lazy adam, per slot), so a
#                      head id moves by lr x its slots: 1e-6 there, and
#                      its tables are held on each step's change
SHARD_ADAM_LR = 1e-6
SHARD_EXCHANGES = (  # label, exchange, host plan kind, optimizer
    ("global hybrid", "global", "hybrid", "adagrad"),
    ("global", "global", "global", "adagrad"),
    ("unique", "unique", None, "adagrad"),
    ("dense, adam", "dense", None, "adam"))


def shard_host_batches(seed):
    """SHARD_STEPS bench-recipe batches of config 3 (zipf ids, ones,
    random labels) on the host, the same in every process."""
    from sparkfm_tpu_torch.data.batching import SparseDataset, batch_iterator
    rng = np.random.default_rng(seed)
    n = SHARD_STEPS * BATCH
    ds = SparseDataset(ids=np.concatenate([zipf_ids(rng, BATCH)
                                           for _ in range(SHARD_STEPS)]),
                       vals=np.ones((n, SLOTS), np.float32),
                       y=rng.integers(0, 2, n).astype(np.float32),
                       num_features=BUCKETS)
    return list(batch_iterator(ds, BATCH, device="cpu"))


def shard_plans(batches, fill, shards):
    """Each batch's global host plan as ``train_sgd``'s sharded loop builds
    it (ladder rung over the global batch, growing only), with the hybrid
    extras for ``shards`` data shards: [(plan, hybrid plan)]."""
    from sparkfm_tpu_torch.ops import embedding as E
    cap = E.auto_budget(BATCH * SLOTS)
    rung, u_cap, out = 1, 1, []
    for b in batches:
        ids, vals = np.asarray(b.ids), np.asarray(b.vals)
        hp = E.host_dedup(ids, cap, fill, vals=vals)
        rung = max(rung, E.ladder_budget(int(hp.count), cap=cap))
        hp = hp._replace(uids=hp.uids[:rung])
        seg, sv, sex, gmap, u_cap = E.stack_hybrid_extras(
            hp.ranks, vals, shards, u_cap=u_cap)
        out.append((hp, hp._replace(order=gmap, seg=seg, svals=sv, sex=sex)))
    return out


def shard_cfgs(optimizer):
    from sparkfm_tpu_torch import FMConfig, SGDConfig, Task
    cfg = FMConfig(num_features=BUCKETS, num_factors=RANK,
                   task=Task.CLASSIFICATION, reg_w=1e-6, reg_v=1e-6,
                   seed=SEED)
    return cfg, SGDConfig(batch_size=BATCH, optimizer=optimizer,
                          learning_rate=SHARD_ADAM_LR if optimizer == "adam"
                          else SHARD_LR)


def lifted_batches(mesh, batches, plans, kind):
    """The rank's device batches for one exchange's run."""
    from sparkfm_tpu_torch.parallel import multihost as MH
    out = []
    for b, (plan, hybrid) in zip(batches, plans):
        if kind == "hybrid":
            out.append(MH.global_batch(mesh, b, plan=hybrid,
                                       plan_mode="global_hybrid"))
        elif kind == "global":
            out.append(MH.global_batch(mesh, b, plan=plan._replace(
                order=None, seg=None, svals=None, sex=None),
                plan_mode="global"))
        else:
            out.append(MH.global_batch(mesh, b))
    return out


def sharded_rank_run(mesh, ref):
    """Phase 32 on one rank of a (2, 2) gloo world on card 0: 5 global
    hybrid steps at config 3's width, the owned rows of every row phase
    31's one-rank run touched held against its tables (rtol 1e-4, atol
    1e-6) and the losses against its losses (rtol 1e-5); then 2 steps of
    each other exchange, their losses against phase 31's. Returns what it
    saw."""
    from sparkfm_tpu_torch.ops import segsum
    from sparkfm_tpu_torch.parallel import mesh as PM
    from sparkfm_tpu_torch.parallel import sharded_sgd as S
    dev = PM.device_of(mesh)
    batches = shard_host_batches(SEED + 31)
    out = {"rank": torch.distributed.get_rank(), "losses": {},
           "backend": torch.distributed.get_backend()}
    for label, exchange, kind, opt in SHARD_EXCHANGES:
        cfg, sgd = shard_cfgs(opt)
        state, pcfg = S.init_sharded_state(
            cfg, mesh, torch.Generator(dev).manual_seed(SEED + 31), opt)
        plans = shard_plans(batches, pcfg.num_features - 1,
                            PM.size(mesh, PM.DATA_AXIS))
        lifted = lifted_batches(mesh, batches, plans, kind)
        step = S.make_sharded_train_step(pcfg, sgd, mesh, exchange)
        steps = SHARD_STEPS if kind == "hybrid" else 2
        segsum.FACTORED.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for b in lifted[:steps]:
            state, aux = step(state, b)
            losses.append(float(aux["loss"]))
        out["losses"][label] = losses
        np.testing.assert_allclose(losses, ref["losses"][label][:steps],
                                   rtol=1e-5, err_msg=label)
        if kind != "hybrid":
            del state
            continue
        out["hybrid_s_per_step"] = (time.perf_counter() - t0) / steps
        out["b3_launches"] = segsum.FACTORED.launches
        rps = state.params.w.shape[0]
        m = PM.axis_index(PM.MODEL_AXIS, mesh)
        ids = torch.as_tensor(ref["ids"], device=dev).long()
        mine = (ids // rps) == m
        local = ids[mine] - m * rps
        sel = mine.cpu().numpy()
        for name, t in (("v", state.params.v), ("w", state.params.w)):
            want = torch.as_tensor(ref[name][sel], device=dev)
            np.testing.assert_allclose(t[local].cpu().numpy(),
                                       want.cpu().numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
        out["rows_held"] = int(local.numel())
        out["u_cap"] = int(lifted[0].plan.order.shape[1])
        out["n_local"] = int(lifted[0].plan.seg.shape[1])
        del state
    return out


def sharded_phases(dev, card, root, als_ctx):
    """Phases 31-34 on the sharded paths; phase 33 needs phases 11-14's
    data and workspace (``als_ctx``). Returns the kernel entries of the
    sharded shapes and the one-rank mesh for phase 35."""
    from sparkfm_tpu_torch.models import deepfm as DF
    from sparkfm_tpu_torch.ops import embedding as E
    from sparkfm_tpu_torch.ops import rowio, segsum
    from sparkfm_tpu_torch.parallel import mesh as PM
    from sparkfm_tpu_torch.parallel import multihost as MH
    from sparkfm_tpu_torch.parallel import sharded_sgd as S
    from sparkfm_tpu_torch.solvers import sgd as sgd_solver
    from sparkfm_tpu_torch.solvers import sgd_fused, sgd_hybrid
    from sparkfm_tpu_torch.solvers.sgd_fused import FusedState

    entries = []
    t_phase = time.perf_counter()
    # the sharded phases draw from their own generator: the later phases'
    # random rows (phase 15's) stay the ones they were checked at
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    # 31. config 3 on a (1, 1) mesh of one real NCCL rank
    mesh = PM.make_mesh(1, 1, device=dev.type)
    backend = torch.distributed.get_backend()
    if dev.type == "cuda" and backend != "nccl":
        raise AssertionError(f"the card's one-rank mesh runs on {backend}")
    batches = shard_host_batches(SEED + 31)
    plans = shard_plans(batches, BUCKETS, 1)
    k = RANK
    width = sgd_fused.record_width(k)

    def fused_twin(state):
        """The one-device fused state holding a copy of the sharded
        state's rows (the same F + 1 rows: the sharded table's padding
        row is the fused table's fill row)."""
        p = state.params
        table = torch.zeros((p.w.shape[0], width), device=dev)
        table[:, :k] = p.v
        table[:, k:2 * k] = state.slot_v
        table[:, 2 * k] = p.w
        table[:, 2 * k + 1] = state.slot_w
        return FusedState(table=table, w0=p.w0.clone(),
                          slot_w0=state.slot_w0.clone(),
                          step=state.step.clone())

    def sgd_twin(state):
        return dataclasses.replace(
            state, params=type(state.params)(*(t.clone() for t in (
                state.params.w0, state.params.w, state.params.v))),
            slot_w0=state.slot_w0.clone(), slot_w=state.slot_w.clone(),
            slot_v=state.slot_v.clone(), slot2_w0=state.slot2_w0.clone(),
            slot2_w=state.slot2_w.clone(), slot2_v=state.slot2_v.clone(),
            step=state.step.clone())

    def device_batch(b, plan=None):
        return dataclasses.replace(
            b, ids=b.ids.to(dev), vals=b.vals.to(dev), y=b.y.to(dev),
            mask=b.mask.to(dev), field_ids=None,
            plan=None if plan is None else E.plan_to_device(plan, dev))

    def twin_of(label, cfg, sgd):
        """(twin state maker, one-device step, its batches, its name)."""
        if label == "global hybrid":
            return (fused_twin, sgd_hybrid.make_hybrid_train_step(cfg, sgd),
                    [device_batch(b, p) for b, (p, _) in zip(batches, plans)],
                    "hybrid")
        if label == "global":
            return (fused_twin, sgd_fused.make_fused_train_step(
                cfg, dataclasses.replace(sgd, update_path="fused")),
                [device_batch(b, p) for b, (p, _) in zip(batches, plans)],
                "fused (host plans)")
        path = "dedup" if label == "unique" else "direct"
        return (sgd_twin, sgd_solver.make_train_step(
            cfg.replace(num_features=BUCKETS + 1), dataclasses.replace(
                sgd, update_path=path, host_plan=False)),
            [device_batch(b) for b in batches], f"{path} (device plans)")

    def compare(state, twin, what, before=None, lr=0.0):
        """The sharded state's F true rows, every table and slot, against
        the twin's: at rtol 1e-4, atol 1e-6; or, given the tables
        ``before`` the step (adam, whose entries move by about lr), on
        the step's change (:func:`assert_close_changes`), where up to 64
        entries of w and V a step may differ by 2 lr: a slot whose
        gradient is at rounding level, where the two gradients' float
        orders part, flips the sign of its adam step. Returns how many
        entries were excused."""
        p = state.params
        if isinstance(twin, FusedState):
            pairs = (("v", p.v, twin.table[:, :k]),
                     ("slot_v", state.slot_v, twin.table[:, k:2 * k]),
                     ("w", p.w[:, None], twin.table[:, 2 * k:2 * k + 1]),
                     ("slot_w", state.slot_w[:, None],
                      twin.table[:, 2 * k + 1:2 * k + 2]))
        else:
            twins = state_tables(twin)
            pairs = [(n, t, twins[n]) for n, t in state_tables(state).items()]
        excused = 0
        for name, a, b in pairs:
            if before is None:
                excused += assert_close_rows(a[:BUCKETS], b[:BUCKETS], 1e-4,
                                             1e-6, f"{what} {name}")
            else:
                flips = name in ("v", "w")
                excused += assert_close_changes(
                    before[name][:BUCKETS], a[:BUCKETS], b[:BUCKETS], 1e-4,
                    f"{what} {name}", 64 if flips else 0,
                    2 * lr if flips else 0.0)
        w0 = twin.w0 if isinstance(twin, FusedState) else twin.params.w0
        np.testing.assert_allclose(float(p.w0), float(w0), rtol=1e-5,
                                   atol=1e-8)
        return excused

    ref = {"losses": {}}
    report = {}
    launches = collections.Counter()
    b1_case = None
    for label, exchange, kind, opt in SHARD_EXCHANGES:
        cfg, sgd = shard_cfgs(opt)
        lifted = lifted_batches(mesh, batches, plans, kind)
        # the main path: 5 steps from the seeded init, counts from 0
        torch.cuda.reset_peak_memory_stats()
        state, pcfg = S.init_sharded_state(
            cfg, mesh, torch.Generator(dev).manual_seed(SEED + 31), opt)
        step = S.make_sharded_train_step(pcfg, sgd, mesh, exchange)
        kernels = {"fm_grad_segsum_factored": segsum.FACTORED,
                   "gather_vw_rows": rowio.GATHER_VW,
                   "segment_rowsum_sq": segsum.ROWSUM_SQ,
                   "segment_rowsum": segsum.ROWSUM,
                   "scatter_set_rows": rowio.SCATTER}
        # a step's launches: the lookup; B3 on the hybrid exchange, B6 on
        # the global and unique ones; the dense exchange (adam) runs the
        # direct step's update: [v | w], m and v rows gathered, B5 over
        # the per-slot terms, the three tables' V and w rows written
        dense = exchange == "dense"
        expected = {"fm_grad_segsum_factored": kind == "hybrid",
                    "gather_vw_rows": 4 if dense else 1,
                    "segment_rowsum_sq": label in ("unique", "global"),
                    "segment_rowsum": dense, "scatter_set_rows": 6 * dense}
        expected = {n: int(c) * SHARD_STEPS for n, c in expected.items()}
        for kern in kernels.values():
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for b in lifted:
            state, aux = step(state, b)
            losses.append(float(aux["loss"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: kern.launches for name, kern in kernels.items()}
        if not all(np.isfinite(losses)):
            raise AssertionError(f"sharded {label}: losses {losses}")
        if counts != expected:
            raise AssertionError(f"sharded {label}: launches {counts}, "
                                 f"expected {expected}")
        launches.update({f"{n} ({label})": c for n, c in counts.items() if c})
        peak = torch.cuda.max_memory_allocated() / 2**30
        ref["losses"][label] = losses
        if kind == "hybrid":
            # the rows the run touched, for phase 32 to hold its ranks to
            ids = np.unique(np.concatenate([p.uids[:int(p.count)]
                                            for p, _ in plans]))
            it = torch.as_tensor(ids, device=dev).long()
            ref.update(ids=ids, v=state.params.v[it].cpu().numpy(),
                       w=state.params.w[it].cpu().numpy())
            b1_case = (state.params.v, state.params.w,
                       lifted[0].plan.uids.to(torch.int32))
            _, events = device_us(lambda: step(state, lifted[0]), tries=1)
            busy = sum(e.self_device_time_total for e in events)
            b3 = sum(e.self_device_time_total for e in events
                     if "fm_grad" in e.key)
            report["b3_share"] = b3 / busy if busy else None
        # the step's time against its one-device twin's, back to back
        make_twin, twin_step, twin_batches, twin_name = twin_of(label, cfg,
                                                                sgd)
        twin = make_twin(state)
        ms = time_ms(lambda: step(state, lifted[0]), [()], reps=10,
                     windows=3)
        twin_ms = time_ms(lambda: twin_step(twin, twin_batches[0]), [()],
                          reps=10, windows=3)
        del state, twin
        torch.cuda.empty_cache()
        # held step by step against the twin, from the same seeded init
        state, _ = S.init_sharded_state(
            cfg, mesh, torch.Generator(dev).manual_seed(SEED + 31), opt)
        excused = 0
        for i, (b, tb) in enumerate(zip(lifted, twin_batches)):
            twin = make_twin(state)
            before = (state_tables(clone_state(state)) if opt == "adam"
                      else None)
            state, aux = step(state, b)
            twin, taux = twin_step(twin, tb)
            np.testing.assert_allclose(float(aux["loss"]),
                                       float(taux["loss"]), rtol=1e-5)
            excused += compare(state, twin, f"sharded {label} step {i + 1} "
                               f"vs {twin_name}", before, sgd.learning_rate)
            del twin, before
        del state
        torch.cuda.empty_cache()
        report[label] = dict(ms=ms, twin_ms=twin_ms, wall=wall, peak=peak,
                             twin=twin_name)
        print(f"train: phase 31, sharded {label} exchange on a (1, 1) mesh "
              f"(one NCCL rank), config 3 (2^24 x {RANK}, B = {BATCH}, "
              f"{SLOTS} slots, lr {sgd.learning_rate}): 5 steps, losses "
              f"{losses}, "
              f"{wall / SHARD_STEPS * 1e3:.3f} ms a step with host "
              f"dispatch; launches {counts}; a step back to back "
              f"{ms:.3f} ms against the one-device {twin_name} step's "
              f"{twin_ms:.3f} ms (exchange layer at world size 1: "
              f"{ms - twin_ms:+.3f} ms); peak {peak:.2f} GiB; held step by "
              f"step against the {twin_name} step (losses rtol 1e-5, "
              f"every table and slot "
              + ("on each step's change at rtol 1e-4 + ulp + 1e-6 of the "
                 f"largest change; {excused} entries of w and V excused "
                 "within 2 lr, up to 64 a table and step allowed"
                 if opt == "adam" else "at rtol 1e-4, atol 1e-6")
              + f"); {card}", flush=True)
    print(f"profile: phase 31 global hybrid step: B3 "
          f"{pct(report['b3_share'])} of its device time; {card}",
          flush=True)

    # B1 at the masked lookup's shape, B3 and B6 at the sharded shapes
    v, w, uids = b1_case
    got = rowio.gather_vw_rows(v, w, uids)
    if not torch.equal(got, rowio.gather_vw_rows_reference(v, w, uids)):
        raise AssertionError("the sharded lookup's gather != its plain version")
    u = uids.numel()
    t = timed_kernel(f"B1 gather_vw_rows, the sharded masked lookup "
                     f"(U={u}, K+1={RANK + 1})", rowio.gather_vw_rows,
                     rowio.gather_vw_rows_reference, (v, w, uids), None,
                     4 * (u + 2 * u * (RANK + 1)), 0, card)
    entries.append({
        "name": "gather_vw_rows (sharded masked lookup, config 3)",
        "route": "cuda", "source": "sparkfm_tpu_torch/csrc/rowio.cu",
        "replaces": "sparkfm_tpu/ops/pallas_rowio.py:140",
        "launches": sum(c for n, c in launches.items()
                        if n.startswith("gather_vw_rows")),
        "path": "phase 31: the four exchanges' 5 steps on a (1, 1) NCCL "
                "mesh, one lookup a step, and the dense exchange's three "
                "row reads a step", "max_abs_err": 0.0,
        "library": "none (two index_selects and a cat: the plain version)",
        **t})
    del v, w, uids, b1_case
    checked = []
    # the (2, 2) mesh's shard: half the batch, its local dense ranks
    p2 = shard_plans(batches[:1], BUCKETS + 1, 2)[0][1]
    for shape, (seg_np, sv_np, sex_np, gmap_np), n_launch, label in (
            ("1 x 1", (plans[0][1].seg[0], plans[0][1].svals[0],
                       plans[0][1].sex[0], plans[0][1].order[0]),
             launches["fm_grad_segsum_factored (global hybrid)"],
             "phase 31: the global hybrid exchange's 5 steps on one NCCL "
             "rank"),
            ("(2, 2) shard", (p2.seg[0], p2.svals[0], p2.sex[0],
                              p2.order[0]), None,
             "phase 32: 5 global hybrid steps on each of 4 gloo ranks")):
        seg = torch.as_tensor(seg_np, device=dev)
        n, u_cap = seg.shape[0], gmap_np.shape[0]
        vw_loc = 0.01 * torch.randn((u_cap, k + 1), generator=gen,
                                    device=dev)
        ex = torch.randn((n, k + 2), generator=gen, device=dev)
        x = torch.as_tensor(sv_np, device=dev)
        cv = cw = torch.tensor(2e-6 / BATCH, device=dev)
        args = (vw_loc, ex, x, seg, u_cap, cv, cw)
        exact = plain64(*args)
        got = segsum.fm_grad_segsum_factored(*args)
        err = max_rel_err(got, exact)
        plain_err = max_rel_err(
            segsum.fm_grad_segsum_factored_reference(*args), exact)
        if not err < 1e-4:
            raise AssertionError(f"B3 off at the {shape} shape: {err:.3g}")
        checked.append(f"B3 {shape} N={n} U={u_cap}: kernel {err:.3g}, "
                       f"plain {plain_err:.3g}")
        t = timed_kernel(f"B3 at the sharded {shape} shape (N={n}, "
                         f"U={u_cap})", segsum.fm_grad_segsum_factored,
                         segsum.fm_grad_segsum_factored_reference, args,
                         None, 4 * (u_cap * (k + 1) + n * (k + 4)
                                    + u_cap * (2 * k + 2)),
                         8 * n * (k + 1), card)
        entries.append({
            "name": f"fm_grad_segsum_factored (sharded, {shape})",
            "route": "cuda", "source": "sparkfm_tpu_torch/csrc/segsum.cu",
            "replaces": "sparkfm_tpu/ops/pallas_segsum.py:613",
            "launches": n_launch, "path": label,
            "max_abs_err": float((got.double() - exact).abs().max()),
            "max_rel_err": err, "plain_f32_max_rel_err": plain_err,
            "err_against": "plain version in float64",
            "library": "none (the gradient is formed in the kernel)", **t})
    # B6 on the unique exchange's device plan
    plan = E.dedup_ids(batches[0].ids.to(dev), E.auto_budget(BATCH * SLOTS),
                       fill=BUCKETS)
    g = 0.01 * torch.randn((BATCH * SLOTS, k + 1), generator=gen,
                           device=dev)
    g_srt = g.index_select(0, plan.order.long())
    payload = (g_srt, plan.seg, plan.uids.shape[0])
    res = hold64(segsum.segment_rowsum_sq, segsum.segment_rowsum_sq_reference,
                 payload, "B6 at the unique exchange's device plan", checked)
    entries.append(rowsum_sq_entry_of(
        "sharded unique exchange, config 3", res, payload,
        sum(c for n, c in launches.items()
            if n.startswith("segment_rowsum_sq")),
        "phase 31: the local [Σg | Σg²] of the global (over a device sort "
        "of the plan's ranks) and unique (over its device plan) exchanges, "
        "one a step each", card))
    # B5 on the dense exchange's per-slot adam terms of [v | w], sorted by
    # row, over the direct step's plan of the batch's ids (every slot's
    # own at world size 1)
    dplan = E.dedup_ids(batches[0].ids.to(dev), BATCH * SLOTS, fill=BUCKETS)
    terms = 1e-6 * torch.randn((BATCH * SLOTS, k + 1), generator=gen,
                               device=dev)
    payload = (terms.index_select(0, dplan.order.long()), dplan.seg,
               dplan.uids.shape[0])
    res = hold64(segsum.segment_rowsum, segsum.segment_rowsum_reference,
                 payload, "B5 at the dense exchange's per-slot terms",
                 checked)
    n_b5, w_b5 = payload[0].shape
    t = timed_kernel(f"B5 segment_rowsum, the dense exchange's adam terms "
                     f"(N={n_b5}, W={w_b5}, U={payload[2]})",
                     segsum.segment_rowsum, segsum.segment_rowsum_reference,
                     payload, lambda: torch.zeros(
                         (payload[2], w_b5), device=dev).index_add_(
                         0, payload[1].long(), payload[0]),
                     4 * (n_b5 * w_b5 + n_b5 + payload[2] * w_b5),
                     n_b5 * w_b5, card)
    entries.append({
        "name": "segment_rowsum (sharded dense exchange, adam)",
        "route": "cuda", "source": "sparkfm_tpu_torch/csrc/segsum.cu",
        "replaces": "sparkfm_tpu/ops/pallas_segsum.py:101",
        "launches": launches["segment_rowsum (dense, adam)"],
        "path": "phase 31: the dense exchange's per-slot step terms under "
                "adam, summed per row of [v | w], one a step",
        "max_abs_err": res[0], "max_rel_err": res[1],
        "plain_f32_max_rel_err": res[2],
        "err_against": "plain version in float64", "library": "index_add_",
        **t})
    del g, g_srt, payload, plan, terms
    # B2 writing the dense exchange's V rows back (the direct step's
    # write: the plan's distinct ids, then its fill), exact on every row
    # a run's first slot names
    uids = dplan.uids
    u = uids.shape[0]
    distinct = min(int(dplan.count) + 1, u)
    table = torch.zeros((BUCKETS + 1, k), device=dev)
    rows = torch.randn((u, k), generator=gen, device=dev)
    rowio.scatter_set_rows(table, uids, rows)
    firsts = torch.ones(u, dtype=torch.bool, device=dev)
    firsts[1:] = uids[1:] != uids[:-1]
    if not torch.equal(table[uids[firsts].long()], rows[firsts]):
        raise AssertionError("B2 wrong at the dense exchange's write")
    keep = uids[:distinct].long()
    t = timed_kernel(f"B2 scatter_set_rows, the dense exchange's V rows "
                     f"(U={u}, W={k})", rowio.scatter_set_rows,
                     rowio.scatter_set_rows_reference, (table, uids, rows),
                     lambda: table.index_copy_(0, keep, rows[:distinct]),
                     u * 4 + 2 * distinct * k * 4, 0, card)
    entries.append({
        "name": "scatter_set_rows (sharded dense exchange, adam)",
        "route": "cuda", "source": "sparkfm_tpu_torch/csrc/rowio.cu",
        "replaces": "sparkfm_tpu/ops/pallas_rowio.py:74",
        "launches": launches["scatter_set_rows (dense, adam)"],
        "launches_counts": "every write of the run, W = 32 and 1",
        "path": "phase 31: the dense exchange's row writes under adam "
                "(V and w of the table, m and v: 6 a step), timed at W = 32",
        "max_abs_err": 0.0,
        "library": "index_copy_ over the plan's distinct ids", **t})
    del dplan, uids, table, rows, firsts, keep
    print(f"check: {'; '.join(checked)} (max |a-b|/(1+|b|) against float64, "
          f"kernel < 1e-4)", flush=True)
    torch.cuda.empty_cache()
    print(f"phase 31: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 32. a (2, 2) mesh of 4 processes on card 0 over gloo
    t_phase = time.perf_counter()
    outs = MH.spawn(sharded_rank_run, (2, 2),
                    device="cuda:0" if dev.type == "cuda" else "cpu",
                    timeout=420, args=(ref,))
    if {o["backend"] for o in outs} != {"gloo"}:
        raise AssertionError(f"phase 32: four ranks on one card ran on "
                             f"{[o['backend'] for o in outs]}, not gloo")
    b3_ranks = sum(o["b3_launches"] for o in outs)
    if any(o["b3_launches"] != SHARD_STEPS for o in outs):
        raise AssertionError(f"phase 32: B3 launches "
                             f"{[o['b3_launches'] for o in outs]}")
    next(e for e in entries if e["name"] == "fm_grad_segsum_factored "
         "(sharded, (2, 2) shard)")["launches"] = b3_ranks
    print(f"train: phase 32, (2, 2) mesh as 4 processes on card 0 over gloo "
          f"(NCCL refuses two ranks on one card: 'Duplicate GPU detected'), "
          f"config 3's width: 5 global hybrid steps a rank, losses "
          f"{outs[0]['losses']['global hybrid']} equal phase 31's one-rank "
          f"run (rtol 1e-5), the {sum(o['rows_held'] for o in outs)} rows "
          f"the run touched, on their owners, equal its tables (rtol 1e-4, "
          f"atol 1e-6); B3 per shard N={outs[0]['n_local']}, "
          f"U_cap={outs[0]['u_cap']}, {b3_ranks} launches (5 a rank); the "
          f"unique, global and dense (adam) exchanges 2 steps each over "
          f"gloo (all_gather and all_reduce of CUDA tensors), losses equal "
          f"phase 31's: { {l: o for l, o in outs[0]['losses'].items()} }; "
          f"{outs[0]['hybrid_s_per_step']:.3f} s a step through the host "
          f"(no number of the card); {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # 33. config 2: sharded ALS and MCMC sweeps on the one-rank mesh
    t_phase = time.perf_counter()
    entries += sharded_sweep_phase(dev, card, mesh, als_ctx)
    print(f"phase 33: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 34. config 5: sharded DeepFM on the one-rank mesh
    t_phase = time.perf_counter()
    entries += sharded_deepfm_phase(dev, card, mesh)
    print(f"phase 34: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return entries, mesh


def sharded_sweep_phase(dev, card, mesh, ctx):
    """Phase 33: one sharded ALS sweep and one sharded MCMC sweep at
    config 2 on the one-rank mesh, against the compact sweeps of
    ``train_als`` / ``train_mcmc`` and against the same sweep with B7's
    float64 plain version (guard flips as phase 12 allows); B7's launches
    by S and its entries at the direct sweep's shape (N = 50M, U = F)."""
    from sparkfm_tpu_torch import ALSConfig, MCMCConfig
    from sparkfm_tpu_torch.models import fm as fm_model
    from sparkfm_tpu_torch.ops import segsum
    from sparkfm_tpu_torch.parallel import sharded_als as SA
    from sparkfm_tpu_torch.solvers import als as A
    from sparkfm_tpu_torch.solvers import mcmc

    ds, ws, nb, cfg = ctx["ds"], ctx["ws"], ctx["nb"], ctx["cfg"]
    flags = ctx["flags"]
    f = cfg.num_features
    t0 = time.perf_counter()
    sws, snb = SA.build_sharded_workspace(
        ds, cfg, ALSConfig(feature_blocks=ctx["feature_blocks"]), mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if snb != nb:
        raise AssertionError(f"sharded blocks {snb} != {nb}")
    start = fm_model.init_params(cfg, torch.Generator(dev).manual_seed(
        SEED + 33), device=dev)
    reg_w, reg_v = (torch.as_tensor(r, device=dev)
                    for r in cfg.reg_vectors())
    sweep = SA.make_sharded_sweep(cfg, nb, mesh)
    by_s = collections.Counter()
    real = segsum.segment_colsums

    def counting(streams, seg, num_segments):
        by_s[len(streams)] += 1
        return real(streams, seg, num_segments)

    segsum.COLSUMS.launches = 0
    with swapped([(segsum, "segment_colsums", counting)]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sweep(start, sws)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
    als_launches = segsum.COLSUMS.launches
    if als_launches != (RANK + 1) * nb or by_s != {1: nb, 2: RANK * nb}:
        raise AssertionError(f"sharded ALS sweep: B7 launches "
                             f"{als_launches}, by S {dict(by_s)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compact = A.als_sweep_compact(start, ws, nb, ws.present.shape[0],
                                  cfg.reg0, reg_w, reg_v, **flags)
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    flips = params_agree(got, compact, start, "sharded ALS sweep vs compact",
                         ids=ds.ids)
    with swapped([(segsum, "segment_colsums", colsums64)]):
        twin = sweep(start, sws)
    flips64 = params_agree(got, twin, start, "sharded ALS sweep vs its "
                           "float64-plain-B7 twin", ids=ds.ids)
    del twin, compact
    print(f"train: phase 33, sharded ALS sweep on a (1, 1) NCCL mesh, "
          f"config 2 ({ALS_N} ratings, F={f}, rank {RANK}, {nb} slot "
          f"blocks): sharded workspace {build_s:.3f} s (host); a sweep "
          f"{sweep_s * 1e3:.3f} ms against the compact sweep's "
          f"{compact_s * 1e3:.3f} ms; B7 launches {als_launches} = by S "
          f"{dict(by_s)} at N={sws.col_feat.shape[0]}, U={f}; against the "
          f"compact sweep (guard flips, neighbours) {flips}, against the "
          f"float64-plain-B7 twin {flips64}; {card}", flush=True)

    # MCMC: one sharded sweep against the compact sweep on its draws
    state0 = mcmc.init_mcmc_state(start)
    draws = RecordedDraws(mcmc.TorchDraws(
        torch.Generator(dev).manual_seed(SEED + 34)))
    msweep = SA.make_sharded_mcmc_sweep(
        cfg, MCMCConfig(feature_blocks=ctx["feature_blocks"]), nb, mesh,
        None, 1)
    by_s.clear()
    segsum.COLSUMS.launches = 0
    with swapped([(segsum, "segment_colsums", counting)]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgot = msweep(state0, sws, draws)
        torch.cuda.synchronize()
        msweep_s = time.perf_counter() - t0
    mcmc_launches = segsum.COLSUMS.launches
    if mcmc_launches != (RANK + 1) * nb or by_s != {1: nb, 2: RANK * nb}:
        raise AssertionError(f"sharded MCMC sweep: B7 launches "
                             f"{mcmc_launches}, by S {dict(by_s)}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mwant = mcmc.mcmc_sweep(state0, ws, draws.replay(), nb, f, **flags)
    torch.cuda.synchronize()
    mcompact_s = time.perf_counter() - t0
    np.testing.assert_allclose(float(mgot.alpha), float(mwant.alpha),
                               rtol=1e-5)
    mflips = params_agree(mgot.params, mwant.params, start,
                          "sharded MCMC sweep vs compact", ids=ds.ids)
    print(f"train: phase 33, sharded MCMC sweep on the same mesh and data: "
          f"{msweep_s * 1e3:.3f} ms against the compact sweep's "
          f"{mcompact_s * 1e3:.3f} ms; B7 launches {mcmc_launches} = by S "
          f"{dict(by_s)}; alpha {float(mgot.alpha):.6f} equal (rtol 1e-5), "
          f"parameters against the compact sweep on the same draws (guard "
          f"flips, neighbours) {mflips}; {card}", flush=True)
    del mgot, mwant, state0, draws

    entries = []
    seg = sws.col_feat
    gen = torch.Generator(dev).manual_seed(SEED + 35)
    checked = []
    for s, n_launch, what in ((1, nb, "a w block"),
                              (2, RANK * nb, "a (factor, block)")):
        streams = [torch.randn(seg.shape[0], generator=gen, device=dev)
                   for _ in range(s)]
        entries.append(colsums_entry(
            f"sharded sweep S = {s}, {what}", streams, seg, f,
            n_launch, f"phase 33: one sharded ALS sweep on a (1, 1) NCCL "
            f"mesh (the sharded MCMC sweep: the same counts)", checked,
            card))
        del streams
    print(f"check: B7 at the sharded sweep's shape: {'; '.join(checked)}",
          flush=True)
    del sws
    torch.cuda.empty_cache()
    return entries


def sharded_deepfm_phase(dev, card, mesh):
    """Phase 34: config 5's DeepFM on the one-rank mesh: 5 sharded steps
    with global host plans (``train_deepfm``'s sharded default), each
    held against the one-device dedup step on the same batch and plan
    from a copy of the sharded state; B1's launches."""
    from sparkfm_tpu_torch import FMConfig, SGDConfig, Task
    from sparkfm_tpu_torch.data.batching import SparseDataset, batch_iterator
    from sparkfm_tpu_torch.models import deepfm as DF
    from sparkfm_tpu_torch.ops import embedding as E
    from sparkfm_tpu_torch.ops import rowio, segsum
    from sparkfm_tpu_torch.parallel import multihost as MH
    from sparkfm_tpu_torch.parallel import sharded_deepfm as SD

    rng = np.random.default_rng(SEED + 34)
    n = SHARD_STEPS * CONFIG5_BATCH
    ids = np.concatenate([ctr_batch_ids(rng, CONFIG5_BATCH)
                          for _ in range(SHARD_STEPS)])
    ds = SparseDataset(ids=ids, vals=np.ones((n, SLOTS), np.float32),
                       y=rng.integers(0, 2, n).astype(np.float32),
                       num_features=CONFIG5_BUCKETS)
    cfg = DF.DeepFMConfig(fm=FMConfig(
        num_features=CONFIG5_BUCKETS, num_factors=CONFIG5_RANK,
        num_fields=SLOTS, task=Task.CLASSIFICATION, reg_w=1e-6, reg_v=1e-6,
        seed=SEED), hidden=CONFIG5_HIDDEN)
    sgd = SGDConfig(batch_size=CONFIG5_BATCH, learning_rate=SHARD_LR,
                    update_path="dedup")
    state, pcfg = SD.init_sharded_state(cfg, mesh,
                                        torch.Generator(dev).manual_seed(
                                            SEED + 34))
    step = SD.make_sharded_train_step(pcfg, sgd, mesh)
    fill = pcfg.fm.num_features - 1
    cap = E.auto_budget(CONFIG5_BATCH * SLOTS)
    batches, twins, rung = [], [], 1
    for b in batch_iterator(ds, CONFIG5_BATCH, device="cpu"):
        hp = E.host_dedup(np.asarray(b.ids), cap, fill,
                          vals=np.asarray(b.vals))
        rung = max(rung, E.ladder_budget(int(hp.count), cap=cap))
        hp = hp._replace(uids=hp.uids[:rung])
        batches.append(MH.global_batch(mesh, b, plan=hp._replace(
            order=None, seg=None, svals=None, sex=None), plan_mode="global"))
        twins.append(dataclasses.replace(
            b, ids=b.ids.to(dev), vals=b.vals.to(dev), y=b.y.to(dev),
            mask=b.mask.to(dev), field_ids=None,
            plan=E.plan_to_device(hp, dev)))
    ref_cfg = DF.DeepFMConfig(fm=pcfg.fm.replace(num_features=fill),
                              hidden=cfg.hidden)
    twin_step = DF.make_train_step(ref_cfg, sgd)

    def twin_of(state):
        p = state.fm.params
        fm = dataclasses.replace(
            state.fm, params=type(p)(p.w0.clone(), p.w.clone(), p.v.clone()),
            slot_w0=state.fm.slot_w0.clone(), slot_w=state.fm.slot_w.clone(),
            slot_v=state.fm.slot_v.clone(), step=state.fm.step.clone())
        return DF.DeepFMState(fm=fm, mlp_w=tuple(x.clone() for x in
                                                  state.mlp_w),
                              mlp_b=tuple(x.clone() for x in state.mlp_b),
                              smw=tuple(x.clone() for x in state.smw),
                              smb=tuple(x.clone() for x in state.smb))

    # the main path: 5 steps, counts from 0
    start = twin_of(state)
    rowio.GATHER_VW.launches = segsum.ROWSUM_SQ.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for b in batches:
        state, aux = step(state, b)
        losses.append(float(aux["loss"]))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / SHARD_STEPS
    b1, b6 = rowio.GATHER_VW.launches, segsum.ROWSUM_SQ.launches
    if b1 != SHARD_STEPS or b6 != SHARD_STEPS or not all(
            np.isfinite(losses)):
        raise AssertionError(f"phase 34: B1 launches {b1}, B6 {b6}, losses "
                             f"{losses}")
    ms = time_ms(lambda: step(state, batches[0]), [()], reps=10, windows=3)
    tw = twin_of(state)
    twin_ms = time_ms(lambda: twin_step(tw, twins[0]), [()], reps=10,
                      windows=3)
    del tw
    # held step by step from the same start
    state = start
    for i, (b, tb) in enumerate(zip(batches, twins)):
        tw = twin_of(state)
        state, aux = step(state, b)
        tw, taux = twin_step(tw, tb)
        np.testing.assert_allclose(float(aux["loss"]), float(taux["loss"]),
                                   rtol=1e-5)
        f = CONFIG5_BUCKETS
        for a, bb, what in ((state.fm.params.v, tw.fm.params.v, "V"),
                            (state.fm.slot_v, tw.fm.slot_v, "slot V"),
                            (state.fm.params.w[:, None],
                             tw.fm.params.w[:, None], "w")):
            assert_close_rows(a[:f], bb[:f], 1e-4, 1e-6,
                              f"sharded DeepFM step {i + 1} {what}")
        for a, bb in zip(state.mlp_w + state.mlp_b, tw.mlp_w + tw.mlp_b):
            np.testing.assert_allclose(a.cpu(), bb.cpu(), rtol=1e-4,
                                       atol=1e-6)
    print(f"train: phase 34, sharded DeepFM on a (1, 1) NCCL mesh, config "
          f"5 (2^20 x {CONFIG5_RANK}, {SLOTS} fields, tower "
          f"{CONFIG5_HIDDEN}, B = {CONFIG5_BATCH}, global host plans, lr "
          f"{SHARD_LR}): 5 steps, losses {losses}, {wall * 1e3:.3f} ms a "
          f"step with host dispatch, B1 launches {b1}, B6 {b6}; a step back "
          f"to back "
          f"{ms:.3f} ms against the one-device dedup step's {twin_ms:.3f} "
          f"ms; held step by step against it (losses rtol 1e-5, tables and "
          f"tower rtol 1e-4, atol 1e-6); {card}", flush=True)
    p = state.fm.params
    uids = batches[0].plan.uids.to(torch.int32)
    if not torch.equal(rowio.gather_vw_rows(p.v, p.w, uids),
                       rowio.gather_vw_rows_reference(p.v, p.w, uids)):
        raise AssertionError("phase 34's lookup gather != its plain version")
    u = uids.numel()
    t = timed_kernel(f"B1 gather_vw_rows, sharded DeepFM lookup (U={u}, "
                     f"K+1={CONFIG5_RANK + 1})", rowio.gather_vw_rows,
                     rowio.gather_vw_rows_reference, (p.v, p.w, uids), None,
                     4 * (u + 2 * u * (CONFIG5_RANK + 1)), 0, card)
    runs = E.dedup_ids(batches[0].plan.ranks, CONFIG5_BATCH * SLOTS,
                       fill=0)
    g = 0.01 * torch.randn((CONFIG5_BATCH * SLOTS, CONFIG5_RANK + 1),
                           generator=torch.Generator(dev).manual_seed(SEED),
                           device=dev)
    payload = (g.index_select(0, runs.order.long()), runs.seg,
               runs.uids.shape[0])
    checked = []
    res = hold64(segsum.segment_rowsum_sq, segsum.segment_rowsum_sq_reference,
                 payload, "B6 at the sharded DeepFM step's runs", checked)
    b6_entry = rowsum_sq_entry_of(
        "sharded DeepFM, config 5", res, payload, b6,
        "phase 34: the sharded DeepFM step's local [Σg | Σg²] over a device "
        "sort of the global plan's ranks, one a step", card)
    print(f"check: {checked[0]} (against float64, kernel < 1e-4)",
          flush=True)
    del state, start, batches, twins, g, payload, runs
    torch.cuda.empty_cache()
    return [{"name": "gather_vw_rows (sharded masked lookup, config 5)",
             "route": "cuda", "source": "sparkfm_tpu_torch/csrc/rowio.cu",
             "replaces": "sparkfm_tpu/ops/pallas_rowio.py:140",
             "launches": b1, "path": "phase 34: 5 sharded DeepFM steps on "
             "a (1, 1) NCCL mesh", "max_abs_err": 0.0,
             "library": "none (two index_selects and a cat: the plain "
             "version)", **t}, b6_entry]


ENTRY_CHILD_ARGS = ["train", "--synth", "ctr", "--synth-examples", "40000",
                    "--solver", "sgd", "--iters", "2", "--batch-size",
                    "4096", "--mesh", "1x1", "--distributed"]


def entry_point_phase(dev, card, root, mesh):
    """Phase 35: the entry points on the card: ``FM(mesh="1x1").fit`` for
    the sgd, als and mcmc solvers, the command line's ``train --mesh 1x1
    --distributed`` under ``torch.distributed.run`` (one process, NCCL),
    and the dry run of every sharded path at one rank; each launches its
    kernels."""
    from sparkfm_tpu_torch import FM
    from sparkfm_tpu_torch.data import synth
    from sparkfm_tpu_torch.ops import rowio, segsum
    from sparkfm_tpu_torch.parallel import multihost as MH

    ctr = synth.synth_ctr(1 << 16, num_fields=SLOTS, num_buckets=1 << 20,
                          seed=SEED)
    ml = synth.synth_movielens(6040, 3706, 1_000_000, seed=SEED)
    kernels = {"B1 gather_vw_rows": rowio.GATHER_VW,
               "B3 fm_grad_segsum_factored": segsum.FACTORED,
               "B6 segment_rowsum_sq": segsum.ROWSUM_SQ,
               "B7 segment_colsums": segsum.COLSUMS}
    seen = {}
    for label, kw, data, want in (
            ("FM(mesh='1x1', solver='sgd')",
             dict(solver="sgd", task="classification", batch_size=4096,
                  learning_rate=0.05, max_iter=2, num_factors=RANK),
             ctr, ("B1 gather_vw_rows", "B3 fm_grad_segsum_factored")),
            ("FM(mesh='1x1', solver='als')",
             dict(solver="als", max_iter=2, num_factors=8, reg_v=1.0), ml,
             ("B7 segment_colsums",)),
            ("FM(mesh='1x1', solver='mcmc')",
             dict(solver="mcmc", max_iter=2, num_factors=8), ml,
             ("B7 segment_colsums",))):
        for kern in kernels.values():
            kern.launches = 0
        t0 = time.perf_counter()
        model = FM(mesh="1x1", **kw).fit(data, eval_ds=data)
        torch.cuda.synchronize()
        counts = {n: kern.launches for n, kern in kernels.items()}
        if not all(counts[n] for n in want):
            raise AssertionError(f"{label}: launches {counts}")
        last = model.history[-1]
        if not all(np.isfinite(v) for v in last.values()):
            raise AssertionError(f"{label}: history {last}")
        seen[label] = (counts, {k: round(v, 6) for k, v in last.items()},
                       round(time.perf_counter() - t0, 3))
    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    stops = MH.dryrun(mesh)
    counts = {n: kern.launches for n, kern in kernels.items()}
    if not (counts["B3 fm_grad_segsum_factored"]
            and counts["B7 segment_colsums"]
            and counts["B1 gather_vw_rows"]):
        raise AssertionError(f"dryrun: launches {counts}")
    seen["dryrun (1 rank)"] = (counts, stops,
                               round(time.perf_counter() - t0, 3))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--nproc-per-node", "1", "--master-addr", "127.0.0.1",
         "--master-port", str(MH.free_port()), "-m", "sparkfm_tpu_torch",
         *ENTRY_CHILD_ARGS], cwd=root, env=env, capture_output=True,
        text=True, timeout=300)
    if child.returncode != 0:
        raise AssertionError(f"torchrun train exited {child.returncode}:\n"
                             f"{child.stdout[-2000:]}{child.stderr[-3000:]}")
    out = json.loads([ln for ln in child.stdout.splitlines()
                      if ln.startswith("{")][-1])
    if not np.isfinite(out["examples_per_sec"]):
        raise AssertionError(f"torchrun train: {out}")
    for label, (counts, last, secs) in seen.items():
        print(f"entry: {label} on the card: launches {counts}; {last}; "
              f"{secs} s", flush=True)
    print(f"entry: python -m torch.distributed.run --nproc-per-node 1 -m "
          f"sparkfm_tpu_torch {' '.join(ENTRY_CHILD_ARGS)} (NCCL, on the "
          f"card) exited 0 in {time.perf_counter() - t0:.1f} s: {out}; "
          f"{card}", flush=True)


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

    t_main = time.perf_counter()
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

    def elapsed(after):
        print(f"elapsed: {time.perf_counter() - t_main:.1f} s after phases "
              f"{after}", flush=True)
    elapsed("1-6")
    # 7-10. the training path
    train_entries, gather_record = train_phases(dev, cfg, gen, rng, card)
    elapsed("7-10")
    # 11-14. the ALS path, with the serving model's 2 GB table freed
    del params, model, mb, w_col, uids
    torch.cuda.empty_cache()
    als_entry, als_ctx = als_phases(dev, gen, card)
    elapsed("11-14")
    # 28-30. MCMC, relational SGD and BS-ALS on phase 11's data
    torch.cuda.empty_cache()
    relational_entries = mcmc_relational_phases(dev, card, als_ctx)
    elapsed("28-30")
    # 31-34. the sharded paths (phase 33 on phase 11's data), 35. their
    # entry points
    torch.cuda.empty_cache()
    sharded_entries, mesh = sharded_phases(dev, card, root, als_ctx)
    del als_ctx
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    entry_point_phase(dev, card, root, mesh)
    print(f"phase 35: {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.distributed.destroy_process_group()
    elapsed("31-35")
    # 15-18. the row sums, the fused and sorted SGD paths, B4 and B6
    torch.cuda.empty_cache()
    segsum_entries = segsum_phases(dev, cfg, gen, rng, card)
    elapsed("15-18")
    # 19-21. BASELINE configs 1 and 4, the dedup path under adam and
    # momentum
    torch.cuda.empty_cache()
    ddf_entries = direct_dedup_ffm_phases(dev, cfg, gen, rng, card)
    elapsed("19-21")
    # 22-24. grouped steps as CUDA graphs, checkpointed training
    torch.cuda.empty_cache()
    graph_checkpoint_phases(dev, cfg, gen, rng, card, root)
    elapsed("22-24")
    # 25-27. BASELINE config 5 (DeepFM), DeepFM serving, the command line
    torch.cuda.empty_cache()
    deepfm_entries = deepfm_cli_phases(dev, gen, rng, card, root)
    elapsed("25-27")

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
        *train_entries, als_entry, *relational_entries, *segsum_entries,
        *ddf_entries, *deepfm_entries, *sharded_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
