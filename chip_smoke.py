#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparkfm_tpu_torch``) on one GPU.

Drives the port's two paths once at the full width of BASELINE config 3
(Criteo-shape logistic FM: 2^24 hashed buckets, rank 32, 39 slots), with
random weights and data from a seed: FM serving, then hybrid SGD training.

  1. builds every kernel library from ``sparkfm_tpu_torch/csrc/`` at once,
     one nvcc per source in parallel (``rowio.cu``: row gather and row
     write; ``segsum.cu``: factored backward), and prints ptxas's
     registers and spills per kernel;
  2. holds the gather kernel against its plain version (``index_select``) on the
     card, with exact equality (a gather is a copy), at the main path's
     shapes and at odd widths, and times both with CUDA events;
  3. shows, in a child process, that an id out of range traps the kernel;
  4. checks scores on a small input against a float64 numpy reference;
  5. serves a few dozen requests through ``MicroBatcher`` and one
     16384-row batch through ``FMModel.predict_dataset``, with the launch
     count set to 0 just before and read just after, and holds the
     outputs against the same requests scored with the plain gather;
  6. profiles where the time goes: device time per gather call, the
     device's busy share of the serving run, the host wall time of the
     run split into plan building, plan copy and the scoring call, and
     the host plan alone at both batch shapes. The plans must come from
     the native builder (``native/dedup_plan.cpp``); the smoke fails if
     it did not build;
  7. holds the row-write kernel against ``index_copy_`` (exact, every row
     but the plan's fill row) on a (2^24+1, 68) fused-record table with
     the uids of real bench-recipe ladder plans, at odd widths and on a
     misaligned table, and the gather at the record's width;
  8. holds the factored-backward kernel against its plain version on a
     bench-recipe plan (N = 638,976 slots, one run of ~162k) and on a
     ``synth_ctr`` plan, at k = 32, 4 and 33 (f32 sums in another order:
     max |a - b| / (1 + |b|) < 1e-4), and shows its sums repeat exactly;
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
     host plan, its copy to the card and the step's host side.

Every phase raises on failure. Needs one CUDA card; without one it exits
non-zero and prints no result. Run from the repository root:

    python3 chip_smoke.py

The line before the last is the kernels' JSON (``ms``/``plain_ms``: one
call at the main path's shape, back to back under CUDA events, for the
gather one plan's V+w serving gather, where the host's launch cost sets
the pace; ``device_ms``/``plain_device_ms``: the device time of one call
from torch.profiler; ``launches``: the count from the main paths' runs,
serving and training), the last line the result.
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


def device_us(fn):
    """All device time (us) that torch.profiler records while ``fn`` runs:
    the sum over device-side events (kernels, copies) only, since a CPU
    op's entry repeats the device time of the kernels it launched. Also
    the device events, sorted by time."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    return sum(e.self_device_time_total for e in events), events


TRAP_CHILD = """
import sys, torch
from sparkfm_tpu_torch.ops import rowio
table = torch.zeros((10, 4), device="cuda")
ids = torch.tensor([0, 10], dtype=torch.int32, device="cuda")
try:
    rowio.gather_rows(table, ids)
    torch.cuda.synchronize()
except RuntimeError as e:
    if "unspecified launch failure" not in str(e):   # not the trap
        raise
    print("trapped:", str(e).splitlines()[0])
    sys.exit(3)
print("no trap")
"""


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


def assert_close_rows(a, b, rtol, atol, what, rows=1 << 22):
    """np.allclose semantics over two big tables, a block of rows at a
    time (the temporaries of one call would take several GB)."""
    for r0 in range(0, a.shape[0], rows):
        x, y = a[r0:r0 + rows], b[r0:r0 + rows]
        bad = ((x - y).abs() > atol + rtol * y.abs()).sum().item()
        if bad:
            raise AssertionError(f"{what}: {bad} entries differ beyond rtol "
                                 f"{rtol}, atol {atol} in rows {r0}..")


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
    # their plain versions on a full-size record table
    table = torch.randn((BUCKETS + 1, width), generator=gen, device=dev)
    for u in uids:
        got = rowio.gather_rows(table, u)
        if not torch.equal(got, rowio.gather_rows_reference(table, u)):
            raise AssertionError(f"gather kernel wrong at W={width}")
        rows = torch.randn((rung, width), generator=gen, device=dev)
        want = rowio.scatter_set_rows_reference(table.clone(), u, rows)
        if rowio.scatter_set_rows(table, u, rows) is not table:
            raise AssertionError("scatter_set_rows did not write in place")
        if not torch.equal(table[:-1], want[:-1]):
            raise AssertionError(f"row write kernel != index_copy_ at "
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
        if not torch.equal(rowio.scatter_set_rows(t, ids, new)[:-1],
                           want[:-1]):
            raise AssertionError(f"row write kernel wrong at {(r, w, n)}")
    t = torch.randn(1000 * 4 + 1, device=dev, generator=gen)[1:].view(1000, 4)
    ids = torch.arange(999, -1, -3, dtype=torch.int32, device=dev)
    new = torch.randn((ids.numel(), 4), generator=gen, device=dev)
    want = rowio.scatter_set_rows_reference(t.clone(), ids, new)
    if not torch.equal(rowio.scatter_set_rows(t, ids, new), want):
        raise AssertionError("row write kernel wrong on a misaligned table")
    torch.cuda.synchronize()
    print(f"check: row write kernel == index_copy_ (every row but the fill "
          f"row) on the record table {tuple(table.shape)} with U={rung} (4 "
          f"bench-recipe plans, counts {[int(p.count) for p in plans]}), at "
          f"(R, W, U) {odd} and on a misaligned table; gather kernel == "
          f"index_select at W={width}", flush=True)
    rows = [torch.randn((rung, width), generator=gen, device=dev)
            for _ in uids]
    wargs = list(zip(uids, rows))
    times = {
        "gather": (time_ms(lambda u: rowio.gather_rows(table, u),
                           [(u,) for u in uids]),
                   time_ms(lambda u: rowio.gather_rows_reference(table, u),
                           [(u,) for u in uids])),
        "write": (time_ms(lambda u, r: rowio.scatter_set_rows(table, u, r),
                          wargs),
                  time_ms(lambda u, r: rowio.scatter_set_rows_reference(
                      table, u, r), wargs))}
    dev_us = {
        "gather": tuple(device_us(lambda: [g(table, u) for u in uids])[0]
                        / len(uids) for g in (
                            rowio.gather_rows, rowio.gather_rows_reference)),
        "write": tuple(device_us(lambda: [w(table, u, r) for u, r in wargs])
                       [0] / len(wargs) for w in (
                           rowio.scatter_set_rows,
                           rowio.scatter_set_rows_reference))}
    del table, rows, wargs
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
    times["backward"] = (
        time_ms(lambda: segsum.fm_grad_segsum_factored(*main_case, cv, cw),
                [()]),
        time_ms(lambda: segsum.fm_grad_segsum_factored_reference(
            *main_case, cv, cw), [()]))
    dev_us["backward"] = tuple(
        device_us(lambda: [f(*main_case, cv, cw) for _ in range(5)])[0] / 5
        for f in (segsum.fm_grad_segsum_factored,
                  segsum.fm_grad_segsum_factored_reference))
    del main_case
    for name, (ms, plain) in times.items():
        print(f"time: {name} per call at the main path's shape (U={rung}, "
              f"W={width}, N={BATCH * SLOTS}): kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms back to back (CUDA events, best of 5 "
              f"windows of 20); device {dev_us[name][0]:.2f} us vs "
              f"{dev_us[name][1]:.2f} us (torch.profiler); {card}",
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
    first = state.table.clone()
    step = sgd_hybrid.make_hybrid_train_step(cfg, sgd)
    # Each step runs twice from the same state, with the kernels and with
    # the plain versions (the backward's in float64: see plain64), and the
    # run goes on from the kernels' result. Run freely, the two would
    # drift apart beyond any tolerance for a reason that is no fault of
    # either: on random labels at lr 0.05 the loss grows by orders of
    # magnitude within a few steps, and that growth amplifies the f32
    # rounding of the sums.
    losses = []
    for b in batches:
        plain_in = dataclasses.replace(state, table=state.table.clone())
        state, aux = step(state, b)
        counts = [k.launches for k in kernels.values()]
        with swapped([(rowio, "gather_rows", rowio.gather_rows_reference),
                      (rowio, "scatter_set_rows",
                       rowio.scatter_set_rows_reference),
                      (segsum, "fm_grad_segsum_factored", plain64)]):
            plain_out, plain_aux = step(plain_in, b)
        if [k.launches for k in kernels.values()] != counts:
            raise AssertionError("the plain step launched a kernel")
        losses.append(float(aux["loss"]))
        np.testing.assert_allclose(losses[-1], float(plain_aux["loss"]),
                                   rtol=1e-5)
        assert_close_rows(state.table[:BUCKETS, :used],
                          plain_out.table[:BUCKETS, :used], 1e-4, 1e-6,
                          f"step {len(losses)} tables")
        np.testing.assert_allclose(float(state.w0), float(plain_out.w0),
                                   rtol=1e-5)
        del plain_in, plain_out
    moved = int((state.table[:BUCKETS, :used] != first[:BUCKETS, :used])
                .any(dim=1).sum())
    print(f"check: 5 hybrid steps on bench-recipe batches (uniques "
          f"{[int(b.plan.count) for b in batches]}), each from the same "
          f"state with the kernels and with the plain versions: losses "
          f"{losses} equal (rtol 1e-5), tables [:F, :{used}] equal (rtol "
          f"1e-4, atol 1e-6), {moved} rows updated in all", flush=True)
    del state, first
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

    entries = [
        {"name": "scatter_set_rows", "route": "cuda",
         "source": "sparkfm_tpu_torch/csrc/rowio.cu",
         "replaces": "sparkfm_tpu/ops/pallas_rowio.py:74",
         "launches": launches["scatter_set_rows"], "max_abs_err": 0.0,
         "ms": times["write"][0], "plain_ms": times["write"][1],
         "device_ms": dev_us["write"][0] / 1e3,
         "plain_device_ms": dev_us["write"][1] / 1e3},
        {"name": "fm_grad_segsum_factored", "route": "cuda",
         "source": "sparkfm_tpu_torch/csrc/segsum.cu",
         "replaces": "sparkfm_tpu/ops/pallas_segsum.py:613",
         "launches": launches["fm_grad_segsum_factored"],
         "max_abs_err": main_abs, "max_rel_err": main_err,
         "plain_f32_max_rel_err": main_plain_err,
         "err_against": "plain version in float64",
         "ms": times["backward"][0], "plain_ms": times["backward"][1],
         "device_ms": dev_us["backward"][0] / 1e3,
         "plain_device_ms": dev_us["backward"][1] / 1e3}]
    gather_record = {
        "launches_training": launches["gather_rows"],
        "record_ms": times["gather"][0],
        "record_plain_ms": times["gather"][1],
        "record_device_ms": dev_us["gather"][0] / 1e3,
        "record_plain_device_ms": dev_us["gather"][1] / 1e3}
    return entries, gather_record


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

    # 2. kernel against plain gather: main-path shapes (V and the w
    # column, by the uids of real ladder plans), then odd shapes
    cap = E.auto_budget(BATCH * SLOTS)
    plans = [E.host_dedup(zipf_ids(rng, BATCH), cap, fill=BUCKETS - 1)
             for _ in range(8)]
    rung = max(E.ladder_budget(int(p.count), cap=cap) for p in plans)
    if any(p.overflow for p in plans):
        raise AssertionError("a 16384-row zipf plan overflowed its cap")
    uids = [torch.as_tensor(p.uids[:rung], device=dev) for p in plans]
    w_col = params.w.view(-1, 1)
    max_err = 0.0
    for u in uids:
        for table in (params.v, w_col):
            got = rowio.gather_rows(table, u)
            ref = rowio.gather_rows_reference(table, u)
            if not torch.equal(got, ref):
                raise AssertionError("gather kernel != index_select at "
                                     f"{tuple(table.shape)}, U={u.numel()}")
            max_err = max(max_err, (got - ref).abs().max().item())
    odd = [(100003, 1, 1001), (100003, 33, 1001), (100003, 128, 1001),
           (7, 5, 3)]
    for rows, width, n in odd:
        table = torch.randn((rows, width), device=dev, generator=gen)
        ids = torch.as_tensor(rng.integers(0, rows, n, dtype=np.int32),
                              device=dev)
        got = rowio.gather_rows(table, ids)
        if not torch.equal(got, rowio.gather_rows_reference(table, ids)):
            raise AssertionError(f"gather kernel wrong at {(rows, width, n)}")
    # a 16-byte-misaligned table takes the kernel's scalar path
    table = torch.randn(1000 * 4 + 1, device=dev, generator=gen)[1:].view(
        1000, 4)
    ids = torch.arange(999, -1, -1, dtype=torch.int32, device=dev)
    if not torch.equal(rowio.gather_rows(table, ids),
                       rowio.gather_rows_reference(table, ids)):
        raise AssertionError("gather kernel wrong on a misaligned table")
    torch.cuda.synchronize()
    print(f"check: gather kernel == index_select at V {tuple(params.v.shape)}"
          f" and w {tuple(w_col.shape)} with U={rung} (8 zipf plans, counts "
          f"{[int(p.count) for p in plans]}), at (R, W, U) {odd} and on a "
          "misaligned table", flush=True)

    def pair(gather):
        def run(u):
            gather(params.v, u)
            gather(w_col, u)
        return run
    args = [(u,) for u in uids]
    plain_ms = time_ms(pair(rowio.gather_rows_reference), args)
    kernel_ms = time_ms(pair(rowio.gather_rows), args)
    kernel_ms = min(kernel_ms, time_ms(pair(rowio.gather_rows), args))
    plain_ms = min(plain_ms, time_ms(pair(rowio.gather_rows_reference), args))
    v_ms = time_ms(lambda u: rowio.gather_rows(params.v, u), args)
    v_plain_ms = time_ms(
        lambda u: rowio.gather_rows_reference(params.v, u), args)
    print(f"time: one plan's V+w gather (U={rung}): kernel {kernel_ms:.4f} "
          f"ms, index_select {plain_ms:.4f} ms; V alone: kernel "
          f"{v_ms:.4f} ms, index_select {v_plain_ms:.4f} ms; per call, back "
          f"to back, CUDA events, best of 10 windows of 20; {card}",
          flush=True)

    # 3. an id out of range traps (in a child: a trap leaves the CUDA
    # context of its process unusable)
    child = subprocess.run([sys.executable, "-c", TRAP_CHILD], cwd=root,
                           capture_output=True, text=True, timeout=300)
    if child.returncode != 3:
        raise AssertionError("out-of-range id did not trap: rc "
                             f"{child.returncode}\n{child.stdout}"
                             f"{child.stderr[-2000:]}")
    print(f"check: out-of-range id -> {child.stdout.strip()}", flush=True)

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
    rowio.GATHER.launches = 0                  # the main path's run
    t0_serve = time.perf_counter()
    outs = serve()
    t1 = time.perf_counter()
    preds = model.predict_dataset(ds, batch_size=BATCH)
    t2 = time.perf_counter()
    launches = rowio.GATHER.launches
    if launches == 0:
        raise AssertionError("the serving path never launched the kernel")
    # one chunk of at most 4096 per flush call, two gathers (V, w) each,
    # plus two for the predict_dataset batch
    chunks = -(-n_req // MAX_BATCH)
    if launches != 2 * chunks + 2:
        raise AssertionError(f"{launches} launches, expected "
                             f"{2 * chunks + 2}")

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
    for label, gather in (("kernel", rowio.gather_rows),
                          ("index_select", rowio.gather_rows_reference)):
        for tname, table in (("V", params.v), ("w", w_col)):
            us, _ = device_us(lambda: [gather(table, u) for u in uids])
            per_call[f"{label} {tname}"] = us / len(uids)

    def device_ms(label):
        """Device time of one plan's V+w gather, None if not measured."""
        ms = (per_call[f"{label} V"] + per_call[f"{label} w"]) / 1e3
        return ms or None

    if not any(per_call.values()):
        print("profile: not measured (torch.profiler saw no device time)")
    else:
        v_bytes = rung * (RANK * 4 * 2 + 4)
        print(f"profile: device us per gather call (U={rung}): "
              + ", ".join(f"{k} {v:.2f}" for k, v in per_call.items())
              + f"; kernel V moves {v_bytes / per_call['kernel V'] / 1e3:.0f}"
              f" GB/s of device time; {card}", flush=True)
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

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "gather_rows", "route": "cuda",
        "source": "sparkfm_tpu_torch/csrc/rowio.cu",
        "replaces": "sparkfm_tpu/ops/pallas_rowio.py:140",
        "launches": launches + gather_record["launches_training"],
        "launches_serving": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "device_ms": device_ms("kernel"),
        "plain_device_ms": device_ms("index_select"), **gather_record},
        *train_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
