#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparkfm_tpu_torch``) on one GPU.

Drives the port's FM serving path once at the full width of BASELINE
config 3 (Criteo-shape logistic FM: 2^24 hashed buckets, rank 32, 39
slots), with random weights from a seed:

  1. builds the row-gather kernel from ``sparkfm_tpu_torch/csrc/rowio.cu``;
  2. holds the kernel against its plain version (``index_select``) on the
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
     it did not build.

Every phase raises on failure. Needs one CUDA card; without one it exits
non-zero and prints no result. Run from the repository root:

    python3 chip_smoke.py

The line before the last is the kernels' JSON (``ms``/``plain_ms``: one
plan's V+w gather per call back to back under CUDA events, where the
host's launch cost sets the pace; ``device_ms``/``plain_device_ms``: its
device time from torch.profiler), the last line the result.
"""

import collections
import contextlib
import json
import os
import subprocess
import sys
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
    from sparkfm_tpu_torch.ops import rowio

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(f"device: {name}; nvidia-smi: {smi}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    rowio.GATHER.build()
    build_s = time.perf_counter() - t0
    with open(rowio.GATHER.path[:-len(".so")] + ".log") as log:
        ptxas = [ln.split(":", 1)[-1].strip() for ln in log
                 if "registers" in ln or "spill" in ln]
    print(f"build: rowio.cu -> {os.path.relpath(rowio.GATHER.path, root)} "
          f"in {build_s:.2f} s; ptxas: {'; '.join(ptxas)}", flush=True)
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

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "gather_rows", "route": "cuda",
        "source": "sparkfm_tpu_torch/csrc/rowio.cu",
        "replaces": "sparkfm_tpu/ops/pallas_rowio.py:140",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "device_ms": device_ms("kernel"),
        "plain_device_ms": device_ms("index_select")}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
