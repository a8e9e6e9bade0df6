#!/usr/bin/env python3
"""Device times of the port's hand-written kernels at the smoke's main-path
shapes, for one or more checkouts of the repository, taken in turns on one
card.

    python3 kernel_times.py ROOT [ROOT ...] [--order 0,1,1,0]

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
- B5 and B6, the row sums, at W = 66 and 33 on the same plan;
- B1, the gather: one serving chunk's V (W = 32) and w (W = 1) by two
  calls, and by the two-table form where the root has it, at U = 40,960;
  the fused record (W = 68) at U = 40,960 (each of these one call per
  plan over 8 bench-recipe plans, so the rows are not all in L2 from the
  call before) and at a device plan's 2^18 slots.

The parent lines show how far the card drifts between turns; compare two
roots only within one run. Needs one CUDA card; prints the card's
``nvidia-smi`` name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
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


def split(res, *names):
    if res is None:                 # no trace saw device time
        return None
    total, by = res
    return [total] + [sum(v for k, v in by.items() if n in k) for n in names]


def rel(got, want):
    return float(((got.double() - want).abs() / (1 + want.abs())).max())


out = {}
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
for name, fn, plain, w in (
        ("B5", segsum.segment_rowsum, segsum.segment_rowsum_reference, 66),
        ("B6", segsum.segment_rowsum_sq, segsum.segment_rowsum_sq_reference,
         33)):
    g = torch.randn((n, w), generator=gen, device=dev)
    err = rel(fn(g, seg, u), plain(g.double(), seg, u))
    assert err < 1e-4, (name, err)
    out[name] = split(device_us(lambda: fn(g, seg, u)), "rowsum_chunks",
                      "crossing") + [err]
    del g

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
print(json.dumps({"root": ROOT, "n": n, "u": u, "us": out}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--order", default=None,
                    help="comma-separated indices into the roots, in turn")
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
            [sys.executable, "-c", f"ROOT = {roots[i]!r}\n" + CHILD],
            capture_output=True, text=True, timeout=900)
        if child.returncode != 0:
            sys.exit(f"kernel_times: {roots[i]} failed:\n{child.stdout}"
                     f"{child.stderr[-4000:]}")
        print(child.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
