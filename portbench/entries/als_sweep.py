"""Driver of the port's ALS sweep on MovieLens-25M-shape ratings.

Set-up makes the ratings and the initial weights from the seed and builds
the workspace exactly as ``train_als`` does (``build_workspace``, the
structure checks, the B7 build), then runs three sweeps of
``als_sweep_compact`` as ``train_als`` calls it, which warm every shape and
are recorded for the check. The window then runs further sweeps on the
same workspace and parameters until ``--seconds`` have passed on the host,
and ends in a device sync (a traced run: an untraced window, then a
traced one).

``als_examples_per_s`` is ratings times the window's sweeps over its wall
time. The check: the reference (``reference/als.py``) runs the first three
sweeps from the same weights and ratings in float64 and compares the loss
(training RMSE) after each, and per leaf the norm of the parameters'
change after sweep 1 and after sweep 3.
"""

from __future__ import annotations

import torch

from portbench import harness
from portbench.counts import als as als_counts
from portbench.gen import ratings, weights
from portbench.reference import als as ref_als
from portbench.reference import judge

CHECK_SWEEPS = 3
LEAVES = ("w0", "w", "v")


def run(ctx) -> harness.Outcome:
    from sparkfm_tpu_torch.config import ALSConfig, FMConfig
    from sparkfm_tpu_torch.data.batching import SparseDataset
    from sparkfm_tpu_torch.models.fm import FMParams
    from sparkfm_tpu_torch.ops import segsum
    from sparkfm_tpu_torch.solvers import als as A

    c, dev = ctx.config, ctx.device
    ctx.log("entry started")
    ids, vals, y = ratings.ratings(c, ctx.seed_for("data"), dev)
    nf = int(c["num_users"]) + int(c["num_movies"])
    k = int(c["num_factors"])
    ds = SparseDataset(ids=ids, vals=vals, y=y, num_features=nf)
    cfg = FMConfig(num_features=nf, num_factors=k, reg0=c["reg0"],
                   reg_w=c["reg_w"], reg_v=c["reg_v"],
                   init_stdev=c["init_stdev"])
    ctx.log(f"ratings made: {ds.num_examples}")
    als_cfg = ALSConfig(feature_blocks=A.slot_blocks(ds))
    params = FMParams(*weights.fm_weights(nf, k, ctx.seed_for("weights"),
                                          dev, v_stdev=c["init_stdev"]))
    # train_als's set-up, step for step
    ws, num_blocks = A.build_workspace(ds, cfg, als_cfg, device=dev)
    reg_w, reg_v = (torch.as_tensor(r, device=dev)
                    for r in cfg.reg_vectors())
    n_ranks = ws.present.shape[0]
    block_of_feat, _ = A.feature_blocks_of(nf, als_cfg)
    cpure = bool(n_ranks) and A.blocks_are_column_pure(ds, block_of_feat)
    uniform = cpure and A.csc_blocks_uniform(ds, block_of_feat)
    ident = (A.csc_slice_identity(ws, num_blocks, ds.num_examples)
             if uniform else ())
    if dev.type == "cuda":
        segsum.COLSUMS.build()
    ctx.log("workspace built")

    def sweep(p):
        return A.als_sweep_compact(
            p, ws, num_blocks, n_ranks, cfg.reg0, reg_w, reg_v,
            cfg.use_bias, cfg.use_linear, column_pure=cpure,
            csc_uniform=uniform, slice_identity=ident)

    snaps = []
    for _ in range(CHECK_SWEEPS):
        params = sweep(params)
        snaps.append({"w0": params.w0.clone(), "w": params.w.clone(),
                      "v": params.v.clone()})

    ctx.log("three sweeps run")
    calls = []
    colsums = segsum.segment_colsums
    if ctx.trace:
        def counted(streams, seg, num_segments):
            streams = list(streams)
            if ctx.tracing:
                calls.append((len(streams), int(seg.shape[0]),
                              int(num_segments)))
            return colsums(streams, seg, num_segments)
        segsum.segment_colsums = counted
    try:
        ctx.begin_window()
        while True:
            while ctx.in_window() < ctx.seconds:
                with ctx.span("sweep"):
                    params = sweep(params)
                ctx.steps += 1
            if not ctx.end_window():
                break
    finally:
        segsum.segment_colsums = colsums
    sweeps = ctx.steps
    e2e = {"als_examples_per_s": sweeps * ds.num_examples / ctx.window_s}
    work, notes = {}, {}
    if ctx.trace:
        per = als_counts.sweep_work(int(ds.ids.size), ds.num_examples,
                                    n_ranks, k)
        work = {key: val * ctx.rate_steps for key, val in per.items()}
        notes["b7_bytes"] = float(sum(als_counts.b7_bytes(*cl)
                                      for cl in calls))
        notes["b7_calls"] = len(calls)
    del params, ws, reg_w, reg_v
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx.log(f"window: {sweeps} sweeps, {ctx.window_s:.3f} s")
    ref = reference_run(ctx, ids, vals, y)
    readings = readings_of(ctx, ids, vals, y, snaps, ref)
    ctx.log("reference done")
    return harness.Outcome(e2e=e2e, attempted=sweeps, failed=0,
                           readings=readings, work=work, notes=notes)


def stand_in(ctx, dtype=torch.float32, fault=None) -> dict:
    """The numbers compared when the reference, computed in ``dtype`` and
    with ``fault`` planted, is put in the program's place."""
    ids, vals, y = ratings.ratings(ctx.config, ctx.seed_for("data"),
                                   ctx.device)
    ref = reference_run(ctx, ids, vals, y)
    alt = reference_run(ctx, ids, vals, y, dtype=dtype, fault=fault)
    del alt["data"]
    return readings_of(ctx, ids, vals, y, alt["params"], ref)


def reference_run(ctx, ids, vals, y, dtype=torch.float64,
                  fault=None) -> dict:
    c, dev = ctx.config, ctx.device
    nf = int(c["num_users"]) + int(c["num_movies"])
    w0, w, v = weights.fm_weights(nf, int(c["num_factors"]),
                                  ctx.seed_for("weights"), dev,
                                  v_stdev=c["init_stdev"])
    init = {"w0": w0.double(), "w": w.double(), "v": v.double()}
    data = ref_als.to_device(ids, vals, y, dev)
    out = ref_als.sweeps(data, w0, w, v, reg0=c["reg0"], reg_w=c["reg_w"],
                         reg_v=c["reg_v"], n_sweeps=CHECK_SWEEPS,
                         dtype=dtype, fault=fault)
    out["init"] = init
    out["data"] = data
    return out


def readings_of(ctx, ids, vals, y, snaps, ref) -> dict:
    """``loss.sweep<i>`` (training RMSE of the program's parameters after
    sweep i, both scored by the reference in float64, against the
    reference's), ``change1.worst_leaf`` and ``change3.worst_leaf``."""
    data, init = ref["data"], ref["init"]
    out = {}
    for i, (p, r) in enumerate(zip(snaps, ref["params"])):
        out[f"loss.sweep{i + 1}"] = judge.rel_gap(
            ref_als.rmse(data, p["w0"], p["w"], p["v"]),
            ref_als.rmse(data, r["w0"], r["w"], r["v"]))

    def change(p):
        return {k: float((p[k].double() - init[k]).norm()) for k in LEAVES}
    first = change(ref["params"][0])
    leaves = judge.counted_leaves(first)
    out["leaves_counted"] = float(len(leaves))      # not limited
    out["change1.worst_leaf"] = judge.worst_leaf(change(snaps[0]), first,
                                                 leaves)
    out["change3.worst_leaf"] = judge.worst_leaf(
        change(snaps[CHECK_SWEEPS - 1]), change(ref["params"][-1]), leaves)
    return out
