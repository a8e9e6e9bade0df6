"""Runs ``train_deepfm`` on xDeepFM (a CIN beside the tower), on
Criteo-shape data, as ``deepfm_train.py`` runs it on DeepFM (its
readings and helpers are reused).

Set-up builds the model's configuration first (a port whose DeepFM has
no CIN refuses it at once), makes one epoch of examples, the FM weights,
the tower and the CIN from the seed on the device, and calls
``train_deepfm`` once with the mix's update path: its first epoch (the
first dispatch builds the kernels) is the warm-up, and its first three
steps are recorded for the check. On the card the step's first call runs
eagerly before its CUDA graphs are captured, and steps 2 and 3 replay
them. The window opens at the end of that epoch, in the trainer's epoch
hook, and closes at the first epoch end ``--seconds`` later (a traced
run: an untraced window, then a traced one).

``train_examples_per_s`` is the examples of the window's epochs over its
wall time, which ends in a device sync. The check: the reference
(``reference/xdeepfm.py``) follows the first three steps from the same
weights and batches in float64 and compares each step's loss, per leaf
(w0, w, V, each tower weight and bias, W^1..W^K and w_cin) the norm of
step 1's gradient, read from Adam's first moment as m / (1 - beta1), and
the median over its coordinates of their relative error, and the norm
of the parameters' change after step 3 (read before step 4 runs).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import harness
from portbench.counts import xdeepfm as counts
from portbench.entries import deepfm_train, sgd_train
from portbench.gen import cin as cin_gen
from portbench.gen import order, tower, weights
from portbench.reference import deepfm as ref_df
from portbench.reference import xdeepfm as ref_x

CHECK_STEPS = sgd_train.CHECK_STEPS


def _fields(c) -> int:
    return int(c["num_integer_fields"]) + int(c["num_categorical_fields"])


def _model(ctx):
    """(DeepFMConfig, SGDConfig) of the cell."""
    from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
    from sparkfm_tpu_torch.models.deepfm import DeepFMConfig
    c = ctx.config
    tr = c["training"]
    cfg = DeepFMConfig(
        fm=FMConfig(num_features=int(c["num_buckets"]),
                    num_factors=int(c["num_factors"]),
                    num_fields=_fields(c), task=Task.CLASSIFICATION,
                    init_stdev=c["init_stdev"], seed=ctx.seed_for("order"),
                    reg0=c["reg0"], reg_w=c["reg_w"], reg_v=c["reg_v"]),
        hidden=tuple(int(h) for h in c["hidden"]),
        dropout=float(c["dropout"]),
        cin=tuple(int(h) for h in c["cin"]),
        reg_dense=float(c["reg_dense"]))
    sgd_cfg = SGDConfig(batch_size=int(tr["batch_size"]),
                        optimizer=tr["optimizer"],
                        learning_rate=tr["learning_rate"], epochs=1 << 30,
                        **ctx.traffic["sgd"])
    return cfg, sgd_cfg


def _weights(ctx):
    """(w0, w, v, tower weights, tower biases, CIN tensors) made from the
    seed."""
    c = ctx.config
    k, fields = int(c["num_factors"]), _fields(c)
    w0, w, v = weights.fm_weights(int(c["num_buckets"]), k,
                                  ctx.seed_for("weights"), ctx.device,
                                  v_stdev=c["init_stdev"])
    mlp_w, mlp_b = tower.tower_weights(fields * k, c["hidden"],
                                       ctx.seed_for("tower"), ctx.device)
    cin = cin_gen.cin_weights(fields, c["cin"], ctx.seed_for("cin"),
                              ctx.device)
    return w0, w, v, mlp_w, mlp_b, cin


def _probe(factory, rows: torch.Tensor, probe: dict):
    """``factory`` with its steps wrapped: after each of the first
    CHECK_STEPS steps the loss and the leaves (the touched rows of the
    tables) are copied on the device, after the first also Adam's first
    moments."""
    def make(cfg, sgd_cfg):
        step = factory(cfg, sgd_cfg)

        def wrapped(state, batch):
            state, aux = step(state, batch)
            if len(probe["losses"]) < CHECK_STEPS:
                fm = state.fm
                p = fm.params
                probe["losses"].append(aux["loss"].detach().double().clone())
                probe["params"].append({k: t.detach().clone() for k, t in
                                        ref_x.leaves(
                                            p.w0, p.w.index_select(0, rows),
                                            p.v.index_select(0, rows),
                                            state.mlp_w, state.mlp_b,
                                            state.cin).items()})
                if probe["slot1"] is None:
                    probe["slot1"] = {k: t.detach().clone() for k, t in
                                      ref_x.leaves(
                                          fm.slot_w0,
                                          fm.slot_w.index_select(0, rows),
                                          fm.slot_v.index_select(0, rows),
                                          state.smw, state.smb,
                                          state.smc).items()}
            return state, aux
        return wrapped
    return make


def run(ctx) -> harness.Outcome:
    from sparkfm_tpu_torch.models import deepfm as DF
    from sparkfm_tpu_torch.models.fm import FMParams

    ctx.log("entry started")
    cfg, sgd_cfg = _model(ctx)
    path = DF.resolve_deepfm_path(cfg, sgd_cfg)
    DF.make_train_step(cfg, sgd_cfg)        # refuses what it cannot train
    c, dev = ctx.config, ctx.device
    n, bsz = int(c["num_examples"]), sgd_cfg.batch_size
    ds, first, rows_np = sgd_train.inputs(ctx)
    ctx.log(f"examples made: {n} x {ds.ids.shape[1]}; path {path}")
    w0, w, v, mlp_w, mlp_b, cin = _weights(ctx)
    start = DF.DeepFMParams(fm=FMParams(w0, w, v), mlp_w=mlp_w, mlp_b=mlp_b,
                            cin=cin)
    steps_per_epoch = -(-n // bsz)
    rows = torch.as_tensor(rows_np, dtype=torch.long, device=dev)

    probe = {"losses": [], "params": [], "slot1": None}
    epochs = {"timed": 0, "rate": 0}

    def hook(epoch, state, record):
        ctx.log(f"epoch {epoch}: train_loss {record['train_loss']:.6f}")
        if epoch == 0:
            ctx.begin_window()
            return
        epochs["timed"] += 1
        ctx.steps = epochs["timed"] * steps_per_epoch
        if ctx.in_window() >= ctx.seconds:
            if ctx.end_window():
                epochs["rate"] = epochs["timed"]
                return
            raise sgd_train._WindowClosed

    factory = DF.make_train_step
    DF.make_train_step = _probe(factory, rows, probe)
    try:
        DF.train_deepfm(cfg, sgd_cfg, ds, hooks=[hook], init_params=start,
                        device=dev)
        raise RuntimeError("train_deepfm returned before the window closed")
    except sgd_train._WindowClosed:
        pass
    finally:
        DF.make_train_step = factory
    timed = epochs["timed"]
    e2e = {"train_examples_per_s": timed * n / ctx.window_s}
    del w0, w, v, mlp_w, mlp_b, cin, start
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ctx.log(f"window: {timed} epochs, {ctx.window_s:.3f} s")
    work, notes = {}, {}
    if ctx.trace:
        work = _window_work(ctx, ds, epochs["rate"], bsz)
        notes["xdeepfm_cin"] = {"fields": ds.ids.shape[1],
                                "k": int(c["num_factors"]),
                                "widths": [int(h) for h in c["cin"]]}
        notes["deepfm_dense_flops"] = counts.dense_flops(
            bsz, ds.ids.shape[1], int(c["num_factors"]), c["hidden"],
            c["cin"])
    readings = deepfm_train.readings_of(
        deepfm_train.program_readings(probe),
        reference_run(ctx, ds, first, rows_np))
    ctx.log("reference done")
    return harness.Outcome(e2e=e2e, attempted=ctx.steps, failed=0,
                           readings=readings, work=work, notes=notes)


def stand_in(ctx, dtype=torch.float32, fault=None) -> dict:
    """The numbers compared when the reference, computed in ``dtype`` and
    with ``fault`` planted, is put in the program's place: the control and
    the faults of ``correct``'s limits. ``fault="tf32"`` runs the program
    itself with TF32 on for its matrix products (the CIN's and the
    tower's)."""
    if fault == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            return run(ctx).readings
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
    ds, first, rows_np = sgd_train.inputs(ctx)
    ref = reference_run(ctx, ds, first, rows_np)
    alt = reference_run(ctx, ds, first, rows_np, dtype=dtype, fault=fault)
    return deepfm_train.readings_of(alt, ref)


def _window_work(ctx, ds, timed: int, bsz: int) -> dict:
    """The counted work of the untraced window's steps (epochs
    1..timed), each batch's distinct ids found on the device."""
    c = ctx.config
    ids = torch.as_tensor(ds.ids, device=ctx.device)
    n, slots = ds.ids.shape
    seed = ctx.seed_for("order")
    flops = nbytes = 0.0
    for epoch in range(1, timed + 1):
        perm = torch.as_tensor(order.epoch_order(n, seed, epoch),
                               device=ctx.device)
        for s in range(0, n, bsz):
            u = torch.unique(ids.index_select(0, perm[s:s + bsz])).numel()
            wk = counts.step_work(min(bsz, n - s), slots, u,
                                  int(c["num_factors"]), c["hidden"],
                                  c["cin"])
            flops += wk["flops"]
            nbytes += wk["bytes"]
    return {"flops": flops, "bytes": nbytes}


def reference_run(ctx, ds, first, rows_np, dtype=torch.float64,
                  fault=None) -> dict:
    """The reference's first steps from the weights made again from the
    seed, on the rows the steps touch."""
    c, dev = ctx.config, ctx.device
    tr = c["training"]
    w0, w, v, mlp_w, mlp_b, cin = _weights(ctx)
    rows = torch.as_tensor(rows_np, dtype=torch.long, device=dev)
    w, v = w[rows], v[rows]
    n, bsz = int(c["num_examples"]), int(tr["batch_size"])
    batches = []
    for s, ids in enumerate(first):
        r = order.batch_rows(n, bsz, ctx.seed_for("order"), 0, s)
        batches.append({
            "idx": torch.as_tensor(np.searchsorted(rows_np, ids),
                                   device=dev),
            "vals": torch.as_tensor(ds.vals[r], device=dev),
            "y": torch.as_tensor(ds.y[r], device=dev), "step": s})
    if tr["optimizer"] != "adam" or tuple(tr["adam_betas"]) != ref_df.BETAS:
        raise ValueError("the xDeepFM reference trains with Adam at betas "
                         f"{ref_df.BETAS}")
    return ref_x.train_steps(
        w0, w, v, mlp_w, mlp_b, cin, batches, lr=tr["learning_rate"],
        reg_w=c["reg_w"], reg_v=c["reg_v"], reg_dense=c["reg_dense"],
        dtype=dtype, fault=fault)
