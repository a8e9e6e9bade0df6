"""The entry that runs ``train_sgd`` on a field-aware FM (Juan et al.
2016) at LIBFFM's Criteo settings, as ``sgd_train.py`` runs the plain FM
(its helpers are reused).

Set-up makes one epoch of Criteo-shape examples with instance-normalised
values (``gen/ffm.py``) and V ~ U(0, 1/sqrt(k)) from the seed on the
device, and calls ``train_sgd`` once with the mix's update path ("auto"
takes the fused path): its first epoch (the first dispatch builds the
kernels) is the warm-up, and its first three steps are recorded for the
check. The window opens at the end of that epoch, in the trainer's epoch
hook, and closes at the first epoch end ``--seconds`` later (a traced
run: an untraced window, then a traced one).

``train_examples_per_s`` is the examples of the window's epochs over its
wall time, which ends in a device sync. The check: the per-pair
reference (``reference/ffm.py``) follows the first three steps from the
same weights and batches in float64 and compares each step's loss, and
per leaf, V's block toward each of the 39 fields (``v.f00`` ...
``v.f38``: column block t of every touched row), the norm of step 1's
per-slot gradients as adagrad's slots hold them after step 1 and the
norm of the change after step 3 (read before step 4 runs), so a fault in
one field's block shows.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import harness
from portbench.counts import ffm_sgd
from portbench.entries import sgd_train
from portbench.gen import order
from portbench.gen import ffm as gen_ffm
from portbench.reference import ffm as ref_ffm
from portbench.reference import judge

CHECK_STEPS = sgd_train.CHECK_STEPS


def _shape(c: dict):
    """(fields, k, vk) of the configuration."""
    fields, k = int(c["num_fields"]), int(c["num_factors"])
    return fields, k, fields * k


def _model(ctx):
    """(FMConfig, SGDConfig) of the cell."""
    from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
    c = ctx.config
    tr = c["training"]
    fields, k, _ = _shape(c)
    cfg = FMConfig(num_features=int(c["num_buckets"]), num_factors=k,
                   num_fields=fields, slot_major_fields=True,
                   use_bias=bool(c["use_bias"]),
                   use_linear=bool(c["use_linear"]),
                   task=Task.CLASSIFICATION, seed=ctx.seed_for("order"),
                   reg0=c["reg0"], reg_w=c["reg_w"], reg_v=c["reg_v"])
    sgd_cfg = SGDConfig(batch_size=int(tr["batch_size"]),
                        optimizer=tr["optimizer"],
                        learning_rate=tr["learning_rate"],
                        adagrad_eps=tr["adagrad_eps"], epochs=1 << 30,
                        **ctx.traffic["sgd"])
    return cfg, sgd_cfg


def _weights(ctx):
    c = ctx.config
    fields, k, _ = _shape(c)
    return gen_ffm.ffm_weights(int(c["num_buckets"]), fields, k,
                               ctx.seed_for("weights"), ctx.device)


def inputs(ctx):
    """``sgd_train.inputs``'s epoch, first steps' ids and distinct ids,
    each example's values normalised (slot l holds field l)."""
    ds, first, rows_np = sgd_train.inputs(ctx)
    if ctx.config["instance_normalization"]:
        ds.vals = gen_ffm.normalized(ds.vals)
    return ds, first, rows_np


def run(ctx) -> harness.Outcome:
    from sparkfm_tpu_torch.models.fm import FMParams
    from sparkfm_tpu_torch.solvers import sgd as sgd_solver
    from sparkfm_tpu_torch.training import trainer

    ctx.log("entry started")
    cfg, sgd_cfg = _model(ctx)
    path = sgd_solver.resolve_update_path(cfg, sgd_cfg)
    c, dev = ctx.config, ctx.device
    n, bsz = int(c["num_examples"]), sgd_cfg.batch_size
    fields, k, _ = _shape(c)
    ds, first, rows_np = inputs(ctx)
    ctx.log(f"examples made: {n} x {ds.ids.shape[1]}; path {path}")
    w0, w, v = _weights(ctx)
    steps_per_epoch = -(-n // bsz)
    rows = torch.as_tensor(rows_np, dtype=torch.long, device=dev)

    probe = {"losses": [], "states": []}
    epochs = {"timed": 0, "rate": 0}

    def hook(epoch, state, record):
        ctx.log(f"epoch {epoch}: train_loss {record['train_loss']:.6f} "
                f"overflow steps {record.get('unique_overflow_steps', 0)}")
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

    module, attr = sgd_train._factories(path)
    factory = getattr(module, attr)
    setattr(module, attr, sgd_train._probe(factory, rows, probe))
    try:
        trainer.train_sgd(cfg, sgd_cfg, ds, hooks=[hook],
                          init_params=FMParams(w0, w, v), device=dev)
        raise RuntimeError("train_sgd returned before the window closed")
    except sgd_train._WindowClosed:
        pass
    finally:
        setattr(module, attr, factory)
    timed = epochs["timed"]
    e2e = {"train_examples_per_s": timed * n / ctx.window_s}
    del w0, w, v
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ctx.log(f"window: {timed} epochs, {ctx.window_s:.3f} s")
    work, notes = {}, {}
    if ctx.trace:
        work = _window_work(ctx, ds, epochs["rate"], bsz)
        notes.update(ffm_fields=fields, ffm_k=k)
    readings = readings_of(program_readings(ctx, probe),
                           reference_run(ctx, ds, first, rows_np), fields)
    ctx.log("reference done")
    return harness.Outcome(e2e=e2e, attempted=ctx.steps, failed=0,
                           readings=readings, work=work, notes=notes)


def stand_in(ctx, dtype=torch.float32, fault=None) -> dict:
    """The numbers compared when the reference, computed in ``dtype`` and
    with ``fault`` planted ("half", "stale", "shared"), is put in the
    program's place: the control and the faults of ``correct``'s
    limits."""
    ds, first, rows_np = inputs(ctx)
    ref = reference_run(ctx, ds, first, rows_np)
    alt = reference_run(ctx, ds, first, rows_np, dtype=dtype, fault=fault)
    return readings_of(alt, ref, _shape(ctx.config)[0])


def _window_work(ctx, ds, timed: int, bsz: int) -> dict:
    """The counted work of the untraced window's steps (epochs
    1..timed), each batch's distinct ids found on the device."""
    fields, k, _ = _shape(ctx.config)
    ids = torch.as_tensor(ds.ids, device=ctx.device)
    n = ds.ids.shape[0]
    seed = ctx.seed_for("order")
    flops = nbytes = 0.0
    for epoch in range(1, timed + 1):
        perm = torch.as_tensor(order.epoch_order(n, seed, epoch),
                               device=ctx.device)
        for s in range(0, n, bsz):
            u = torch.unique(ids.index_select(0, perm[s:s + bsz])).numel()
            wk = ffm_sgd.step_work(min(bsz, n - s), fields, u, k)
            flops += wk["flops"]
            nbytes += wk["bytes"]
    return {"flops": flops, "bytes": nbytes}


def reference_run(ctx, ds, first, rows_np, dtype=torch.float64,
                  fault=None) -> dict:
    """The reference's first steps from the weights made again from the
    seed, on the rows the steps touch."""
    c, dev = ctx.config, ctx.device
    tr = c["training"]
    fields, _, _ = _shape(c)
    _, _, v = _weights(ctx)
    rows = torch.as_tensor(rows_np, dtype=torch.long, device=dev)
    init = v[rows].double()
    del v
    n, bsz = int(c["num_examples"]), int(tr["batch_size"])
    batches = []
    for s, ids in enumerate(first):
        r = order.batch_rows(n, bsz, ctx.seed_for("order"), 0, s)
        idx = torch.as_tensor(np.searchsorted(rows_np, ids), device=dev)
        batches.append({
            "idx": idx, "vals": torch.as_tensor(ds.vals[r], device=dev),
            "y": torch.as_tensor(ds.y[r], device=dev),
            "field_ids": torch.arange(ids.shape[1], device=dev).expand(
                ids.shape[0], -1)})
    out = ref_ffm.sgd_steps(init, batches, fields=fields,
                            lr=tr["learning_rate"], eps=tr["adagrad_eps"],
                            reg_v=c["reg_v"], dtype=dtype, fault=fault)
    out["init"] = init
    return out


def _blocks(t: torch.Tensor, fields: int) -> dict:
    """The leaves of (R, fields * k) ``t``: its column block toward each
    field."""
    k = t.shape[1] // fields
    return {f"v.f{f:02d}": t[:, f * k:(f + 1) * k] for f in range(fields)}


def readings_of(prog: dict, ref: dict, fields: int) -> dict:
    """The numbers compared: ``loss.step<i>``, ``grad1.worst_leaf`` and
    ``change3.worst_leaf`` over V's ``fields`` blocks, from the program's
    (or a stand-in's) losses, slots after step 1 and V after step 3,
    against the float64 reference's."""
    out = {}
    for i, (lp, lr_) in enumerate(zip(prog["losses"], ref["losses"])):
        out[f"loss.step{i + 1}"] = judge.rel_gap(lp, lr_)

    def norms(d):
        return {name: float(t.double().sum().sqrt()) for name, t in
                _blocks(d, fields).items()}
    g_ref = norms(ref["slot1"])
    leaves = judge.counted_leaves(g_ref)
    out["grad1.worst_leaf"] = judge.worst_leaf(norms(prog["slot1"]), g_ref,
                                               leaves)
    out["leaves_counted"] = float(len(leaves))      # not limited
    init = ref["init"]

    def change(p):
        return {name: float(t.norm()) for name, t in
                _blocks(p.double() - init, fields).items()}
    out["change3.worst_leaf"] = judge.worst_leaf(
        change(prog["params"][CHECK_STEPS - 1]),
        change(ref["params"][CHECK_STEPS - 1]), leaves)
    return out


def program_readings(ctx, probe: dict) -> dict:
    """The program's losses, V's slots after step 1 and V after each
    probed step, from the probed record rows ``[v | slot_v | w |
    slot_w]``."""
    if len(probe["states"]) < CHECK_STEPS:
        raise RuntimeError("the probe saw fewer than three steps: the "
                           "trainer did not run the probed step factory")
    _, _, vk = _shape(ctx.config)
    return {"losses": [float(x) for x in probe["losses"]],
            "slot1": probe["states"][0][0][:, vk:2 * vk],
            "params": [table[:, :vk] for table, _, _ in probe["states"]]}
