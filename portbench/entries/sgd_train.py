"""Driver of ``train_sgd``, the port's SGD trainer, on Criteo-shape data.

Set-up makes one epoch of examples and the initial weights from the seed
on the device, and calls ``train_sgd`` once, with the mix's update path:
its first epoch (the first dispatch builds the kernels) is the warm-up,
and its first three steps are recorded for the check. The window opens at
the end of that epoch, in the trainer's epoch hook, and closes at the
first epoch end ``--seconds`` later (a traced run: an untraced window,
then a traced one); the trainer's own prefetch thread builds the batches
and their plans inside it. So the one trainer, state
and step object that set-up drove are the ones timed.

``train_examples_per_s`` is the examples of the window's epochs over its
wall time, which ends in a device sync. The check: the reference follows
the first three steps from the same weights and batches, in float64, and
compares each step's loss, per leaf the norm of step 1's per-slot
gradients as adagrad's slots hold them after step 1, and the norm of the
parameters' change after step 3 (read before step 4 runs).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import harness
from portbench.counts import fm_sgd
from portbench.gen import ctr, order, weights
from portbench.reference import fm as ref_fm
from portbench.reference import judge

CHECK_STEPS = 3
LEAVES = ("w0", "w", "v")


class _WindowClosed(Exception):
    pass


def _factories(path: str):
    from sparkfm_tpu_torch.solvers import sgd_fused, sgd_hybrid, sgd_sorted
    return {"hybrid": (sgd_hybrid, "make_hybrid_train_step"),
            "fused": (sgd_fused, "make_fused_train_step"),
            "sorted": (sgd_sorted, "make_sorted_train_step")}[path]


def _probe(factory, rows: torch.Tensor, probe: dict):
    """``factory`` with its steps wrapped: after each of the first
    CHECK_STEPS steps, the loss and the touched rows of the record table
    (and the bias and its slot) are copied on the device."""
    def make(cfg, sgd_cfg):
        step = factory(cfg, sgd_cfg)

        def wrapped(state, batch):
            state, aux = step(state, batch)
            if len(probe["losses"]) < CHECK_STEPS:
                probe["losses"].append(aux["loss"].detach().double().clone())
                probe["states"].append(
                    (state.table.index_select(0, rows).clone(),
                     state.w0.detach().clone(),
                     state.slot_w0.detach().clone()))
            return state, aux
        return wrapped
    return make


def run(ctx) -> harness.Outcome:
    from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
    from sparkfm_tpu_torch.models.fm import FMParams
    from sparkfm_tpu_torch.solvers import sgd as sgd_solver
    from sparkfm_tpu_torch.training import trainer

    c, dev = ctx.config, ctx.device
    ctx.log("entry started")
    tr = c["training"]
    n, bsz, k = int(c["num_examples"]), int(tr["batch_size"]), int(
        c["num_factors"])
    nf = int(c["num_buckets"])
    order_seed = ctx.seed_for("order")
    ds, first, rows_np = inputs(ctx)
    ctx.log(f"examples made: {n} x {ds.ids.shape[1]}")
    w0, w, v = weights.fm_weights(nf, k, ctx.seed_for("weights"), dev,
                                  v_stdev=c["init_stdev"])
    cfg = FMConfig(num_features=nf, num_factors=k,
                   task=Task.CLASSIFICATION, init_stdev=c["init_stdev"],
                   seed=order_seed, reg0=c["reg0"], reg_w=c["reg_w"],
                   reg_v=c["reg_v"])
    sgd_cfg = SGDConfig(batch_size=bsz, optimizer=tr["optimizer"],
                        learning_rate=tr["learning_rate"],
                        adagrad_eps=tr["adagrad_eps"], epochs=1 << 30,
                        **ctx.traffic["sgd"])
    path = sgd_solver.resolve_update_path(cfg, sgd_cfg)
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
            raise _WindowClosed

    module, attr = _factories(path)
    factory = getattr(module, attr)
    setattr(module, attr, _probe(factory, rows, probe))
    try:
        trainer.train_sgd(cfg, sgd_cfg, ds, hooks=[hook],
                          init_params=FMParams(w0, w, v), device=dev)
        raise RuntimeError("train_sgd returned before the window closed")
    except _WindowClosed:
        pass
    finally:
        setattr(module, attr, factory)
    timed = epochs["timed"]
    e2e = {"train_examples_per_s": timed * n / ctx.window_s}
    del w0, w, v
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ctx.log(f"window: {timed} epochs, {ctx.window_s:.3f} s")
    work = (_window_work(ctx, ds, order_seed, epochs["rate"], bsz, k)
            if ctx.trace else {})
    readings = readings_of(program_readings(ctx, probe),
                           reference_run(ctx, ds, first, rows_np))
    ctx.log("reference done")
    return harness.Outcome(e2e=e2e, attempted=ctx.steps, failed=0,
                           readings=readings, work=work)


def inputs(ctx):
    """The epoch of examples as a host dataset, the first steps' examples'
    ids and the sorted distinct ids they touch (found as the reference
    finds them, from the frozen batch order)."""
    from sparkfm_tpu_torch.data.batching import SparseDataset
    c = ctx.config
    n, bsz = int(c["num_examples"]), int(c["training"]["batch_size"])
    ids, vals, y = ctr.examples(c, n, ctx.seed_for("data"), ctx.device)
    ds = SparseDataset(ids=ids.cpu().numpy(), vals=vals.cpu().numpy(),
                       y=y.cpu().numpy(), num_features=int(c["num_buckets"]))
    first = [ds.ids[order.batch_rows(n, bsz, ctx.seed_for("order"), 0, s)]
             for s in range(CHECK_STEPS)]
    rows_np = np.unique(np.concatenate([f.reshape(-1) for f in first]))
    return ds, first, rows_np


def stand_in(ctx, dtype=torch.float32, fault=None) -> dict:
    """The numbers compared when the reference, computed in ``dtype`` and
    with ``fault`` planted, is put in the program's place: the control and
    the faults of ``correct``'s limits."""
    ds, first, rows_np = inputs(ctx)
    ref = reference_run(ctx, ds, first, rows_np)
    alt = reference_run(ctx, ds, first, rows_np, dtype=dtype, fault=fault)
    return readings_of(alt, ref)


def _window_work(ctx, ds, order_seed: int, timed: int, bsz: int,
                 k: int) -> dict:
    """The counted work of the untraced window's steps (epochs
    1..timed), each batch's distinct ids found on the device."""
    ids = torch.as_tensor(ds.ids, device=ctx.device)
    n, slots = ds.ids.shape
    flops = nbytes = 0.0
    for epoch in range(1, timed + 1):
        perm = torch.as_tensor(order.epoch_order(n, order_seed, epoch),
                               device=ctx.device)
        for s in range(0, n, bsz):
            u = torch.unique(ids.index_select(0, perm[s:s + bsz])).numel()
            wk = fm_sgd.step_work(min(bsz, n - s), slots, u, k)
            flops += wk["flops"]
            nbytes += wk["bytes"]
    return {"flops": flops, "bytes": nbytes}


def reference_run(ctx, ds, first, rows_np, dtype=torch.float64,
                  fault=None) -> dict:
    """The reference's first steps from the weights made again from the
    seed, on the rows the steps touch."""
    c, dev = ctx.config, ctx.device
    tr = c["training"]
    w0, w, v = weights.fm_weights(int(c["num_buckets"]),
                                  int(c["num_factors"]),
                                  ctx.seed_for("weights"), dev,
                                  v_stdev=c["init_stdev"])
    rows = torch.as_tensor(rows_np, dtype=torch.long, device=dev)
    init = {"w0": w0.double(), "w": w[rows].double(), "v": v[rows].double()}
    del w, v
    n, bsz = int(c["num_examples"]), int(tr["batch_size"])
    batches = []
    for s, ids in enumerate(first):
        r = order.batch_rows(n, bsz, ctx.seed_for("order"), 0, s)
        batches.append({
            "idx": torch.as_tensor(np.searchsorted(rows_np, ids),
                                   device=dev),
            "vals": torch.as_tensor(ds.vals[r], device=dev),
            "y": torch.as_tensor(ds.y[r], device=dev)})
    out = ref_fm.sgd_steps(init["w0"], init["w"], init["v"], batches,
                           lr=tr["learning_rate"], eps=tr["adagrad_eps"],
                           reg0=c["reg0"], reg_w=c["reg_w"], reg_v=c["reg_v"],
                           dtype=dtype, fault=fault)
    out["init"] = init
    return out


def readings_of(prog: dict, ref: dict) -> dict:
    """The numbers compared: ``loss.step<i>``, ``grad1.worst_leaf`` and
    ``change3.worst_leaf``, from the program's (or a stand-in's) losses,
    slots after step 1 and parameters after step 3, against the float64
    reference's."""
    out = {}
    for i, (lp, lr_) in enumerate(zip(prog["losses"], ref["losses"])):
        out[f"loss.step{i + 1}"] = judge.rel_gap(lp, lr_)
    g_ref = {k: float(t.double().sum().sqrt()) for k, t in
             ref["slot1"].items()}
    g_prog = {k: float(t.double().sum().sqrt()) for k, t in
              prog["slot1"].items()}
    leaves = judge.counted_leaves(g_ref)
    out["grad1.worst_leaf"] = judge.worst_leaf(g_prog, g_ref, leaves)
    out["leaves_counted"] = float(len(leaves))      # not limited
    init = ref["init"]

    def change(p):
        return {k: float((p[k].double() - init[k]).norm()) for k in LEAVES}
    out["change3.worst_leaf"] = judge.worst_leaf(
        change(prog["params"][CHECK_STEPS - 1]),
        change(ref["params"][CHECK_STEPS - 1]), leaves)
    return out


def program_readings(ctx, probe: dict) -> dict:
    """The program's losses, slots after step 1 and parameters after
    step 3 from the probed record rows ``[v | slot_v | w | slot_w]``."""
    if len(probe["states"]) < CHECK_STEPS:
        raise RuntimeError("the probe saw fewer than three steps: the "
                           "trainer did not run the probed step factory")
    k = int(ctx.config["num_factors"])

    def params(st):
        table, w0, _ = st
        return {"w0": w0, "w": table[:, 2 * k], "v": table[:, :k]}
    table1, _, slot_w01 = probe["states"][0]
    return {"losses": [float(x) for x in probe["losses"]],
            "slot1": {"w0": slot_w01, "w": table1[:, 2 * k + 1],
                      "v": table1[:, k:2 * k]},
            "params": [params(s) for s in probe["states"]]}

