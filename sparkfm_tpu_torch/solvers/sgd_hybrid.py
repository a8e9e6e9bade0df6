"""Hybrid SGD step: natural-order forward, id-sorted analytic backward.

Port of ``sparkfm_tpu/solvers/sgd_hybrid.py::make_hybrid_train_step``.
The FM gradient has a closed form in per-example quantities,

    dL/dv[b,l,f] = ds_b * x_bl * (s_bf - v[b,l,f] * x_bl)
    dL/dw[b,l]   = ds_b * x_bl          (+ per-appearance L2 terms)

so after the forward has the per-example factor sums s (B, K) and loss
derivatives ds (B,), the backward evaluates it directly in id-sorted slot
order and sums each id's run: no autograd, no per-slot gradient in
natural order, no scatter-add. One step is:

1. one gather of the batch's unique fused records (kernel B1,
   ``ops/rowio.py::gather_rows``);
2. the forward in natural slot order, as torch ops;
3. the backward: the example pack ``[s | ds | wt]`` gathered into sorted
   slot order, then the per-run gradient sums (kernel B3,
   ``ops/segsum.py::fm_grad_segsum_factored``);
4. the adagrad / adagrad_row / sgd update of the unique records, as torch
   ops (``sgd_fused.update_records``);
5. one write-back of the updated records (kernel B2,
   ``ops/rowio.py::scatter_set_rows``), IN PLACE on ``state.table``: the
   JAX step donates the table and returns a new one, the port overwrites
   the rows of the table it was given;
6. the bias update.

The step looks the three kernels up through their modules at each call
(``rowio.gather_rows``, ``segsum.fm_grad_segsum_factored``,
``rowio.scatter_set_rows``).

It needs a host plan carrying ``order/seg/svals/sex``
(``data/batching.py::batch_iterator`` with ``dedup_budget`` emits it),
whose fill id is ``num_features``: the table's extra last row.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.data.batching import SparseBatch
from sparkfm_tpu_torch.ops import rowio, segsum
from sparkfm_tpu_torch.solvers import sgd as sgd_solver
from sparkfm_tpu_torch.solvers import sgd_fused
from sparkfm_tpu_torch.solvers.sgd_fused import FusedState


def make_hybrid_train_step(cfg: FMConfig, sgd_cfg: SGDConfig):
    """(FusedState, SparseBatch) -> (FusedState, aux), with aux holding
    ``loss`` and ``scores`` (tensors on the device) and the plan's
    ``unique_count`` and ``unique_overflow`` (host numbers). The returned
    state holds the same table tensor, updated in place."""
    if cfg.num_fields > 0:
        raise ValueError("hybrid path supports plain FM (use dedup for FFM)")
    if sgd_cfg.optimizer not in ("adagrad", "adagrad_row", "sgd"):
        raise ValueError("hybrid path supports adagrad/adagrad_row/sgd")
    if sgd_cfg.momentum > 0:
        raise ValueError("hybrid path: momentum not supported")
    if getattr(torch, cfg.compute_dtype, None) != torch.float32:
        raise ValueError("hybrid path computes in float32")
    if cfg.feature_groups is not None:
        raise ValueError("hybrid path does not support attribute-group "
                         "regularization yet; use update_path='fused' or "
                         "'dedup' (their loss gathers per-group lambdas)")
    if not sgd_cfg.host_plan:
        raise ValueError("update_path='hybrid' requires host_plan=True "
                         "(the sorted backward consumes plan.svals/sex)")
    sgd_solver.check_grouping("hybrid", sgd_cfg)
    k = cfg.num_factors
    classification = cfg.task == Task.CLASSIFICATION
    lr = sgd_cfg.learning_rate

    def train_step(state: FusedState, batch: SparseBatch):
        plan = batch.plan
        if plan is None or plan.svals is None or plan.sex is None:
            raise ValueError(
                "hybrid step requires a host dedup plan with svals/sex "
                "(batch_iterator(..., dedup_budget=...) emits it)")
        budget = plan.uids.shape[0]
        valid = min(int(plan.count), budget)

        # ---- one big-table gather for the whole working set
        rec_u = rowio.gather_rows(state.table, plan.uids)       # (U, W)
        rec_u[valid:] = 0.0                                     # fill slots
        vw_u = torch.cat([rec_u[:, :k], rec_u[:, 2 * k:2 * k + 1]],
                         dim=1)                                 # (U, k+1)

        # ---- natural-order forward
        vals = batch.vals
        vw_rows = vw_u.index_select(0, plan.ranks.reshape(-1)).view(
            *plan.ranks.shape, k + 1)                           # (B, L, k+1)
        vx = vw_rows[..., :k] * vals[..., None]                 # (B, L, k)
        s = vx.sum(dim=1)                                       # (B, k)
        ssq = vx.square().sum(dim=(1, 2))                       # (B,)
        score = 0.5 * (s.square().sum(dim=-1) - ssq)
        if cfg.use_linear:
            score = score + (vw_rows[..., k] * vals).sum(dim=-1)
        if cfg.use_bias:
            score = score + state.w0

        wt = (batch.mask.to(torch.float32) if batch.mask is not None
              else torch.ones_like(batch.y))
        # data term sums over max(Σwt, 1e-12); the per-appearance L2
        # normaliser is max(Σwt, 1)
        denom_data = wt.sum().clamp(min=1e-12)
        denom_reg = wt.sum().clamp(min=1.0)
        if classification:
            y_pm = torch.where(batch.y > 0, 1.0, -1.0)
            z = -y_pm * score
            data_loss = (F.softplus(z) * wt).sum() / denom_data
            ds = -y_pm * torch.sigmoid(z) * wt / denom_data    # (B,)
        else:
            err = score - batch.y
            data_loss = (err.square() * wt).sum() / denom_data
            ds = 2.0 * err * wt / denom_data

        # ---- id-sorted analytic backward
        ex_pack = torch.cat([s, ds[:, None], wt[:, None]], dim=1)  # (B, k+2)
        ex_srt = ex_pack.index_select(0, plan.sex)                # (N, k+2)
        acc = segsum.fm_grad_segsum_factored(
            vw_u, ex_srt, plan.svals, plan.seg, budget,
            2.0 * cfg.reg_v / denom_reg, 2.0 * cfg.reg_w / denom_reg)
        if not cfg.use_linear:
            acc[:, [k, 2 * k + 1]] = 0.0                # Σg_w, Σg_w²

        # ---- update and write-back, in the fused step's layout
        if sgd_cfg.optimizer == "adagrad_row":
            acc = torch.cat([acc[:, :k],
                             acc[:, k + 1:2 * k + 1].mean(-1, keepdim=True),
                             acc[:, k:k + 1], acc[:, 2 * k + 1:]], dim=1)
        rec_new = sgd_fused.update_records(sgd_cfg.optimizer, sgd_cfg, rec_u,
                                           acc, k)
        rowio.scatter_set_rows(state.table, plan.uids, rec_new)

        if cfg.use_bias:
            g_w0 = ds.sum() + 2.0 * cfg.reg0 * state.w0
            w0, slot_w0, _ = sgd_solver._dense_scalar_update(
                sgd_cfg.optimizer, lr, sgd_cfg, state.w0, state.slot_w0,
                None, g_w0, state.step)
        else:
            w0, slot_w0 = state.w0, state.slot_w0

        new_state = dataclasses.replace(state, w0=w0, slot_w0=slot_w0,
                                        step=state.step + 1)
        return new_state, {"loss": data_loss, "scores": score,
                           "unique_count": plan.count,
                           "unique_overflow": plan.overflow}

    return train_step
