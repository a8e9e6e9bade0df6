"""Sorted-slot SGD: the fused-record step restructured around sorted runs.

Port of ``sparkfm_tpu/solvers/sgd_sorted.py::make_sorted_train_step``.
One stable sort of the batch's ids on the device carries each slot's
value and example index (``ops/embedding.py::sorted_plan``); the slots
stay in id-sorted order from then on. One step is:

1. the sorted plan, built on the device (no host plan, no host round
   trip);
2. one gather of the unique fused records (kernel B1,
   ``ops/rowio.py::gather_rows``), then the monotone expand of ``[v | w]``
   to the sorted slots by ``seg``;
3. the slot terms ``[v·x (k) | Σ_k v²x² | w·x]`` summed into the small
   (B, k+2) example space in a fixed order: written back to natural slot
   order by the plan's permutation (every slot once, so no atomics) and
   summed over each example's L slots, where the JAX package sums by
   example index; then ``torch.autograd.grad`` of the per-example loss
   with respect to those sums and the bias;
4. the slot-space backward written out by hand (bilinear terms plus the
   per-appearance L2), packed as ``[g_v | g_v² | g_w | g_w²]`` (N, 2k+2)
   and summed over runs by kernel B5 (``ops/segsum.py::segment_rowsum``);
5. the adagrad / sgd update of ``solvers/sgd_fused.py`` and one
   write-back (kernel B2, ``ops/rowio.py::scatter_set_rows``), IN PLACE
   on ``state.table``;
6. the bias update.

Same table layout and update semantics as the fused step; the kernels are
looked up through their modules at each call.
"""

from __future__ import annotations

import dataclasses

import torch

from sparkfm_tpu_torch.config import FMConfig, SGDConfig
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.ops import losses as L
from sparkfm_tpu_torch.ops import segsum
from sparkfm_tpu_torch.solvers import sgd as sgd_solver
from sparkfm_tpu_torch.solvers import sgd_fused
from sparkfm_tpu_torch.solvers.sgd_fused import FusedState


def make_sorted_train_step(cfg: FMConfig, sgd_cfg: SGDConfig,
                           kernel_mode: str = "auto"):
    """(FusedState, SparseBatch) -> (FusedState, aux), with aux holding
    ``loss``, ``scores`` and the plan's ``unique_count`` and
    ``unique_overflow`` (tensors on the device). The returned state holds
    the same table tensor, updated in place.

    ``kernel_mode`` is the JAX signature's; here the kernels run for CUDA
    tensors and their plain versions for CPU tensors, whatever it says.
    """
    del kernel_mode
    if cfg.num_fields > 0:
        raise ValueError("sorted path supports plain FM")
    if sgd_cfg.optimizer not in ("adagrad", "sgd"):
        raise ValueError("sorted path supports adagrad/sgd")
    if sgd_cfg.momentum > 0 and sgd_cfg.optimizer == "sgd":
        raise ValueError("sorted path: momentum not supported")
    sgd_solver.check_supported(sgd_cfg)
    k = cfg.num_factors
    loss_fn = L.loss_for_task(cfg.task)

    def train_step(state: FusedState, batch):
        b, l = batch.ids.shape
        budget = sgd_cfg.unique_budget or E.auto_budget(batch.ids.numel())
        with torch.no_grad():
            plan = E.sorted_plan(batch.ids, batch.vals, budget,
                                 fill=state.table.shape[0] - 1)
            x = plan.svals                              # (N,) sorted vals
            ex = plan.sex.long()                        # (N,) example index
            rec_u = E.gather_unique(state.table, plan)  # (U, W)
            vw_u = torch.cat([rec_u[:, :k], rec_u[:, 2 * k:2 * k + 1]], 1)
            vw_s = vw_u.index_select(0, plan.seg.long())  # (N, k+1)
            v_s, w_s = vw_s[:, :k], vw_s[:, k]
            c = v_s * x[:, None]                        # (N, k) v·x
            slot_feats = torch.cat([c, c.square().sum(1, keepdim=True),
                                    (w_s * x)[:, None]], dim=1)
            agg = torch.empty_like(slot_feats).index_copy_(
                0, plan.order.long(), slot_feats).view(b, l, k + 2).sum(1)
            weights = (None if batch.mask is None
                       else batch.mask.to(torch.float32))
            denom = (weights.sum().clamp(min=1.0) if weights is not None
                     else max(float(b), 1.0))

        agg = agg.requires_grad_()
        w0 = state.w0.detach().requires_grad_()
        with torch.enable_grad():
            s = 0.5 * (agg[:, :k].square().sum(1) - agg[:, k])
            if cfg.use_linear:
                s = s + agg[:, k + 1]
            if cfg.use_bias:
                s = s + w0
            data_loss = loss_fn(s, batch.y, weights)
            total = data_loss + cfg.reg0 * w0.square()
            g_agg, g_w0 = torch.autograd.grad(total, (agg, w0))

        with torch.no_grad():
            # slot-space backward: dv = gS·x + gQ·2·v·x² + 2·reg_v·v·a/denom,
            # dw = gLin·x + 2·reg_w·w·a/denom, a = [x != 0]·mask
            g_slot = g_agg.index_select(0, ex)          # (N, k+2)
            active = (x != 0).to(torch.float32)
            if weights is not None:
                active = active * weights.index_select(0, ex)
            g_v = (g_slot[:, :k] * x[:, None]
                   + g_slot[:, k:k + 1] * 2.0 * v_s * x.square()[:, None]
                   + (2.0 * cfg.reg_v / denom) * v_s * active[:, None])
            g_w = (g_slot[:, k + 1] * x
                   + (2.0 * cfg.reg_w / denom) * w_s * active)
            packed = torch.cat([g_v, g_v.square(), g_w[:, None],
                                g_w.square()[:, None]], dim=1)  # (N, 2k+2)
            acc = segsum.segment_rowsum(packed, plan.seg, budget)
            E.scatter_set_unique(state.table, plan, sgd_fused.update_records(
                sgd_cfg.optimizer, sgd_cfg, rec_u, acc, k))
            if cfg.use_bias:
                # total carries reg0·w0², so g_w0 has the regularizer
                w0_new, slot_w0, _ = sgd_solver._dense_scalar_update(
                    sgd_cfg.optimizer, sgd_cfg.learning_rate, sgd_cfg,
                    state.w0, state.slot_w0, None, g_w0, state.step)
            else:
                w0_new, slot_w0 = state.w0, state.slot_w0

        new_state = dataclasses.replace(state, w0=w0_new, slot_w0=slot_w0,
                                        step=state.step + 1)
        return new_state, {"loss": data_loss.detach(), "scores": s.detach(),
                           "unique_count": plan.count,
                           "unique_overflow": plan.overflow}

    return train_step
