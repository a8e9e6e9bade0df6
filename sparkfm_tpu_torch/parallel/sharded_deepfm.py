"""Sharded DeepFM: row-sharded FM/embedding tables and a data-parallel
tower. Port of ``sparkfm_tpu/parallel/sharded_deepfm.py`` onto
``torch.distributed``.

- The shared (F, K) tables split their rows over ``model`` and move
  through the sharded SGD's unique-row machinery
  (``parallel/sharded_sgd.py``): one ``psum`` over ``model`` of the masked
  unique rows forward, the per-unique ``[Σg | Σg²]`` exchanged backward
  (one ``psum`` over ``data`` with a global host plan, an ``all_gather``
  with per-shard plans), and the owner's adding update.
- The tower is replicated: each rank runs it on its rows of the batch and
  the tower and bias gradients are summed over ``data`` (they already
  agree over ``model``, whose ranks see the same rows).
- The loss normalizer is the global count of valid examples, so uneven
  tail shards give the one-device objective.

Tables update by adagrad or plain sgd, the optimizers whose updates split
into per-shard sums; anything else is refused, as is tower dropout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sparkfm_tpu_torch.config import SGDConfig, Task
from sparkfm_tpu_torch.models import deepfm as DF
from sparkfm_tpu_torch.models.deepfm import (DeepFMConfig, DeepFMParams,
                                             DeepFMState)
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.parallel import mesh as M
from sparkfm_tpu_torch.parallel import sharded_sgd as S
from sparkfm_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from sparkfm_tpu_torch.solvers import sgd as sgd_solver
from sparkfm_tpu_torch.solvers.sgd_fused import valid_slots


def padded_config(cfg: DeepFMConfig, model_size: int) -> DeepFMConfig:
    """The tables padded as ``sharded_sgd.padded_config`` pads them."""
    return dataclasses.replace(cfg, fm=S.padded_config(cfg.fm, model_size))


def _shard(full: DeepFMState, mesh) -> DeepFMState:
    return DeepFMState(fm=S._shard_state(full.fm, mesh),
                       mlp_w=full.mlp_w, mlp_b=full.mlp_b, smw=full.smw,
                       smb=full.smb)


def init_sharded_state(cfg: DeepFMConfig, mesh,
                       generator: Optional[torch.Generator] = None) -> tuple:
    """(this rank's DeepFMState, padded config): the whole padded init
    drawn on every rank alike from ``generator`` (default: seeded from
    ``cfg.fm.seed``), the rank keeping its table rows and the tower."""
    pcfg = padded_config(cfg, M.size(mesh, MODEL_AXIS))
    params = DF.init_params(pcfg, generator, device=M.device_of(mesh))
    return _shard(DF.init_state(params), mesh), pcfg


def sharded_state_from_numpy(w0, w, v, slot_w0, slot_w, slot_v, mlp_w,
                             mlp_b, smw, smb, mesh) -> DeepFMState:
    """This rank's shard of a JAX sharded DeepFM state (its padded
    ``params`` and ``slots``), given as whole numpy arrays."""
    dev = M.device_of(mesh)
    fm = sgd_solver.state_from_numpy(w0, w, v, slot_w0, slot_w, slot_v,
                                     np.float32(0), np.float32(0),
                                     np.float32(0), 0, device=dev)

    def t(xs):
        return tuple(torch.as_tensor(np.array(x, np.float32, copy=True),
                                     device=dev) for x in xs)
    return _shard(DeepFMState(fm=fm, mlp_w=t(mlp_w), mlp_b=t(mlp_b),
                              smw=t(smw), smb=t(smb)), mesh)


def make_sharded_train_step(cfg: DeepFMConfig, sgd_cfg: SGDConfig, mesh):
    """``step(state, batch) -> (state, aux)`` on this rank's shard
    (``cfg.fm.num_features`` padded, :func:`init_sharded_state`). The
    batch's plan picks the exchange: a global host plan (uids (U_g,)) the
    one psum, the rank's row of stacked plans (uids (1, U)) the
    all_gather, no plan the all_gather of plans built on the device. aux:
    ``loss``, ``unique_count``, ``unique_overflow``. Every tensor of the
    state is updated in place."""
    if sgd_cfg.optimizer not in ("adagrad", "sgd") or sgd_cfg.momentum > 0:
        raise ValueError(
            f"sharded deepfm supports optimizer='adagrad' or plain 'sgd' "
            f"(got {sgd_cfg.optimizer!r}, momentum={sgd_cfg.momentum}); "
            "the unique-row exchange needs per-row-decomposable updates")
    if cfg.dropout > 0:
        raise ValueError("sharded deepfm has no tower dropout; train with "
                         "dropout=0 or on one device")
    if cfg.cin or cfg.reg_dense > 0:
        raise ValueError("sharded deepfm has no Compressed Interaction "
                         "Network and no dense L2: train xDeepFM (cin="
                         f"{tuple(cfg.cin)}, reg_dense={cfg.reg_dense}) on "
                         "one device")
    fm_cfg = cfg.fm
    k = fm_cfg.num_factors
    fill = fm_cfg.num_features - 1
    opt, lr = sgd_cfg.optimizer, sgd_cfg.learning_rate

    def step(state: DeepFMState, batch):
        fm = state.fm
        p = fm.params
        dev = p.v.device
        ids = batch.ids
        plan = batch.plan
        local_plan = None
        if plan is None:
            budget = sgd_cfg.unique_budget or E.auto_budget(ids.numel())
            local_plan = E.dedup_ids(ids, budget, fill=fill)
            uids, ranks = local_plan.uids, local_plan.ranks
            count, overflow = local_plan.count, local_plan.overflow
        elif plan.uids.dim() == 2:
            uids, ranks = plan.uids[0], plan.ranks
            count = torch.as_tensor(plan.count, device=dev).reshape(())
            overflow = torch.as_tensor(plan.overflow, device=dev).reshape(())
        else:
            uids, ranks = plan.uids, plan.ranks
            count, overflow = plan.count, plan.overflow
        global_plan = plan is not None and plan.uids.dim() == 1
        budget = uids.shape[0]
        valid = valid_slots(count, budget, dev)
        vw_u = torch.where(valid[:, None], S.gather_vw(p.v, p.w, uids, mesh),
                           0.0)
        vw_rows = vw_u.index_select(0, ranks.reshape(-1).long()).view(
            *ids.shape, k + 1)
        total = S._global_count(batch, mesh)

        w0 = p.w0.detach().requires_grad_()
        w_rows = vw_rows[..., k].detach().requires_grad_()
        v_rows = vw_rows[..., :k].detach().requires_grad_()
        mlp_w = [x.detach().requires_grad_() for x in state.mlp_w]
        mlp_b = [x.detach().requires_grad_() for x in state.mlp_b]
        with torch.enable_grad():
            s = DF.scores_from_rows(w0, mlp_w, mlp_b, cfg, w_rows, v_rows,
                                    batch.vals)
            wts = (batch.mask.to(torch.float32) if batch.mask is not None
                   else torch.ones_like(batch.y))
            if Task(fm_cfg.task) == Task.REGRESSION:
                per_ex = (s - batch.y).square()
            else:
                per_ex = F.softplus(-torch.where(batch.y > 0, 1.0, -1.0) * s)
            dsum = (per_ex * wts).sum()
            active = (batch.vals != 0).to(torch.float32) * wts[:, None]
            rsum = (fm_cfg.reg_w * (w_rows.square() * active).sum()
                    + fm_cfg.reg_v * (v_rows.square()
                                      * active[..., None]).sum())
            obj = (dsum + rsum) * (1.0 / total.clamp(min=1.0))
            grads = torch.autograd.grad(
                obj, (w0, w_rows, v_rows, *mlp_w, *mlp_b),
                materialize_grads=True)
        g_w0, g_w, g_v = grads[:3]
        dense_g = grads[3:]

        with torch.no_grad():
            acc = S._local_acc(g_v, g_w, ranks, budget, local_plan)
            if global_plan:
                acc_all, uids_all = M.psum(acc, DATA_AXIS, mesh), uids
            else:
                uids_all = M.all_gather(uids, DATA_AXIS, mesh)
                acc_all = M.all_gather(acc, DATA_AXIS, mesh)
            mine, lids = S._own_mask_and_lid(uids_all, p.w.shape[0], mesh)
            acc_all = torch.where(mine[:, None], acc_all, 0.0)
            S.unique_row_update(opt, sgd_cfg, p.w, fm.slot_w, lids,
                                acc_all[:, k], acc_all[:, 2 * k + 1])
            S.unique_row_update(opt, sgd_cfg, p.v, fm.slot_v, lids,
                                acc_all[:, :k], acc_all[:, k + 1:2 * k + 1])

            # the bias and the tower: one psum over data of all their
            # gradients, then the dense rule on every rank
            flat = M.psum(torch.cat([g_w0.reshape(1)]
                                    + [g.reshape(-1) for g in dense_g]),
                          DATA_AXIS, mesh)
            sizes = [1] + [g.numel() for g in dense_g]
            parts = flat.split(sizes)
            dense = [(p.w0, fm.slot_w0, parts[0].reshape(()))]
            dense += [(x, slot, g.view_as(x)) for x, slot, g in zip(
                list(state.mlp_w) + list(state.mlp_b),
                list(state.smw) + list(state.smb), parts[1:])]
            for x, slot, g in dense:
                x_new, slot_new, _ = sgd_solver._dense_scalar_update(
                    opt, lr, sgd_cfg, x, slot, None, g, None)
                x.copy_(x_new)
                slot.copy_(slot_new)
            fm.step.add_(1)
            loss = M.psum(dsum.detach().reshape(1), DATA_AXIS,
                          mesh)[0] / total.clamp(min=1.0)
            if global_plan:
                aux = {"loss": loss, "unique_count": count,
                       "unique_overflow": overflow}
            else:
                aux = {"loss": loss,
                       "unique_count": M.pmax(
                           torch.as_tensor(count, device=dev).to(
                               torch.int64).reshape(1), DATA_AXIS, mesh)[0],
                       "unique_overflow": M.pmax(
                           torch.as_tensor(overflow, device=dev).to(
                               torch.int32).reshape(1), DATA_AXIS,
                           mesh)[0] > 0}
        return state, aux

    return step


def make_sharded_score(cfg: DeepFMConfig, mesh):
    """``score(state, ids, vals) -> (B/D,)`` raw scores of the rank's rows:
    per-slot rows by the masked lookup and a psum over ``model``, the
    tower on the rank."""
    k = cfg.fm.num_factors

    @torch.no_grad()
    def score(state: DeepFMState, ids, vals):
        p = state.fm.params
        vw = S.gather_vw(p.v, p.w, ids, mesh)
        return DF.scores_from_rows(p.w0, state.mlp_w, state.mlp_b, cfg,
                                   vw[..., k], vw[..., :k], vals)
    return score


def trimmed_params(state: DeepFMState, mesh,
                   num_features: int) -> DeepFMParams:
    """The whole DeepFMParams on the rank's device: the tables gathered
    over ``model`` and trimmed to the true feature count, the tower
    copied."""
    fm = S.trimmed_params(state.fm, mesh, num_features)
    return DeepFMParams(fm=FMParams(fm.w0, fm.w, fm.v),
                        mlp_w=[w.clone() for w in state.mlp_w],
                        mlp_b=[b.clone() for b in state.mlp_b])
