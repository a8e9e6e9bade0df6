"""DeepFM: a shared-embedding FM plus an MLP tower (Guo et al. 2017). Port
of ``sparkfm_tpu/models/deepfm.py`` for one device.

The FM tables (w, V) double as the deep side's embedding tables, so one
gather feeds both heads; the tower's input is the (B, num_fields * K)
concatenation of each slot's V row scaled by its value. Input is
field-major: ids (B, L) with one active feature per field, so L must equal
``num_fields`` (``synth_ctr`` and the Criteo/Avazu loaders give that
layout).

The tower is plain ``torch.matmul`` + bias + relu in float32, as the JAX
package computes it with ``jnp.dot`` outside any Pallas kernel; the port
never turns on TF32. The tables go through the port's row kernels:

* scoring gathers ``[v | w]`` per slot, or per unique id of a dedup plan,
  in one launch of the two-table gather (kernel B1,
  ``ops/rowio.py::gather_vw_rows``);
* the train steps (:func:`make_train_step`) gather the unique rows before
  autograd and sum and write them back after it, so no kernel needs a
  ``torch.autograd.Function``: "direct" and "dedup" on separate tables
  (an ``SGDState``: two-table gathers B1, one row write B2 per table),
  "fused" on one record table (a ``FusedState`` of width 2K+2 rounded up
  to 4 floats, 36 at K = 16, against the JAX package's 128: one gather
  B1 and one write B2). The per-unique sums of ``[g_v | g_w]`` and their
  squares are those of the fused FM step
  (``solvers/sgd_fused.py::segsum_accumulate``): kernel B6 over id-sorted
  runs on CUDA tensors, whose sums repeat bit for bit, ``index_add_`` of
  the ``[g | g²]`` pack on CPU tensors, the JAX package's choice. The
  direct step under momentum sums its per-slot terms by kernel B5, as the
  FM direct step does (``solvers/sgd.py::_update_direct_per_slot``).

Optimizers: adagrad and sgd everywhere, sgd with momentum on "direct"
only; others raise the JAX package's ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.data.batching import batch_iterator, prefetch
from sparkfm_tpu_torch.models import fm as fm_model
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.ops import interaction as I
from sparkfm_tpu_torch.ops import losses as L
from sparkfm_tpu_torch.ops import metrics as M
from sparkfm_tpu_torch.ops import rowio
from sparkfm_tpu_torch.solvers import sgd as sgd_solver
from sparkfm_tpu_torch.solvers import sgd_fused
from sparkfm_tpu_torch.solvers.sgd import SGDState
from sparkfm_tpu_torch.solvers.sgd_fused import FusedState
from sparkfm_tpu_torch.utils import device as device_util

_OPTIMIZERS = ("adagrad", "sgd")


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    """fm: the tables' shape and regularization (``num_fields`` = slots
    per example); hidden: the tower's widths (the scalar output layer is
    implicit)."""

    fm: FMConfig
    hidden: Tuple[int, ...] = (128, 64)

    @property
    def tower_in(self) -> int:
        return self.num_fields * self.fm.num_factors

    @property
    def num_fields(self) -> int:
        if self.fm.num_fields <= 0:
            raise ValueError("DeepFMConfig requires fm.num_fields > 0 "
                             "(slots-per-example = field count)")
        return self.fm.num_fields


class DeepFMParams(nn.Module):
    """fm: the shared tables (one (F, K) V, whatever ``num_fields``);
    mlp_w: the tower's (in, out) weights; mlp_b: its (out,) biases. The
    train steps differentiate with respect to gathered rows and detached
    copies, never these, so they need no gradient."""

    def __init__(self, fm: FMParams, mlp_w: Sequence[torch.Tensor],
                 mlp_b: Sequence[torch.Tensor]):
        super().__init__()
        self.fm = fm
        self.mlp_w = nn.ParameterList(
            [nn.Parameter(w, requires_grad=False) for w in mlp_w])
        self.mlp_b = nn.ParameterList(
            [nn.Parameter(b, requires_grad=False) for b in mlp_b])

    @property
    def device(self) -> torch.device:
        return self.fm.device


def init_params(cfg: DeepFMConfig,
                generator: Optional[torch.Generator] = None, *,
                device) -> DeepFMParams:
    """The FM tables as ``models/fm.py::init_params`` makes them for a
    plain FM (one shared (F, K) V), then He-initialized tower weights
    N(0, 2 / fan_in) and zero biases, all from one generator on
    ``device`` (default: seeded from ``cfg.fm.seed``). torch's numbers
    differ from jax.random's for the same seed."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.fm.seed)
    fm = fm_model.init_params(cfg.fm.replace(num_fields=0), generator,
                              device=device)
    dims = (cfg.tower_in,) + tuple(cfg.hidden) + (1,)
    ws, bs = [], []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=device)
        ws.append(w * math.sqrt(2.0 / fan_in))
        bs.append(torch.zeros((fan_out,), device=device))
    return DeepFMParams(fm=fm, mlp_w=ws, mlp_b=bs)


def deepfm_params_from_numpy(w0, w, v, mlp_w, mlp_b, *,
                             device) -> DeepFMParams:
    """DeepFMParams on ``device`` from numpy arrays, e.g. the JAX
    package's as ``np.asarray(params.fm.w)``, ``[np.asarray(x) for x in
    params.mlp_w]``."""
    def t(x):
        return torch.as_tensor(np.array(x, np.float32, copy=True),
                               device=device)
    return DeepFMParams(fm=fm_model.params_from_numpy(w0, w, v,
                                                      device=device),
                        mlp_w=[t(x) for x in mlp_w],
                        mlp_b=[t(x) for x in mlp_b])


def _tower(mlp_w, mlp_b, h: torch.Tensor) -> torch.Tensor:
    """(B,) tower output: matmul + bias, relu between layers."""
    n = len(mlp_w)
    for i, (w, b) in enumerate(zip(mlp_w, mlp_b)):
        h = torch.matmul(h, w) + b
        if i < n - 1:
            h = torch.relu(h)
    return h[:, 0]


def _check_field_major(cfg: DeepFMConfig, slots: int) -> None:
    if slots != cfg.num_fields:
        raise ValueError(
            f"DeepFM takes field-major input, one slot per field: the batch "
            f"has L = {slots} slots but num_fields = {cfg.num_fields}, so "
            f"its embeddings are not the tower's {cfg.tower_in} inputs")


def scores_from_rows(w0: torch.Tensor, mlp_w, mlp_b, cfg: DeepFMConfig,
                     w_rows: torch.Tensor, v_rows: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """(B,) raw scores, FM head + deep head, from gathered rows: w_rows
    (B, L), v_rows (B, L, K), vals (B, L)."""
    _check_field_major(cfg, vals.shape[1])
    fm_s = I.fm_scores_from_gathered(
        w0, w_rows, v_rows, vals, use_bias=cfg.fm.use_bias,
        use_linear=cfg.fm.use_linear,
        compute_dtype=getattr(torch, cfg.fm.compute_dtype))
    emb = (v_rows * vals[..., None]).reshape(vals.shape[0], -1)
    return fm_s + _tower(mlp_w, mlp_b, emb)


def scores(params: DeepFMParams, cfg: DeepFMConfig, ids: torch.Tensor,
           vals: torch.Tensor,
           plan: Optional[E.DedupBatch] = None) -> torch.Tensor:
    """(B,) raw scores of a field-major batch on the parameters' device.
    ``[v | w]`` comes from one two-table gather launch: per slot, or with
    ``plan`` (a dedup plan of ``ids`` on that device whose count fits its
    budget) per unique id, spread to the slots by the plan's ranks."""
    _check_field_major(cfg, ids.shape[1])
    k = cfg.fm.num_factors
    fm = params.fm
    if plan is None:
        vw = rowio.gather_vw_rows(fm.v, fm.w, ids.reshape(-1).to(
            torch.int32)).view(*ids.shape, k + 1)
    else:
        vw = E.spread(rowio.gather_vw_rows(fm.v, fm.w, plan.uids), plan)
    return scores_from_rows(fm.w0, params.mlp_w, params.mlp_b, cfg,
                            vw[..., k], vw[..., :k], vals)


def predict(params: DeepFMParams, cfg: DeepFMConfig, ids: torch.Tensor,
            vals: torch.Tensor,
            plan: Optional[E.DedupBatch] = None) -> torch.Tensor:
    """Predictions in output space: raw score (regression) or P(y=1)."""
    return L.predict_for_task(cfg.fm.task,
                              scores(params, cfg, ids, vals, plan))


# ---------------------------------------------------------------------------
# Training state

@dataclasses.dataclass
class DeepFMState:
    """A DeepFM train state on one device: ``fm`` holds the tables and
    their slots, an ``SGDState`` on "direct" and "dedup" (the dedup
    tables with the plan's fill row) or a ``FusedState`` on "fused"; the
    tower's weights and biases and their optimizer slots ride beside it.
    The train steps update every tensor in place."""

    fm: Union[SGDState, FusedState]
    mlp_w: Tuple[torch.Tensor, ...]
    mlp_b: Tuple[torch.Tensor, ...]
    smw: Tuple[torch.Tensor, ...]
    smb: Tuple[torch.Tensor, ...]


def _tower_state(fm_state, mlp_w, mlp_b) -> DeepFMState:
    mlp_w = tuple(w.detach().clone() for w in mlp_w)
    mlp_b = tuple(b.detach().clone() for b in mlp_b)
    return DeepFMState(fm=fm_state, mlp_w=mlp_w, mlp_b=mlp_b,
                       smw=tuple(torch.zeros_like(w) for w in mlp_w),
                       smb=tuple(torch.zeros_like(b) for b in mlp_b))


def init_state(params: DeepFMParams) -> DeepFMState:
    """Fresh (zero) optimizer state around ``params`` for the direct and
    dedup paths; the tables are the params' own tensors, the tower a
    copy. The adam slots stay 0-d placeholders: DeepFM rejects adam."""
    return _tower_state(sgd_solver.init_state(params.fm, optimizer="sgd"),
                        params.mlp_w, params.mlp_b)


def pad_deepfm_state_for_dedup(state: DeepFMState) -> DeepFMState:
    """The dedup path's state: every table and slot with one extra row,
    the dedup plan's fill row (garbage by contract)."""
    return dataclasses.replace(state,
                               fm=sgd_solver.pad_state_for_dedup(state.fm))


def init_fused_deepfm_state(cfg: DeepFMConfig,
                            generator: Optional[torch.Generator] = None, *,
                            device) -> DeepFMState:
    """The fused path's state: the FM tables and their adagrad slots in
    one (F+1, W) record table ``[v (K) | slot_v (K) | w | slot_w | pad]``
    (W = ``sgd_fused.record_width(K)``), from the same init as
    :func:`init_params`; the tower dense beside it."""
    params = init_params(cfg, generator, device=device)
    fused = sgd_fused.fused_from_params(
        params.fm, cfg.fm.replace(num_fields=0), device=device)
    return _tower_state(fused, params.mlp_w, params.mlp_b)


def fused_deepfm_state_from_numpy(table, w0, slot_w0, mlp_w, mlp_b, smw,
                                  smb, cfg: DeepFMConfig, *,
                                  device) -> DeepFMState:
    """A JAX fused DeepFM state carried into the port, from its arrays as
    numpy (``np.asarray(state["table"])``, ...): the record's 2K+2 used
    columns are kept, the JAX package's lane padding dropped."""
    fused = sgd_fused.fused_state_from_numpy(
        table, w0, slot_w0, 0, cfg.fm.replace(num_fields=0), device=device)

    def t(xs):
        return tuple(torch.as_tensor(np.array(x, np.float32, copy=True),
                                     device=device) for x in xs)
    return DeepFMState(fm=fused, mlp_w=t(mlp_w), mlp_b=t(mlp_b), smw=t(smw),
                       smb=t(smb))


def params_from_fused_deepfm(state: DeepFMState,
                             cfg: DeepFMConfig) -> DeepFMParams:
    """DeepFMParams copied out of a fused state (F rows)."""
    return DeepFMParams(
        fm=sgd_fused.params_from_fused(state.fm,
                                       cfg.fm.replace(num_fields=0)),
        mlp_w=[w.clone() for w in state.mlp_w],
        mlp_b=[b.clone() for b in state.mlp_b])


def params_of(state: DeepFMState, cfg: DeepFMConfig) -> DeepFMParams:
    """DeepFMParams of any path's state: F rows (the dedup fill row
    dropped), the tower copied."""
    if isinstance(state.fm, FusedState):
        return params_from_fused_deepfm(state, cfg)
    fm = sgd_solver.trim_params(state.fm.params, cfg.fm.num_features)
    return DeepFMParams(fm=FMParams(fm.w0.clone(), fm.w, fm.v),
                        mlp_w=[w.clone() for w in state.mlp_w],
                        mlp_b=[b.clone() for b in state.mlp_b])


# ---------------------------------------------------------------------------
# Train steps

def resolve_deepfm_path(cfg: DeepFMConfig, sgd_cfg: SGDConfig) -> str:
    """The JAX package's "auto": tables below 2^16 rows take "direct",
    bigger ones the fused record; a pinned ``update_path`` stands."""
    path = sgd_cfg.update_path
    if path == "auto":
        return "direct" if cfg.fm.num_features < (1 << 16) else "fused"
    return path


def _check_deepfm_optimizer(sgd_cfg: SGDConfig, path: str) -> None:
    """adagrad and plain sgd everywhere, momentum on "direct" only: adam
    would need second-moment slots the DeepFM state does not carry."""
    if sgd_cfg.optimizer not in _OPTIMIZERS:
        raise ValueError(
            f"deepfm supports optimizer 'adagrad' or 'sgd', got "
            f"{sgd_cfg.optimizer!r} — it would otherwise train with a "
            "different optimizer than requested")
    if path in ("dedup", "fused") and sgd_cfg.momentum > 0:
        raise ValueError(f"deepfm {path} path does not support momentum; "
                         "use update_path='direct' or momentum=0")


def _deepfm_loss(cfg: DeepFMConfig, batch, w0, w_rows, v_rows, mlp_w,
                 mlp_b):
    """The loss of all three paths: both heads from gathered rows, plus
    per-appearance L2 on the touched rows (each active slot of a valid
    example, over max(Σmask, 1)). Returns (data loss + L2, (scores, data
    loss))."""
    fm_cfg = cfg.fm
    s = scores_from_rows(w0, mlp_w, mlp_b, cfg, w_rows, v_rows, batch.vals)
    weights = None if batch.mask is None else batch.mask.to(torch.float32)
    data_loss = L.loss_for_task(fm_cfg.task)(s, batch.y, weights)
    active = (batch.vals != 0).to(torch.float32)
    if weights is not None:
        active = active * weights[:, None]
        denom = weights.sum().clamp(min=1.0)
    else:
        denom = max(float(batch.vals.shape[0]), 1.0)
    reg = (fm_cfg.reg_w * (w_rows.square() * active).sum()
           + fm_cfg.reg_v * (v_rows.square() * active[..., None]).sum()
           ) / denom
    return data_loss + reg, (s, data_loss)


def _unique_sums(g_v: torch.Tensor, g_w: torch.Tensor, plan, budget: int,
                 sorted_runs: bool) -> torch.Tensor:
    """(U, 2K+2) ``[Σg_v | Σg_w | Σg_v² | Σg_w²]`` per unique id of the
    per-slot gradients: by kernel B6 over id-sorted runs, or by
    ``index_add_`` of the ``[g | g²]`` pack by rank."""
    g = torch.cat([g_v.reshape(-1, g_v.shape[-1]), g_w.reshape(-1, 1)], 1)
    if sorted_runs:
        return E.accumulate_sq_to_unique_sorted(g, plan, budget)
    packed = torch.cat([g, g.square()], 1)
    return E.accumulate_to_unique(packed.view(*plan.ranks.shape, -1), plan,
                                  budget)


def make_train_step(cfg: DeepFMConfig, sgd_cfg: SGDConfig):
    """(DeepFMState, SparseBatch) -> (DeepFMState, aux) on the path that
    :func:`resolve_deepfm_path` picks; every tensor of the state is
    updated in place and the same state returned. aux holds ``loss`` and
    ``scores`` (tensors on the device) and, on "dedup" and "fused", the
    plan's ``unique_count`` and ``unique_overflow``.

    Each step:

    1. a dedup plan of the batch: on "direct" one built on the device
       whose budget holds every distinct id, fill id F - 1; on "dedup"
       and "fused" the batch's host plan, else one built on the device
       (``unique_budget`` or ``auto_budget``), fill id F;
    2. the unique rows gathered by kernel B1 (two-table ``[v | w]`` and
       ``[slot_v | slot_w]`` on "direct"/"dedup", the record on "fused"),
       rows past the plan's count zeroed, and spread to the slots;
    3. ``torch.autograd.grad`` of :func:`_deepfm_loss` with respect to
       w0, the slot rows and the tower;
    4. the per-unique sums (:func:`_unique_sums`, or kernel B5 on the
       direct step under momentum), the update of the unique rows and
       their write-back by kernel B2 (one per table, or one record);
    5. the bias and the tower by the dense rule (adagrad, sgd, momentum).
    """
    path = resolve_deepfm_path(cfg, sgd_cfg)
    if path not in ("direct", "dedup", "fused"):
        raise ValueError(f"deepfm supports update_path direct/dedup/fused, "
                         f"got {path!r}")
    _check_deepfm_optimizer(sgd_cfg, path)
    if cfg.fm.feature_groups is not None:
        raise ValueError("deepfm has no per-group L2 (feature_groups); the "
                         "JAX package ignores them here, the port refuses")
    if sgd_cfg.accumulate not in ("auto", "scatter", "segsum"):
        raise ValueError(
            f"unknown accumulate={sgd_cfg.accumulate!r}; expected "
            "'auto', 'scatter' or 'segsum'")
    opt, lr = sgd_cfg.optimizer, sgd_cfg.learning_rate
    k = cfg.fm.num_factors
    per_slot = path == "direct" and opt == "sgd" and sgd_cfg.momentum > 0
    writes_slot = opt != "sgd" or sgd_cfg.momentum > 0

    def plan_of(batch, rows: int):
        if path == "direct":
            budget = min(batch.ids.numel(), rows)
            return E.dedup_ids(batch.ids, budget, fill=rows - 1), budget
        if batch.plan is not None:
            return batch.plan, batch.plan.uids.shape[0]
        budget = sgd_cfg.unique_budget or E.auto_budget(batch.ids.numel())
        return E.dedup_ids(batch.ids, budget, fill=rows - 1), budget

    def train_step(state: DeepFMState, batch):
        fm = state.fm
        fused = isinstance(fm, FusedState)
        if fused != (path == "fused"):
            raise ValueError(f"the {path} step takes "
                             + ("a fused" if path == "fused" else "an SGD")
                             + " DeepFMState")
        table = fm.table if fused else fm.params.v
        device = table.device
        plan, budget = plan_of(batch, table.shape[0])
        sorted_runs = per_slot or sgd_fused.segsum_accumulate(
            sgd_cfg.accumulate, device)
        if sorted_runs and (plan.order is None or plan.seg is None):
            raise ValueError(
                f"the {path} step sums by sorted runs on {device} and "
                "requires a plan with the id-sort permutation "
                "(plan.order/plan.seg); both dedup_ids and host_dedup "
                "emit it - this plan was built without it")

        with torch.no_grad():
            valid = sgd_fused.valid_slots(plan.count, budget, device)[:, None]
            if fused:
                rec_u = torch.where(valid, E.gather_unique(table, plan), 0.0)
                vw_u = torch.cat([rec_u[:, :k], rec_u[:, 2 * k:2 * k + 1]],
                                 1)
            else:
                p = fm.params
                t_u = rowio.gather_vw_rows(p.v, p.w, plan.uids)
                s_u = rowio.gather_vw_rows(fm.slot_v, fm.slot_w, plan.uids)
                vw_u = torch.where(valid, t_u, 0.0)
            vw_rows = E.spread(vw_u, plan)                  # (B, L, K+1)
            w0_t = fm.w0 if fused else fm.params.w0
            slot_w0 = fm.slot_w0
        w0 = w0_t.detach().requires_grad_()
        w_rows = vw_rows[..., k].detach().requires_grad_()
        v_rows = vw_rows[..., :k].detach().requires_grad_()
        mlp_w = [x.detach().requires_grad_() for x in state.mlp_w]
        mlp_b = [x.detach().requires_grad_() for x in state.mlp_b]
        n_layers = len(mlp_w)
        with torch.enable_grad():
            total, (s, data_loss) = _deepfm_loss(cfg, batch, w0, w_rows,
                                                 v_rows, mlp_w, mlp_b)
            # w0 is off the graph without use_bias: a zero gradient
            grads = torch.autograd.grad(
                total, (w0, w_rows, v_rows, *mlp_w, *mlp_b),
                materialize_grads=True)
        g_w0, g_wrows, g_vrows = grads[:3]
        g_mw, g_mb = grads[3:3 + n_layers], grads[3 + n_layers:]

        with torch.no_grad():
            if per_slot:
                g = torch.cat([g_vrows.reshape(-1, k),
                               g_wrows.reshape(-1, 1)], 1)
                t_new, s_new, _ = sgd_solver._update_direct_per_slot(
                    opt, sgd_cfg, t_u, s_u, None,
                    g.index_select(0, plan.order.long()), plan, budget,
                    fm.step)
            else:
                acc = _unique_sums(g_vrows, g_wrows, plan, budget,
                                   sorted_runs)
            if fused:
                E.scatter_set_unique(table, plan, sgd_fused.update_records(
                    opt, sgd_cfg, rec_u, acc, k))
            else:
                if not per_slot:
                    t_new, s_new, _ = sgd_solver._update_unique(
                        opt, sgd_cfg, t_u, s_u, None, acc[:, :k + 1],
                        acc[:, k + 1:], fm.step)
                # slots past the plan's count keep the rows they read
                writes = [(p.v, p.w, torch.where(valid, t_new, t_u))]
                if writes_slot:
                    writes.append((fm.slot_v, fm.slot_w,
                                   torch.where(valid, s_new, s_u)))
                for tv, tw, new in writes:
                    rowio.scatter_set_rows(tv, plan.uids,
                                           new[:, :k].contiguous())
                    rowio.scatter_set_rows(tw.view(-1, 1), plan.uids,
                                           new[:, k:].contiguous())
            dense = [(w0_t, slot_w0, g_w0)]
            dense += list(zip(state.mlp_w, state.smw, g_mw))
            dense += list(zip(state.mlp_b, state.smb, g_mb))
            for x, slot, g in dense:
                x_new, slot_new, _ = sgd_solver._dense_scalar_update(
                    opt, lr, sgd_cfg, x, slot, None, g, None)
                x.copy_(x_new)
                slot.copy_(slot_new)
            fm.step.add_(1)

        aux = {"loss": data_loss.detach(), "scores": s.detach()}
        if path != "direct":
            aux.update(unique_count=plan.count,
                       unique_overflow=plan.overflow)
        return state, aux

    return train_step


# ---------------------------------------------------------------------------
# Training loop

def _metrics_of(s: torch.Tensor, y: np.ndarray,
                task: Task) -> Dict[str, float]:
    """The JAX trainer's eval keys from every example's score: rmse
    (regression), or auc and accuracy (classification)."""
    y = torch.from_numpy(y[:s.shape[0]])
    if task == Task.REGRESSION:
        return {"rmse": float((s.double() - y.double()).square().mean()
                              .sqrt())}
    prob = torch.sigmoid(s.double())
    return {"auc": float(M.auc(s, y)),
            "accuracy": float(((prob >= 0.5) == (y > 0)).double().mean())}


def _eval_metrics(params: DeepFMParams, cfg: DeepFMConfig, ds,
                  batch_size: int) -> Dict[str, float]:
    """:func:`_metrics_of` the scores of every example."""
    outs = []
    for b in batch_iterator(ds, batch_size, device=params.device):
        outs.append(scores(params, cfg, b.ids, b.vals)[b.mask])
    return _metrics_of(torch.cat(outs).cpu(), ds.y, cfg.fm.task)


def train_deepfm(cfg: DeepFMConfig, sgd_cfg: SGDConfig, train,
                 eval_ds=None, eval_every: int = 1,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, resume: bool = True, *,
                 device=device_util.DEFAULT):
    """DeepFM training on ``device`` (default: the card; without one it
    raises), the JAX package's loop for one device.

    The path is :func:`resolve_deepfm_path`'s; the state comes from
    ``generator`` (default: seeded from ``cfg.fm.seed``). Batches are
    shuffled per epoch with the JAX package's (seed, epoch) order and
    built in a background thread; on "dedup" and "fused" under
    ``host_plan`` they carry host ladder plans (or plans of
    ``unique_budget``), fill id F. Each history record holds the epoch's
    mean ``train_loss`` (in float64) and, every ``eval_every`` epochs and
    after the last, ``eval_rmse`` or ``eval_auc`` and ``eval_accuracy``.
    ``max_seconds`` stops after the epoch that reaches it.

    With ``checkpoint_dir`` the state is saved every ``checkpoint_every``
    epochs, after the last and on a ``max_seconds`` stop; with ``resume``
    a checkpoint there is restored into the state's own tensors and
    training goes on at the next epoch with the same batch order, so a
    resumed run equals an uninterrupted one bit for bit. A checkpoint of
    another path's layout raises ``ValueError``. ``examples_per_sec``
    leaves out the first step, its time and its examples (kernel builds,
    warm-up). The epoch loop is ``training/trainer.py::run_epochs``, the
    one ``train_sgd`` runs. ``mesh`` (a ``DeviceMesh``, a ``MeshConfig``,
    whose ``exchange`` is honoured, or "DxM") trains sharded on this rank:
    :func:`_train_deepfm_sharded`. Returns a ``TrainResult`` whose
    params are DeepFMParams of F rows.
    """
    # imported here: the trainer imports this module
    from sparkfm_tpu_torch.training.trainer import (PREFETCH_DEPTH,
                                                    TrainResult, run_epochs)

    device = device_util.resolve(device)
    if mesh is not None:
        return _train_deepfm_sharded(cfg, sgd_cfg, train, eval_ds,
                                     eval_every, generator, mesh,
                                     checkpoint_dir, checkpoint_every,
                                     resume, device)
    path = resolve_deepfm_path(cfg, sgd_cfg)
    step_fn = make_train_step(cfg, sgd_cfg)
    if path == "fused":
        state = init_fused_deepfm_state(cfg, generator, device=device)
    else:
        state = init_state(init_params(cfg, generator, device=device))
        if path == "dedup":
            state = pad_deepfm_state_for_dedup(state)
    dedup_budget = None
    if path in ("dedup", "fused") and sgd_cfg.host_plan:
        dedup_budget = sgd_cfg.unique_budget or "ladder"

    def run_epoch(state, epoch, dispatch):
        flags = []
        for batch in prefetch(batch_iterator(
                train, sgd_cfg.batch_size, device=device,
                shuffle=sgd_cfg.shuffle_each_epoch, seed=cfg.fm.seed,
                epoch=epoch, dedup_budget=dedup_budget,
                dedup_fill=cfg.fm.num_features), PREFETCH_DEPTH):
            def single(b=batch):
                nonlocal state
                state, aux = step_fn(state, b)
                return aux
            aux = dispatch(single, 1)
            if "unique_overflow" in aux:
                flags.append(aux["unique_overflow"])
        return state, flags

    # the JAX package's DeepFM records hold no unique_overflow_steps
    state, history, eps = run_epochs(
        state, sgd_cfg, train.num_examples, run_epoch, path=path,
        evaluate_state=None if eval_ds is None else (
            lambda s: _eval_metrics(params_of(s, cfg), cfg, eval_ds,
                                    sgd_cfg.batch_size)),
        eval_every=eval_every, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, resume=resume,
        record_overflows=False)
    return TrainResult(params=params_of(state, cfg), history=history,
                       examples_per_sec=eps)


def _train_deepfm_sharded(cfg: DeepFMConfig, sgd_cfg: SGDConfig, train,
                          eval_ds, eval_every: int, generator, mesh,
                          checkpoint_dir, checkpoint_every, resume, device):
    """The sharded DeepFM loop of this rank (JAX
    ``models/deepfm.py::_train_deepfm_sharded``) through
    ``parallel/sharded_deepfm.py``'s step. The exchange
    (``MeshConfig.exchange``, honoured or refused): "auto" takes global
    host plans with ``host_plan``, else per-shard device plans; "global"
    one host ladder plan over the global batch (needs ``host_plan``);
    "unique" per-shard plans, stacked host plans with ``host_plan``;
    "dense" is refused (DeepFM's table updates are per unique row). The
    batches, checkpoints (one directory per rank), time budget and evals
    as ``training/trainer.py::_train_sgd_sharded``."""
    from sparkfm_tpu_torch.parallel import mesh as Mesh
    from sparkfm_tpu_torch.parallel import multihost as MH
    from sparkfm_tpu_torch.parallel import sharded_deepfm as SD
    from sparkfm_tpu_torch.training.trainer import (PREFETCH_DEPTH,
                                                    TrainResult, _rank_dir,
                                                    run_epochs)

    mesh, exchange = Mesh.resolve_mesh(mesh, device=device)
    if exchange not in ("auto", "global", "unique"):
        raise ValueError(
            f"sharded DeepFM supports exchange auto/global/unique, got "
            f"{exchange!r} (dense slot exchange does not apply: DeepFM "
            "table updates are per-unique-row)")
    if exchange == "global" and not sgd_cfg.host_plan:
        raise ValueError("exchange='global' requires host_plan=True "
                         "(it consumes a host dedup plan)")
    mode = exchange
    if mode == "auto":
        mode = "global" if sgd_cfg.host_plan else "unique"
    d_shards = Mesh.size(mesh, Mesh.DATA_AXIS)
    if sgd_cfg.batch_size % d_shards:
        raise ValueError(f"batch_size={sgd_cfg.batch_size} not divisible by "
                         f"data axis size {d_shards}")
    state, pcfg = SD.init_sharded_state(cfg, mesh, generator)
    step_fn = SD.make_sharded_train_step(pcfg, sgd_cfg, mesh)
    score_fn = SD.make_sharded_score(pcfg, mesh)
    fill = pcfg.fm.num_features - 1
    plan_cap = E.auto_budget(sgd_cfg.batch_size * train.max_nnz)
    stacked_budget = E.auto_budget(
        (sgd_cfg.batch_size // d_shards) * train.max_nnz)
    rung = [1]

    def lift(batch):
        ids = np.asarray(batch.ids)
        if sgd_cfg.host_plan and mode == "global":
            hp = E.host_dedup(ids, plan_cap, fill)
            rung[0] = max(rung[0], E.ladder_budget(int(hp.count),
                                                   cap=plan_cap))
            plan = hp._replace(uids=hp.uids[:rung[0]], order=None,
                               seg=None, svals=None, sex=None)
            return MH.global_batch(mesh, batch, False, plan, "global")
        if sgd_cfg.host_plan:
            plan = E.stack_plans(ids, d_shards, stacked_budget, fill)
            return MH.global_batch(mesh, batch, False, plan, "stacked")
        return MH.global_batch(mesh, batch)

    def eval_metrics(state):
        outs = []
        for b in batch_iterator(eval_ds, sgd_cfg.batch_size, device="cpu"):
            gb = MH.global_batch(mesh, b)
            s = MH.collect(score_fn(state, gb.ids, gb.vals), mesh,
                           Mesh.DATA_AXIS)
            outs.append(torch.from_numpy(s[:int(b.mask.sum())]))
        return _metrics_of(torch.cat(outs), eval_ds.y, cfg.fm.task)

    def run_epoch(state, epoch, dispatch):
        batches = batch_iterator(train, sgd_cfg.batch_size, device="cpu",
                                 shuffle=sgd_cfg.shuffle_each_epoch,
                                 seed=cfg.fm.seed, epoch=epoch)
        for batch in prefetch(map(lift, batches), PREFETCH_DEPTH):
            def single(b=batch):
                nonlocal state
                state, aux = step_fn(state, b)
                return aux
            dispatch(single, 1)
        return state, []

    state, history, eps = run_epochs(
        state, sgd_cfg, train.num_examples, run_epoch,
        path=f"sharded deepfm {mode}",
        evaluate_state=None if eval_ds is None else eval_metrics,
        eval_every=eval_every,
        checkpoint_dir=_rank_dir(checkpoint_dir, mesh),
        checkpoint_every=checkpoint_every, resume=resume,
        record_overflows=False,
        stop_together=lambda stop: Mesh.any_rank(stop, mesh))
    return TrainResult(
        params=SD.trimmed_params(state, mesh, cfg.fm.num_features),
        history=history, examples_per_sec=eps)
