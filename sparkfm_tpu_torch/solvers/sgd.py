"""SGD solver: the update-path policy, the per-batch loss, the dense
scalar update, and the "direct" and "dedup" train steps on separate
tables. Port of ``sparkfm_tpu/solvers/sgd.py``.

The port trains on every single-device update path of the JAX package:
"direct" and "dedup" here, on an :class:`SGDState` of separate tables
(w, V and their optimizer slots), and "hybrid" (``solvers/sgd_hybrid.py``),
"fused" (``solvers/sgd_fused.py``) and "sorted" (``solvers/sgd_sorted.py``)
on the fused record table. :func:`resolve_update_path` picks among them as
the JAX package's "auto" policy does.

The direct and dedup steps (:func:`make_train_step`) share one route on
the device, with no atomic adds:

1. a dedup plan of the batch (the batch's host plan on "dedup" when it has
   one, else ``ops/embedding.py::dedup_ids`` on the device);
2. one two-table gather of the unique ``[v | w]`` rows (kernel B1,
   ``ops/rowio.py::gather_vw_rows``), and of ``[slot_v | slot_w]`` (and
   the adam second moments); the spread to the slots and
   ``torch.autograd.grad`` of the batch loss;
3. the per-slot ``[g_v | g_w]`` permuted into id-sorted order and summed
   per unique id, ``[Σg | Σg²]``, by kernel B6
   (``ops/embedding.py::accumulate_sq_to_unique_sorted``); the direct
   step's momentum and adam, whose per-slot terms are not linear in g, sum
   those terms by kernel B5 (``ops/segsum.py::segment_rowsum``);
4. the optimizer update of the unique rows and their write-back, IN PLACE
   on the state's tensors, one row-write launch a table (kernel B2,
   ``ops/rowio.py::scatter_set_rows``); then the bias update.

CPU tensors take each kernel's plain version along the same route.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sparkfm_tpu_torch.config import FMConfig, SGDConfig
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.ops import interaction as I
from sparkfm_tpu_torch.ops import losses as L
from sparkfm_tpu_torch.ops import rowio, segsum

_ROW_OPTIMIZERS = ("adagrad", "adam", "sgd")
_RECORD_OPTIMIZERS = ("adagrad", "adagrad_row", "sgd")  # the record paths
_ADAM = (0.9, 0.999, 1e-8)      # beta1, beta2, eps, as the JAX package's


@dataclasses.dataclass
class SGDState:
    """Parameters, per-coordinate optimizer slots and the step counter, on
    one device. The slots mirror the parameters' shapes: adagrad's squared
    gradient sums, momentum's velocities, adam's first moments (``slot``)
    and second moments (``slot2``). For optimizers other than adam the
    ``slot2_w``/``slot2_v`` are 0-d placeholders (:func:`init_state`)."""

    params: FMParams
    slot_w0: torch.Tensor
    slot_w: torch.Tensor
    slot_v: torch.Tensor
    slot2_w0: torch.Tensor
    slot2_w: torch.Tensor
    slot2_v: torch.Tensor
    step: torch.Tensor          # () int32


def init_state(params: FMParams, optimizer: Optional[str] = None
               ) -> SGDState:
    """Fresh (zero) optimizer state around ``params``, which the steps then
    update in place. With ``optimizer`` given and not "adam", the second
    moment slots are 0-d placeholders: only adam reads them, and a full
    slot2_v would cost a whole table (2 GB at 2^24 x 32). None keeps full
    slots, as in the JAX package."""
    lean = optimizer is not None and optimizer != "adam"

    def s2(x):
        return x.new_zeros(()) if lean else torch.zeros_like(x)
    z = torch.zeros_like
    return SGDState(params=params, slot_w0=z(params.w0),
                    slot_w=z(params.w), slot_v=z(params.v),
                    slot2_w0=z(params.w0), slot2_w=s2(params.w),
                    slot2_v=s2(params.v),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=params.device))


def state_from_numpy(w0, w, v, slot_w0, slot_w, slot_v, slot2_w0, slot2_w,
                     slot2_v, step, *, device) -> SGDState:
    """A JAX ``SGDState`` carried into the port from its arrays as numpy
    (``np.asarray(state.params.w)``, ``np.asarray(state.slot_v)``, ...):
    copies on ``device``, 0-d slot2 placeholders kept 0-d."""
    def t(x):
        return torch.as_tensor(np.array(x, copy=True), device=device)
    return SGDState(params=FMParams(w0=t(w0), w=t(w), v=t(v)),
                    slot_w0=t(slot_w0), slot_w=t(slot_w), slot_v=t(slot_v),
                    slot2_w0=t(slot2_w0), slot2_w=t(slot2_w),
                    slot2_v=t(slot2_v),
                    step=t(np.asarray(step, np.int32)))


def pad_state_for_dedup(state: SGDState) -> SGDState:
    """Append one zero row to every table: the dedup plan's fill row, whose
    content is garbage by contract (unused budget slots and overflow write
    there). 0-d slot2 placeholders pass through."""
    def pad(x):
        if x.dim() == 0:
            return x
        return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    p = state.params
    return SGDState(params=FMParams(w0=p.w0, w=pad(p.w), v=pad(p.v)),
                    slot_w0=state.slot_w0, slot_w=pad(state.slot_w),
                    slot_v=pad(state.slot_v), slot2_w0=state.slot2_w0,
                    slot2_w=pad(state.slot2_w), slot2_v=pad(state.slot2_v),
                    step=state.step)


def reg_vectors(cfg: FMConfig):
    """The per-feature L2 strengths (reg_w, reg_v) as CPU float32 (F,)
    tensors when ``cfg.feature_groups`` is set, else None: the step moves
    them to its device once."""
    if cfg.feature_groups is None:
        return None
    return tuple(torch.from_numpy(r) for r in cfg.reg_vectors())


def slot_reg_strengths(ids: torch.Tensor, cfg: FMConfig, reg_vecs=None):
    """The L2 strengths (reg_w, reg_v) of a batch's slots: the floats of
    ``cfg``, or with ``reg_vecs`` (the (F,) vectors of
    :func:`reg_vectors`, on the batch's device) their (B, L) gathers by
    ``ids``."""
    if reg_vecs is None:
        return cfg.reg_w, cfg.reg_v
    flat = ids.reshape(-1).long()
    return tuple(r.index_select(0, flat).view(ids.shape) for r in reg_vecs)


def _batch_loss_from_rows(w0: torch.Tensor, w_rows: torch.Tensor,
                          v_rows: torch.Tensor, batch, cfg: FMConfig,
                          reg_vecs=None):
    """Mean loss over valid examples as a function of the gathered rows:
    ``(data loss + L2, (scores, data loss))``. FFM (``cfg.num_fields >
    0``) takes flat (B, L, num_fields * K) v rows and the batch's
    field_ids, or the slot-major form under ``cfg.slot_major_fields``.

    Per-appearance L2 (libFM SGD semantics): each active slot (value != 0,
    example unmasked) regularizes its row, over max(Σmask, 1). With
    ``reg_vecs`` (the (F,) reg_w and reg_v vectors of attribute groups, on
    the batch's device) the strengths are per-slot gathers."""
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.num_fields > 0:
        s = I.ffm_scores_from_gathered(
            w0, w_rows, v_rows, batch.vals, batch.field_ids, cfg.num_fields,
            use_bias=cfg.use_bias, use_linear=cfg.use_linear,
            compute_dtype=cdt, slot_major=cfg.slot_major_fields)
    else:
        s = I.fm_scores_from_gathered(
            w0, w_rows, v_rows, batch.vals, use_bias=cfg.use_bias,
            use_linear=cfg.use_linear, compute_dtype=cdt)
    weights = None if batch.mask is None else batch.mask.to(torch.float32)
    data_loss = L.loss_for_task(cfg.task)(s, batch.y, weights)
    rw, rv = slot_reg_strengths(batch.ids, cfg, reg_vecs)
    reg = L.appearance_l2(w0, w_rows, v_rows, batch.vals, weights, cfg.reg0,
                          rw, rv)
    return data_loss + reg, (s, data_loss)


def _check_row_optimizer(opt: str) -> None:
    """The direct and dedup steps take adagrad, adam and sgd. adagrad_row
    (one accumulator per row) exists only on the fused-record paths."""
    if opt not in _ROW_OPTIMIZERS:
        hint = (" (adagrad_row requires update_path='fused'/'sorted'; see "
                "solvers/sgd_fused.py)") if opt == "adagrad_row" else ""
        raise ValueError(f"unsupported optimizer {opt!r} for this update "
                         f"path; expected one of {_ROW_OPTIMIZERS}{hint}")


def _adam_scales(step: torch.Tensor):
    """adam's bias corrections 1 - beta^t at t = step + 1, in float32."""
    b1, b2, _ = _ADAM
    t = step.to(torch.float32) + 1.0
    return 1 - b1 ** t, 1 - b2 ** t


def _dense_scalar_update(opt: str, lr: float, sgd_cfg: SGDConfig,
                         x: torch.Tensor, slot: torch.Tensor, slot2,
                         g: torch.Tensor, step):
    """One optimizer update of a dense scalar (the bias w0): returns
    (x, slot, slot2). adagrad_row on a scalar is adagrad (a scalar is a
    width-1 row)."""
    if opt == "adagrad_row":
        opt = "adagrad"
    elif opt not in _ROW_OPTIMIZERS:
        raise ValueError(f"unsupported optimizer {opt!r}")
    if opt == "adagrad":
        slot = slot + g.square()
        x = x - lr * g * torch.rsqrt(slot + sgd_cfg.adagrad_eps)
    elif opt == "adam":
        b1, b2, eps = _ADAM
        c1, c2 = _adam_scales(step)
        slot = b1 * slot + (1 - b1) * g
        slot2 = b2 * slot2 + (1 - b2) * g.square()
        x = x - lr * (slot / c1) / (torch.sqrt(slot2 / c2) + eps)
    elif sgd_cfg.momentum > 0:
        slot = sgd_cfg.momentum * slot + g
        x = x - lr * slot
    else:
        x = x - lr * g
    return x, slot, slot2


def _hybrid_eligible(cfg: FMConfig, sgd_cfg: SGDConfig) -> bool:
    """The hybrid step's static requirements plus host plans (its sorted
    backward reads plan.svals/sex, which only the host pipeline emits)."""
    return (sgd_cfg.host_plan
            and cfg.num_fields == 0
            and sgd_cfg.optimizer in _RECORD_OPTIMIZERS
            and sgd_cfg.momentum == 0
            and getattr(torch, cfg.compute_dtype, None) == torch.float32
            and cfg.feature_groups is None)


def resolve_update_path(cfg: FMConfig, sgd_cfg: SGDConfig) -> str:
    """The JAX package's policy (or a pinned ``update_path``): under
    "auto", tables below 2^16 rows take "direct"; bigger ones "hybrid"
    when host plans and the model and optimizer fit it, else "fused"
    (FFM included) for adagrad / adagrad_row / sgd without momentum, else
    "dedup" (adam, momentum). adagrad_row always takes a record path."""
    if sgd_cfg.update_path != "auto":
        return sgd_cfg.update_path
    if sgd_cfg.optimizer == "adagrad_row":
        return "hybrid" if _hybrid_eligible(cfg, sgd_cfg) else "fused"
    if cfg.num_features < (1 << 16):
        return "direct"
    if _hybrid_eligible(cfg, sgd_cfg):
        return "hybrid"
    if sgd_cfg.optimizer in _RECORD_OPTIMIZERS and sgd_cfg.momentum == 0:
        return "fused"
    return "dedup"


def trim_params(params: FMParams, num_features: int) -> FMParams:
    """Drop the dedup dummy row if present."""
    if params.w.shape[0] == num_features + 1:
        return FMParams(w0=params.w0, w=params.w[:num_features],
                        v=params.v[:num_features])
    return params


def _update_unique(opt: str, sgd_cfg: SGDConfig, t_u, s_u, s2_u, g_u, sq_u,
                   step):
    """The dedup rule: one update of each unique row from its summed
    gradient ``g_u`` (and summed squares ``sq_u``), on (U, W) rows of a
    table ``t_u`` and its slots. Returns (table, slot, slot2) rows."""
    lr = sgd_cfg.learning_rate
    if opt == "adagrad":
        s_u = s_u + sq_u
        t_u = t_u - lr * g_u * torch.rsqrt(s_u + sgd_cfg.adagrad_eps)
    elif opt == "adam":
        b1, b2, eps = _ADAM
        c1, c2 = _adam_scales(step)
        s_u = b1 * s_u + (1 - b1) * g_u
        s2_u = b2 * s2_u + (1 - b2) * g_u.square()
        t_u = t_u - lr * (s_u / c1) / (torch.sqrt(s2_u / c2) + eps)
    elif sgd_cfg.momentum > 0:
        s_u = sgd_cfg.momentum * s_u + g_u
        t_u = t_u - lr * s_u
    else:
        t_u = t_u - lr * g_u
    return t_u, s_u, s2_u


def _update_direct_per_slot(opt: str, sgd_cfg: SGDConfig, t_u, s_u, s2_u,
                            g_srt, plan, budget: int, step):
    """The direct rule for momentum and adam, whose updates are not linear
    in the slot gradients. The JAX direct step forms each slot's moments
    from the row's old slot, scatter-ADDS every slot's table term and SETS
    the slots with duplicate ids: of the slots of one id, the last in
    row-major order wins (checked on the JAX package's CPU backend:
    ``jnp.zeros(4).at[[1, 2, 1, 1]].set([10, 20, 30, 40])`` gives row 1 =
    40). Here the terms of the id-sorted slots ``g_srt`` are summed per
    run by kernel B5, and the moments are taken from each run's last slot:
    the sort is stable, so that is the last in row-major order."""
    seg = plan.seg
    seg_l = seg.long()
    lr = sgd_cfg.learning_rate
    if opt == "adam":
        b1, b2, eps = _ADAM
        c1, c2 = _adam_scales(step)
        m = b1 * s_u.index_select(0, seg_l) + (1 - b1) * g_srt
        v = b2 * s2_u.index_select(0, seg_l) + (1 - b2) * g_srt.square()
        term = lr * (m / c1) / (torch.sqrt(v / c2) + eps)
    else:
        m = sgd_cfg.momentum * s_u.index_select(0, seg_l) + g_srt
        v = None
        term = lr * m
    total = segsum.segment_rowsum(term.contiguous(), seg, budget)
    ranks = torch.arange(budget, dtype=seg.dtype, device=seg.device)
    last = (torch.searchsorted(seg, ranks, right=True) - 1).clamp(min=0)
    s_u = m.index_select(0, last)
    if v is not None:
        s2_u = v.index_select(0, last)
    return t_u - total, s_u, s2_u


def update_plan_rows(sgd_cfg: SGDConfig, state: SGDState, plan,
                     budget: int, g: torch.Tensor, rows_u: tuple,
                     valid: torch.Tensor, per_slot: bool) -> None:
    """Update the plan's unique rows of ``state``'s tables IN PLACE from
    the per-slot gradients ``g`` ((N, vk+1) ``[g_v | g_w]`` in the order of
    the ids the plan was built on). ``rows_u``: the (table, slot, slot2)
    rows the plan's uids read (slot2 None but under adam); ``valid``:
    (U, 1), false for budget slots past the plan's count, which write back
    the rows they read. ``per_slot``: the direct rule of momentum and adam
    (:func:`_update_direct_per_slot`), else one update of each unique row
    from its ``[Σg | Σg²]`` (kernel B6). The rows go back through kernel
    B2, so the plan's uids must be distinct up to its fill."""
    opt = sgd_cfg.optimizer
    p = state.params
    vk = p.v.shape[1]
    t_u, s_u, s2_u = rows_u
    if per_slot:
        g_srt = g.index_select(0, plan.order.long())
        t_new, s_new, s2_new = _update_direct_per_slot(
            opt, sgd_cfg, t_u, s_u, s2_u, g_srt, plan, budget, state.step)
    else:
        acc = E.accumulate_sq_to_unique_sorted(g, plan, budget)
        t_new, s_new, s2_new = _update_unique(
            opt, sgd_cfg, t_u, s_u, s2_u, acc[:, :vk + 1], acc[:, vk + 1:],
            state.step)
    writes = [(p.v, p.w, torch.where(valid, t_new, t_u))]
    if opt != "sgd" or sgd_cfg.momentum > 0:
        writes.append((state.slot_v, state.slot_w,
                       torch.where(valid, s_new, s_u)))
    if opt == "adam":
        writes.append((state.slot2_v, state.slot2_w,
                       torch.where(valid, s2_new, s2_u)))
    for tv, tw, new in writes:
        rowio.scatter_set_rows(tv, plan.uids, new[:, :vk].contiguous())
        rowio.scatter_set_rows(tw.view(-1, 1), plan.uids,
                               new[:, vk:].contiguous())


def make_train_step(cfg: FMConfig, sgd_cfg: SGDConfig):
    """(SGDState, SparseBatch) -> (SGDState, aux) for the "direct" and
    "dedup" paths (:func:`resolve_update_path`); the returned state holds
    the same table tensors, updated in place. aux holds ``loss`` and
    ``scores`` (tensors on the device), and on "dedup" the plan's
    ``unique_count`` and ``unique_overflow`` (host numbers for host plans,
    0-d device tensors for device plans).

    "dedup" needs the state padded with :func:`pad_state_for_dedup` and
    takes the batch's host plan (fill id F) or builds one on the device
    at ``unique_budget`` or ``auto_budget``. "direct" works on the F-row
    tables themselves: it ignores any batch plan and builds one on the
    device whose budget holds every distinct id (no overflow) and whose
    fill id is the last row, F - 1, and it writes unused budget slots back
    with the rows they read, so no row changes that no slot touched.

    The two paths differ only where the JAX package's do: under momentum
    and adam the dedup step updates each unique row once from its summed
    gradient, while the direct step sums per-slot updates and keeps the
    moments of an id's last slot (:func:`_update_direct_per_slot`).
    adagrad and plain sgd update alike on both. The module doc lists the
    steps; the kernels are looked up through their modules at each call.
    """
    # sgd_fused imports this module
    from sparkfm_tpu_torch.solvers.sgd_fused import valid_slots
    path = resolve_update_path(cfg, sgd_cfg)
    if path in ("fused", "sorted", "hybrid"):
        raise ValueError(
            f"resolved update path is '{path}', which uses a FusedState - "
            "build it with sparkfm_tpu_torch.solvers.sgd_fused / sgd_sorted "
            "/ sgd_hybrid instead (the trainer does this automatically)")
    if path not in ("direct", "dedup"):
        raise ValueError(f"unknown update_path {path!r}")
    opt = sgd_cfg.optimizer
    _check_row_optimizer(opt)
    direct = path == "direct"
    per_slot = direct and (opt == "adam" or (opt == "sgd"
                                             and sgd_cfg.momentum > 0))
    reg_cpu = reg_vectors(cfg)
    reg_on = {}                         # device -> the reg vectors there

    def train_step(state: SGDState, batch):
        p = state.params
        device = p.v.device
        rows, vk = p.v.shape
        n_slots = batch.ids.numel()
        if direct:
            budget = min(n_slots, rows)
            plan = E.dedup_ids(batch.ids, budget, fill=rows - 1)
        elif batch.plan is not None:
            plan = batch.plan
            budget = plan.uids.shape[0]
        else:
            budget = sgd_cfg.unique_budget or E.auto_budget(n_slots)
            plan = E.dedup_ids(batch.ids, budget, fill=rows - 1)
        if plan.order is None or plan.seg is None:
            raise ValueError(
                f"the {path} step sums by sorted runs and requires a plan "
                "with the id-sort permutation (plan.order/plan.seg); both "
                "dedup_ids and host_dedup emit it - this plan was built "
                "without it")
        if reg_cpu is not None and device not in reg_on:
            reg_on[device] = tuple(r.to(device) for r in reg_cpu)
        adam = opt == "adam"

        with torch.no_grad():
            valid = valid_slots(plan.count, budget, device)[:, None]
            t_u = rowio.gather_vw_rows(p.v, p.w, plan.uids)     # (U, vk+1)
            s_u = rowio.gather_vw_rows(state.slot_v, state.slot_w,
                                       plan.uids)
            s2_u = (rowio.gather_vw_rows(state.slot2_v, state.slot2_w,
                                         plan.uids) if adam else None)
            vw_rows = E.spread(torch.where(valid, t_u, 0.0), plan)
        w0 = p.w0.detach().requires_grad_()
        w_rows = vw_rows[..., vk].detach().requires_grad_()
        v_rows = vw_rows[..., :vk].detach().requires_grad_()
        with torch.enable_grad():
            total, (scores, data_loss) = _batch_loss_from_rows(
                w0, w_rows, v_rows, batch, cfg, reg_on.get(device))
            g_w0, g_wrows, g_vrows = torch.autograd.grad(
                total, (w0, w_rows, v_rows))

        with torch.no_grad():
            g = torch.cat([g_vrows.reshape(-1, vk), g_wrows.reshape(-1, 1)],
                          dim=1)                                # (N, vk+1)
            update_plan_rows(sgd_cfg, state, plan, budget, g,
                             (t_u, s_u, s2_u), valid, per_slot)
            if cfg.use_bias:
                w0_new, sw0, s2w0 = _dense_scalar_update(
                    opt, sgd_cfg.learning_rate, sgd_cfg, p.w0,
                    state.slot_w0, state.slot2_w0, g_w0, state.step)
            else:
                w0_new, sw0, s2w0 = p.w0, state.slot_w0, state.slot2_w0
            p.w0.copy_(w0_new)

        new_state = dataclasses.replace(state, slot_w0=sw0, slot2_w0=s2w0,
                                        step=state.step + 1)
        aux = {"loss": data_loss.detach(), "scores": scores.detach()}
        if not direct:
            aux.update(unique_count=plan.count,
                       unique_overflow=plan.overflow)
        return new_state, aux

    return train_step

