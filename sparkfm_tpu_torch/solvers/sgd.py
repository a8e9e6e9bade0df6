"""SGD solver: the update-path policy, the per-batch loss, the dense
scalar update and what the port's SGD paths share. Port of the parts of
``sparkfm_tpu/solvers/sgd.py`` that the fused-record paths use.

The port trains on three of the JAX package's update paths, all on the
fused record table: "hybrid" (``solvers/sgd_hybrid.py``), "fused"
(``solvers/sgd_fused.py``, with host or device plans) and "sorted"
(``solvers/sgd_sorted.py``). The "direct" and "dedup" paths, adam,
momentum and FFM are not ported yet; selecting them raises
``NotImplementedError`` naming ROADMAP A9.
"""

from __future__ import annotations

import torch

from sparkfm_tpu_torch.config import FMConfig, SGDConfig
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import interaction as I
from sparkfm_tpu_torch.ops import losses as L

_PORTED_OPTIMIZERS = ("adagrad", "adagrad_row", "sgd")


def reg_vectors(cfg: FMConfig):
    """The per-feature L2 strengths (reg_w, reg_v) as CPU float32 (F,)
    tensors when ``cfg.feature_groups`` is set, else None: the step moves
    them to its device once."""
    if cfg.feature_groups is None:
        return None
    return tuple(torch.from_numpy(r) for r in cfg.reg_vectors())


def _batch_loss_from_rows(w0: torch.Tensor, w_rows: torch.Tensor,
                          v_rows: torch.Tensor, batch, cfg: FMConfig,
                          reg_vecs=None):
    """Mean loss over valid examples as a function of the gathered rows
    (plain FM): ``(data loss + L2, (scores, data loss))``.

    Per-appearance L2 (libFM SGD semantics): each active slot (value != 0,
    example unmasked) regularizes its row, over max(Σmask, 1). With
    ``reg_vecs`` (the (F,) reg_w and reg_v vectors of attribute groups, on
    the batch's device) the strengths are per-slot gathers."""
    s = I.fm_scores_from_gathered(
        w0, w_rows, v_rows, batch.vals, use_bias=cfg.use_bias,
        use_linear=cfg.use_linear,
        compute_dtype=getattr(torch, cfg.compute_dtype))
    weights = None if batch.mask is None else batch.mask.to(torch.float32)
    data_loss = L.loss_for_task(cfg.task)(s, batch.y, weights)
    active = (batch.vals != 0).to(torch.float32)
    if weights is not None:
        active = active * weights[:, None]
        denom = weights.sum().clamp(min=1.0)
    else:
        denom = max(float(batch.vals.shape[0]), 1.0)
    if reg_vecs is not None:
        flat = batch.ids.reshape(-1).long()
        rw, rv = (r.index_select(0, flat).view(batch.ids.shape)
                  for r in reg_vecs)
    else:
        rw, rv = cfg.reg_w, cfg.reg_v
    reg = (cfg.reg0 * w0.square()
           + (rw * w_rows.square() * active).sum() / denom
           + ((rv * active)[..., None] * v_rows.square()).sum() / denom)
    return data_loss + reg, (s, data_loss)


def _dense_scalar_update(opt: str, lr: float, sgd_cfg: SGDConfig,
                         x: torch.Tensor, slot: torch.Tensor, slot2,
                         g: torch.Tensor, step):
    """One optimizer update of a dense scalar (the bias w0): returns
    (x, slot, slot2). adagrad_row on a scalar is adagrad (a scalar is a
    width-1 row)."""
    if opt == "adagrad_row":
        opt = "adagrad"
    elif opt == "adam":
        raise NotImplementedError("adam is not ported yet (ROADMAP A9)")
    elif opt not in ("adagrad", "sgd"):
        raise ValueError(f"unsupported optimizer {opt!r}")
    if opt == "adagrad":
        slot = slot + g.square()
        x = x - lr * g * torch.rsqrt(slot + sgd_cfg.adagrad_eps)
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
            and sgd_cfg.optimizer in _PORTED_OPTIMIZERS
            and sgd_cfg.momentum == 0
            and getattr(torch, cfg.compute_dtype, None) == torch.float32
            and cfg.feature_groups is None)


def _jax_update_path(cfg: FMConfig, sgd_cfg: SGDConfig) -> str:
    """The path the JAX package's ``resolve_update_path`` picks."""
    if sgd_cfg.update_path != "auto":
        return sgd_cfg.update_path
    if sgd_cfg.optimizer == "adagrad_row":
        return "hybrid" if _hybrid_eligible(cfg, sgd_cfg) else "fused"
    if cfg.num_features < (1 << 16):
        return "direct"
    if _hybrid_eligible(cfg, sgd_cfg):
        return "hybrid"
    if (sgd_cfg.optimizer in _PORTED_OPTIMIZERS
            and sgd_cfg.momentum == 0):
        return "fused"
    return "dedup"


def _unported_path(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"update path {path!r} is not ported yet (ROADMAP A9); the port "
        "trains on 'hybrid', 'fused' and 'sorted', and tables below 2^16 "
        "rows take the direct path under update_path='auto'")


def resolve_update_path(cfg: FMConfig, sgd_cfg: SGDConfig) -> str:
    """The path the JAX package's auto policy (or a pinned
    ``update_path``) picks: "hybrid", "fused" or "sorted" where the JAX
    one picks them; "direct" and "dedup" raise ``NotImplementedError``."""
    path = _jax_update_path(cfg, sgd_cfg)
    if path not in ("hybrid", "fused", "sorted"):
        raise _unported_path(path)
    return path


def check_supported(sgd_cfg: SGDConfig) -> None:
    """Raise ``NotImplementedError`` for SGDConfig values the port cannot
    honour yet, naming the ROADMAP item that brings each."""
    if sgd_cfg.update_path in ("direct", "dedup"):
        raise _unported_path(sgd_cfg.update_path)


def check_grouping(path: str, sgd_cfg: SGDConfig) -> None:
    """``steps_per_dispatch``, read where the JAX trainer reads it: only
    the hybrid path groups steps into one dispatch, and every other path
    runs its steps one by one whatever the value. The port has no grouped
    hybrid dispatch yet, so the hybrid path raises
    ``NotImplementedError`` for a value above 1."""
    if path == "hybrid" and sgd_cfg.steps_per_dispatch > 1:
        raise NotImplementedError(
            "steps_per_dispatch > 1 on the hybrid path (CUDA-graph "
            "multi-step) is not ported yet (ROADMAP A3)")


def trim_params(params: FMParams, num_features: int) -> FMParams:
    """Drop the dedup dummy row if present."""
    if params.w.shape[0] == num_features + 1:
        return FMParams(w0=params.w0, w=params.w[:num_features],
                        v=params.v[:num_features])
    return params
