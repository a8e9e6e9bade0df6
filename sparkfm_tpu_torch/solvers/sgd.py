"""SGD solver: the update-path policy, the dense scalar update and what
the port's SGD paths share. Port of the parts of
``sparkfm_tpu/solvers/sgd.py`` that the hybrid training path uses.

The port trains on the hybrid path only (``solvers/sgd_hybrid.py``). The
JAX package's other paths (direct, dedup, fused, sorted), adam and
momentum are not ported yet; selecting them raises
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import torch

from sparkfm_tpu_torch.config import FMConfig, SGDConfig
from sparkfm_tpu_torch.models.fm import FMParams

_PORTED_OPTIMIZERS = ("adagrad", "adagrad_row", "sgd")


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
    item = "A13" if path == "sorted" else "A9"
    return NotImplementedError(
        f"update path {path!r} is not ported yet (ROADMAP {item}); the "
        "port trains on the hybrid path: plain FM, float32, "
        "adagrad/adagrad_row/sgd without momentum, host plans, and "
        "num_features >= 2^16 under update_path='auto'")


def resolve_update_path(cfg: FMConfig, sgd_cfg: SGDConfig) -> str:
    """"hybrid" where the JAX package's auto policy (or a pinned
    ``update_path``) picks it; any other path raises
    ``NotImplementedError``, since only the hybrid path is ported."""
    path = _jax_update_path(cfg, sgd_cfg)
    if path != "hybrid":
        raise _unported_path(path)
    return path


def check_supported(sgd_cfg: SGDConfig) -> None:
    """Raise ``NotImplementedError`` for SGDConfig values the port cannot
    honour yet, naming the ROADMAP item that brings each."""
    if sgd_cfg.update_path not in ("auto", "hybrid"):
        raise _unported_path(sgd_cfg.update_path)
    if sgd_cfg.steps_per_dispatch > 1:
        raise NotImplementedError(
            "steps_per_dispatch > 1 (CUDA-graph multi-step) is not ported "
            "yet (ROADMAP A3)")
    if not sgd_cfg.host_plan:
        raise NotImplementedError(
            "host_plan=False (device plans feed the fused and dedup paths) "
            "is not ported yet (ROADMAP A9)")


def trim_params(params: FMParams, num_features: int) -> FMParams:
    """Drop the dedup dummy row if present."""
    if params.w.shape[0] == num_features + 1:
        return FMParams(w0=params.w0, w=params.w[:num_features],
                        v=params.v[:num_features])
    return params
