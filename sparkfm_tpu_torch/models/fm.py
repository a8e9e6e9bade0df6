"""FM model: parameters and batched prediction. Port of
``sparkfm_tpu/models/fm.py`` for plain FM.

Big tables (F >= 2^16) score through a dedup plan: the two-table gather
kernel reads each unique row of V and w once and writes the small (U, K+1)
``[v | w]`` matrix in one launch (``ops/rowio.py::gather_vw_rows``), and
the rows are spread to the batch's slots from it. Small tables gather per
slot, through the same kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from sparkfm_tpu_torch.config import FMConfig
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.ops import interaction as I
from sparkfm_tpu_torch.ops import losses as L
from sparkfm_tpu_torch.ops import rowio

BIG_TABLE = 1 << 16     # tables at least this tall score through plans


class FMParams(nn.Module):
    """w0: () bias; w: (F,) linear weights; v: (F, K) factors. Nothing in
    the port differentiates yet, so the parameters need no gradient."""

    def __init__(self, w0: torch.Tensor, w: torch.Tensor, v: torch.Tensor):
        super().__init__()
        self.w0 = nn.Parameter(w0, requires_grad=False)
        self.w = nn.Parameter(w, requires_grad=False)
        self.v = nn.Parameter(v, requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.v.device


def init_params(cfg: FMConfig, generator: Optional[torch.Generator] = None,
                *, device) -> FMParams:
    """V ~ N(init_mean, init_stdev), w0 = 0, w = 0, made on ``device``.
    Without a generator one is seeded from ``cfg.seed`` on that device
    (torch's random numbers differ from jax.random's for the same seed)."""
    if cfg.num_fields > 0:
        raise NotImplementedError("field-aware FM is not ported yet "
                                  "(ROADMAP A9)")
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    dtype = getattr(torch, cfg.dtype)
    v = torch.randn((cfg.num_features, cfg.num_factors), generator=generator,
                    device=device, dtype=torch.float32)
    v = cfg.init_mean + cfg.init_stdev * v
    return FMParams(w0=torch.zeros((), dtype=dtype, device=device),
                    w=torch.zeros((cfg.num_features,), dtype=dtype,
                                  device=device),
                    v=v.to(dtype))


def params_from_numpy(w0, w, v, *, device) -> FMParams:
    """FMParams on ``device`` from numpy arrays, e.g. the JAX package's
    parameters as ``np.asarray(params.w)``."""
    def t(x):
        return torch.as_tensor(np.array(x, copy=True), device=device)
    return FMParams(w0=t(w0), w=t(w), v=t(v))


def scores(params: FMParams, cfg: FMConfig,
           ids: torch.Tensor, vals: torch.Tensor,
           field_ids: Optional[torch.Tensor] = None,
           plan: Optional[E.DedupBatch] = None) -> torch.Tensor:
    """(B,) raw (pre-sigmoid) scores for a padded CSR batch (ids (B, L)
    int32, vals (B, L)) on the parameters' device.

    ``plan``: a dedup plan for this batch with its arrays on that device
    (``host_dedup`` + ``plan_to_device``, or ``batch_iterator(
    dedup_budget="ladder")``). The caller promises count <= budget;
    overflowed ids would score wrong. Without a plan, big tables build one
    on the device when the budget can hold every slot. ``field_ids`` is
    ignored by plain FM.
    """
    if cfg.num_fields > 0:
        raise NotImplementedError("field-aware FM scoring is not ported yet "
                                  "(ROADMAP A9)")
    cdt = getattr(torch, cfg.compute_dtype)
    if plan is None and cfg.num_features >= BIG_TABLE:
        budget = E.auto_budget(ids.numel())
        if budget >= ids.numel():       # no overflow possible: exact scores
            plan = E.dedup_ids(ids, budget, fill=cfg.num_features - 1)
    if plan is None:
        return I.fm_scores(params.w0, params.w, params.v, ids, vals,
                           use_bias=cfg.use_bias, use_linear=cfg.use_linear,
                           compute_dtype=cdt)
    vw_u = rowio.gather_vw_rows(params.v, params.w, plan.uids)  # (U, K+1)
    vw_rows = vw_u.index_select(0, plan.ranks.reshape(-1)).view(
        *plan.ranks.shape, cfg.num_factors + 1)
    return I.fm_scores_from_gathered(
        params.w0, vw_rows[..., cfg.num_factors],
        vw_rows[..., :cfg.num_factors], vals,
        use_bias=cfg.use_bias, use_linear=cfg.use_linear, compute_dtype=cdt)


def predict(params: FMParams, cfg: FMConfig,
            ids: torch.Tensor, vals: torch.Tensor,
            field_ids: Optional[torch.Tensor] = None,
            plan: Optional[E.DedupBatch] = None) -> torch.Tensor:
    """Predictions in output space: raw score (regression) or P(y=1)."""
    return L.predict_for_task(cfg.task,
                              scores(params, cfg, ids, vals, field_ids, plan))


def l2_penalty(params: FMParams, cfg: FMConfig) -> torch.Tensor:
    """reg0 * w0^2 + reg_w * |w|^2 + reg_v * |V|^2."""
    return (cfg.reg0 * params.w0.square()
            + cfg.reg_w * params.w.square().sum()
            + cfg.reg_v * params.v.square().sum())
