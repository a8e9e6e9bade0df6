"""Loss heads: squared loss for regression, logistic loss for
classification (labels in {-1, +1} or {0, 1}). Port of
``sparkfm_tpu/ops/losses.py``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sparkfm_tpu_torch.config import Task


def _mean(x: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return x.mean()
    return (x * weights).sum() / weights.sum().clamp(min=1e-12)


def squared_loss(scores: torch.Tensor, targets: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _mean((scores - targets).square(), weights)


def logistic_loss(scores: torch.Tensor, targets: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary logistic loss log(1 + exp(-y s)), computed stably."""
    y_pm = torch.where(targets > 0, 1.0, -1.0)
    return _mean(F.softplus(-y_pm * scores), weights)


def appearance_l2(w0: torch.Tensor, w_rows: torch.Tensor,
                  v_rows: torch.Tensor, vals: torch.Tensor,
                  weights: Optional[torch.Tensor], reg0, reg_w,
                  reg_v) -> torch.Tensor:
    """Per-appearance L2 (libFM SGD semantics): reg0 w0^2 plus, for each
    active slot (value != 0, example unmasked), reg_w w^2 + reg_v |v|^2 of
    its rows, over max(Σweights, 1) (B without weights). ``reg_w`` and
    ``reg_v`` are floats or per-slot (B, L) strengths; ``w_rows`` (B, L),
    ``v_rows`` (B, L, vk)."""
    active = (vals != 0).to(torch.float32)
    if weights is not None:
        active = active * weights[:, None]
        denom = weights.sum().clamp(min=1.0)
    else:
        denom = max(float(vals.shape[0]), 1.0)
    return (reg0 * w0.square()
            + (reg_w * w_rows.square() * active).sum() / denom
            + ((reg_v * active)[..., None] * v_rows.square()).sum() / denom)


def loss_for_task(task: Task):
    return squared_loss if task == Task.REGRESSION else logistic_loss


def predict_for_task(task: Task, scores: torch.Tensor) -> torch.Tensor:
    """Raw scores to predictions: identity (regression) or P(y=1)."""
    return scores if task == Task.REGRESSION else torch.sigmoid(scores)
