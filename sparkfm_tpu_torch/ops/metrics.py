"""Evaluation metrics on tensors. Port of ``sparkfm_tpu/ops/metrics.py``:
a true MAE (with the abs), float-division accuracy, exact rank AUC.

Every metric takes an optional (N,) bool validity mask, so the padded
tail of the last batch can be excluded exactly.
"""

from __future__ import annotations

from typing import Optional

import torch


def _masked(x: torch.Tensor, mask: Optional[torch.Tensor]):
    if mask is None:
        return x, x.numel()
    return torch.where(mask, x, 0.0), mask.sum().clamp(min=1)


def rmse(pred: torch.Tensor, target: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    se, n = _masked((pred - target).square(), mask)
    return torch.sqrt(se.sum() / n)


def mae(pred: torch.Tensor, target: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    ae, n = _masked((pred - target).abs(), mask)
    return ae.sum() / n


def accuracy(prob: torch.Tensor, target: torch.Tensor,
             threshold: float = 0.5,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Accuracy of probabilities against {0,1} (or {-1,1}) labels."""
    hit = (prob >= threshold) == (target > 0)
    a, n = _masked(hit.to(torch.float32), mask)
    return a.sum() / n


def auc(scores: torch.Tensor, target: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact ROC AUC by the rank statistic (Mann-Whitney U), with average
    ranks over ties.

    The order is lexicographic on (invalid, score), so masked entries
    trail every valid one whatever their score, and tie groups never
    join valid and invalid entries.
    """
    y = (target > 0).to(torch.float32)
    valid_b = (torch.ones_like(scores, dtype=torch.bool) if mask is None
               else mask)
    valid = valid_b.to(torch.float32)
    n = scores.shape[0]
    inval = (~valid_b).to(torch.int32)
    sval = torch.where(valid_b, scores, 0.0)
    # lexsort: sort by score, then stably by validity
    order = torch.sort(sval, stable=True).indices
    order = order[torch.sort(inval[order], stable=True).indices]
    skey = sval[order]
    sinv = inval[order]
    base_ranks = torch.arange(1, n + 1, dtype=torch.float32,
                              device=scores.device)
    new_group = torch.ones((n,), dtype=torch.bool, device=scores.device)
    new_group[1:] = (skey[1:] != skey[:-1]) | (sinv[1:] != sinv[:-1])
    gid = torch.cumsum(new_group, 0) - 1
    gsum = torch.zeros((n,), device=scores.device).index_add_(0, gid,
                                                              base_ranks)
    gcnt = torch.zeros((n,), device=scores.device).index_add_(
        0, gid, torch.ones_like(base_ranks))
    ranks = torch.empty((n,), device=scores.device)
    ranks[order] = gsum[gid] / gcnt[gid].clamp(min=1.0)
    npos = (y * valid).sum()
    nneg = ((1.0 - y) * valid).sum()
    u = (ranks * y * valid).sum() - npos * (npos + 1.0) / 2.0
    return torch.where(npos * nneg > 0, u / (npos * nneg).clamp(min=1.0),
                       0.5)


def logloss(prob: torch.Tensor, target: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            eps: float = 1e-7) -> torch.Tensor:
    """Mean binary cross-entropy of probabilities against labels."""
    y01 = (target > 0).to(prob.dtype)
    p = prob.clamp(eps, 1.0 - eps)
    ll = -(y01 * torch.log(p) + (1.0 - y01) * torch.log1p(-p))
    v, n = _masked(ll, mask)
    return v.sum() / n
