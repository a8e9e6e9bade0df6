"""Plain FM SGD steps (logistic loss, per-appearance L2, adagrad with a
per-element accumulator of the summed squared per-slot gradients, as the
port's and the JAX package's fused paths define it).

    score = w0 + Σ_l w[i_l] x_l + ½ Σ_f ((Σ_l v[i_l, f] x_l)² - Σ_l v[i_l, f]² x_l²)
    loss  = mean_b softplus(-y±_b score_b)
            + reg0 w0² + Σ_{b,l active} (reg_w w[i_l]² + reg_v |v[i_l]|²) / B
    slot += Σ_slots g²;   θ -= lr Σ_slots g / sqrt(slot + eps)
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F


def sgd_steps(w0, w, v, batches: List[dict], *, lr: float, eps: float,
              reg0: float, reg_w: float, reg_v: float, dtype=torch.float64,
              fault: Optional[str] = None) -> Dict[str, object]:
    """Adagrad steps from zero slots on the rows ``w`` (R,), ``v`` (R, K)
    that the batches touch; each batch holds ``idx`` (B, L) indices into
    those rows, ``vals`` and ``y``. Returns the per-step ``losses`` (data
    loss), the slots after step 1 (``slot1`` with keys w0, w, v) and the
    parameters after each step (``params``: list of dicts w0, w, v).

    ``fault`` plants one in the reference put in the program's place:
    "half" scores half of each batch, the mean taken over it; "stale"
    reports step 1's loss again as step 2's."""
    w0 = w0.to(dtype).clone()
    w = w.to(dtype).clone()
    v = v.to(dtype).clone()
    s_w0 = torch.zeros((), dtype=dtype, device=w.device)
    s_w = torch.zeros_like(w)
    s_v = torch.zeros_like(v)
    losses, params, slot1 = [], [], None
    for b in batches:
        idx = b["idx"].long()
        x = b["vals"].to(dtype)
        y = b["y"].to(dtype)
        if fault == "half":
            h = idx.shape[0] // 2
            idx, x, y = idx[:h], x[:h], y[:h]
        n = idx.shape[0]
        a0 = w0.detach().requires_grad_()
        wr = w[idx].detach().requires_grad_()
        vr = v[idx].detach().requires_grad_()
        vx = vr * x[..., None]
        score = (a0 + (wr * x).sum(1)
                 + 0.5 * (vx.sum(1).square().sum(1)
                          - vx.square().sum((1, 2))))
        ypm = torch.where(y > 0, 1.0, -1.0).to(dtype)
        data = F.softplus(-ypm * score).mean()
        active = (x != 0).to(dtype)
        total = (data + reg0 * a0.square()
                 + (reg_w * wr.square() * active).sum() / n
                 + (reg_v * active[..., None] * vr.square()).sum() / n)
        g0, gw, gv = torch.autograd.grad(total, (a0, wr, vr))
        flat = idx.reshape(-1)
        sum_w = torch.zeros_like(w).index_add_(0, flat, gw.reshape(-1))
        sq_w = torch.zeros_like(w).index_add_(0, flat,
                                              gw.square().reshape(-1))
        k = v.shape[1]
        sum_v = torch.zeros_like(v).index_add_(0, flat, gv.reshape(-1, k))
        sq_v = torch.zeros_like(v).index_add_(0, flat,
                                              gv.square().reshape(-1, k))
        with torch.no_grad():
            s_w0 = s_w0 + g0.square()
            w0 = w0 - lr * g0 * torch.rsqrt(s_w0 + eps)
            s_w = s_w + sq_w
            w = w - lr * sum_w * torch.rsqrt(s_w + eps)
            s_v = s_v + sq_v
            v = v - lr * sum_v * torch.rsqrt(s_v + eps)
        losses.append(float(data.detach()))
        if slot1 is None:
            slot1 = {"w0": s_w0.clone(), "w": s_w.clone(), "v": s_v.clone()}
        params.append({"w0": w0.clone(), "w": w.clone(), "v": v.clone()})
    if fault == "stale" and len(losses) > 1:
        losses[1] = losses[0]
    return {"losses": losses, "slot1": slot1, "params": params}
