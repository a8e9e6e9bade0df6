"""Plain ALS sweeps (Rendle's coordinate descent for squared loss).

Each sweep updates w0, then the linear weights block by block, then for
each factor f every block; each coordinate takes the exact minimiser of
the squared loss plus its L2 term,

    theta* = (theta Σh² - Σ e h) / (reg + Σh²)

kept where it is finite and the feature has entries, with h = x for w and
h = x (q_f - x v_f) for a factor (q_f = Σ_l v[i_l, f] x_l). Within a block
the updates use the block's old values (Jacobi); across blocks the
residual e = score - y and q_f are patched exactly (Gauss-Seidel). A
feature's block is the first slot it appears in. Per-feature sums are
``index_add_`` over every entry of the block's features, in ``dtype``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def to_device(ids: np.ndarray, vals: np.ndarray, y: np.ndarray,
              device) -> dict:
    ids_t = torch.as_tensor(ids, device=device).long()
    nf_seen = int(ids_t.max()) + 1
    block = torch.full((nf_seen,), ids.shape[1], dtype=torch.long,
                       device=device)
    for slot in reversed(range(ids.shape[1])):
        block[ids_t[:, slot]] = slot
    return {"ids": ids_t, "vals": torch.as_tensor(vals, device=device),
            "y": torch.as_tensor(y, device=device), "block": block}


def _slot_sum(table: torch.Tensor, ids: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    return (table[ids] * x).sum(1)


def rmse(data: dict, w0, w, v) -> float:
    """Training RMSE of the parameters, scored in float64."""
    ids, x, y = data["ids"], data["vals"].double(), data["y"].double()
    score = w0.double() + _slot_sum(w.double(), ids, x)
    for f in range(v.shape[1]):
        vf = v[:, f].double()
        score += 0.5 * (_slot_sum(vf, ids, x).square()
                        - _slot_sum(vf.square(), ids, x.square()))
    return float((score - y).square().mean().sqrt())


def _theta(theta, num, den, reg):
    new = (theta * den - num) / (reg + den)
    return torch.where(torch.isfinite(new) & (den > 0), new, theta)


def sweeps(data: dict, w0, w, v, *, reg0: float, reg_w: float,
           reg_v: float, n_sweeps: int, dtype=torch.float64,
           fault: Optional[str] = None) -> Dict[str, List[dict]]:
    """``n_sweeps`` sweeps from (w0, w, v) in ``dtype``; returns
    ``params``, the parameters after each sweep. ``fault`` plants one in
    the reference put in the program's place: "half" sweeps over the first
    half of the ratings; "stale" returns sweep 1's input as its output."""
    ids, x, y = data["ids"], data["vals"].to(dtype), data["y"].to(dtype)
    if fault == "half":
        h = ids.shape[0] // 2
        ids, x, y = ids[:h], x[:h], y[:h]
    nf = w.shape[0]
    block = torch.full((nf,), -1, dtype=torch.long, device=w.device)
    block[:data["block"].shape[0]] = data["block"]
    slots = ids.shape[1]
    w0 = w0.to(dtype).clone()
    w = w.to(dtype).clone()
    v = v.to(dtype).clone()
    n = ids.shape[0]
    out = []
    for s in range(n_sweeps):
        before = {"w0": w0.clone(), "w": w.clone(), "v": v.clone()}
        score = w0 + _slot_sum(w, ids, x)
        for f in range(v.shape[1]):
            score += 0.5 * (_slot_sum(v[:, f], ids, x).square()
                            - _slot_sum(v[:, f].square(), ids, x.square()))
        e = score - y
        new0 = _theta(w0, e.sum(), torch.tensor(float(n), dtype=dtype,
                                                device=e.device), reg0)
        e += new0 - w0
        w0 = new0
        for b in range(slots):
            num = torch.zeros_like(w)
            den = torch.zeros_like(w)
            for slot in range(slots):
                num.index_add_(0, ids[:, slot], e * x[:, slot])
                den.index_add_(0, ids[:, slot], x[:, slot].square())
            delta = torch.where(block == b, _theta(w, num, den, reg_w) - w,
                                0.0)
            e += _slot_sum(delta, ids, x)
            w = w + delta
        for f in range(v.shape[1]):
            vf = v[:, f].clone()
            q = _slot_sum(vf, ids, x)
            for b in range(slots):
                num = torch.zeros_like(vf)
                den = torch.zeros_like(vf)
                for slot in range(slots):
                    xs = x[:, slot]
                    h = xs * (q - xs * vf[ids[:, slot]])
                    num.index_add_(0, ids[:, slot], e * h)
                    den.index_add_(0, ids[:, slot], h.square())
                delta = torch.where(block == b,
                                    _theta(vf, num, den, reg_v) - vf, 0.0)
                new = vf + delta
                q_new = q + _slot_sum(delta, ids, x)
                e += (0.5 * (q_new.square() - q.square())
                      - 0.5 * _slot_sum(new.square() - vf.square(), ids,
                                        x.square()))
                vf, q = new, q_new
            v[:, f] = vf
        if fault == "stale" and s == 0:
            w0, w, v = before["w0"], before["w"], before["v"]
        out.append({"w0": w0.clone(), "w": w.clone(), "v": v.clone()})
    return {"params": out}
