"""Plain DeepFM steps (Guo et al. 2017, arXiv:1703.04247): an FM head and
a ReLU tower over one shared field embedding, trained on the logistic
loss with per-appearance L2 on the touched rows.

    e_l   = v[i_l] x_l                  (the L field embeddings, K each)
    y_FM  = w0 + Σ_l w[i_l] x_l + ½ Σ_f ((Σ_l e_lf)² - Σ_l e_lf²)
    h_0   = [e_1 | ... | e_L]            (L K inputs, slot-major)
    h_i   = relu(h_{i-1} W_i + b_i) ⊙ keep_i / (1 - p)   (hidden layers)
    y_DNN = h_n W_out + b_out
    loss  = mean_b softplus(-y±_b (y_FM + y_DNN))
            + Σ_{b,l active} (reg_w w[i_l]² + reg_v |v[i_l]|²) / B

Departures from the paper, each the port's:

- y_FM carries a bias w0 (the paper's FM component has none);
- the L2 is per appearance on the rows a batch touches, not a global
  weight decay, and the tower has none;
- Adam is lazy on the embedding rows: a row moves only in a step whose
  batch holds its id, from its own moments, with bias corrections of
  the global step (TF1's dense ``AdamOptimizer`` decays every row's
  moments every step); the tower and w0 take dense Adam;
- dropout's keep mask of hidden layer l at global step t (0 the first)
  of a run seeded s is ``torch.rand((B, width), generator=g) >= p`` on
  the run's device, ``g`` seeded with :func:`mask_seed` (s, t, l); the
  kept units are scaled by 1 / (1 - p) in training and nothing is
  dropped when scoring.

Everything is computed in ``dtype`` (float64 by default) and TF32 is off
for any float32 matrix product. The mask is drawn in float32, as the
program draws it, and compared there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

_M64 = (1 << 64) - 1
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def mask_seed(seed: int, step: int, layer: int) -> int:
    """splitmix64(splitmix64(splitmix64(seed mod 2^64) ^ step) ^ layer),
    shifted right by one: the generator seed of one layer's mask."""
    z = _splitmix64(int(seed) & _M64)
    z = _splitmix64(z ^ int(step))
    return _splitmix64(z ^ int(layer)) >> 1


def keep_masks(seed: int, step: int, rows: int, hidden: Sequence[int],
               p: float, device) -> List[torch.Tensor]:
    """The boolean keep masks (rows, width) of every hidden layer at
    global step ``step``."""
    out = []
    for layer, width in enumerate(hidden):
        g = torch.Generator(device=device).manual_seed(
            mask_seed(seed, step, layer))
        r = torch.rand((rows, width), generator=g, device=device)
        out.append(r >= p)
    return out


def leaves(w0, w, v, mlp_w, mlp_b) -> Dict[str, torch.Tensor]:
    """The named leaves: w0, w, v, then ``mlp_w.<i>`` and ``mlp_b.<i>``."""
    out = {"w0": w0, "w": w, "v": v}
    out.update((f"mlp_w.{i}", x) for i, x in enumerate(mlp_w))
    out.update((f"mlp_b.{i}", x) for i, x in enumerate(mlp_b))
    return out


def train_steps(w0, w, v, mlp_w, mlp_b, batches: List[dict], *,
                lr: float, reg_w: float, reg_v: float, dropout: float,
                seed: int, optimizer: str = "adam",
                adagrad_eps: float = 1e-8, dtype=torch.float64,
                fault: Optional[str] = None) -> Dict[str, object]:
    """Steps from zero optimizer state on the rows ``w`` (R,), ``v``
    (R, K) that the batches touch and the tower ``mlp_w``, ``mlp_b``;
    each batch holds ``idx`` (B, L) indices into those rows, ``vals``,
    ``y`` and ``step``, its global step (which keys its masks).
    ``optimizer`` "adam" (lazy on the rows) or "adagrad" (one sum of
    squared per-slot gradients a coordinate, the port's fused record).

    Returns the per-step ``losses`` (data loss), step 1's gradient of
    each leaf (``grad1``, summed over a row's slots), the leaves before
    the first step (``init``) and after each step (``params``).

    ``fault`` plants one in the reference put in the program's place:
    "half" scores half of each batch, "stale" reports step 1's loss
    again as step 2's, "unchanged" leaves the parameters as they were,
    "no_dropout" keeps every unit, "wrong_step" draws each step's masks
    from the next step's seed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_layers = len(mlp_w)
    hidden = [int(x.shape[1]) for x in mlp_w[:-1]]
    p = {k: t.detach().to(dtype).clone()
         for k, t in leaves(w0, w, v, mlp_w, mlp_b).items()}
    init = {k: t.clone() for k, t in p.items()}
    m1 = {k: torch.zeros_like(t) for k, t in p.items()}
    m2 = {k: torch.zeros_like(t) for k, t in p.items()}
    scale = 1.0 / (1.0 - dropout) if dropout > 0 else 1.0
    b1, b2 = BETAS
    losses, params, grad1 = [], [], None
    for b in batches:
        idx = b["idx"].long()
        x = b["vals"].to(dtype)
        y = b["y"].to(dtype)
        masks = None
        if dropout > 0 and fault != "no_dropout":
            t = int(b["step"]) + (1 if fault == "wrong_step" else 0)
            masks = keep_masks(seed, t, idx.shape[0], hidden, dropout,
                               idx.device)
        if fault == "half":
            h = idx.shape[0] // 2
            idx, x, y = idx[:h], x[:h], y[:h]
            masks = None if masks is None else [m[:h] for m in masks]
        n = idx.shape[0]
        q = {k: t.detach().requires_grad_() for k, t in p.items()
             if k not in ("w", "v")}
        wr = p["w"][idx].detach().requires_grad_()
        vr = p["v"][idx].detach().requires_grad_()
        score = _score_from_rows(q, wr, vr, x, masks, scale, n_layers)
        ypm = torch.where(y > 0, 1.0, -1.0).to(dtype)
        data = F.softplus(-ypm * score).mean()
        active = (x != 0).to(dtype)
        total = (data + (reg_w * wr.square() * active).sum() / n
                 + (reg_v * active[..., None] * vr.square()).sum() / n)
        names = list(q)
        grads = torch.autograd.grad(total, [q[k] for k in names] + [wr, vr],
                                    allow_unused=True)
        g = {k: (torch.zeros_like(q[k]) if gk is None else gk)
             for k, gk in zip(names, grads)}
        flat = idx.reshape(-1)
        k = p["v"].shape[1]
        g["w"] = torch.zeros_like(p["w"]).index_add_(0, flat,
                                                     grads[-2].reshape(-1))
        g["v"] = torch.zeros_like(p["v"]).index_add_(
            0, flat, grads[-1].reshape(-1, k))
        touched = torch.zeros(p["w"].shape[0], dtype=torch.bool,
                              device=flat.device)
        touched[flat] = True
        with torch.no_grad():
            if optimizer == "adam":
                t = int(b["step"]) + 1
                c1, c2 = 1 - b1 ** t, 1 - b2 ** t
                for key in p:
                    gk = g[key]
                    new1 = b1 * m1[key] + (1 - b1) * gk
                    new2 = b2 * m2[key] + (1 - b2) * gk.square()
                    step_ = lr * (new1 / c1) / (torch.sqrt(new2 / c2)
                                                + ADAM_EPS)
                    if key in ("w", "v"):
                        rows = touched if key == "w" else touched[:, None]
                        m1[key] = torch.where(rows, new1, m1[key])
                        m2[key] = torch.where(rows, new2, m2[key])
                        p[key] = torch.where(rows, p[key] - step_, p[key])
                    else:
                        m1[key], m2[key] = new1, new2
                        p[key] = p[key] - step_
            elif optimizer == "adagrad":
                sq = {"w": torch.zeros_like(p["w"]).index_add_(
                          0, flat, grads[-2].square().reshape(-1)),
                      "v": torch.zeros_like(p["v"]).index_add_(
                          0, flat, grads[-1].square().reshape(-1, k))}
                for key in p:
                    m1[key] = m1[key] + sq.get(key, g[key].square())
                    p[key] = p[key] - lr * g[key] * torch.rsqrt(
                        m1[key] + adagrad_eps)
            else:
                raise ValueError(f"unknown optimizer {optimizer!r}")
        losses.append(float(data.detach()))
        if grad1 is None:
            grad1 = {key: t.clone() for key, t in g.items()}
        params.append({key: t.clone() for key, t in
                       (init if fault == "unchanged" else p).items()})
    if fault == "stale" and len(losses) > 1:
        losses[1] = losses[0]
    return {"losses": losses, "grad1": grad1, "params": params,
            "init": init}


def _score_from_rows(q, wr, vr, x, masks, scale: float, n_layers: int):
    """The scores of a batch from its gathered rows ``wr`` (B, L) and
    ``vr`` (B, L, K) and the dense leaves ``q``."""
    vx = vr * x[..., None]
    y_fm = (q["w0"] + (wr * x).sum(1)
            + 0.5 * (vx.sum(1).square().sum(1) - vx.square().sum((1, 2))))
    h = vx.reshape(wr.shape[0], -1)
    for i in range(n_layers):
        h = h @ q[f"mlp_w.{i}"] + q[f"mlp_b.{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
            if masks is not None:
                h = h * (masks[i].to(h.dtype) * scale)
    return y_fm + h[:, 0]


def scores(w0, w, v, mlp_w, mlp_b, idx, vals, dtype=torch.float64):
    """Scores with nothing dropped (serving), from the rows ``w``, ``v``
    that ``idx`` indexes."""
    q = {k: t.to(dtype) for k, t in leaves(w0, w, v, mlp_w, mlp_b).items()}
    idx = idx.long()
    return _score_from_rows(q, q["w"][idx], q["v"][idx], vals.to(dtype),
                            None, 1.0, len(mlp_w))
