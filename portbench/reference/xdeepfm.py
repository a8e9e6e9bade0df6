"""Plain xDeepFM steps (Lian, Zhou, Zhang, Chen, Xie, Sun, KDD 2018,
arXiv:1803.05170): a linear head, a Compressed Interaction Network (CIN)
and a ReLU tower over one shared field embedding, trained on the
logistic loss.

    e_l    = v[i_l] x_l                  (the m field embeddings, D each)
    X^0    = [e_1; ...; e_m]             (m x D)
    X^k_h  = sum_{i <= H_{k-1}} sum_{j <= m} W^k_{h,i,j} (X^{k-1}_i o X^0_j)
                                         (eq. (6); no bias, identity)
    p^k_h  = sum_d X^k_{h,d}             (eq. (7)),  p+ = [p^1 | ... | p^K]
    h_0    = [e_1 | ... | e_m],  h_i = relu(h_{i-1} W_i + b_i)
    y      = w0 + sum_l w[i_l] x_l + w_cin . p+ + h_n W_out + b_out  (eq. (9))
    loss   = mean_b softplus(-y+-_b y_b)
             + sum_{b,l} (reg_w w[i_l]^2 + reg_v |v[i_l]|^2) / B
             + reg_dense (sum_k |W^k|^2 + |w_cin|^2 + sum_i |W_i|^2)

W^k is stored as (H_k, H_{k-1} m), column i m + j. Departures from the
paper, each the port's:

- the linear head carries a bias w0 beside the tower's output bias b;
- the L2 on the embedding rows is per appearance on the rows a batch
  touches, and reg_dense |W|^2 on the weight matrices (the CIN's, w_cin
  and the tower's, no biases) is the paper's lambda on the rest;
- Adam is lazy on the embedding rows: a row moves only in a step whose
  batch holds its id, from its own moments, with bias corrections of
  the global step; every dense tensor and w0 take dense Adam;
- ids are hashed into 2^24 buckets (the paper indexes each value).

Everything is computed in ``dtype`` (float64 by default) with TF32 off,
in blocks of examples so that the CIN's (block, H_{k-1} m, D) products
fit on the card. It imports nothing of the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.deepfm import ADAM_EPS, BETAS

BLOCK = 512             # examples a block of the CIN


def leaves(w0, w, v, mlp_w, mlp_b, cin) -> Dict[str, torch.Tensor]:
    """The named leaves: w0, w, v, ``mlp_w.<i>``, ``mlp_b.<i>``, the CIN
    layers' ``cin.<k>`` and ``w_cin`` (the last of ``cin``)."""
    out = {"w0": w0, "w": w, "v": v}
    out.update((f"mlp_w.{i}", x) for i, x in enumerate(mlp_w))
    out.update((f"mlp_b.{i}", x) for i, x in enumerate(mlp_b))
    out.update((f"cin.{k}", x) for k, x in enumerate(cin[:-1]))
    out["w_cin"] = cin[-1]
    return out


def _names(q, prefix: str) -> List[str]:
    n = sum(k.startswith(prefix) for k in q)
    return [f"{prefix}{i}" for i in range(n)]


def cin_pool(e: torch.Tensor, layers: Sequence[torch.Tensor],
             fault: Optional[str] = None) -> torch.Tensor:
    """p+ (B, sum H_k) of eqs. (6)-(7) over the embeddings ``e`` (B, m,
    D), layer by layer as the equations read. ``fault`` "cin_short"
    leaves the last layer's pool out of p+ (zeros in its place)."""
    b, m, d = e.shape
    x, pools = e, []
    for w in layers:
        z = torch.einsum("bid,bjd->bijd", x, e).reshape(b, -1, d)
        x = torch.einsum("hz,bzd->bhd", w, z)
        pools.append(x.sum(2))
    if fault == "cin_short":
        pools[-1] = torch.zeros_like(pools[-1])
    return torch.cat(pools, 1)


def _score(q, wr, vr, x, fault=None):
    """Scores of a block from its gathered rows ``wr`` (B, m), ``vr``
    (B, m, D) and the dense leaves ``q``."""
    e = vr * x[..., None]
    y = q["w0"] + (wr * x).sum(1)
    if fault != "no_cin":
        layers = [q[k] for k in _names(q, "cin.")]
        y = y + cin_pool(e, layers, fault) @ q["w_cin"]
    h = e.reshape(e.shape[0], -1)
    names = _names(q, "mlp_w.")
    for i, name in enumerate(names):
        h = h @ q[name] + q[f"mlp_b.{i}"]
        if i < len(names) - 1:
            h = torch.relu(h)
    return y + h[:, 0]


def scores(w0, w, v, mlp_w, mlp_b, cin, idx, vals, dtype=torch.float64,
           block: int = BLOCK) -> torch.Tensor:
    """Scores (serving) from the rows ``w``, ``v`` that ``idx`` indexes,
    in blocks of ``block`` examples."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q = {k: t.to(dtype) for k, t in
         leaves(w0, w, v, mlp_w, mlp_b, cin).items()}
    idx = idx.long()
    out = []
    with torch.no_grad():
        for s in range(0, idx.shape[0], block):
            i = idx[s:s + block]
            out.append(_score(q, q["w"][i], q["v"][i],
                              vals[s:s + block].to(dtype)))
    return torch.cat(out)


def _dense_matrices(q) -> List[str]:
    return (_names(q, "mlp_w.") + _names(q, "cin.") + ["w_cin"])


def train_steps(w0, w, v, mlp_w, mlp_b, cin, batches: List[dict], *,
                lr: float, reg_w: float, reg_v: float, reg_dense: float,
                dtype=torch.float64, fault: Optional[str] = None,
                block: int = BLOCK) -> Dict[str, object]:
    """Adam steps from zero optimizer state on the rows ``w`` (R,), ``v``
    (R, D) that the batches touch and the dense tensors ``mlp_w``,
    ``mlp_b``, ``cin`` (W^1..W^K, w_cin); each batch holds ``idx``
    (B, m) indices into those rows, ``vals``, ``y`` and ``step``, its
    global step (0 the first).

    Returns the per-step ``losses`` (data loss), step 1's gradient of
    each leaf (``grad1``, summed over a row's slots), the leaves before
    the first step (``init``) and after each step (``params``).

    ``fault`` plants one in the reference put in the program's place:
    "half" scores half of each batch, "stale" reports step 1's loss
    again as step 2's, "unchanged" leaves the parameters as they were,
    "no_cin" drops the CIN's term from the score, "cin_short" leaves
    the CIN's last layer out of p+."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = {k: t.detach().to(dtype).clone()
         for k, t in leaves(w0, w, v, mlp_w, mlp_b, cin).items()}
    init = {k: t.clone() for k, t in p.items()}
    m1 = {k: torch.zeros_like(t) for k, t in p.items()}
    m2 = {k: torch.zeros_like(t) for k, t in p.items()}
    b1, b2 = BETAS
    dense_w = _dense_matrices(p)
    losses, params, grad1 = [], [], None
    for bt in batches:
        idx = bt["idx"].long()
        x = bt["vals"].to(dtype)
        y = bt["y"].to(dtype)
        if fault == "half":
            h = idx.shape[0] // 2
            idx, x, y = idx[:h], x[:h], y[:h]
        n = idx.shape[0]
        q = {k: t.detach().requires_grad_() for k, t in p.items()
             if k not in ("w", "v")}
        names = list(q)
        g = {k: torch.zeros_like(q[k]) for k in names}
        g["w"] = torch.zeros_like(p["w"])
        g["v"] = torch.zeros_like(p["v"])
        data = 0.0
        for s in range(0, n, block):
            i, xb, yb = idx[s:s + block], x[s:s + block], y[s:s + block]
            wr = p["w"][i].detach().requires_grad_()
            vr = p["v"][i].detach().requires_grad_()
            score = _score(q, wr, vr, xb, fault)
            ypm = torch.where(yb > 0, 1.0, -1.0).to(dtype)
            part = F.softplus(-ypm * score).sum()
            active = (xb != 0).to(dtype)
            rows = ((reg_w * wr.square() * active).sum()
                    + (reg_v * active[..., None] * vr.square()).sum())
            grads = torch.autograd.grad((part + rows) / n,
                                        [q[k] for k in names] + [wr, vr],
                                        allow_unused=True)
            for k, gk in zip(names, grads):
                if gk is not None:
                    g[k] += gk
            g["w"].index_add_(0, i.reshape(-1), grads[-2].reshape(-1))
            g["v"].index_add_(0, i.reshape(-1),
                              grads[-1].reshape(-1, p["v"].shape[1]))
            data += float(part.detach()) / n
        for k in dense_w:
            g[k] += (2.0 * reg_dense) * p[k]
        touched = torch.zeros(p["w"].shape[0], dtype=torch.bool,
                              device=idx.device)
        touched[idx.reshape(-1)] = True
        with torch.no_grad():
            t = int(bt["step"]) + 1
            c1, c2 = 1 - b1 ** t, 1 - b2 ** t
            for key in p:
                gk = g[key]
                new1 = b1 * m1[key] + (1 - b1) * gk
                new2 = b2 * m2[key] + (1 - b2) * gk.square()
                step_ = lr * (new1 / c1) / (torch.sqrt(new2 / c2) + ADAM_EPS)
                if key in ("w", "v"):
                    rows = touched if key == "w" else touched[:, None]
                    m1[key] = torch.where(rows, new1, m1[key])
                    m2[key] = torch.where(rows, new2, m2[key])
                    p[key] = torch.where(rows, p[key] - step_, p[key])
                else:
                    m1[key], m2[key] = new1, new2
                    p[key] = p[key] - step_
        losses.append(data)
        if grad1 is None:
            grad1 = {key: t.clone() for key, t in g.items()}
        params.append({key: t.clone() for key, t in
                       (init if fault == "unchanged" else p).items()})
    if fault == "stale" and len(losses) > 1:
        losses[1] = losses[0]
    return {"losses": losses, "grad1": grad1, "params": params,
            "init": init}
