"""Plain field-aware FM steps (Juan, Zhuang, Chin and Lin, "Field-aware
Factorization Machines for CTR Prediction", RecSys 2016, eq. (4)), per
pair, with the logistic loss, per-appearance L2 and adagrad:

    phi(x) = Σ_{a<c} <v[i_a, f(c)], v[i_c, f(a)]> x_a x_c
    loss   = mean_b softplus(-y±_b phi_b) + Σ_{b, a active} reg_v |v[i_a]|² / B
    slot  += Σ_slots g²;   v -= lr Σ_slots g / sqrt(slot + eps)

``v[i, f]`` is the k-vector of feature i toward field f, the f-th k
columns of its (fields * k) row. Each pair's two vectors are gathered
from the slots' rows by the slots' field ids, so the score does not rest
on the port's slot-major or field-aggregated identities.

LIBFFM's defaults (k = 4, lambda = 2e-5, eta = 0.2, AdaGrad accumulators
starting at 1, V ~ U(0, 1/sqrt(k)), each instance normalised to unit
length) map onto it as: ``eps = 1`` with slots from 0, so the step is
g / sqrt(1 + Σ g²); ``reg_v = lambda / 2``, whose gradient is lambda v a
appearance; the values normalised by the caller. Departures from LIBFFM,
each the port's:

- the loss is the mean over a minibatch of B examples, and each row takes
  one adagrad step from the batch's summed gradient and summed squared
  per-slot gradients, not Hogwild's per-instance SGD;
- the L2 term covers each appearance's whole row, its own field's vector
  too, which no pair of LIBFFM's touches;
- the program's record keeps the bias and linear columns, switched off:
  this model has neither, and nothing here trains them.

Everything is computed in ``dtype`` (float64 by default), in blocks of
examples so that a float64 step of 65,536 examples fits on the card, and
TF32 is off for any float32 matrix product.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

BLOCK = 4096            # examples a block


def pair_scores(vr: torch.Tensor, x: torch.Tensor, field_ids: torch.Tensor,
                fields: int, fault: Optional[str] = None) -> torch.Tensor:
    """(B,) phi from the slots' rows ``vr`` (B, L, fields * k), values
    ``x`` (B, L) and field ids (B, L), over the L (L - 1) / 2 slot pairs
    a < c. ``fault="shared"`` gives each feature one vector for every
    pair, its own field's, as a plain FM would."""
    b, l, width = vr.shape
    k = width // fields
    a, c = torch.triu_indices(l, l, 1, device=vr.device)
    fid = field_ids.long()
    if fault == "shared":       # v[i_a, f(a)] and v[i_c, f(c)]
        toward_c, toward_a = fid[:, a], fid[:, c]
    else:
        toward_c, toward_a = fid[:, c], fid[:, a]
    flat = vr.reshape(b, l * fields, k)
    left = torch.gather(flat, 1, (a * fields + toward_c)[..., None]
                        .expand(-1, -1, k))              # v[i_a, f(c)]
    right = torch.gather(flat, 1, (c * fields + toward_a)[..., None]
                         .expand(-1, -1, k))             # v[i_c, f(a)]
    return ((left * right).sum(-1) * x[:, a] * x[:, c]).sum(1)


def sgd_steps(v: torch.Tensor, batches: List[dict], *, fields: int,
              lr: float, eps: float, reg_v: float, dtype=torch.float64,
              fault: Optional[str] = None,
              block: int = BLOCK) -> Dict[str, object]:
    """Adagrad steps from zero slots on the rows ``v`` (R, fields * k)
    that the batches touch; each batch holds ``idx`` (B, L) indices into
    those rows, ``vals``, ``y`` and ``field_ids`` (B, L). Returns the
    per-step ``losses`` (data loss), the slots after step 1 (``slot1``,
    (R, fields * k)) and V after each step (``params``).

    ``fault`` plants one in the reference put in the program's place:
    "half" scores half of each batch, the mean taken over it; "stale"
    reports step 1's loss again as step 2's; "shared" scores each pair
    with the features' own fields' vectors (:func:`pair_scores`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    v = v.to(dtype).clone()
    slot = torch.zeros_like(v)
    losses, params, slot1 = [], [], None
    for bt in batches:
        idx, x, y = bt["idx"].long(), bt["vals"].to(dtype), bt["y"]
        fid = bt["field_ids"]
        if fault == "half":
            h = idx.shape[0] // 2
            idx, x, y, fid = idx[:h], x[:h], y[:h], fid[:h]
        n = idx.shape[0]
        sum_v = torch.zeros_like(v)
        sq_v = torch.zeros_like(v)
        data = torch.zeros((), dtype=torch.float64, device=v.device)
        for s in range(0, n, block):
            ib, xb = idx[s:s + block], x[s:s + block]
            vr = v[ib].detach().requires_grad_()         # (b, L, fields k)
            phi = pair_scores(vr, xb, fid[s:s + block], fields, fault)
            ypm = torch.where(y[s:s + block] > 0, 1.0, -1.0).to(dtype)
            part = F.softplus(-ypm * phi).sum() / n
            active = (xb != 0).to(dtype)
            reg = (reg_v * active[..., None] * vr.square()).sum() / n
            g, = torch.autograd.grad(part + reg, vr)
            flat = ib.reshape(-1)
            g = g.reshape(flat.shape[0], -1)
            sum_v.index_add_(0, flat, g)
            sq_v.index_add_(0, flat, g.square())
            data += part.detach().double()
        with torch.no_grad():
            slot = slot + sq_v
            v = v - lr * sum_v * torch.rsqrt(slot + eps)
        losses.append(float(data))
        if slot1 is None:
            slot1 = slot.clone()
        params.append(v.clone())
    if fault == "stale" and len(losses) > 1:
        losses[1] = losses[0]
    return {"losses": losses, "slot1": slot1, "params": params}
