"""The least work of one field-aware FM step (Juan et al. 2016, eq. (4);
no bias, no linear term) under adagrad, float32, after ``fm_sgd.py``:
each input read once, each output written once, whatever implements it.

An example has one slot a field, so L = F slots, P = F (F - 1) / 2 pairs
and a row of vk = F k floats a feature. FLOPs: the forward, per pair the
dot of two k-vectors (2k) and its product with both values and the add
into the score (3); the backward, per pair the coefficient kappa x_a x_c
(2) and the two k-vectors it scales (2k); per slot the L2 term's gradient
(2 vk); the logistic loss and its gradient (8 an example); the per-row
sums of the slots' gradients and their squares (3 (vk + 1) a slot); and
adagrad's update of each distinct row (6 (vk + 1)).

Bytes: the batch's ids and values (4 bytes each) and labels; each
distinct row's record (v, its slots, w and its slot: 2 vk + 2 floats)
read once and written once; the scores and the loss written.
"""

from __future__ import annotations

F32 = 4


def pairs(fields: int) -> int:
    return fields * (fields - 1) // 2


def step_work(batch: int, fields: int, distinct: int, k: int) -> dict:
    """``{"flops", "bytes"}`` of one step of ``batch`` examples of
    ``fields`` slots each, with ``distinct`` distinct ids."""
    n = batch * fields
    vk = fields * k
    flops = (batch * pairs(fields) * ((2 * k + 3) + (2 * k + 2))
             + n * 2 * vk + 8 * batch                   # L2, loss
             + n * 3 * (vk + 1)                         # per-row sums
             + distinct * 6 * (vk + 1))                 # adagrad
    nbytes = ((2 * n + batch) * F32                     # ids, vals, y
              + 2 * distinct * (2 * vk + 2) * F32       # rows in and out
              + batch * F32 + F32)                      # scores, loss
    return {"flops": float(flops), "bytes": float(nbytes)}


def interaction_bytes(slots: int, fields: int, k: int) -> float:
    """The least bytes of the interaction's forward and backward over
    ``slots`` slots (``slots / fields`` examples): each slot's
    (fields k + 1) row ``[v | w]`` and its value read once, its gradient
    row (fields k + 1) written once, and each example's score written."""
    row = fields * k + 1
    return float(slots * (2 * row + 1) * F32 + slots // fields * F32)
