"""The least work of one DeepFM step (Guo et al. 2017) under adam,
float32: each input read once, each output written once, as
``fm_sgd.py`` counts the FM step.

FLOPs of the dense part (:func:`dense_flops`): the FM head's forward and
per-slot gradient as ``fm_sgd.py`` counts them; the embeddings ``e = v x``
(K a slot) and, backward, the tower's gradient times x added into the FM
head's (2K a slot); the tower's forward (2 in out a layer and example,
plus the bias) and backward (the input gradient, which the trained
embeddings need at the first layer too, and the weight gradient: 4 in
out, plus the bias gradient); ReLU and dropout forward and backward (4 a
hidden unit and example); the logistic loss and its gradient (8 an
example). The step (:func:`step_work`) adds the per-row sums of the
slots' gradients (K + 1 a slot) and Adam on each distinct row's K + 1
coordinates, on the tower's weights and biases and on w0
(``ADAM_FLOPS`` a coordinate).

Bytes: the batch's ids and values (4 bytes each) and labels; each
distinct row's w, V and both moments (3 (K + 1) floats) read once and
written once; the tower's parameters and both moments read once and
written once; the scores and the loss written.
"""

from __future__ import annotations

from typing import Sequence

F32 = 4
ADAM_FLOPS = 12         # m: 3, v: 4, the corrected step and its write: 5


def _dims(slots: int, k: int, hidden: Sequence[int]):
    return (slots * k,) + tuple(int(h) for h in hidden) + (1,)


def tower_params(slots: int, k: int, hidden: Sequence[int]) -> int:
    """The tower's weights and biases, input ``slots * k`` wide."""
    d = _dims(slots, k, hidden)
    return sum(a * b + b for a, b in zip(d[:-1], d[1:]))


def dense_flops(batch: int, slots: int, k: int,
                hidden: Sequence[int]) -> float:
    """FLOPs of both heads' forward and backward and the loss, for one
    step of ``batch`` examples of ``slots`` active slots each."""
    n = batch * slots
    fm = (n * (4 * k + 2) + batch * (2 * k + 4)       # forward
          + n * (4 * k + 2))                          # per-slot gradient
    emb = n * k + 2 * n * k
    d = _dims(slots, k, hidden)
    mm = sum(2 * batch * a * b for a, b in zip(d[:-1], d[1:]))
    bias = sum(batch * b for b in d[1:])
    units = 4 * batch * sum(int(h) for h in hidden)   # relu, dropout
    loss = 8 * batch
    return float(fm + emb + 3 * mm + 2 * bias + units + loss)


def step_work(batch: int, slots: int, distinct: int, k: int,
              hidden: Sequence[int]) -> dict:
    """``{"flops", "bytes"}`` of one step of ``batch`` examples with
    ``slots`` active slots each and ``distinct`` distinct ids."""
    n = batch * slots
    p = tower_params(slots, k, hidden)
    flops = (dense_flops(batch, slots, k, hidden)
             + n * (k + 1)                            # per-row sums
             + ADAM_FLOPS * (distinct * (k + 1) + p + 1))
    nbytes = (2 * n * F32 + batch * F32               # ids, vals, y
              + 2 * distinct * 3 * (k + 1) * F32      # rows in and out
              + 2 * 3 * (p + 1) * F32                 # tower, w0
              + batch * F32 + F32)                    # scores, loss
    return {"flops": float(flops), "bytes": float(nbytes)}
