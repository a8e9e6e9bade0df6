"""The least work of one xDeepFM step (Lian et al. 2018) under adam,
float32, as ``deepfm.py`` counts DeepFM's: each input read once, each
output written once.

FLOPs of the Compressed Interaction Network (:func:`cin_flops`, an
example): per layer k of H_k maps over Z = H_{k-1} m products of D
coordinates, forward the outer product (Z D), the GEMM (2 H_k Z D) and
the sum pool (H_k D); backward the pooled gradient spread over D and
the gradient from layer k + 1 added (H_k D), the products' gradient and
the weights' gradient (two GEMMs, 4 H_k Z D), and the contractions of
the products' gradient with x_{k-1} and x_0 (4 Z D); and the embeddings
e = v x in, their gradient times x out and added into the rows' (3 m
D). The dense phase (:func:`dense_flops`, the step's span
``deepfm.dense``) counts the linear head (forward 2 a slot and the bias,
its gradient 1 a slot), the tower's input and its gradient times x (3 a
slot and factor), the tower forward and backward (3 GEMMs a layer, bias
and ReLU), w_cin . p+ and its two gradients (4 sum H_k) and the loss
(8), all per example. The step (:func:`step_work`) adds both to the
dense L2's gradient (2 a weight), the per-row sums of the slots'
gradients (K + 1 a slot) and Adam on each distinct row's K + 1
coordinates, the tower, the CIN and w0.

Bytes: the batch's ids, values and labels; each distinct row's w, V and
both moments read once and written once; every dense tensor and both
its moments read once and written once; the scores and the loss.
"""

from __future__ import annotations

from typing import Sequence

from portbench.counts import deepfm

F32 = 4
ADAM_FLOPS = deepfm.ADAM_FLOPS


def cin_params(fields: int, widths: Sequence[int]) -> int:
    """W^1..W^K and w_cin."""
    prev, n = int(fields), 0
    for h in widths:
        n += int(h) * prev * int(fields)
        prev = int(h)
    return n + sum(int(h) for h in widths)


def cin_flops(fields: int, k: int, widths: Sequence[int]) -> float:
    """FLOPs of one example's CIN forward and backward (the module doc)."""
    m, d = int(fields), int(k)
    total, prev = 3 * m * d, m
    for h in (int(x) for x in widths):
        z = prev * m
        total += z * d + 2 * h * z * d + h * d          # forward
        total += h * d + 4 * h * z * d + 4 * z * d      # backward
        prev = h
    return float(total)


def _tower_weights(slots: int, k: int, hidden: Sequence[int]) -> int:
    d = (slots * k,) + tuple(int(h) for h in hidden) + (1,)
    return sum(a * b for a, b in zip(d[:-1], d[1:]))


def dense_flops(batch: int, slots: int, k: int, hidden: Sequence[int],
                widths: Sequence[int]) -> float:
    """FLOPs of one step's dense phase (the module doc) for ``batch``
    examples of ``slots`` active slots each."""
    n = batch * slots
    d = (slots * k,) + tuple(int(h) for h in hidden) + (1,)
    mm = sum(2 * batch * a * b for a, b in zip(d[:-1], d[1:]))
    bias = sum(batch * b for b in d[1:])
    units = 2 * batch * sum(int(h) for h in hidden)   # relu, both ways
    s = sum(int(h) for h in widths)
    return float(3 * n + batch                        # linear head
                 + 3 * n * k                          # tower's input
                 + 3 * mm + 2 * bias + units
                 + 4 * s * batch + 8 * batch)         # w_cin, loss


def step_work(batch: int, slots: int, distinct: int, k: int,
              hidden: Sequence[int], widths: Sequence[int]) -> dict:
    """``{"flops", "bytes"}`` of one step of ``batch`` examples with
    ``slots`` active slots each and ``distinct`` distinct ids."""
    n = batch * slots
    tower_p = deepfm.tower_params(slots, k, hidden)
    cin_p = cin_params(slots, widths)
    flops = (dense_flops(batch, slots, k, hidden, widths)
             + batch * cin_flops(slots, k, widths)
             + 2 * (_tower_weights(slots, k, hidden) + cin_p)
             + n * (k + 1)                            # per-row sums
             + ADAM_FLOPS * (distinct * (k + 1) + tower_p + cin_p + 1))
    nbytes = (2 * n * F32 + batch * F32               # ids, vals, y
              + 2 * distinct * 3 * (k + 1) * F32      # rows in and out
              + 2 * 3 * (tower_p + cin_p + 1) * F32   # dense, w0
              + batch * F32 + F32)                    # scores, loss
    return {"flops": float(flops), "bytes": float(nbytes)}
