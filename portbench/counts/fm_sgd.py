"""The least work of one FM SGD step (adagrad, float32), after the
bound arithmetic of the port's ``kernel_times.py``: each input read once,
each output written once.

Bytes: the batch's ids and values (4 bytes each) and labels; each distinct
row's w, V and optimizer slots (2K + 2 floats) read once and written once;
the scores and the loss written. FLOPs: the forward (per slot K products
for v x, K adds to the sum, K squares and adds; per example the squared
sum), the per-slot gradient (4K + 2), its per-row sum and squares
(3 (K + 1) a slot), and adagrad's update of each distinct row (6 (K + 1)).
"""

from __future__ import annotations

F32 = 4


def step_work(batch: int, slots: int, distinct: int, k: int) -> dict:
    """``{"flops", "bytes"}`` of one step of ``batch`` examples with
    ``slots`` active slots each and ``distinct`` distinct ids."""
    n = batch * slots
    nbytes = (2 * n * F32 + batch * F32                 # ids, vals, y
              + 2 * distinct * (2 * k + 2) * F32        # rows in and out
              + batch * F32 + F32)                      # scores, loss
    flops = (n * (4 * k + 2) + batch * (2 * k + 4)      # forward
             + n * (4 * k + 2)                          # per-slot gradient
             + n * 3 * (k + 1)                          # per-row sums
             + distinct * 6 * (k + 1))                  # adagrad
    return {"flops": float(flops), "bytes": float(nbytes)}
