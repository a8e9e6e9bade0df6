"""The training batch order: a frozen copy of the port's
``data/batching.py`` rule, the examples permuted per (seed, epoch)."""

from __future__ import annotations

import numpy as np


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    order = np.arange(n)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed),
                                                        int(epoch)]))
    rng.shuffle(order)
    return order


def batch_rows(n: int, batch_size: int, seed: int, epoch: int, step: int
               ) -> np.ndarray:
    """The example rows of batch ``step`` of ``epoch`` (full batches)."""
    return epoch_order(n, seed, epoch)[step * batch_size:
                                       (step + 1) * batch_size]
