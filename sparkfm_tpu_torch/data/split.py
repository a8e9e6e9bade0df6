"""Seeded train/test/validation splits. Port of
``sparkfm_tpu/data/split.py``; numpy only, so the same seed gives the same
permutation, and the same split, in both packages."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from sparkfm_tpu_torch.data.batching import SparseDataset


@dataclasses.dataclass
class DataCollection:
    """A train/test bundle with an optional validation part."""

    training: SparseDataset
    test: SparseDataset
    validation: Optional[SparseDataset] = None

    @property
    def num_features(self) -> int:
        return self.training.num_features


def split_by_random(ds: SparseDataset, train_weight: float,
                    test_weight: float, validate_weight: float = 0.0,
                    seed: int = 0) -> DataCollection:
    """Random split by normalized weights; train and test weights must be
    > 0. ``num_features`` travels with every part."""
    if train_weight <= 0 or test_weight <= 0:
        raise ValueError("train and test weights must both be > 0")
    total = train_weight + test_weight + validate_weight
    n = ds.num_examples
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(round(n * train_weight / total))
    n_test = int(round(n * test_weight / total))
    if validate_weight > 0:
        n_test = min(n_test, n - n_train)
        val_idx = perm[n_train + n_test:]
        validation = ds.slice(val_idx) if len(val_idx) else None
    else:
        n_test = n - n_train
        validation = None
    train_idx = perm[:n_train]
    test_idx = perm[n_train:n_train + n_test]
    return DataCollection(training=ds.slice(train_idx),
                          test=ds.slice(test_idx),
                          validation=validation)
