"""Relational (block-structure, "BS") data: relation tables joined to the
examples at batch time. Port of ``sparkfm_tpu/data/relational.py``.

Each relation is a padded-CSR table whose last row is an all-zero null
row for missing joins; each example carries one row key per relation. A
batch's full feature list is ``cat(main block, table.ids[keys] + offset,
...)``, built on the batch's device by :func:`compose_batch` (plain tensor
indexing), so the joined design matrix is never stored. The feature
space is the materialized one (:meth:`RelationalDataset.materialize`,
``data/vectorizer.py::RelationVectorizer.transform``), so both forms score
and train alike.

The SGD step on a composed batch is ``solvers/sgd.py::make_train_step``
on the "direct" or "dedup" path (:func:`relational_update_path`). BS-ALS,
which never composes at all, is ``solvers/als_bs.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from sparkfm_tpu_torch.config import FMConfig, SGDConfig
from sparkfm_tpu_torch.data.batching import SparseBatch, SparseDataset


@dataclasses.dataclass(frozen=True)
class RelationTable:
    """One relation as a padded-CSR block: row k holds key k's
    relation-local feature ids and values (add ``offset`` for the global
    feature space); the last row is the null row. ``ids`` (K+1, Lr) int32
    and ``vals`` (K+1, Lr) float32 are numpy arrays on the host, or
    tensors on a device after :func:`tables_to_device`."""

    ids: object
    vals: object
    offset: int = 0

    @property
    def num_rows(self) -> int:
        return self.ids.shape[0]

    @property
    def row_nnz(self) -> int:
        return self.ids.shape[1]


@dataclasses.dataclass
class RelationalDataset:
    """A dataset in block-structure form on the host: the direct feature
    block ``main_ids``/``main_vals`` (N, Lm) with global ids, labels ``y``
    (N,), and ``keys`` (N, R), each example's row in each of the R
    ``tables`` (the null row for a missing join)."""

    main_ids: np.ndarray
    main_vals: np.ndarray
    y: np.ndarray
    keys: np.ndarray
    tables: Tuple[RelationTable, ...]
    num_features: int

    @property
    def num_examples(self) -> int:
        return self.main_ids.shape[0]

    @property
    def total_nnz_per_example(self) -> int:
        return self.main_ids.shape[1] + sum(t.row_nnz for t in self.tables)

    def materialize(self) -> SparseDataset:
        """The flat SparseDataset: the main block, then each relation's
        joined row at its offset."""
        parts_ids, parts_vals = [self.main_ids], [self.main_vals]
        for r, t in enumerate(self.tables):
            k = self.keys[:, r]
            parts_ids.append(np.asarray(t.ids)[k] + t.offset)
            parts_vals.append(np.asarray(t.vals)[k])
        return SparseDataset(
            ids=np.concatenate(parts_ids, axis=1).astype(np.int32),
            vals=np.concatenate(parts_vals, axis=1).astype(np.float32),
            y=self.y, num_features=self.num_features)

    def slice(self, idx: np.ndarray) -> "RelationalDataset":
        return RelationalDataset(
            main_ids=self.main_ids[idx], main_vals=self.main_vals[idx],
            y=self.y[idx], keys=self.keys[idx], tables=self.tables,
            num_features=self.num_features)


def relational_from_numpy(ds) -> RelationalDataset:
    """A JAX ``RelationalDataset`` (or any object with its fields) carried
    into the port: its arrays and tables as numpy copies."""
    def a(x, dtype):
        return np.array(x, dtype, copy=True)
    return RelationalDataset(
        main_ids=a(ds.main_ids, np.int32), main_vals=a(ds.main_vals,
                                                       np.float32),
        y=a(ds.y, np.float32), keys=a(ds.keys, np.int32),
        tables=tuple(RelationTable(ids=a(t.ids, np.int32),
                                   vals=a(t.vals, np.float32),
                                   offset=int(t.offset))
                     for t in ds.tables),
        num_features=int(ds.num_features))


@dataclasses.dataclass
class RelationalBatch:
    """One batch on one device: the direct block (B, Lm), labels (B,),
    per-relation row keys (B, R) int32 and the validity mask (B,)."""

    main_ids: torch.Tensor
    main_vals: torch.Tensor
    y: torch.Tensor
    keys: torch.Tensor
    mask: Optional[torch.Tensor] = None


def compose_batch(batch: RelationalBatch,
                  tables: Sequence[RelationTable]) -> SparseBatch:
    """The join on the batch's device: each relation's rows gathered by
    key and concatenated after the main block, (B, Lm + sum Lr). A null
    row adds ids at its table's offset with value 0: no score, no
    gradient."""
    ids_parts, vals_parts = [batch.main_ids], [batch.main_vals]
    for r, t in enumerate(tables):
        k = batch.keys[:, r].long()
        ids_parts.append(t.ids.index_select(0, k) + t.offset)
        vals_parts.append(t.vals.index_select(0, k))
    return SparseBatch(ids=torch.cat(ids_parts, dim=1),
                       vals=torch.cat(vals_parts, dim=1), y=batch.y,
                       mask=batch.mask)


def relational_batch_iterator(ds: RelationalDataset, batch_size: int, *,
                              device, shuffle: bool = False, seed: int = 0,
                              epoch: int = 0, drop_remainder: bool = False
                              ) -> Iterator[RelationalBatch]:
    """Fixed-shape RelationalBatches on ``device``, shuffled per epoch in
    the JAX package's (seed, epoch) order; the tail batch is padded (its
    padding rows key every table's null row) and masked, or dropped with
    ``drop_remainder``."""
    n = ds.num_examples
    order = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        rng.shuffle(order)
    null_keys = np.asarray([t.num_rows - 1 for t in ds.tables], np.int32)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        b = len(idx)
        if b < batch_size and drop_remainder:
            return
        pad = batch_size - b
        mask = np.arange(batch_size) < b
        main_ids = np.concatenate([ds.main_ids[idx], np.zeros(
            (pad, ds.main_ids.shape[1]), np.int32)])
        main_vals = np.concatenate([ds.main_vals[idx], np.zeros(
            (pad, ds.main_vals.shape[1]), np.float32)])
        y = np.concatenate([ds.y[idx], np.zeros((pad,), np.float32)])
        keys = np.concatenate([ds.keys[idx], np.broadcast_to(
            null_keys, (pad, len(null_keys)))]).astype(np.int32)
        yield RelationalBatch(
            main_ids=torch.as_tensor(main_ids, device=device),
            main_vals=torch.as_tensor(main_vals, device=device),
            y=torch.as_tensor(y, device=device),
            keys=torch.as_tensor(keys, device=device),
            mask=torch.as_tensor(mask, device=device))


def tables_to_device(tables: Sequence[RelationTable], *,
                     device) -> Tuple[RelationTable, ...]:
    """The relation tables copied to ``device`` once, before the loop."""
    return tuple(RelationTable(ids=torch.as_tensor(np.asarray(t.ids),
                                                   device=device),
                               vals=torch.as_tensor(np.asarray(t.vals),
                                                    device=device),
                               offset=t.offset) for t in tables)


def relational_update_path(cfg: FMConfig, sgd_cfg: SGDConfig) -> str:
    """The update path of the SGD step on composed batches: a pinned
    ``update_path`` as it is; under "auto" "direct" below 2^16 features,
    as the JAX package picks, and "dedup" from 2^16 up, on device plans.

    The JAX package resolves "auto" by its plain-dataset policy, which
    from 2^16 features names a fused-record path that its relational step
    cannot take, so ``train_sgd_relational`` raises there at any real size
    (``sparkfm_tpu/solvers/sgd.py:208-274``); "dedup" is that policy's
    own last fallback."""
    if sgd_cfg.update_path != "auto":
        return sgd_cfg.update_path
    return "direct" if cfg.num_features < (1 << 16) else "dedup"


def make_relational_train_step(cfg: FMConfig, sgd_cfg: SGDConfig):
    """(state, RelationalBatch, tables) -> (state, aux): the SGD step of
    :func:`relational_update_path` on the composed batch (the direct and
    dedup steps, ``solvers/sgd.py::make_train_step``, with B1, B6 and B2
    on the card). A fused-record path pinned by name raises the JAX
    package's ``ValueError``. The state is updated in place; "dedup"
    needs it padded (``sgd.pad_state_for_dedup``)."""
    from sparkfm_tpu_torch.solvers import sgd as sgd_solver
    base = sgd_solver.make_train_step(cfg, dataclasses.replace(
        sgd_cfg, update_path=relational_update_path(cfg, sgd_cfg)))

    def step(state, rbatch: RelationalBatch, tables):
        return base(state, compose_batch(rbatch, tables))

    return step


def make_relational_score_fn(cfg: FMConfig):
    """(params, RelationalBatch, tables) -> (B,) raw scores of the composed
    batch (``models/fm.py::scores``)."""
    from sparkfm_tpu_torch.models import fm as fm_model

    def score(params, rbatch: RelationalBatch, tables):
        full = compose_batch(rbatch, tables)
        return fm_model.scores(params, cfg, full.ids, full.vals)

    return score
