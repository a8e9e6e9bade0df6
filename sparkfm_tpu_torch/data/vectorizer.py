"""Schema-driven vectorization: raw delimited text -> padded-CSR datasets.
Port of ``sparkfm_tpu/data/vectorizer.py`` (numpy only, so a copy).

Same pipeline as the reference's StandardVectorizor / RelationVectorizor:
identify target vs. inputs, drop malformed rows, learn per-column
vocabularies, emit one concatenated sparse block per column with a running
offset. fit and transform are separate phases, vocabularies are assigned
in sorted order (so the same rows give the same vocabulary, and the same
libFM file, in both packages), unseen categorical values go to a
per-column OOV bucket, and strings hash through ``zlib.crc32``.

Relation joins: a side table vectorized once, keyed by its Target
column, and spliced in place of the main table's join-key column, either
materialized (:meth:`RelationVectorizer.transform`) or in block-structure
form (:meth:`RelationVectorizer.transform_relational`: the tables apart,
each example with its row keys, ``data/relational.py``).
"""

from __future__ import annotations

import json
import logging
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from sparkfm_tpu_torch.data.batching import SparseDataset, pack_examples
from sparkfm_tpu_torch.data.schema import (Column, ColumnKind, Schema,
                                           target_index)

log = logging.getLogger("sparkfm_tpu_torch")


def _stable_hash(s: str, buckets: int) -> int:
    """Deterministic string->bucket hash (crc32; stable across processes,
    unlike Python's salted hash())."""
    return zlib.crc32(s.encode("utf-8")) % buckets


class Vectorizer:
    """Fits per-column vocabularies and maps raw rows to sparse features.

    Usage::

        vec = Vectorizer([Target(), Identity("user"), Identity("item")])
        train = vec.fit_transform(read_delimited(path, "::"))
        test = vec.transform(test_rows)
    """

    def __init__(self, schema: Schema):
        self.schema: List[Column] = list(schema)
        self.target_col = target_index(self.schema)
        # col index -> {value: local_index}
        self.vocabs: Dict[int, Dict[str, int]] = {}
        # col index -> block dimension (post-fit)
        self.block_dims: Dict[int, int] = {}
        # col index -> offset of the column's block in the concatenated space
        self.offsets: Dict[int, int] = {}
        self.dimension: int = 0
        self.fitted = False
        self.rows_dropped = 0

    # -- fit ---------------------------------------------------------------

    def _vocab_columns(self) -> List[int]:
        return [i for i, c in enumerate(self.schema)
                if c.kind in (ColumnKind.IDENTITY, ColumnKind.LIST)
                and not self._has_relation(i)]

    def _has_relation(self, col: int) -> bool:
        return False  # RelationVectorizer overrides

    def fit(self, rows: Iterable[Sequence[str]]) -> "Vectorizer":
        """One pass over the data to learn vocabularies and block layout.

        Malformed rows (wrong arity) are skipped, mirroring the reference's
        `features.size == definition.size` filter
        (StandardVectorizor.scala:12).
        """
        ncols = len(self.schema)
        values: Dict[int, set] = {i: set() for i in self._vocab_columns()}
        for row in rows:
            if len(row) != ncols:
                continue
            for i in values:
                col = self.schema[i]
                if col.kind == ColumnKind.IDENTITY:
                    values[i].add(row[i])
                else:  # LIST
                    for part in row[i].split(col.separator):
                        if part:
                            values[i].add(part)
        for i, vals in values.items():
            # Sorted assignment: deterministic, unlike the reference's
            # partition-order zipWithIndex (StandardVectorizor.scala:36).
            self.vocabs[i] = {v: j for j, v in enumerate(sorted(vals))}
        self._finalize_layout()
        return self

    def _column_dim(self, i: int) -> int:
        col = self.schema[i]
        if col.kind in (ColumnKind.TARGET, ColumnKind.IGNORED):
            return 0
        if col.kind in (ColumnKind.IDENTITY, ColumnKind.LIST):
            return len(self.vocabs.get(i, {})) + (1 if col.oov else 0)
        if col.kind == ColumnKind.NUMBER:
            return 1
        if col.kind == ColumnKind.HASHED:
            return col.num_buckets
        raise AssertionError(col.kind)

    def _finalize_layout(self) -> None:
        off = 0
        for i in range(len(self.schema)):
            self.block_dims[i] = self._column_dim(i)
            self.offsets[i] = off
            off += self.block_dims[i]
        self.dimension = off
        self.fitted = True

    # -- transform ---------------------------------------------------------

    def _cell_features(self, i: int, cell: str
                       ) -> Tuple[List[int], List[float]]:
        """Local (indices, values) for one cell of column i."""
        col = self.schema[i]
        if col.kind == ColumnKind.IDENTITY:
            vocab = self.vocabs[i]
            idx = vocab.get(cell)
            if idx is None:
                if not col.oov:
                    return [], []
                idx = len(vocab)
            return [idx], [1.0]
        if col.kind == ColumnKind.LIST:
            vocab = self.vocabs[i]
            parts = [p for p in cell.split(col.separator) if p]
            ids: List[int] = []
            for p in parts:
                idx = vocab.get(p)
                if idx is None:
                    if not col.oov:
                        continue
                    idx = len(vocab)
                ids.append(idx)
            if not ids:
                return [], []
            # Reference `distribution`: each element weighted 1/len
            # (DataNode.scala:48-50).
            wt = 1.0 / len(ids) if col.normalize else 1.0
            return ids, [wt] * len(ids)
        if col.kind == ColumnKind.NUMBER:
            try:
                v = col.transform(cell)
            except ValueError:
                return [], []
            if v == 0.0:
                return [], []
            return [0], [v]
        if col.kind == ColumnKind.HASHED:
            return [_stable_hash(cell, col.num_buckets)], [1.0]
        return [], []  # TARGET / IGNORED

    def _row_features(self, row: Sequence[str]
                      ) -> Tuple[float, List[int], List[float]]:
        y = self.schema[self.target_col].transform(row[self.target_col])
        ids: List[int] = []
        vals: List[float] = []
        for i in range(len(self.schema)):
            if self.block_dims[i] == 0:
                continue
            lids, lvals = self._cell_features(i, row[i])
            off = self.offsets[i]
            ids.extend(off + j for j in lids)
            vals.extend(lvals)
        return y, ids, vals

    def transform(self, rows: Iterable[Sequence[str]],
                  max_nnz: Optional[int] = None) -> SparseDataset:
        """Map raw rows through the fitted schema into a SparseDataset."""
        if not self.fitted:
            raise RuntimeError("call fit() (or fit_transform) first")
        ncols = len(self.schema)
        packed = []
        dropped = 0
        for row in rows:
            if len(row) != ncols:
                dropped += 1
                continue
            try:
                y, ids, vals = self._row_features(row)
            except ValueError:
                dropped += 1   # unparseable target
                continue
            packed.append((y, np.asarray(ids, np.int64),
                           np.asarray(vals, np.float64)))
        self.rows_dropped = dropped
        if dropped:
            log.info("vectorizer: dropped %d malformed rows", dropped)
        return pack_examples(packed, num_features=self.dimension,
                             max_nnz=max_nnz)

    def fit_transform(self, rows: Iterable[Sequence[str]],
                      max_nnz: Optional[int] = None) -> SparseDataset:
        rows = [list(r) for r in rows]
        return self.fit(rows).transform(rows, max_nnz=max_nnz)

    # -- persistence -------------------------------------------------------

    def save_vocab(self, path: str) -> None:
        """Persist fitted state (vocabs + layout) as JSON for serving."""
        state = {
            "vocabs": {str(i): v for i, v in self.vocabs.items()},
            "block_dims": {str(i): d for i, d in self.block_dims.items()},
            "offsets": {str(i): o for i, o in self.offsets.items()},
            "dimension": self.dimension,
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(state, f)

    def load_vocab(self, path: str) -> "Vectorizer":
        with open(path, "r", encoding="utf-8") as f:
            state = json.load(f)
        self.vocabs = {int(i): v for i, v in state["vocabs"].items()}
        self.block_dims = {int(i): d for i, d in state["block_dims"].items()}
        self.offsets = {int(i): o for i, o in state["offsets"].items()}
        self.dimension = state["dimension"]
        self.fitted = True
        return self


class RelationVectorizer(Vectorizer):
    """Vectorizer with side-table joins spliced into the feature space.

    Reference parity: RelationVectorizor.addRelation fully vectorizes a side
    table and keys it by the relation's Target column
    (RelationVectorizor.scala:17-29); at transform time the join-key cell of
    the main table is replaced by the relation's feature block
    (RelationVectorizor.scala:31-42). Differences by design:

      * join keys are raw strings (the reference funnels them through the
        numeric Target transform);
      * a key with no relation row yields an empty block instead of a crash;
      * the relation block's internal layout comes from a plain fitted
        Vectorizer, so relation schemas compose recursively.
    """

    def __init__(self, schema: Schema):
        super().__init__(schema)
        # main col index -> (fitted relation Vectorizer, key->(ids, vals))
        self.relations: Dict[int, Tuple[Vectorizer, Dict[str, tuple]]] = {}

    def _has_relation(self, col: int) -> bool:
        return col in self.relations

    def add_relation(self, rows: Iterable[Sequence[str]],
                     relation_schema: Schema,
                     join_column: int) -> "RelationVectorizer":
        """Vectorize a relation table and attach it to a main-table column.

        Args:
          rows: the relation's raw rows.
          relation_schema: schema whose Target column holds the join key.
          join_column: index of the main-table column holding join keys.
        """
        if not (0 <= join_column < len(self.schema)):
            raise ValueError(f"join_column {join_column} out of range")
        if join_column == self.target_col:
            raise ValueError("cannot join on the target column")
        rows = [list(r) for r in rows]
        rv = Vectorizer(relation_schema)
        rv.fit(rows)
        key_col = rv.target_col
        mapping: Dict[str, tuple] = {}
        ncols = len(relation_schema)
        for row in rows:
            if len(row) != ncols:
                continue
            ids: List[int] = []
            vals: List[float] = []
            for i in range(ncols):
                if rv.block_dims[i] == 0:
                    continue
                lids, lvals = rv._cell_features(i, row[i])
                ids.extend(rv.offsets[i] + j for j in lids)
                vals.extend(lvals)
            mapping[row[key_col]] = (np.asarray(ids, np.int64),
                                     np.asarray(vals, np.float64))
        self.relations[join_column] = (rv, mapping)
        self.fitted = False  # layout must be recomputed
        return self

    def _column_dim(self, i: int) -> int:
        if i in self.relations:
            # Splice: this column's block IS the relation's feature space
            # (RelationVectorizor.computeDimension, :44-46).
            return self.relations[i][0].dimension
        return super()._column_dim(i)

    def _cell_features(self, i: int, cell: str):
        if i in self.relations:
            _, mapping = self.relations[i]
            hit = mapping.get(cell)
            if hit is None:
                return [], []
            ids, vals = hit
            return list(ids), list(vals)
        return super()._cell_features(i, cell)

    # -- block-structure output (Method 2: no materialization) -------------

    def transform_relational(self, rows: Iterable[Sequence[str]],
                             max_nnz: Optional[int] = None):
        """Map rows to a ``data/relational.py::RelationalDataset``: each
        relation stays one padded table (its keys in sorted order, then
        the null row), and each example carries its row key per relation
        (a missed join keys the null row). The feature space is
        :meth:`transform`'s, so both forms score alike."""
        from sparkfm_tpu_torch.data.relational import (RelationalDataset,
                                                       RelationTable)
        if not self.fitted:
            raise RuntimeError("call fit() first")
        rel_cols = sorted(self.relations)

        tables: List[RelationTable] = []
        key_to_row: List[Dict[str, int]] = []
        for c in rel_cols:
            _, mapping = self.relations[c]
            keys = sorted(mapping)
            lr = max(max((len(mapping[k][0]) for k in keys), default=1), 1)
            tids = np.zeros((len(keys) + 1, lr), np.int32)
            tvals = np.zeros((len(keys) + 1, lr), np.float32)
            for r, k in enumerate(keys):
                ids, vals = mapping[k]
                n = min(len(ids), lr)
                tids[r, :n] = ids[:n]
                tvals[r, :n] = vals[:n]
            tables.append(RelationTable(ids=tids, vals=tvals,
                                        offset=self.offsets[c]))
            key_to_row.append({k: r for r, k in enumerate(keys)})

        ncols = len(self.schema)
        packed = []
        all_keys: List[List[int]] = []
        dropped = 0
        for row in rows:
            if len(row) != ncols:
                dropped += 1
                continue
            try:
                y = self.schema[self.target_col].transform(
                    row[self.target_col])
            except ValueError:
                dropped += 1
                continue
            ids: List[int] = []
            vals: List[float] = []
            for i in range(ncols):
                if self.block_dims[i] == 0 or i in self.relations:
                    continue
                lids, lvals = self._cell_features(i, row[i])
                ids.extend(self.offsets[i] + j for j in lids)
                vals.extend(lvals)
            packed.append((y, np.asarray(ids, np.int64),
                           np.asarray(vals, np.float64)))
            all_keys.append([key_to_row[r].get(row[c], len(key_to_row[r]))
                             for r, c in enumerate(rel_cols)])
        self.rows_dropped = dropped
        main = pack_examples(packed, num_features=self.dimension,
                             max_nnz=max_nnz)
        return RelationalDataset(
            main_ids=main.ids, main_vals=main.vals, y=main.y,
            keys=np.asarray(all_keys, np.int32).reshape(
                len(packed), len(rel_cols)),
            tables=tuple(tables), num_features=self.dimension)


def feature_groups_of(vec: "Vectorizer") -> tuple:
    """Per-feature attribute-group ids from a fitted vectorizer: one group
    per source column (the reference's Metadata attribute->group mapping,
    fm/bs/Metadata.scala:8-29, built automatically from the schema layout
    instead of by hand). Feed to FMConfig(feature_groups=...) for
    per-group regularization (ALS/SGD) and per-group hyperpriors (MCMC).
    """
    if not vec.offsets:
        raise ValueError("vectorizer is not fitted (no layout)")
    groups = np.zeros((vec.dimension,), np.int32)
    # offsets map column -> block start; blocks are contiguous, so group
    # boundaries are the sorted offsets.
    cols = sorted(vec.offsets, key=lambda i: vec.offsets[i])
    for g, col in enumerate(cols):
        start = vec.offsets[col]
        end = (vec.offsets[cols[g + 1]] if g + 1 < len(cols)
               else vec.dimension)
        groups[start:end] = g
    return tuple(int(x) for x in groups)
