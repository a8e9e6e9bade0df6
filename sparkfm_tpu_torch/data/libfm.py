"""libFM-format text I/O. Port of ``sparkfm_tpu/data/libfm.py``.

Format, per line:  ``<label> <idx>:<value> <idx>:<value> ...``, 0-based
indices in both directions and values at full precision (the reference's
FMUtils reads 0-based but writes 1-based and truncates values). Lines
starting with '#' and blank lines are skipped.

:func:`load_libfm` takes the native parser (``native/libfm_parser.cpp``
through ``data/native_io.py``) when it builds, and the Python parser
below otherwise; both give the same arrays.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from sparkfm_tpu_torch.data import native_io
from sparkfm_tpu_torch.data.batching import SparseDataset


def _parse_lines_python(path: str):
    labels, idx_rows, val_rows = [], [], []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            ids = np.empty(len(parts) - 1, np.int32)
            vls = np.empty(len(parts) - 1, np.float32)
            for k, tok in enumerate(parts[1:]):
                i, _, v = tok.partition(":")
                ids[k] = int(i)
                vls[k] = float(v)
            idx_rows.append(ids)
            val_rows.append(vls)
    return labels, idx_rows, val_rows


def load_libfm(path: str, num_features: int = -1,
               max_nnz: Optional[int] = None) -> SparseDataset:
    """Load a libFM file into a padded SparseDataset.

    Args:
      num_features: feature-space dimension; if <= 0, inferred as
        max index + 1 (reference infers the same way: FMUtils.scala:40-47).
      max_nnz: padding budget; default = max row nnz (lossless).
    """
    parsed = native_io.parse_libfm_padded(path, max_nnz=max_nnz)
    if parsed is not None:
        # Native fast path: arrays arrive already padded — no per-row loop.
        y, ids, vals, max_idx = parsed
        if len(y) == 0:
            raise ValueError(f"no examples in {path}")
        if num_features <= 0:
            num_features = max_idx + 1
        return SparseDataset(ids=ids, vals=vals, y=y,
                             num_features=num_features)
    labels, idx_rows, val_rows = _parse_lines_python(path)
    n = len(labels)
    if n == 0:
        raise ValueError(f"no examples in {path}")
    if max_nnz is None:
        max_nnz = max(1, max(len(r) for r in idx_rows))
    if num_features <= 0:
        num_features = 1 + max((int(r.max()) for r in idx_rows if len(r)),
                               default=0)
    ids = np.zeros((n, max_nnz), np.int32)
    vals = np.zeros((n, max_nnz), np.float32)
    y = np.asarray(labels, np.float32)
    for i, (r, v) in enumerate(zip(idx_rows, val_rows)):
        k = min(len(r), max_nnz)
        ids[i, :k] = r[:k]
        vals[i, :k] = v[:k]
    return SparseDataset(ids=ids, vals=vals, y=y, num_features=num_features)


def save_libfm(ds: SparseDataset, path: str) -> None:
    """Write a SparseDataset in libFM format (0-based, full precision).

    Padding slots (val == 0) are omitted, matching sparse semantics.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for i in range(ds.num_examples):
            toks = [repr(float(ds.y[i]))]
            row_ids = ds.ids[i]
            row_vals = ds.vals[i]
            for j in range(len(row_ids)):
                v = float(row_vals[j])
                if v != 0.0:
                    toks.append(f"{int(row_ids[j])}:{v!r}")
            f.write(" ".join(toks) + "\n")
