"""Real-dataset loaders: MovieLens rating files, Criteo and Avazu CTR
files. Port of ``sparkfm_tpu/data/datasets.py`` (numpy only, so a copy:
the same file gives the same arrays in both packages).

  * MovieLens 100K   — `u.data`, tab-separated  user item rating ts
  * MovieLens 1M/10M — `ratings.dat`, `::`-separated  user::item::rating::ts
  * MovieLens 20M/25M — `ratings.csv`, comma-separated with a header row
  * Criteo Kaggle CTR — `train.txt`: label \t 13 integer \t 26 categorical
                        (hex strings), tab-separated, empty = missing
  * Avazu CTR        — `train.csv`, comma + header: id,click,hour,21 cats

The tests run the loaders on fixture files in the exact on-disk formats
(``tests/fixtures/``).
"""

from __future__ import annotations

import csv
import os
import zlib
from typing import Iterator, Optional, Sequence

import numpy as np

from sparkfm_tpu_torch.data.batching import SparseDataset
from sparkfm_tpu_torch.data.schema import (Column, Identity, Ignored, Target,
                                           read_delimited)
from sparkfm_tpu_torch.data.vectorizer import (RelationVectorizer,
                                               Vectorizer)


# ---------------------------------------------------------------------------
# MovieLens

def _detect_movielens(path: str) -> tuple:
    """Return (ratings_path, separator, has_header) for a MovieLens file or
    directory (100K `u.data` tab / 1M-10M `ratings.dat` :: /
    20M-25M `ratings.csv` comma+header)."""
    if os.path.isdir(path):
        for name, sep, hdr in (("ratings.dat", "::", False),
                               ("u.data", "\t", False),
                               ("ratings.csv", ",", True)):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                return cand, sep, hdr
        raise FileNotFoundError(
            f"no ratings.dat / u.data / ratings.csv under {path}")
    if path.endswith(".csv"):
        return path, ",", True
    if path.endswith("u.data") or path.endswith(".tsv"):
        return path, "\t", False
    return path, "::", False


def movielens_rating_rows(path: str) -> Iterator[list]:
    """Yield [user, item, rating, timestamp] string rows from any MovieLens
    ratings file (format auto-detected; header skipped for CSV)."""
    fpath, sep, has_header = _detect_movielens(path)
    it = read_delimited(fpath, sep)
    if has_header:
        it = iter(it)
        next(it, None)
    for row in it:
        if len(row) >= 3:
            yield row[:4] if len(row) >= 4 else row[:3] + ["0"]


def movielens_schema() -> Sequence[Column]:
    """user/item one-hot + rating target (+ ignored timestamp): the exact
    encoding the reference's vectorizor builds for its canonical eval
    (user and movie Identity columns, rating Target)."""
    return [Identity("user"), Identity("item"), Target("rating"),
            Ignored("timestamp")]


def load_movielens(path: str, max_examples: Optional[int] = None,
                   vectorizer: Optional[Vectorizer] = None
                   ) -> tuple:
    """Real MovieLens ratings -> (SparseDataset, fitted Vectorizer).

    Pass a fitted ``vectorizer`` to transform held-out rows with the
    training vocabularies (unseen users/items go to the OOV buckets).
    """
    rows = list(movielens_rating_rows(path))
    if max_examples is not None:
        rows = rows[:max_examples]
    if vectorizer is None:
        vectorizer = Vectorizer(movielens_schema())
        ds = vectorizer.fit_transform(rows)
    else:
        ds = vectorizer.transform(rows)
    return ds, vectorizer


def load_movielens_relational(directory: str,
                              max_examples: Optional[int] = None
                              ) -> tuple:
    """The ratings joined with the users.dat side table (MovieLens-1M
    layout): gender, age and occupation one-hot, zip ignored. Returns
    (SparseDataset, fitted RelationVectorizer); the vectorizer's
    ``transform_relational`` gives the block-structure form of the same
    rows."""
    ratings = os.path.join(directory, "ratings.dat")
    users = os.path.join(directory, "users.dat")
    if not (os.path.exists(ratings) and os.path.exists(users)):
        raise FileNotFoundError(
            f"need ratings.dat and users.dat under {directory} "
            "(MovieLens-1M layout)")
    vec = RelationVectorizer(
        [Identity("user"), Identity("item"), Target("rating"),
         Ignored("timestamp")])
    vec.add_relation(
        read_delimited(users, "::"),
        [Target("user_id"), Identity("gender"), Identity("age"),
         Identity("occupation"), Ignored("zip")],
        join_column=0)
    rows = list(read_delimited(ratings, "::"))
    if max_examples is not None:
        rows = rows[:max_examples]
    ds = vec.fit_transform(rows)
    return ds, vec


# ---------------------------------------------------------------------------
# Criteo

_CRITEO_NUM_INTS = 13
_CRITEO_NUM_CATS = 26


def _int_bin(v: str) -> int:
    """Standard Criteo integer-feature binning: floor(log2(x+1)) for x >= 0,
    a dedicated negative bin, and a missing bin for empty cells. Keeps the
    integer features categorical so the whole example is 39 hashed ids."""
    if v == "":
        return 64            # missing
    x = int(v)
    if x < 0:
        return 65            # negative (I2 can be -1/-2)
    return int(x + 1).bit_length() - 1   # floor(log2(x+1)), 0..~40


def _hash_tokens(tokens: np.ndarray, buckets: int) -> np.ndarray:
    """Vectorized stable 64-bit mix -> [0, buckets). Fibonacci-style
    multiplicative hashing of (field, token) pairs; deterministic across
    processes (unlike Python's salted hash)."""
    h = tokens.astype(np.uint64)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xC4CEB9FE1A85EC53)
    h ^= h >> np.uint64(33)
    return (h % np.uint64(buckets)).astype(np.int32)


def load_criteo_tsv(path: str, num_buckets: int = 1 << 24,
                    max_examples: Optional[int] = None,
                    with_fields: bool = False) -> SparseDataset:
    """Criteo Kaggle `train.txt` -> hashed SparseDataset (BASELINE config 3).

    Each row: label \\t I1..I13 \\t C1..C26 (tab-separated; empty = missing).
    Integer features are log2-binned (:func:`_int_bin`), categorical hex
    strings parsed as 64-bit tokens; every field f contributes exactly one
    hashed id mix(f, token) so nnz = 39 per example with weight 1.0 —
    the fixed-shape padded-CSR layout the TPU step consumes directly.

    ``with_fields=True`` attaches per-slot field ids for FFM (config 4).
    """
    labels, tok_rows = [], []
    n_fields = _CRITEO_NUM_INTS + _CRITEO_NUM_CATS
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) != 1 + n_fields:
                continue        # malformed row: drop (reference behavior,
                                # StandardVectorizor.scala:12)
            labels.append(float(parts[0]))
            toks = np.empty((n_fields,), np.uint64)
            for i in range(_CRITEO_NUM_INTS):
                toks[i] = _int_bin(parts[1 + i])
            for j in range(_CRITEO_NUM_CATS):
                cell = parts[1 + _CRITEO_NUM_INTS + j]
                toks[_CRITEO_NUM_INTS + j] = (
                    int(cell, 16) if cell else 0xFFFFFFFF)
            tok_rows.append(toks)
            if max_examples is not None and len(labels) >= max_examples:
                break
    if not labels:
        raise ValueError(f"no valid Criteo rows in {path}")
    toks = np.stack(tok_rows)                       # (N, 39) u64
    field_salt = (np.arange(n_fields, dtype=np.uint64)
                  * np.uint64(0x9E3779B97F4A7C15))
    ids = _hash_tokens(toks ^ field_salt[None, :], num_buckets)
    n = len(labels)
    return SparseDataset(
        ids=ids, vals=np.ones((n, n_fields), np.float32),
        y=np.asarray(labels, np.float32), num_features=num_buckets,
        field_ids=(np.broadcast_to(
            np.arange(n_fields, dtype=np.int32), (n, n_fields)).copy()
            if with_fields else None))


def load_avazu_csv(path: str, num_buckets: int = 1 << 24,
                   max_examples: Optional[int] = None,
                   with_fields: bool = True) -> SparseDataset:
    """Avazu `train.csv` -> hashed SparseDataset (BASELINE config 4).

    Header: id,click,hour,C1,banner_pos,site_id,...,C21 (24 columns).
    Every column after `click` is treated as categorical and hashed with a
    per-field salt; `id` is dropped. Field ids attach by default (Avazu is
    the FFM config)."""
    labels, tok_rows = [], []
    with open(path, "r", encoding="utf-8", errors="replace", newline="") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        if header is None:
            raise ValueError(f"empty Avazu file {path}")
        try:
            click_col = header.index("click")
        except ValueError:
            raise ValueError("Avazu header must contain 'click'")
        feat_cols = [i for i, name in enumerate(header)
                     if i != click_col and name != "id"]
        for parts in reader:
            if len(parts) != len(header):
                continue
            labels.append(float(parts[click_col]))
            toks = np.array([np.uint64(zlib_crc(parts[c]))
                             for c in feat_cols], np.uint64)
            tok_rows.append(toks)
            if max_examples is not None and len(labels) >= max_examples:
                break
    if not labels:
        raise ValueError(f"no valid Avazu rows in {path}")
    toks = np.stack(tok_rows)
    n_fields = toks.shape[1]
    field_salt = (np.arange(n_fields, dtype=np.uint64)
                  * np.uint64(0x9E3779B97F4A7C15))
    ids = _hash_tokens(toks ^ field_salt[None, :], num_buckets)
    n = len(labels)
    return SparseDataset(
        ids=ids, vals=np.ones((n, n_fields), np.float32),
        y=np.asarray(labels, np.float32), num_features=num_buckets,
        field_ids=(np.broadcast_to(
            np.arange(n_fields, dtype=np.int32), (n, n_fields)).copy()
            if with_fields else None))


def zlib_crc(s: str) -> int:
    return zlib.crc32(s.encode("utf-8"))
