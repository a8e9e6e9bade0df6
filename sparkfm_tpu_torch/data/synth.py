"""Synthetic datasets: low-rank MovieLens-style ratings and hashed
power-law CTR data (Criteo/Avazu shape). Port of
``sparkfm_tpu/data/synth.py`` (``synth_movielens``, ``synth_ctr``,
``field_of_feature_map``); numpy only, so the same seed gives the same
arrays in both packages."""

from __future__ import annotations

import numpy as np

from sparkfm_tpu_torch.data.batching import SparseDataset


def synth_movielens(num_users: int = 200, num_items: int = 300,
                    num_examples: int = 20000, rank: int = 4,
                    noise: float = 0.1, seed: int = 0,
                    rating_range: tuple = (1.0, 5.0)) -> SparseDataset:
    """Low-rank ratings y = mu + b_u + b_i + <p_u, q_i> + noise, clipped to
    ``rating_range``. Two one-hot features per example: the user (ids
    [0, num_users)) and the item (ids [num_users, num_users + num_items))."""
    rng = np.random.default_rng(seed)
    mu = (rating_range[0] + rating_range[1]) / 2.0
    bu = 0.3 * rng.normal(size=num_users)
    bi = 0.3 * rng.normal(size=num_items)
    p = rng.normal(size=(num_users, rank)) / np.sqrt(rank)
    q = rng.normal(size=(num_items, rank)) / np.sqrt(rank)

    users = rng.integers(0, num_users, num_examples)
    items = rng.integers(0, num_items, num_examples)
    y = (mu + bu[users] + bi[items]
         + np.einsum("nk,nk->n", p[users], q[items])
         + noise * rng.normal(size=num_examples))
    y = np.clip(y, rating_range[0], rating_range[1]).astype(np.float32)

    ids = np.stack([users, num_users + items], axis=1).astype(np.int32)
    vals = np.ones((num_examples, 2), np.float32)
    return SparseDataset(ids=ids, vals=vals, y=y,
                         num_features=num_users + num_items)


def synth_ctr(num_examples: int = 100000, num_fields: int = 16,
              num_buckets: int = 1 << 18, seed: int = 0, zipf_a: float = 1.3,
              label_range: tuple = (0.0, 1.0)) -> SparseDataset:
    """Each example has one active feature per field, drawn from a Zipf
    distribution over the field's bucket range; labels are Bernoulli from
    a planted logistic FM on a small projected space."""
    rng = np.random.default_rng(seed)
    per_field = num_buckets // num_fields
    raw = rng.zipf(zipf_a, size=(num_examples, num_fields)) - 1
    raw = raw % per_field
    offsets = (np.arange(num_fields) * per_field)[None, :]
    ids = (raw + offsets).astype(np.int32)
    vals = np.ones((num_examples, num_fields), np.float32)

    k, proj_dim = 8, 512
    proj = (ids.astype(np.int64) * 2654435761) % proj_dim
    w_small = rng.normal(size=proj_dim)
    v_small = 0.5 * rng.normal(size=(proj_dim, k)) / np.sqrt(k)
    lin = w_small[proj].sum(axis=1)
    s = v_small[proj].sum(axis=1)
    sq = np.square(v_small[proj]).sum(axis=(1, 2))
    score = lin + 0.5 * (np.square(s).sum(axis=1) - sq)
    score = score - np.mean(score)
    prob = 1.0 / (1.0 + np.exp(-score))
    y = (rng.random(num_examples) < prob).astype(np.float32)
    if label_range == (-1.0, 1.0):
        y = 2.0 * y - 1.0

    field_ids = np.broadcast_to(np.arange(num_fields, dtype=np.int32),
                                (num_examples, num_fields)).copy()
    return SparseDataset(ids=ids, vals=vals, y=y, num_features=num_buckets,
                         field_ids=field_ids)


def field_of_feature_map(num_buckets: int, num_fields: int) -> np.ndarray:
    """(F,) int32 feature -> field map of :func:`synth_ctr`'s layout: field
    f owns the bucket range [f * (F // num_fields), (f + 1) * ...), and the
    remainder buckets go to the last field."""
    per_field = num_buckets // num_fields
    f = np.minimum(np.arange(num_buckets) // per_field, num_fields - 1)
    return f.astype(np.int32)
