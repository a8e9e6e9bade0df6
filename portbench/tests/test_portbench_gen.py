"""The benchmark's inputs repeat by seed, and its frozen copies agree with
the port at this commit."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.gen import ctr, order, ratings, weights

from conftest import write_tiny

BIG_SEED = 2 ** 31 + 12345


@pytest.fixture
def tiny_configs(tmp_path):
    import json
    spec = write_tiny(str(tmp_path))
    return [json.load(open(tmp_path / c["file"])) for c in spec["configs"]]


def test_ctr_examples_repeat_by_seed(tiny_configs):
    c = tiny_configs[0]
    a = ctr.examples(c, 512, BIG_SEED, "cpu")
    b = ctr.examples(c, 512, BIG_SEED, "cpu")
    other = ctr.examples(c, 512, BIG_SEED + 1, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], other[0])
    ids, vals, y = a
    assert ids.shape == (512, len(ctr.cardinalities(c)))
    assert int(ids.min()) >= 0 and int(ids.max()) < c["num_buckets"]
    assert torch.all(vals == 1.0)
    assert set(torch.unique(y).tolist()) <= {0.0, 1.0}


def test_ctr_fields_follow_their_zipf_law(tiny_configs):
    c = dict(tiny_configs[0], num_buckets=1 << 30)
    ids, _, _ = ctr.examples(c, 20000, 7, "cpu")
    # field 4 (cardinality 7): its head value takes ~1/H(7, 1.3) of draws
    head = torch.mode(ids[:, 4]).values
    share = float((ids[:, 4] == head).float().mean())
    h = sum((r + 1) ** -1.3 for r in range(7))
    assert share == pytest.approx(1 / h, abs=0.02)
    assert len(torch.unique(ids[:, 4])) == 7


def test_ratings_repeat_by_seed(tiny_configs):
    m = tiny_configs[1]
    a = ratings.ratings(m, BIG_SEED, "cpu")
    b = ratings.ratings(m, BIG_SEED, "cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    ids = a[0]
    assert ids[:, 0].max() < m["num_users"]
    assert ids[:, 1].min() >= m["num_users"]
    assert ids[:, 1].max() < m["num_users"] + m["num_movies"]
    assert set(np.unique(a[2]) * 2) <= set(range(1, 11))


def test_ratings_give_every_seed_the_same_counts(tiny_configs):
    m = tiny_configs[1]
    per_seed = []
    for seed in (BIG_SEED, 5):
        ids = ratings.ratings(m, seed, "cpu")[0]
        users = np.bincount(ids[:, 0], minlength=m["num_users"])
        movies = np.bincount(ids[:, 1] - m["num_users"],
                             minlength=m["num_movies"])
        per_seed.append((ids, np.sort(users), np.sort(movies)))
    (a, ua, ma), (b, ub, mb) = per_seed
    np.testing.assert_array_equal(ua, ub)
    np.testing.assert_array_equal(ma, mb)
    assert not np.array_equal(a, b)
    law = m["rating_counts"]
    assert ua.min() == law["users"]["floor"] and ua.max() == law[
        "users"]["first"]
    assert ma.min() >= law["movies"]["floor"]


@pytest.mark.parametrize("side", ["users", "movies"])
def test_rating_laws_hold_their_published_anchors(side):
    import json
    import os
    from conftest import ROOT
    m = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                    "ml25m-als-r32.json")))
    n = m["num_" + side]
    c = ratings.counts(n, m["num_ratings"], m["rating_counts"][side])
    assert c.sum() == m["num_ratings"] and c.size == n
    assert np.all(np.diff(c) <= 0)
    assert c[-1] == m["rating_counts"][side]["floor"]
    for rank, count in m["assumed"]["count_anchors"][side]:
        assert abs(int(c[rank - 1]) - count) <= 1, (rank, c[rank - 1])


def test_rating_law_fit_finds_the_frozen_law():
    pytest.importorskip("scipy")
    s, q = ratings.fit_law(59047, 25000095, 1, ((1, 81491), (10, 58773)))
    assert s == pytest.approx(0.762743, abs=1e-5)
    assert q == pytest.approx(15.8737, abs=1e-3)


def test_ctr_fields_give_every_seed_the_same_values(tiny_configs):
    c = tiny_configs[0]
    a = ctr.examples(c, 4096, BIG_SEED, "cpu")
    b = ctr.examples(c, 4096, 11, "cpu")
    assert not torch.equal(a[0], b[0])
    for f in range(a[0].shape[1]):
        assert torch.equal(torch.sort(a[0][:, f]).values,
                           torch.sort(b[0][:, f]).values)


def test_ctr_labels_hold_the_positive_rate(tiny_configs):
    c = tiny_configs[0]
    rates = [float(ctr.examples(c, 8192, seed, "cpu")[2].mean())
             for seed in (BIG_SEED, 3, 4)]
    for r in rates:
        assert r == pytest.approx(c["positive_rate"], abs=0.015)


def test_batch_order_is_the_ports():
    from sparkfm_tpu_torch.data.batching import SparseDataset, batch_iterator
    n, bsz, seed = 1000, 128, BIG_SEED
    ids = np.arange(n, dtype=np.int32)[:, None]
    ds = SparseDataset(ids=ids, vals=np.ones_like(ids, np.float32),
                       y=np.zeros(n, np.float32), num_features=n)
    for epoch in (0, 3):
        got = [b.ids[:, 0].numpy() for b in batch_iterator(
            ds, bsz, device="cpu", shuffle=True, seed=seed, epoch=epoch,
            drop_remainder=True)]
        for step, g in enumerate(got):
            np.testing.assert_array_equal(
                g, order.batch_rows(n, bsz, seed, epoch, step))


def test_weights_repeat_by_seed():
    a = weights.fm_weights(100, 4, 9, "cpu", v_stdev=0.01)
    b = weights.fm_weights(100, 4, 9, "cpu", v_stdev=0.01)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a[0]) == 0.0 and torch.count_nonzero(a[1]) == 0
    assert float(a[2].std()) == pytest.approx(0.01, rel=0.2)
    assert not torch.equal(a[2], weights.fm_weights(100, 4, 10, "cpu",
                                                    v_stdev=0.01)[2])


def test_sub_seeds_take_large_seeds_and_differ_by_stream():
    a = harness.sub_seed(BIG_SEED, "data")
    assert a == harness.sub_seed(BIG_SEED, "data")
    assert a != harness.sub_seed(BIG_SEED, "weights")
    assert a != harness.sub_seed(BIG_SEED + 1, "data")
    assert 0 <= a < 2 ** 63
    torch.Generator().manual_seed(a)
