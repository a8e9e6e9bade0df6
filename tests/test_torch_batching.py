"""The port's batch_iterator against the JAX package's, element for
element: shuffle order over epochs, drop_remainder, ladder and fixed
budgets, and every plan array (uids, ranks, count, overflow and the
id-sorted order/seg/svals/sex that the hybrid step reads). Both iterators
are numpy underneath, so everything must be equal exactly."""

import numpy as np
import pytest
import torch

from sparkfm_tpu.data import batching as jbatching
from sparkfm_tpu.data import synth as jsynth
from sparkfm_tpu_torch.data import batching as pbatching
from sparkfm_tpu_torch.data import synth as psynth

torch.set_num_threads(1)
F = 1 << 16
PLAN_FIELDS = ("uids", "ranks", "count", "overflow", "order", "seg",
               "svals", "sex")


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_examples=700, num_fields=6, num_buckets=F, seed=3)
    return jsynth.synth_ctr(**kw), psynth.synth_ctr(**kw)


def _assert_same(got, want, plans):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ("ids", "vals", "y", "mask", "field_ids"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)),
                                          err_msg=f)
        if not plans:
            assert g.plan is None and w.plan is None
            continue
        for f in PLAN_FIELDS:
            gv, wv = getattr(g.plan, f), getattr(w.plan, f)
            gv = gv.numpy() if isinstance(gv, torch.Tensor) else gv
            np.testing.assert_array_equal(np.asarray(gv), np.asarray(wv),
                                          err_msg=f)
            assert np.asarray(gv).dtype == np.asarray(wv).dtype, f


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("budget", [None, "ladder", 1024])
def test_shuffled_epochs_match_jax(datasets, drop_remainder, budget):
    ds, pds = datasets
    orders = []
    for epoch in (0, 1):
        kw = dict(shuffle=True, seed=11, epoch=epoch,
                  drop_remainder=drop_remainder, dedup_budget=budget,
                  dedup_fill=F)
        want = list(jbatching.batch_iterator(ds, 128, **kw))
        got = list(pbatching.batch_iterator(pds, 128, device="cpu", **kw))
        assert len(got) == (5 if drop_remainder else 6)
        _assert_same(got, want, plans=budget is not None)
        orders.append(np.concatenate([b.ids.numpy() for b in got]))
    assert not np.array_equal(orders[0], orders[1])   # epochs differ


def test_unshuffled_tail_is_padded_and_masked(datasets):
    ds, pds = datasets
    kw = dict(dedup_budget="ladder", dedup_fill=F)
    want = list(jbatching.batch_iterator(ds, 256, **kw))
    got = list(pbatching.batch_iterator(pds, 256, device="cpu", **kw))
    _assert_same(got, want, plans=True)
    tail = got[-1]
    assert int(tail.mask.sum()) == 700 - 512
    assert float(tail.vals[~tail.mask].abs().sum()) == 0.0
    # the sorted payloads agree with the natural-order batch
    p = tail.plan
    flat_ids = tail.ids.reshape(-1)
    np.testing.assert_array_equal(p.svals.numpy(),
                                  tail.vals.reshape(-1)[p.order].numpy())
    np.testing.assert_array_equal(p.sex.numpy(), (p.order // 6).numpy())
    np.testing.assert_array_equal(p.uids[p.seg].numpy(),
                                  flat_ids[p.order].numpy())


def test_fixed_budget_overflow_matches_jax(datasets):
    ds, pds = datasets
    kw = dict(dedup_budget=64, dedup_fill=F)
    want = list(jbatching.batch_iterator(ds, 128, **kw))
    got = list(pbatching.batch_iterator(pds, 128, device="cpu", **kw))
    _assert_same(got, want, plans=True)
    assert all(bool(b.plan.overflow) for b in got)
    assert all(b.plan.uids.shape == (64,) for b in got)


@pytest.mark.parametrize("budget", ["fixed", 0, -5, True, 12.5])
def test_bad_budget_raises(datasets, budget):
    _, pds = datasets
    with pytest.raises(ValueError, match="ladder"):
        next(pbatching.batch_iterator(pds, 128, device="cpu",
                                      dedup_budget=budget, dedup_fill=F))
