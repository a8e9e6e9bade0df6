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


@pytest.mark.parametrize("buckets,fields", [(1 << 10, 16), (1000, 7),
                                            (39, 39)])
def test_field_of_feature_map_matches_jax(buckets, fields):
    got = psynth.field_of_feature_map(buckets, fields)
    want = jsynth.field_of_feature_map(buckets, fields)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    ds = psynth.synth_ctr(num_examples=64, num_fields=fields,
                          num_buckets=buckets, seed=1)
    np.testing.assert_array_equal(got[ds.ids], ds.field_ids)


@pytest.mark.parametrize("fields", [False, True])
def test_to_device_arrays_matches_jax(fields):
    ds = psynth.synth_ctr(num_examples=50, num_fields=4, num_buckets=64,
                          seed=2)
    if not fields:
        ds.field_ids = None
    got = pbatching.to_device_arrays(ds, device="cpu")
    want = jbatching.to_device_arrays(ds)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].device.type == "cpu"
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(arr),
                                      err_msg=name)


@pytest.mark.parametrize("budget", [None, "ladder"])
def test_pinned_batches_and_plans_equal_pageable_ones(datasets, budget):
    """batch_iterator(pinned=True), the feed of the grouped hybrid steps
    and of DeepFM, yields the batches and host plans of pinned=False,
    tail included, with each plan's count a 0-d host tensor (which a
    graph's feed copies without blocking) where pinned=False leaves a
    number. The pinning itself needs a card: tests/test_torch_cuda.py
    holds the pinned copies to the pageable ones there."""
    _, pds = datasets
    kw = dict(shuffle=True, seed=5, epoch=2, dedup_budget=budget,
              dedup_fill=F)
    got = list(pbatching.batch_iterator(pds, 128, device="cpu", pinned=True,
                                        **kw))
    want = list(pbatching.batch_iterator(pds, 128, device="cpu", **kw))
    assert len(got) == 6
    _assert_same(got, want, plans=budget is not None)
    for g, w in zip(got, want):
        if budget is not None:
            assert torch.is_tensor(g.plan.count) and g.plan.count.ndim == 0
            assert g.plan.count.device.type == "cpu"
            assert not torch.is_tensor(w.plan.count)
