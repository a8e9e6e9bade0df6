"""The serving slice end to end: a model trained by the JAX package,
carried into the port, scores and evaluates the same through the port's
FMModel (host ladder plans on a 2^16-row table), and survives a save/load
round trip.

Tolerance rtol 1e-5 (atol 1e-6 on predictions): float32 sums in different
orders."""

import numpy as np
import pytest
import torch

import sparkfm_tpu as jsfm
from sparkfm_tpu.api import _cfg_to_json
from sparkfm_tpu.data import batching as jbatching
from sparkfm_tpu.data import synth as jsynth
from sparkfm_tpu_torch import FMConfig, FMModel, params_from_numpy
from sparkfm_tpu_torch.data import batching as pbatching
from sparkfm_tpu_torch.data import synth as psynth
from sparkfm_tpu_torch.models import fm as pfm
from sparkfm_tpu_torch.ops import embedding as PE
from sparkfm_tpu_torch.ops import rowio

torch.set_num_threads(1)
F = 1 << 16


@pytest.fixture(scope="module", params=["classification", "regression"])
def trained(request):
    """A JAX FM trained for a few SGD steps, and its port."""
    labels = (0.0, 1.0) if request.param == "classification" else (-1.0, 1.0)
    kw = dict(num_examples=1500, num_fields=8, num_buckets=F, seed=0,
              label_range=labels)
    ds = jsynth.synth_ctr(**kw)
    pds = psynth.synth_ctr(**kw)
    jmodel = jsfm.FM(num_factors=4, task=request.param, solver="sgd",
                     max_iter=1, batch_size=256, learning_rate=0.1,
                     reg_v=1e-4).fit(ds)
    p = jmodel.params
    pmodel = FMModel(params=params_from_numpy(
        np.asarray(p.w0), np.asarray(p.w), np.asarray(p.v), device="cpu"),
        cfg=FMConfig.from_json(_cfg_to_json(jmodel.cfg)))
    return ds, pds, jmodel, pmodel


def test_synth_data_is_identical(trained):
    ds, pds, _, _ = trained
    for f in ("ids", "vals", "y", "field_ids"):
        np.testing.assert_array_equal(getattr(pds, f), getattr(ds, f))
    assert pds.num_features == ds.num_features == F


def test_predict_dataset_matches_jax(trained):
    ds, pds, jmodel, pmodel = trained
    want = jmodel.predict_dataset(ds, batch_size=512)   # ragged tail batch
    got = pmodel.predict_dataset(pds, batch_size=512)
    assert got.shape == want.shape == (1500,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pmodel.predict(pds.ids[:40], pds.vals[:40]),
                               want[:40], rtol=1e-5, atol=1e-6)


def test_metrics_match_jax(trained):
    ds, pds, jmodel, pmodel = trained
    for name in ("compute_rmse", "compute_mae", "compute_accuracy"):
        np.testing.assert_allclose(getattr(pmodel, name)(pds),
                                   getattr(jmodel, name)(ds), rtol=1e-5)
    want = jmodel.evaluate(ds, batch_size=512)
    got = pmodel.evaluate(pds, batch_size=512)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_save_load_round_trip(trained, tmp_path):
    ds, pds, jmodel, pmodel = trained
    pmodel.save(str(tmp_path / "model"))
    back = FMModel.load(str(tmp_path / "model"), device="cpu")
    assert back.cfg == pmodel.cfg
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(back.params, name),
                           getattr(pmodel.params, name))
    np.testing.assert_allclose(back.predict_dataset(pds),
                               jmodel.predict_dataset(ds),
                               rtol=1e-5, atol=1e-6)


def test_batches_carry_ladder_plans_on_the_device(trained):
    _, pds, _, _ = trained
    batches = list(pbatching.prefetch(pbatching.batch_iterator(
        pds, 512, device="cpu", dedup_budget="ladder", dedup_fill=F - 1)))
    assert [int(b.mask.sum()) for b in batches] == [512, 512, 476]
    rungs = [b.plan.uids.shape[0] for b in batches]
    assert rungs == sorted(rungs)                    # monotonic rung
    for b in batches:
        assert b.plan.uids.dtype == torch.int32
        assert rungs[-1] >= int(b.plan.count) and not b.plan.overflow
        assert rungs[-1] == max(PE.ladder_budget(int(x.plan.count),
                                                 cap=PE.auto_budget(512 * 8))
                                for x in batches)
        assert float(b.vals[~b.mask].abs().sum()) == 0.0


def test_batches_match_jax(trained):
    """Same batches and ladder plans as the JAX package's iterator: ids,
    vals, y, mask, and each plan's uids, ranks and count."""
    ds, pds, _, _ = trained
    want = list(jbatching.batch_iterator(ds, 512, dedup_budget="ladder",
                                         dedup_fill=F - 1))
    got = list(pbatching.batch_iterator(pds, 512, device="cpu",
                                        dedup_budget="ladder",
                                        dedup_fill=F - 1))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for f in ("ids", "vals", "y", "mask"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)))
        for f in ("uids", "ranks", "count"):
            np.testing.assert_array_equal(np.asarray(getattr(g.plan, f)),
                                          np.asarray(getattr(w.plan, f)))


def test_batch_iterator_plans_only_the_ladder(trained):
    """Budgets are the ladder or a fixed positive int (training's
    ``unique_budget``); anything else raises, and no budget means no
    plan."""
    _, pds, _, _ = trained
    with pytest.raises(ValueError, match="ladder"):
        next(pbatching.batch_iterator(pds, 512, device="cpu",
                                      dedup_budget="pow2", dedup_fill=F - 1))
    fixed = next(pbatching.batch_iterator(pds, 512, device="cpu",
                                          dedup_budget=4096,
                                          dedup_fill=F - 1))
    assert fixed.plan.uids.shape == (4096,)
    plain = next(pbatching.batch_iterator(pds, 512, device="cpu"))
    assert plain.plan is None


def test_prefetch_reraises_worker_errors():
    def broken():
        yield 1
        raise KeyError("bad batch")
    it = pbatching.prefetch(broken())
    assert next(it) == 1
    with pytest.raises(KeyError, match="bad batch"):
        next(it)


def test_overflowed_batch_scores_exactly(monkeypatch, trained):
    """A ladder plan that overflows its cap would alias rows; predict_
    dataset scores that batch without a plan instead."""
    _, pds, _, pmodel = trained
    monkeypatch.setattr(PE, "auto_budget", lambda n_slots, cap=1 << 18: 8)
    got = pmodel.predict_dataset(pds.slice(np.arange(64)), batch_size=32)
    want = pfm.predict(pmodel.params, pmodel.cfg,
                       torch.from_numpy(pds.ids[:64]),
                       torch.from_numpy(pds.vals[:64]))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-7)
    assert rowio.GATHER.launches == 0
