"""The port's MicroBatcher against the JAX package's on the same
parameters and requests.

Tolerance rtol 1e-5, atol 1e-6: float32 sums in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu import serving as jserving
from sparkfm_tpu.config import FMConfig as JConfig
from sparkfm_tpu.config import Task as JTask
from sparkfm_tpu.models import fm as jfm
from sparkfm_tpu.ops import embedding as JE
from sparkfm_tpu_torch import serving as pserving
from sparkfm_tpu_torch.config import FMConfig, Task
from sparkfm_tpu_torch.models import deepfm as pdeepfm
from sparkfm_tpu_torch.models import fm as pfm
from sparkfm_tpu_torch.ops import embedding as PE

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _both(num_features, num_factors, task, seed):
    rng = np.random.default_rng(seed)
    w0 = np.float32(rng.normal())
    w = rng.normal(0, 0.5, num_features).astype(np.float32)
    v = rng.normal(0, 0.3, (num_features, num_factors)).astype(np.float32)
    jcfg = JConfig(num_features=num_features, num_factors=num_factors,
                   task=JTask(task), seed=seed)
    pcfg = FMConfig(num_features=num_features, num_factors=num_factors,
                    task=Task(task), seed=seed)
    jparams = jfm.FMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                           v=jnp.asarray(v))
    return (jserving, jparams, jcfg), (pserving, pfm.params_from_numpy(
        w0, w, v, device="cpu"), pcfg), rng


def _serve_both(sides, reqs, **kw):
    """Submit ``reqs`` to a MicroBatcher of each package; flush both."""
    outs = []
    for mod, params, cfg in sides:
        mb = mod.MicroBatcher(params, cfg, **kw)
        for ids, vals in reqs:
            single = ids.shape[0] == 1
            mb.submit(ids[0] if single else ids, vals[0] if single else vals)
        assert mb.pending == sum(r[0].shape[0] for r in reqs)
        outs.append(mb.flush())
        assert mb.pending == 0 and mb.flush() == []
        outs.append(mb.use_plans)
    return outs


def test_pad_ladder_matches_jax():
    for max_batch in (1, 64, 4096):
        for n in range(1, 5000, 7):
            assert (pserving._pad_batch_size(n, max_batch)
                    == jserving._pad_batch_size(n, max_batch))


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_small_table_single_and_batched_submits(task):
    jside, pside, rng = _both(512, 4, task, seed=0)
    reqs = []
    for _ in range(7):
        n = int(rng.integers(1, 5))
        reqs.append((rng.integers(0, 512, (n, 6)).astype(np.int32),
                     rng.normal(size=(n, 6)).astype(np.float32)))
    want, jplans, got, pplans = _serve_both([jside, pside], reqs,
                                            max_batch=64)
    assert jplans is pplans is False
    assert len(got) == len(want) == 7
    for g, w, (ids, _) in zip(got, want, reqs):
        assert g.shape == (ids.shape[0],)
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_big_table_plans_and_chunking(task):
    """Big table: host plans engage; a queue over max_batch flushes in
    several chunks, each padded up the ladder."""
    jside, pside, rng = _both(1 << 17, 4, task, seed=1)
    reqs = [(rng.integers(0, 1 << 17, (n, 8)).astype(np.int32),
             np.ones((n, 8), np.float32)) for n in (100, 1, 100, 37, 100)]
    want, jplans, got, pplans = _serve_both([jside, pside], reqs,
                                            max_batch=128)
    assert jplans and pplans
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_overflowed_plan_scores_exactly(monkeypatch):
    """A chunk whose unique ids overflow the plan cap scores without a
    plan (exactly) in both packages."""
    for mod in (JE, PE):
        monkeypatch.setattr(mod, "auto_budget",
                            lambda n_slots, cap=1 << 18: 8)
    jside, pside, rng = _both(1 << 16, 4, "classification", seed=2)
    ids = rng.choice(1 << 16, 64 * 6, replace=False).astype(np.int32)
    reqs = [(ids.reshape(64, 6), np.ones((64, 6), np.float32))]
    want, _, got, _ = _serve_both([jside, pside], reqs, max_batch=64)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    exact = pfm.predict(pside[1], pside[2], torch.from_numpy(reqs[0][0]),
                        torch.from_numpy(reqs[0][1]))
    np.testing.assert_allclose(got[0], exact.numpy(), rtol=0, atol=0)


def test_rejects_mixed_field_submissions():
    jside, pside, _ = _both(64, 2, "regression", seed=3)
    ids = np.zeros((1, 3), np.int32)
    vals = np.ones((1, 3), np.float32)
    outs = []
    for mod, params, cfg in (jside, pside):
        mb = mod.MicroBatcher(params, cfg, max_batch=16)
        mb.submit(ids, vals, field_ids=np.arange(3, dtype=np.int32)[None])
        with pytest.raises(ValueError, match="mixed"):
            mb.submit(ids, vals)              # no field_ids
        outs.append(mb.flush())               # the queue is not poisoned
    assert len(outs[0]) == len(outs[1]) == 1
    np.testing.assert_allclose(outs[1][0], outs[0][0], **TOL)


def test_failed_flush_keeps_the_queue(monkeypatch):
    """Deliberate divergence from the JAX package, whose flush empties the
    queue before scoring, so one failing chunk loses every queued request.
    The port clears the queue only after every chunk has scored."""
    _, (mod, params, cfg), rng = _both(256, 4, "regression", seed=4)
    mb = mod.MicroBatcher(params, cfg, max_batch=8)
    reqs = [(rng.integers(0, 256, (n, 5)).astype(np.int32),
             rng.normal(size=(n, 5)).astype(np.float32)) for n in (6, 7, 3)]
    for ids, vals in reqs:
        mb.submit(ids, vals)
    real = pfm.predict
    calls = []

    def failing_second_chunk(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device lost")
        return real(*a, **kw)

    monkeypatch.setattr(pfm, "predict", failing_second_chunk)
    with pytest.raises(RuntimeError, match="device lost"):
        mb.flush()
    assert mb.pending == 16                   # nothing was dropped
    monkeypatch.setattr(pfm, "predict", real)
    out = mb.flush()
    assert mb.pending == 0 and len(out) == 3
    for (ids, vals), got in zip(reqs, out):
        want = pfm.predict(params, cfg, torch.from_numpy(ids),
                           torch.from_numpy(vals))
        np.testing.assert_allclose(got, want.numpy(), **TOL)


def test_deepfm_and_unknown_models_raise():
    """An unknown model raises; a DeepFM batcher (ported since DeepFM
    serving, ``tests/test_torch_deepfm.py``) raises on field_ids, which
    the JAX package's ignores: DeepFM input is field-major."""
    _, (mod, params, cfg), _ = _both(64, 2, "regression", seed=5)
    with pytest.raises(ValueError):
        mod.MicroBatcher(params, cfg, model="ffm")
    dcfg = pdeepfm.DeepFMConfig(fm=FMConfig(num_features=64, num_factors=2,
                                            num_fields=3), hidden=(4,))
    mb = mod.MicroBatcher(pdeepfm.init_params(dcfg, device="cpu"), dcfg,
                          model="deepfm")
    ids = np.array([[1, 20, 40]], np.int32)
    with pytest.raises(ValueError, match="field-major"):
        mb.submit(ids, np.ones((1, 3), np.float32), np.arange(3)[None])
    assert mb.pending == 0
