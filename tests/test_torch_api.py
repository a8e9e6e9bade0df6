"""The port's ``FM`` facade (``sparkfm_tpu_torch/api.py``), held to the
behaviours of ``tests/test_api_cli.py::TestFMFacade``, its timeout and
warm-start tests, and to the JAX facade itself: ``FM(solver="als")``
warm-started from the same numpy parameters gives the same model (rtol
2e-4 / atol 2e-5, the ALS sweep parity of ``tests/test_torch_als.py``).

Some SGD cases on small tables pin ``update_path="hybrid"``, which they
were written for; under "auto" such tables train on the direct path, and
``FM(solver="sgd")`` with no pinned path, and with adam, is held to the JAX
facade (epoch losses rtol 1e-5, parameters rtol 1e-4, atol 1e-6).
``FM(solver="sgd", feature_groups=...)`` on a 2^16-row table trains on the
fused path under "auto", as the JAX facade does, and is held to it at the
trainer tests' tolerance (rtol 2e-4, atol 2e-5). ``FM(num_fields=...)``
is held to the JAX facade in ``tests/test_torch_ffm.py``.

One divergence from the JAX facade, on purpose: a callable solver given
``init_params`` or a nonzero ``timeout`` raises ``ValueError``, where the
JAX facade drops both silently (``sparkfm_tpu/api.py:524-525``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparkfm_tpu as sfm
from sparkfm_tpu.data import synth as jsynth
from sparkfm_tpu.models import fm as jfm
from sparkfm_tpu_torch import (FM, ALSConfig, FMModel, TrainResult,
                               params_from_numpy, train_als)
from sparkfm_tpu_torch.data import synth

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ratings():
    return synth.synth_movielens(num_users=50, num_items=60,
                                 num_examples=4000, seed=0)


def test_fit_als_and_metrics(ratings):
    model = FM(num_factors=4, max_iter=4, solver="als", reg_v=0.1,
               seed=0).fit(ratings, eval_ds=ratings, device="cpu")
    rmse = model.compute_rmse(ratings)
    assert rmse < 0.6
    assert model.compute_mae(ratings) < rmse      # true MAE <= RMSE
    assert 0.0 <= model.compute_accuracy(ratings) <= 1.0
    assert [h["epoch"] for h in model.history] == [0, 1, 2, 3]
    assert model.history[-1]["eval_rmse"] == pytest.approx(rmse, rel=1e-5)
    assert model.examples_per_sec > 0


def test_fit_sgd(ratings):
    model = FM(num_factors=4, max_iter=6, solver="sgd", learning_rate=0.1,
               batch_size=512, reg_v=0.01, seed=0,
               update_path="hybrid").fit(ratings, device="cpu")
    assert model.compute_rmse(ratings) < 0.8
    assert len(model.history) == 6 and model.examples_per_sec > 0


def test_custom_solver_callable(ratings):
    calls = {}

    def my_solver(cfg, train, eval_ds, eval_every, generator):
        calls.update(cfg=cfg, generator=generator, eval_every=eval_every)
        return train_als(cfg, ALSConfig(epochs=2), train, generator=generator,
                         device="cpu")

    model = FM(num_factors=3, solver=my_solver, eval_every=3).fit(
        ratings, device="cpu")
    assert calls["cfg"].num_factors == 3 and calls["eval_every"] == 3
    assert isinstance(calls["generator"], torch.Generator)
    assert np.isfinite(model.compute_rmse(ratings))
    assert len(model.history) == 2


@pytest.mark.parametrize("kw,fit_kw", [({}, "init_params"),
                                       (dict(timeout=5.0), None)])
def test_callable_solver_refuses_what_it_cannot_honour(ratings, kw, fit_kw):
    """The JAX facade drops init_params and timeout for a callable solver
    without a word; the port raises."""
    called = []

    def my_solver(*args):
        called.append(args)
        return TrainResult(params=None, history=[])

    fm = FM(num_factors=3, solver=my_solver, **kw)
    extra = {}
    if fit_kw:
        init = FM(num_factors=3, max_iter=1).fit(ratings, device="cpu")
        extra = {fit_kw: init}
    with pytest.raises(ValueError, match="callable solver"):
        fm.fit(ratings, device="cpu", **extra)
    assert not called


def test_save_load_roundtrip(ratings, tmp_path):
    model = FM(num_factors=3, max_iter=2, solver="als", reg_v=0.1).fit(
        ratings, device="cpu")
    d = str(tmp_path / "model")
    model.save(d)
    loaded = FMModel.load(d, device="cpu")
    assert loaded.cfg == model.cfg
    a = model.predict(ratings.ids[:8], ratings.vals[:8])
    b = loaded.predict(ratings.ids[:8], ratings.vals[:8])
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_unknown_solver_raises(ratings):
    with pytest.raises(ValueError, match="unknown solver"):
        FM(solver="newton").fit(ratings, device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        FM(model="wide")


class _Relational:
    """Stands in for the JAX package's RelationalDataset."""

    num_features = 10

    def materialize(self):
        raise AssertionError("not reached")


@pytest.mark.parametrize("kw,fit_kw,match", [
    (dict(solver="mcmc"), {}, "A11"),
    (dict(mesh="4x1"), {}, "A15"),
    (dict(model="deepfm", solver="sgd"), {}, "A12"),
    ({}, dict(checkpoint_dir="ckpt"), "A5"),
    ({}, dict(train=_Relational()), "A10"),
    (dict(feature_groups=type("Vectorizer", (), {"offsets": (0,)})()), {},
     "A14"),
])
def test_unported_options_raise(ratings, kw, fit_kw, match):
    fit_kw = dict(fit_kw)
    train = fit_kw.pop("train", ratings)
    with pytest.raises(NotImplementedError, match=match):
        FM(max_iter=1, **kw).fit(train, device="cpu", **fit_kw)


def test_timeout_knob_stops_training_early():
    """A sub-microsecond budget is spent when the first epoch ends: both
    solvers run exactly one epoch."""
    ds = synth.synth_movielens(num_users=30, num_items=40,
                               num_examples=2000, seed=0)
    for solver in ("sgd", "als"):
        model = FM(num_factors=4, solver=solver, max_iter=500,
                   timeout=1e-6, batch_size=256, reg_v=0.1,
                   learning_rate=0.05, update_path="hybrid").fit(
                       ds, device="cpu")
        assert len(model.history) == 1, (solver, len(model.history))


def test_warm_start_continues_training():
    ds = synth.synth_movielens(num_users=30, num_items=40,
                               num_examples=3000, seed=4)
    for solver in ("sgd", "als"):
        fm = FM(num_factors=4, solver=solver, max_iter=2, reg_v=0.1,
                batch_size=512, learning_rate=0.1, update_path="hybrid")
        m1 = fm.fit(ds, eval_ds=ds, device="cpu")
        r1 = m1.history[-1]["eval_rmse"]
        v1 = m1.params.v.clone()
        m2 = fm.fit(ds, eval_ds=ds, init_params=m1, device="cpu")
        r2 = m2.history[-1]["eval_rmse"]
        # 2 more epochs from m1 beat m1: the fit started from it
        assert r2 < r1, (solver, r1, r2)
        # and trained a copy: m1 itself is unchanged
        assert torch.equal(m1.params.v, v1)


def test_feature_groups_reach_the_config(ratings):
    groups = tuple([0] * 50 + [1] * 60)
    model = FM(num_factors=3, max_iter=1, feature_groups=groups,
               group_reg_v=(0.5, 2.0)).fit(ratings, device="cpu")
    assert model.cfg.feature_groups == groups
    assert model.cfg.group_reg_v == (0.5, 2.0)
    with pytest.raises(ValueError, match="feature_groups length"):
        FM(feature_groups=(0, 1)).fit(ratings, device="cpu")


def test_als_facade_matches_jax_facade():
    """Both facades, warm-started from the same numpy parameters on the
    same data, fit the same model and report the same evals."""
    kw = dict(num_users=40, num_items=50, num_examples=3000, seed=2)
    pds, jds = synth.synth_movielens(**kw), jsynth.synth_movielens(**kw)
    rng = np.random.default_rng(2)
    w0 = np.float32(3.0)
    w = rng.normal(0, 0.05, 90).astype(np.float32)
    v = rng.normal(0, 0.05, (90, 4)).astype(np.float32)
    fm_kw = dict(num_factors=4, max_iter=3, solver="als", reg_w=0.1,
                 reg_v=0.5)
    got = FM(**fm_kw).fit(pds, eval_ds=pds, device="cpu",
                          init_params=params_from_numpy(w0, w, v,
                                                        device="cpu"))
    want = sfm.FM(**fm_kw).fit(jds, eval_ds=jds, init_params=jfm.FMParams(
        w0=jnp.asarray(w0), w=jnp.asarray(w), v=jnp.asarray(v)))
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(got.params, name).numpy(),
                                   np.asarray(getattr(want.params, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    assert len(got.history) == len(want.history) == 3
    for g, h in zip(got.history, want.history):
        np.testing.assert_allclose(g["eval_rmse"], h["eval_rmse"], rtol=1e-4)
    assert got.cfg.to_json() == {
        **{k: v for k, v in want.cfg.__dict__.items() if k != "task"},
        "task": want.cfg.task.value}


def test_fitted_model_fields_match_jax():
    import dataclasses
    want = [f.name for f in dataclasses.fields(sfm.FMModel)]
    assert [f.name for f in dataclasses.fields(FMModel)] == want
    assert FMModel(params=None, cfg=None).history == []
    assert FMModel(params=None, cfg=None).examples_per_sec == 0.0


def _groups_fit(**extra):
    """Both facades, warm-started from the same numpy parameters, fit
    with attribute-group L2 on a 2^16-row table (which rules the hybrid
    path out, so "auto" picks the fused path); returns both models and
    the port's fit again from the same start with ``extra`` options."""
    f = 1 << 16
    kw = dict(num_examples=600, num_fields=5, num_buckets=f, seed=3)
    pds, jds = synth.synth_ctr(**kw), jsynth.synth_ctr(**kw)
    rng = np.random.default_rng(3)
    w0 = np.float32(0.0)
    w = rng.normal(0, 0.05, f).astype(np.float32)
    v = rng.normal(0, 0.05, (f, 4)).astype(np.float32)
    fm_kw = dict(num_factors=4, max_iter=2, solver="sgd", batch_size=128,
                 learning_rate=0.1, reg_w=0.01, reg_v=0.01,
                 feature_groups=tuple(i % 4 for i in range(f)),
                 group_reg_w=(0.0, 0.01, 0.02, 0.05),
                 group_reg_v=(0.05, 0.0, 0.01, 0.1))

    def port(**kw):
        return FM(**fm_kw, **kw).fit(pds, eval_ds=pds, device="cpu",
                                     init_params=params_from_numpy(
                                         w0, w, v, device="cpu"))
    got = port(**extra)
    want = sfm.FM(**fm_kw, **extra).fit(
        jds, eval_ds=jds, init_params=jfm.FMParams(
            w0=jnp.asarray(w0), w=jnp.asarray(w), v=jnp.asarray(v)))
    return got, want, port


def test_sgd_feature_groups_train_on_the_fused_path_as_jax():
    """Attribute-group L2 rules the hybrid path out, so "auto" picks the
    fused path on a 2^16-row table; both facades, warm-started from the
    same numpy parameters, fit the same model."""
    from sparkfm_tpu_torch import SGDConfig
    from sparkfm_tpu_torch.solvers import sgd as psgd
    got, want, _ = _groups_fit()
    assert psgd.resolve_update_path(got.cfg, SGDConfig()) == "fused"
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(got.params, name).numpy(),
                                   np.asarray(getattr(want.params, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    for g, h in zip(got.history, want.history):
        np.testing.assert_allclose(g["train_loss"], h["train_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(g["eval_rmse"], h["eval_rmse"], rtol=1e-4)
    assert len(got.history) == 2


def test_sgd_steps_per_dispatch_trains_on_the_fused_path():
    """FM(solver="sgd", steps_per_dispatch=2) on the fused path trains as
    the JAX facade does (which groups hybrid steps only), and equals the
    port's fit with steps_per_dispatch=1 bit for bit."""
    got, want, port = _groups_fit(steps_per_dispatch=2)
    single = port()
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(got.params, name),
                           getattr(single.params, name)), name
        np.testing.assert_allclose(getattr(got.params, name).numpy(),
                                   np.asarray(getattr(want.params, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    assert [h["train_loss"] for h in got.history] == [
        h["train_loss"] for h in single.history]


@pytest.mark.parametrize("optimizer,update_path,lr", [
    ("adagrad", "auto", 0.1), ("adam", "auto", 0.01),
    ("adam", "dedup", 0.01)])
def test_sgd_facade_matches_jax_facade(ratings, optimizer, update_path, lr):
    """FM(solver="sgd") on a 110-row MovieLens table with no pinned path
    (the direct path) and with adam, and adam pinned to the dedup path,
    against the JAX facade from the same numpy parameters: epoch losses,
    evals and parameters."""
    jratings = jsynth.synth_movielens(num_users=50, num_items=60,
                                      num_examples=4000, seed=0)
    rng = np.random.default_rng(5)
    w0, w, v = (np.float32(3.0), rng.normal(0, 0.05, 110).astype(np.float32),
                rng.normal(0, 0.05, (110, 4)).astype(np.float32))
    kw = dict(num_factors=4, max_iter=3, solver="sgd", batch_size=512,
              learning_rate=lr, reg_v=0.01, optimizer=optimizer,
              update_path=update_path)
    got = FM(**kw).fit(ratings, eval_ds=ratings, device="cpu",
                       init_params=params_from_numpy(w0, w, v, device="cpu"))
    want = sfm.FM(**kw).fit(jratings, eval_ds=jratings,
                            init_params=jfm.FMParams(w0=jnp.asarray(w0),
                                                     w=jnp.asarray(w),
                                                     v=jnp.asarray(v)))
    assert len(got.history) == len(want.history) == 3
    for g, h in zip(got.history, want.history):
        assert g.keys() == h.keys()
        for key in ("train_loss", "eval_rmse", "eval_mae"):
            np.testing.assert_allclose(g[key], h[key], rtol=1e-5,
                                       err_msg=key)
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(got.params, name).numpy(),
                                   np.asarray(getattr(want.params, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert got.params.v.shape == (110, 4)
