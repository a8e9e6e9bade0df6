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

``FM(solver="mcmc")`` is held to the JAX facade under the injected draws
of ``tests/test_torch_mcmc.py``, and a ``RelationalDataset`` is routed as
the JAX facade routes it ("sgd" and "als" on the block structure, the
others on ``materialize()``); ``tests/test_torch_relational.py`` and
``tests/test_torch_als_bs.py`` hold those fits to the JAX facade's.

Two divergences from the JAX facade, on purpose: a callable solver given
``init_params`` or a nonzero ``timeout``, and any solver but "sgd" given a
``checkpoint_dir``, raise ``ValueError``, where the JAX facade drops them
silently (``sparkfm_tpu/api.py:524-537``).
"""

import os

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
from test_torch_mcmc import FakeDraws, jax_fakes  # noqa: F401 (a fixture)

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


@pytest.mark.parametrize("kw,match", [pytest.param(
    dict(mesh="4x1"), "world of 4 processes", id="kw0-A15")])
def test_unported_options_raise(ratings, kw, match):
    """A mesh (ported since A15) larger than 1 x 1 in a one-process run
    raises and names the world it needs; it never shrinks."""
    with pytest.raises(ValueError, match=match):
        FM(max_iter=1, **kw).fit(ratings, device="cpu")


def test_fit_mcmc_matches_jax(ratings, jax_fakes, monkeypatch):
    """FM(solver="mcmc") warm-started from the same weights, under the same
    injected draws (``tests/test_torch_mcmc.py``), equals the JAX facade:
    slot blocks, burn-in max(1, max_iter // 10), the history at rtol 1e-4
    and the last sample at the sweep parity."""
    from sparkfm_tpu_torch.solvers import mcmc as pmcmc

    jds = jsynth.synth_movielens(num_users=50, num_items=60,
                                 num_examples=4000, seed=0)
    rng = np.random.default_rng(11)
    arrays = (np.float32(0.1),
              rng.normal(0, 0.05, ratings.num_features).astype(np.float32),
              rng.normal(0, 0.05, (ratings.num_features, 4)
                         ).astype(np.float32))
    kw = dict(num_factors=4, solver="mcmc", max_iter=3, seed=0)
    jmodel = sfm.FM(**kw).fit(jds, eval_ds=jds, init_params=jfm.FMParams(
        *(jnp.asarray(a) for a in arrays)))
    monkeypatch.setattr(pmcmc, "TorchDraws", lambda generator: FakeDraws())
    pmodel = FM(**kw).fit(ratings, eval_ds=ratings, device="cpu",
                          init_params=params_from_numpy(*arrays,
                                                        device="cpu"))
    assert [sorted(h) for h in pmodel.history] == [
        sorted(h) for h in jmodel.history]
    assert "eval_rmse_avg" not in pmodel.history[0]     # burn-in 1
    for got, want in zip(pmodel.history, jmodel.history):
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-4,
                                       err_msg=key)
    for name in ("w", "v"):
        np.testing.assert_allclose(getattr(pmodel.params, name).numpy(),
                                   np.asarray(getattr(jmodel.params, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("solver", ["sgd", "als", "mcmc", "callable"])
def test_fit_relational_routes_as_jax(solver, monkeypatch):
    """A RelationalDataset: "sgd" trains on composed batches and "als" by
    BS-ALS, neither materializing the training set; "mcmc" and a callable
    solver train on its ``materialize()``, as the JAX facade routes
    them."""
    from sparkfm_tpu_torch.data import relational as PR
    from sparkfm_tpu_torch.solvers import als_bs, mcmc
    from sparkfm_tpu_torch.training import trainer
    from test_als_bs import _relational

    rel = PR.relational_from_numpy(_relational(n=600))
    called = []
    for mod, name in ((trainer, "train_sgd_relational"),
                      (als_bs, "train_als_relational"),
                      (mcmc, "train_mcmc")):
        monkeypatch.setattr(mod, name, lambda *a, _f=getattr(mod, name),
                            _n=name, **k: called.append(_n) or _f(*a, **k))
    materialized = []
    real = PR.RelationalDataset.materialize
    monkeypatch.setattr(PR.RelationalDataset, "materialize",
                        lambda self: materialized.append(1) or real(self))

    def fit_callable(cfg, train, eval_ds, eval_every, generator):
        called.append("callable")
        return train_als(cfg, ALSConfig(epochs=1), train, device="cpu")

    model = FM(num_factors=2, max_iter=2, reg_v=0.5, batch_size=128,
               solver=fit_callable if solver == "callable" else solver
               ).fit(rel, device="cpu")
    want = {"sgd": "train_sgd_relational", "als": "train_als_relational",
            "mcmc": "train_mcmc", "callable": "callable"}[solver]
    assert called == [want]
    assert len(materialized) == (solver in ("mcmc", "callable"))
    assert np.isfinite(model.predict_dataset(real(rel))).all()


@pytest.mark.parametrize("solver", ["als", "sgd"])
def test_vectorizer_feature_groups_match_jax(solver):
    """FM(feature_groups=<fitted Vectorizer>) gives one L2 group per source
    column, as the JAX facade's (``feature_groups_of``); the fit warm-started
    from the same weights equals the JAX facade's (parameters at rtol 2e-4,
    atol 2e-5, the ALS sweep parity above). DeepFM through the facade is
    held in ``tests/test_torch_deepfm.py``."""
    from sparkfm_tpu.data import schema as jschema
    from sparkfm_tpu.data import vectorizer as jvec
    from sparkfm_tpu_torch.data import schema as pschema
    from sparkfm_tpu_torch.data import vectorizer as pvec
    path = os.path.join(os.path.dirname(__file__), "fixtures", "ml_fixture",
                        "ratings.dat")
    rows = list(pschema.read_delimited(path, "::"))[:3000]

    def schema(mod):
        return [mod.Identity("u"), mod.Identity("i"), mod.Target("y"),
                mod.Ignored("t")]
    jv, pv = jvec.Vectorizer(schema(jschema)), pvec.Vectorizer(
        schema(pschema))
    jds, pds = jv.fit_transform(rows), pv.fit_transform(rows)
    f = pds.num_features
    rng = np.random.default_rng(4)
    w0, w, v = (np.float32(3.0), rng.normal(0, 0.05, f).astype(np.float32),
                rng.normal(0, 0.05, (f, 4)).astype(np.float32))
    kw = dict(num_factors=4, solver=solver, max_iter=2, learning_rate=0.1,
              batch_size=512, reg_w=0.1, group_reg_v=(0.3, 0.8))
    want = sfm.FM(feature_groups=jv, **kw).fit(jds, init_params=jfm.FMParams(
        w0=jnp.asarray(w0), w=jnp.asarray(w), v=jnp.asarray(v)))
    got = FM(feature_groups=pv, **kw).fit(
        pds, init_params=params_from_numpy(w0, w, v, device="cpu"),
        device="cpu")
    assert got.cfg.feature_groups == want.cfg.feature_groups
    assert set(got.cfg.feature_groups) == {0, 1}
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(got.params, name).numpy(),
                                   np.asarray(getattr(want.params, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_fit_checkpoint_dir_resumes_as_the_jax_facade(tmp_path):
    """FM(solver="sgd").fit(checkpoint_dir=...) as the JAX facade's:
    2 epochs, then a fit to 4 epochs that resumes from the checkpoint.
    The resumed port model equals a straight 4-epoch port fit bit for bit
    and the JAX facade's resumed model at the SGD facade tolerance
    (parameters rtol 1e-4, atol 1e-6; epoch losses rtol 1e-5)."""
    kw = dict(num_users=30, num_items=40, num_examples=1500, seed=2)
    jds, pds = jsynth.synth_movielens(**kw), synth.synth_movielens(**kw)
    rng = np.random.default_rng(2)
    f = pds.num_features
    w0, w, v = (np.float32(0.0), rng.normal(0, 0.05, f).astype(np.float32),
                rng.normal(0, 0.05, (f, 4)).astype(np.float32))
    fm_kw = dict(num_factors=4, solver="sgd", learning_rate=0.1,
                 batch_size=256, reg_v=0.01, seed=2)
    jinit = jfm.FMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                         v=jnp.asarray(v))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    sfm.FM(max_iter=2, **fm_kw).fit(jds, checkpoint_dir=jdir,
                                    init_params=jinit)
    jmodel = sfm.FM(max_iter=4, **fm_kw).fit(jds, checkpoint_dir=jdir,
                                             init_params=jinit)

    def port(max_iter, **fit_kw):
        return FM(max_iter=max_iter, **fm_kw).fit(
            pds, init_params=params_from_numpy(w0, w, v, device="cpu"),
            device="cpu", **fit_kw)
    first = port(2, checkpoint_dir=pdir)
    assert len(first.history) == 2 and sorted(os.listdir(pdir)) == ["0",
                                                                     "1"]
    resumed = port(4, checkpoint_dir=pdir)
    straight = port(4)
    assert resumed.history == straight.history
    assert [h["epoch"] for h in resumed.history] == [0, 1, 2, 3]
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(resumed.params, name),
                           getattr(straight.params, name)), name
        np.testing.assert_allclose(
            getattr(resumed.params, name).numpy(),
            np.asarray(getattr(jmodel.params, name)), rtol=1e-4, atol=1e-6,
            err_msg=name)
    for g, h in zip(resumed.history, jmodel.history):
        np.testing.assert_allclose(g["train_loss"], h["train_loss"],
                                   rtol=1e-5)


@pytest.mark.parametrize("solver", ["als", "callable"])
def test_checkpoint_dir_off_the_sgd_solver_raises(ratings, solver,
                                                  tmp_path):
    """The JAX facade drops checkpoint_dir silently for other solvers; the
    port refuses it, as it refuses what a callable solver cannot
    honour."""
    if solver == "callable":
        def solver(cfg, train, eval_ds, eval_every, generator):
            raise AssertionError("not reached")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        FM(max_iter=1, solver=solver).fit(
            ratings, checkpoint_dir=str(tmp_path / "ck"), device="cpu")


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
