"""The port's train_sgd against the JAX package's (``update_path=
"hybrid"``, "fused", "sorted", "direct" and "dedup"), from the same
initial parameters, on ``synth_ctr`` with shuffled epochs and, where the
path takes them, ladder plans; and BASELINE config 1's recipe at a small
scale (the direct path under "auto").

Tolerance rtol 1e-4 (atol 1e-6 on parameters): the two trainers run the
same steps on the same batches, and float32 sums in another order compound
over the run's steps through the adagrad accumulators, as the JAX package
allows its own hybrid step against its fused step."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.config import FMConfig as JFMConfig
from sparkfm_tpu.config import SGDConfig as JSGDConfig
from sparkfm_tpu.config import Task as JTask
from sparkfm_tpu.data import synth as jsynth
from sparkfm_tpu.models.fm import FMParams as JFMParams
from sparkfm_tpu.solvers import sgd as jsgd
from sparkfm_tpu.training import trainer as jtrainer
from sparkfm_tpu_torch import FMConfig, SGDConfig, Task, evaluate, train_sgd
from sparkfm_tpu_torch.config import SGDConfig as PSGDConfig
from sparkfm_tpu_torch.data import synth as psynth
from sparkfm_tpu_torch.models.fm import params_from_numpy

torch.set_num_threads(1)
F = 1 << 17
K = 4
SYNTH = dict(num_fields=5, num_buckets=F)
SGD = dict(batch_size=256, learning_rate=0.1, optimizer="adagrad", epochs=2,
           shuffle_each_epoch=True)


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return (np.float32(0.1), rng.normal(0, 0.05, F).astype(np.float32),
            rng.normal(0, 0.05, (F, K)).astype(np.float32))


@pytest.fixture(scope="module", params=["classification", "regression"])
def runs(request):
    task = request.param
    labels = (0.0, 1.0) if task == "classification" else (-1.0, 1.0)
    kw = dict(SYNTH, label_range=labels)
    train = dict(num_examples=1100, seed=1, **kw)
    held = dict(num_examples=300, seed=2, **kw)
    cfg_kw = dict(num_features=F, num_factors=K, reg_w=1e-4, reg_v=1e-4,
                  seed=5)
    w0, w, v = _params()
    jcfg = JFMConfig(task=JTask(task), **cfg_kw)
    jheld = jsynth.synth_ctr(**held)
    jres = jtrainer.train_sgd(
        jcfg, JSGDConfig(update_path="hybrid", **SGD),
        jsynth.synth_ctr(**train), eval_ds=jheld,
        init_params=JFMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                              v=jnp.asarray(v)))
    pcfg = FMConfig(task=Task(task), **cfg_kw)
    pheld = psynth.synth_ctr(**held)
    pres = train_sgd(pcfg, SGDConfig(**SGD), psynth.synth_ctr(**train),
                     eval_ds=pheld,
                     init_params=params_from_numpy(w0, w, v, device="cpu"),
                     device="cpu")
    return jres, pres, (jcfg, jheld), (pcfg, pheld)


def test_epoch_losses_and_eval_match_jax(runs):
    jres, pres, _, _ = runs
    assert len(pres.history) == len(jres.history) == 2
    for g, w in zip(pres.history, jres.history):
        assert g.keys() == w.keys()
        assert g["epoch"] == w["epoch"]
        assert g["unique_overflow_steps"] == w["unique_overflow_steps"] == 0
        for key in g:
            if key.startswith("eval_") or key == "train_loss":
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                           err_msg=key)
    assert pres.examples_per_sec > 0


def test_final_params_match_jax(runs):
    jres, pres, _, _ = runs
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(pres.params, name).numpy(),
                                   np.asarray(getattr(jres.params, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert pres.params.v.shape == (F, K)


def test_evaluate_matches_jax(runs):
    jres, pres, (jcfg, jheld), (pcfg, pheld) = runs
    want = jtrainer.evaluate(jres.params, jcfg, jheld, batch_size=128)
    got = evaluate(pres.params, pcfg, pheld, batch_size=128)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)


def test_max_seconds_stops_at_an_epoch_boundary():
    ds = psynth.synth_ctr(num_examples=512, seed=3, **SYNTH)
    cfg = FMConfig(num_features=F, num_factors=K, seed=3)
    seen = []
    res = train_sgd(cfg, SGDConfig(**dict(SGD, epochs=5),
                                   max_seconds=1e-9),
                    ds, hooks=[lambda e, s, r: seen.append(e)],
                    device="cpu")
    assert [h["epoch"] for h in res.history] == seen == [0]


@pytest.mark.parametrize("steps,want", [(4, 6 / 1.5), (1, 2 / 1.0)])
def test_examples_per_sec_leaves_out_the_first_dispatch(monkeypatch, steps,
                                                        want):
    """The first dispatch's time and its examples leave the count
    together (a run of one dispatch keeps it), on a clock that the steps
    move: 1 s for the first step, 0.5 s for each after it."""
    from sparkfm_tpu_torch.training import trainer

    clock = [0.0]
    monkeypatch.setattr(trainer.time, "perf_counter", lambda: clock[0])

    def run_epoch(state, epoch, dispatch):
        for i in range(steps):
            def run(i=i):
                clock[0] += 1.0 if i == 0 else 0.5
                return {"loss": torch.tensor(1.0)}
            dispatch(run, 1)
        return state, []

    _, history, eps = trainer.run_epochs(
        None, PSGDConfig(batch_size=2, epochs=1), 2 * steps, run_epoch,
        path="direct")
    assert eps == pytest.approx(want) and history[0]["train_loss"] == 1.0


def test_hooks_see_every_epoch_and_the_live_state():
    ds = psynth.synth_ctr(num_examples=300, seed=4, **SYNTH)
    cfg = FMConfig(num_features=F, num_factors=K, seed=4)
    steps = []
    train_sgd(cfg, SGDConfig(**dict(SGD, epochs=3)), ds,
              hooks=[lambda e, s, r: steps.append(int(s.step))],
              device="cpu")
    assert steps == [2, 4, 6]                 # two batches of 256 an epoch


@pytest.mark.parametrize("sgd_kw", [
    dict(update_path="fused"),
    dict(update_path="fused", accumulate="segsum"),
    dict(update_path="fused", host_plan=False, optimizer="adagrad_row"),
    dict(update_path="sorted"),
    dict(update_path="fused", steps_per_dispatch=2),
    dict(update_path="sorted", steps_per_dispatch=3),
])
def test_fused_and_sorted_paths_match_jax(sgd_kw):
    """train_sgd on the fused path (host ladder plans, or plans built in
    the step) and on the sorted path, against the JAX trainer on the same
    path: epoch losses, evals and final parameters."""
    kw = dict(SYNTH, label_range=(0.0, 1.0))
    train, held = dict(num_examples=700, seed=6, **kw), dict(
        num_examples=200, seed=7, **kw)
    cfg_kw = dict(num_features=F, num_factors=K, reg_w=1e-4, reg_v=1e-4,
                  seed=5, task=JTask.CLASSIFICATION)
    w0, w, v = _params(1)
    sgd = dict(SGD, **sgd_kw)
    jres = jtrainer.train_sgd(
        JFMConfig(**cfg_kw), JSGDConfig(**sgd), jsynth.synth_ctr(**train),
        eval_ds=jsynth.synth_ctr(**held),
        init_params=JFMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                              v=jnp.asarray(v)))
    pres = train_sgd(FMConfig(**dict(cfg_kw, task=Task.CLASSIFICATION)),
                     SGDConfig(**sgd), psynth.synth_ctr(**train),
                     eval_ds=psynth.synth_ctr(**held),
                     init_params=params_from_numpy(w0, w, v, device="cpu"),
                     device="cpu")
    for g, h in zip(pres.history, jres.history):
        assert g["unique_overflow_steps"] == h.get("unique_overflow_steps",
                                                   0) == 0
        for key in ("train_loss", "eval_logloss", "eval_auc"):
            np.testing.assert_allclose(g[key], h[key], rtol=1e-4,
                                       err_msg=key)
    assert len(pres.history) == len(jres.history) == 2
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(pres.params, name).numpy(),
                                   np.asarray(getattr(jres.params, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("path", ["fused", "sorted"])
def test_steps_per_dispatch_runs_single_steps_off_the_hybrid_path(path):
    """As the JAX trainer: only hybrid steps are grouped, so on the fused
    and sorted paths steps_per_dispatch=2 trains exactly as 1 does."""
    ds = psynth.synth_ctr(num_examples=700, seed=8, **SYNTH)
    cfg = FMConfig(num_features=F, num_factors=K, reg_v=1e-4, seed=8)
    runs = [train_sgd(cfg, SGDConfig(**dict(SGD, update_path=path,
                                            steps_per_dispatch=spd)), ds,
                      generator=torch.Generator().manual_seed(8),
                      device="cpu") for spd in (1, 2)]
    assert [h["train_loss"] for h in runs[0].history] == [
        h["train_loss"] for h in runs[1].history]
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(runs[0].params, name),
                           getattr(runs[1].params, name)), name


@pytest.mark.parametrize("kw,sgd_kw,match", [
    pytest.param(dict(mesh=object()), {}, "mesh must be",
                 id="kw0-sgd_kw0-A15"),
])
def test_unported_options_raise(kw, sgd_kw, match):
    """A ``mesh`` (ported since A15) that is no mesh raises."""
    ds = psynth.synth_ctr(num_examples=64, seed=5, **SYNTH)
    cfg = FMConfig(num_features=F, num_factors=K)
    with pytest.raises(ValueError, match=match):
        train_sgd(cfg, SGDConfig(**dict(SGD, **sgd_kw)), ds, device="cpu",
                  **kw)


def test_hybrid_steps_per_dispatch_and_checkpoints_match_jax(tmp_path):
    """What the JAX trainer does with steps_per_dispatch=2 on the hybrid
    path and a checkpoint_dir: grouped, checkpointed and resumed after the
    first epoch, the port's run matches the JAX trainer's grouped run from
    the same parameters, and the port's own single-step run bit for
    bit."""
    w0, w, v = _params(3)
    kw = dict(num_examples=900, seed=3, **SYNTH)
    cfg_kw = dict(num_features=F, num_factors=K, reg_v=1e-4, seed=3,
                  task="classification")
    common = dict(SGD, update_path="hybrid")
    jres = jtrainer.train_sgd(
        JFMConfig(**dict(cfg_kw, task=JTask.CLASSIFICATION)),
        JSGDConfig(steps_per_dispatch=2, **common), jsynth.synth_ctr(**kw),
        init_params=JFMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                              v=jnp.asarray(v)))
    pcfg = FMConfig(**dict(cfg_kw, task=Task.CLASSIFICATION))
    pds = psynth.synth_ctr(**kw)

    def port(spd, epochs, **run_kw):
        return train_sgd(pcfg, SGDConfig(**dict(common, epochs=epochs,
                                                steps_per_dispatch=spd)),
                         pds, init_params=params_from_numpy(w0, w, v,
                                                            device="cpu"),
                         device="cpu", **run_kw)
    ckdir = str(tmp_path / "ck")
    port(2, 1, checkpoint_dir=ckdir)
    resumed = port(2, 2, checkpoint_dir=ckdir)
    single = port(1, 2)
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(resumed.params, name),
                           getattr(single.params, name)), name
        np.testing.assert_allclose(getattr(resumed.params, name).numpy(),
                                   np.asarray(getattr(jres.params, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    assert resumed.history == single.history
    for g, h in zip(resumed.history, jres.history):
        np.testing.assert_allclose(g["train_loss"], h["train_loss"],
                                   rtol=1e-5)


def test_small_tables_train_on_the_direct_path_under_auto():
    """Under update_path='auto' a table below 2^16 rows trains on the
    direct path, as in the JAX package: the same epoch losses and final
    parameters as the JAX trainer's, and no unique_overflow_steps in the
    history (the direct step's plans hold every id)."""
    cfg_kw = dict(num_features=1000, num_factors=K, reg_v=1e-3, seed=6)
    synth_kw = dict(num_examples=600, num_fields=4, num_buckets=1000,
                    seed=6)
    rng = np.random.default_rng(6)
    w0, w, v = (np.float32(0.0), rng.normal(0, 0.05, 1000).astype(
        np.float32), rng.normal(0, 0.05, (1000, K)).astype(np.float32))
    jres = jtrainer.train_sgd(
        JFMConfig(**cfg_kw), JSGDConfig(**SGD), jsynth.synth_ctr(**synth_kw),
        init_params=JFMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                              v=jnp.asarray(v)))
    pres = train_sgd(FMConfig(**cfg_kw), SGDConfig(**SGD),
                     psynth.synth_ctr(**synth_kw),
                     init_params=params_from_numpy(w0, w, v, device="cpu"),
                     device="cpu")
    for g, h in zip(pres.history, jres.history):
        assert g.keys() == h.keys() == {"epoch", "train_loss"}
        np.testing.assert_allclose(g["train_loss"], h["train_loss"],
                                   rtol=1e-5)
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(pres.params, name).numpy(),
                                   np.asarray(getattr(jres.params, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_config1_recipe_matches_jax():
    """BASELINE config 1's recipe (``benchmarks/run_config.py:30-58``) at
    scale 0.08 (the recipe's own sqrt-per-axis cut: 267 users, 476 items,
    8,000 ratings): 15 epochs of batch 4096 at lr 0.1, adagrad, eval every
    14, from the same initial parameters in both packages. The direct
    path under "auto"; epoch losses and eval RMSE/MAE at rtol 1e-5, the
    parameters at rtol 1e-4, atol 1e-6, and the test RMSE below the
    train-mean baseline the recipe prints."""
    from sparkfm_tpu.data.split import split_by_random as jsplit
    from sparkfm_tpu_torch.data.split import split_by_random as psplit
    scale = 0.08
    users, items = (int(round(n * scale ** 0.5)) for n in (943, 1682))
    data_kw = dict(num_users=users, num_items=items,
                   num_examples=int(100_000 * scale), seed=0)
    jcoll = jsplit(jsynth.synth_movielens(**data_kw), 0.8, 0.2, seed=0)
    pcoll = psplit(psynth.synth_movielens(**data_kw), 0.8, 0.2, seed=0)
    f = users + items
    cfg_kw = dict(num_features=f, num_factors=8, reg_v=0.02, seed=0)
    sgd = dict(batch_size=4096, epochs=15, learning_rate=0.1)
    rng = np.random.default_rng(0)
    w0, w, v = (np.float32(0.0), np.zeros(f, np.float32),
                rng.normal(0, 0.01, (f, 8)).astype(np.float32))
    assert jsgd.resolve_update_path(JFMConfig(**cfg_kw),
                                    JSGDConfig(**sgd)) == "direct"
    jres = jtrainer.train_sgd(
        JFMConfig(**cfg_kw), JSGDConfig(**sgd), jcoll.training,
        eval_ds=jcoll.test, eval_every=14,
        init_params=JFMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                              v=jnp.asarray(v)))
    pres = train_sgd(FMConfig(**cfg_kw), SGDConfig(**sgd), pcoll.training,
                     eval_ds=pcoll.test, eval_every=14,
                     init_params=params_from_numpy(w0, w, v, device="cpu"),
                     device="cpu")
    assert len(pres.history) == len(jres.history) == 15
    for g, h in zip(pres.history, jres.history):
        assert g.keys() == h.keys()
        for key in g:
            np.testing.assert_allclose(g[key], h[key], rtol=1e-5,
                                       err_msg=key)
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(pres.params, name).numpy(),
                                   np.asarray(getattr(jres.params, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    mean_base = float(np.sqrt(np.mean(
        (pcoll.test.y - float(np.mean(pcoll.training.y))) ** 2)))
    assert pres.history[-1]["eval_rmse"] < mean_base


@pytest.mark.parametrize("sgd_kw", [
    dict(update_path="auto", optimizer="adam", learning_rate=0.01),
    dict(update_path="dedup", optimizer="sgd", momentum=0.9,
         learning_rate=0.01, host_plan=False),
])
def test_dedup_path_matches_jax(sgd_kw):
    """adam (which "auto" sends to the dedup path on a 2^17-row table) and
    momentum on device plans: train_sgd against the JAX trainer, epoch
    losses, overflow counts, evals and the final parameters, trimmed of
    the dedup fill row."""
    kw = dict(SYNTH, label_range=(0.0, 1.0))
    cfg_kw = dict(num_features=F, num_factors=K, reg_w=1e-4, reg_v=1e-4,
                  seed=5, task=JTask.CLASSIFICATION)
    w0, w, v = _params(2)
    sgd = dict(SGD, **sgd_kw)
    assert jsgd.resolve_update_path(JFMConfig(**cfg_kw),
                                    JSGDConfig(**sgd)) == "dedup"
    jres = jtrainer.train_sgd(
        JFMConfig(**cfg_kw), JSGDConfig(**sgd),
        jsynth.synth_ctr(num_examples=700, seed=6, **kw),
        eval_ds=jsynth.synth_ctr(num_examples=200, seed=7, **kw),
        init_params=JFMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                              v=jnp.asarray(v)))
    pres = train_sgd(FMConfig(**dict(cfg_kw, task=Task.CLASSIFICATION)),
                     SGDConfig(**sgd),
                     psynth.synth_ctr(num_examples=700, seed=6, **kw),
                     eval_ds=psynth.synth_ctr(num_examples=200, seed=7,
                                              **kw),
                     init_params=params_from_numpy(w0, w, v, device="cpu"),
                     device="cpu")
    for g, h in zip(pres.history, jres.history):
        assert g.keys() == h.keys()
        assert g["unique_overflow_steps"] == h["unique_overflow_steps"] == 0
        for key in ("train_loss", "eval_logloss", "eval_auc"):
            np.testing.assert_allclose(g[key], h[key], rtol=1e-5,
                                       err_msg=key)
    for name in ("w0", "w", "v"):
        got = getattr(pres.params, name).numpy()
        assert got.shape == np.shape(getattr(jres.params, name))
        np.testing.assert_allclose(got,
                                   np.asarray(getattr(jres.params, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    assert pres.params.v.shape == (F, K)


def test_hybrid_needs_host_plans():
    """As the JAX trainer: the hybrid path refuses host_plan=False."""
    ds = psynth.synth_ctr(num_examples=64, seed=5, **SYNTH)
    cfg = FMConfig(num_features=F, num_factors=K)
    with pytest.raises(ValueError, match="host_plan"):
        train_sgd(cfg, SGDConfig(**dict(SGD, update_path="hybrid",
                                        host_plan=False)), ds, device="cpu")


def test_sgd_config_matches_jax_field_for_field():
    jf = [(f.name, f.default) for f in dataclasses.fields(JSGDConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(PSGDConfig)]
    assert pf == jf
