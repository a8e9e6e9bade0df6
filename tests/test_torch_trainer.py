"""The port's train_sgd against the JAX package's (``update_path=
"hybrid"``, and "fused" and "sorted"), from the same initial parameters,
on ``synth_ctr`` with shuffled epochs and, where the path takes them,
ladder plans.

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
    (dict(mesh=object()), {}, "A15"),
    (dict(checkpoint_dir="ckpt"), {}, "A5"),
    ({}, dict(steps_per_dispatch=2), "A3"),
    ({}, dict(update_path="dedup"), "A9"),
    ({}, dict(update_path="direct"), "A9"),
])
def test_unported_options_raise(kw, sgd_kw, match, tmp_path):
    ds = psynth.synth_ctr(num_examples=64, seed=5, **SYNTH)
    cfg = FMConfig(num_features=F, num_factors=K)
    if "checkpoint_dir" in kw:
        kw = dict(checkpoint_dir=str(tmp_path / "ckpt"))
    with pytest.raises(NotImplementedError, match=match):
        train_sgd(cfg, SGDConfig(**dict(SGD, **sgd_kw)), ds, device="cpu",
                  **kw)


def test_small_tables_raise_under_auto():
    """Under update_path='auto' the JAX package trains a table below 2^16
    rows on its direct path, which is not ported; 'hybrid' pinned
    trains it."""
    ds = psynth.synth_ctr(num_examples=64, num_fields=4, num_buckets=1000,
                          seed=6)
    cfg = FMConfig(num_features=1000, num_factors=K)
    with pytest.raises(NotImplementedError, match="direct"):
        train_sgd(cfg, SGDConfig(**SGD), ds, device="cpu")
    res = train_sgd(cfg, SGDConfig(update_path="hybrid", **SGD), ds,
                    device="cpu")
    assert np.isfinite(res.history[-1]["train_loss"])


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
