"""The port's FM scoring against the JAX package's on the same numpy
parameters: the direct path, the host-plan path and the device-plan path,
for both tasks.

Tolerance rtol 1e-5, atol 1e-6: both sides compute in float32 but sum in
different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.config import FMConfig as JConfig
from sparkfm_tpu.config import Task as JTask
from sparkfm_tpu.models import fm as jfm
from sparkfm_tpu.ops import embedding as JE
from sparkfm_tpu.ops import interaction as JI
from sparkfm_tpu.ops import losses as JL
from sparkfm_tpu_torch import FMConfig, Task
from sparkfm_tpu_torch.models import fm as pfm
from sparkfm_tpu_torch.ops import embedding as PE
from sparkfm_tpu_torch.ops import interaction as PI
from sparkfm_tpu_torch.ops import losses as PL
from sparkfm_tpu_torch.ops import rowio

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _both(num_features, num_factors, task, seed, **kw):
    """Same config and numpy parameters in both packages."""
    rng = np.random.default_rng(seed)
    w0 = np.float32(rng.normal())
    w = rng.normal(0, 0.5, num_features).astype(np.float32)
    v = rng.normal(0, 0.3, (num_features, num_factors)).astype(np.float32)
    jcfg = JConfig(num_features=num_features, num_factors=num_factors,
                   task=JTask(task), seed=seed, **kw)
    pcfg = FMConfig(num_features=num_features, num_factors=num_factors,
                    task=Task(task), seed=seed, **kw)
    jparams = jfm.FMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                           v=jnp.asarray(v))
    pparams = pfm.params_from_numpy(w0, w, v, device="cpu")
    return jcfg, jparams, pcfg, pparams, rng


def _batch(rng, num_features, rows=64, slots=8, pad=2):
    ids = rng.integers(0, num_features, (rows, slots)).astype(np.int32)
    vals = rng.normal(size=(rows, slots)).astype(np.float32)
    ids[:, -pad:] = 0          # padding slots: id 0, val 0
    vals[:, -pad:] = 0.0
    return ids, vals


@pytest.mark.parametrize("task", ["regression", "classification"])
@pytest.mark.parametrize("path", ["direct", "host_plan", "device_plan"])
def test_scores_and_predict_match_jax(task, path):
    F = 100 if path == "direct" else 1 << 16
    jcfg, jparams, pcfg, pparams, rng = _both(F, 8, task, seed=len(path))
    ids, vals = _batch(rng, F)
    jplan = pplan = None
    if path == "host_plan":
        cap = PE.auto_budget(ids.size)
        hp = PE.host_dedup(ids, cap, fill=F - 1)
        rung = PE.ladder_budget(int(hp.count), cap=cap)
        hp = hp._replace(uids=hp.uids[:rung])
        pplan = PE.plan_to_device(hp, "cpu")
        jplan = JE.DedupBatch(uids=jnp.asarray(hp.uids),
                              ranks=jnp.asarray(hp.ranks),
                              count=jnp.asarray(hp.count),
                              overflow=jnp.asarray(hp.overflow))
    ids_t, vals_t = torch.from_numpy(ids), torch.from_numpy(vals)
    for jf, pf in ((jfm.scores, pfm.scores), (jfm.predict, pfm.predict)):
        want = np.asarray(jf(jparams, jcfg, jnp.asarray(ids),
                             jnp.asarray(vals), plan=jplan))
        got = pf(pparams, pcfg, ids_t, vals_t, plan=pplan)
        assert got.dtype == torch.float32 and got.shape == (64,)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bias_and_linear_switches_match_jax():
    for use_bias, use_linear in ((False, True), (True, False)):
        jcfg, jparams, pcfg, pparams, rng = _both(
            200, 4, "regression", seed=3, use_bias=use_bias,
            use_linear=use_linear)
        ids, vals = _batch(rng, 200, rows=16)
        want = np.asarray(jfm.scores(jparams, jcfg, jnp.asarray(ids),
                                     jnp.asarray(vals)))
        got = pfm.scores(pparams, pcfg, torch.from_numpy(ids),
                         torch.from_numpy(vals))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_interaction_forms_match_jax():
    rng = np.random.default_rng(4)
    vx = rng.normal(size=(8, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        PI.interaction_from_rows(torch.from_numpy(vx)).numpy(),
        np.asarray(JI.interaction_from_rows(jnp.asarray(vx))), **TOL)
    w_rows = rng.normal(size=(8, 5)).astype(np.float32)
    vals = rng.normal(size=(8, 5)).astype(np.float32)
    w0 = np.float32(0.5)
    want = JI.fm_scores_from_gathered(jnp.asarray(w0), jnp.asarray(w_rows),
                                      jnp.asarray(vx), jnp.asarray(vals))
    got = PI.fm_scores_from_gathered(torch.tensor(w0),
                                     torch.from_numpy(w_rows),
                                     torch.from_numpy(vx),
                                     torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_scoring_paths_never_launch_on_cpu():
    kernels = (rowio.GATHER, rowio.GATHER_VW)
    before = [k.launches for k in kernels]
    _, _, pcfg, pparams, rng = _both(1 << 16, 4, "regression", seed=5)
    ids, vals = _batch(rng, 1 << 16, rows=8)
    pfm.scores(pparams, pcfg, torch.from_numpy(ids), torch.from_numpy(vals))
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("plan", ["host", "device"])
def test_plan_scores_read_vw_u_as_jax_forms_it(plan):
    """The plan path's (U, K+1) rows come from one two-table gather; the
    JAX package forms the same rows by two gathers and a concatenate
    (``sparkfm_tpu/models/fm.py``). The rows are equal exactly, and so are
    the scores the port computes from either."""
    F, K = 1 << 16, 8
    jcfg, jparams, pcfg, pparams, rng = _both(F, K, "classification",
                                              seed=11)
    ids, vals = _batch(rng, F)
    ids_t, vals_t = torch.from_numpy(ids), torch.from_numpy(vals)
    if plan == "host":
        hp = PE.host_dedup(ids, PE.auto_budget(ids.size), fill=F - 1)
        pplan = PE.plan_to_device(hp._replace(
            uids=hp.uids[:PE.ladder_budget(int(hp.count))]), "cpu")
    else:
        pplan = PE.dedup_ids(ids_t, PE.auto_budget(ids.size), fill=F - 1)
    uids = jnp.asarray(pplan.uids.numpy())
    jvw = np.array(jnp.concatenate(
        [jparams.v.at[uids].get(indices_are_sorted=True,
                                mode="promise_in_bounds"),
         jparams.w.at[uids].get(indices_are_sorted=True,
                                mode="promise_in_bounds")[:, None]], axis=1))
    got = rowio.gather_vw_rows(pparams.v, pparams.w, pplan.uids)
    np.testing.assert_array_equal(got.numpy(), jvw)
    rows = torch.from_numpy(jvw)[pplan.ranks.reshape(-1).long()].view(
        *ids.shape, K + 1)
    want = PI.fm_scores_from_gathered(pparams.w0, rows[..., K],
                                      rows[..., :K], vals_t)
    assert torch.equal(pfm.scores(pparams, pcfg, ids_t, vals_t, plan=pplan),
                       want)


def test_l2_penalty_matches_jax():
    jcfg, jparams, pcfg, pparams, _ = _both(300, 4, "regression", seed=6,
                                            reg0=0.1, reg_w=0.01, reg_v=0.5)
    np.testing.assert_allclose(
        pfm.l2_penalty(pparams, pcfg).item(),
        float(jfm.l2_penalty(jparams, jcfg)), rtol=1e-5)


def test_init_params_distribution():
    """torch's and jax's random numbers differ for one seed, so init is
    held to its distribution only: both N(mean, stdev) for V, zeros for
    w0 and w."""
    cfg = FMConfig(num_features=4096, num_factors=8, init_mean=0.1,
                   init_stdev=0.05, seed=3)
    p = pfm.init_params(cfg, device="cpu")
    assert p.v.shape == (4096, 8) and p.v.dtype == torch.float32
    assert p.w.shape == (4096,) and p.w0.shape == ()
    assert float(p.w.abs().max()) == 0.0 and float(p.w0) == 0.0
    assert not p.v.requires_grad
    jp = jfm.init_params(JConfig(num_features=4096, num_factors=8,
                                 init_mean=0.1, init_stdev=0.05, seed=3),
                         jax.random.PRNGKey(3))
    jv = np.asarray(jp.v)
    for v in (p.v.numpy(), jv):
        assert abs(v.mean() - 0.1) < 2e-3
        assert abs(v.std() - 0.05) < 2e-3
    # seeded: the same config gives the same parameters
    torch.testing.assert_close(p.v, pfm.init_params(cfg, device="cpu").v,
                               rtol=0, atol=0)
    g = torch.Generator().manual_seed(11)
    other = pfm.init_params(cfg, g, device="cpu")
    assert not torch.equal(other.v, p.v)


def test_field_aware_config_is_not_ported_yet():
    cfg = FMConfig(num_features=64, num_factors=2, num_fields=3)
    with pytest.raises(NotImplementedError):
        pfm.init_params(cfg, device="cpu")
    params = pfm.params_from_numpy(np.float32(0), np.zeros(64, np.float32),
                                   np.zeros((64, 6), np.float32),
                                   device="cpu")
    with pytest.raises(NotImplementedError):
        pfm.scores(params, cfg, torch.zeros((1, 3), dtype=torch.int32),
                   torch.ones((1, 3)))


def test_losses_match_jax():
    rng = np.random.default_rng(7)
    s = rng.normal(size=32).astype(np.float32)
    y = (rng.random(32) > 0.5).astype(np.float32)
    wt = rng.random(32).astype(np.float32)
    for jl, pl in ((JL.squared_loss, PL.squared_loss),
                   (JL.logistic_loss, PL.logistic_loss)):
        for weights in (None, wt):
            want = float(jl(jnp.asarray(s), jnp.asarray(y),
                            None if weights is None
                            else jnp.asarray(weights)))
            got = pl(torch.from_numpy(s), torch.from_numpy(y),
                     None if weights is None else torch.from_numpy(weights))
            np.testing.assert_allclose(got.item(), want, **TOL)
    for task in ("regression", "classification"):
        np.testing.assert_allclose(
            PL.predict_for_task(Task(task), torch.from_numpy(s)).numpy(),
            np.asarray(JL.predict_for_task(JTask(task), jnp.asarray(s))),
            **TOL)
        assert (PL.loss_for_task(Task(task)).__name__
                == JL.loss_for_task(JTask(task)).__name__)
