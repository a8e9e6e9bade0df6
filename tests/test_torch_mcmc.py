"""The port's MCMC (``sparkfm_tpu_torch/solvers/mcmc.py``) against the JAX
package's, from the same numpy data and parameters under the same
injected draws:

- one sweep, then 3, against JAX ``mcmc_sweep`` at the ALS sweep parity
  (rtol 2e-4 / atol 2e-5, ``tests/test_torch_als.py``), with one and two
  attribute groups, ``use_bias``/``use_linear`` off, and contiguous and
  slot blocks;
- ``train_mcmc``'s history (alpha, lam_w, eval_rmse_avg,
  eval_rmse_sample) and posterior-mean scores against JAX's.

JAX's PRNG and torch's differ, so both sweeps draw from fakes: JAX runs
unjitted (``jax.disable_jit``, since a trace cached by an earlier call
would keep the draws it traced) with ``jax.random.normal`` and
``jax.random.gamma`` patched, the port from a draw source with the same
pattern (:class:`FakeDraws`). The fake gamma returns its shape parameter,
so it cannot see the one place the two sweeps differ on purpose: the port
draws lambda_v with a (G, K) shape parameter, JAX with a (G, 1) one
(defect 2 of ROADMAP C). The default source (``TorchDraws``) is checked by
distribution, and defect 2 by its columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.config import FMConfig as JFMConfig
from sparkfm_tpu.config import MCMCConfig as JMCMCConfig
from sparkfm_tpu.models import fm as jfm
from sparkfm_tpu.solvers import als as JA
from sparkfm_tpu.solvers import mcmc as JM
from sparkfm_tpu_torch import FMConfig, MCMCConfig, Task
from sparkfm_tpu_torch.config import ALSConfig
from sparkfm_tpu_torch.data import synth as psynth
from sparkfm_tpu_torch.data.batching import SparseDataset
from sparkfm_tpu_torch.models.fm import params_from_numpy
from sparkfm_tpu_torch.ops import segsum
from sparkfm_tpu_torch.solvers import als as PA
from sparkfm_tpu_torch.solvers import mcmc as PM

torch.set_num_threads(1)
SWEEP_TOL = dict(rtol=2e-4, atol=2e-5)


def pattern(shape, call):
    """The fake standard normal of the ``call``-th draw: a fixed pattern
    in [-0.4, 0.46) that changes with every call."""
    n = int(np.prod(shape, dtype=np.int64))
    return (((np.arange(n) + 3 * call) % 7) / 7 - 0.4).astype(
        np.float32).reshape(shape)


class FakeDraws:
    """The port's draw source under the JAX fakes' pattern; the gamma
    returns its shape parameter. ``calls`` logs (kind, shape)."""

    def __init__(self, device="cpu"):
        self.device = device
        self.calls = []

    def normal(self, shape):
        self.calls.append(("normal", tuple(shape)))
        return torch.as_tensor(pattern(tuple(shape), len(self.calls) - 1),
                               device=self.device)

    def gamma(self, shape_param):
        self.calls.append(("gamma", tuple(shape_param.shape)))
        return shape_param.clone()


@pytest.fixture
def jax_fakes(monkeypatch):
    """JAX unjitted with the fake normal and gamma; yields the call log."""
    calls = []

    def normal(key, shape=(), dtype=jnp.float32):
        calls.append(("normal", tuple(shape)))
        return jnp.asarray(pattern(tuple(shape), len(calls) - 1), dtype)

    def gamma(key, a, shape=None, dtype=jnp.float32):
        calls.append(("gamma", tuple(jnp.shape(a))))
        return jnp.asarray(a, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    monkeypatch.setattr(jax.random, "gamma", gamma)
    with jax.disable_jit():
        yield calls


def _data(seed, n=300, users=25, movies=20, spare=3):
    """User/movie one-hot pairs; ``spare`` features no example has."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, users, n),
                    users + rng.integers(0, movies, n)], axis=1
                   ).astype(np.int32)
    y = (1.0 + 0.3 * rng.normal(size=n)).astype(np.float32)
    return SparseDataset(ids=ids, vals=np.ones((n, 2), np.float32), y=y,
                         num_features=users + movies + spare)


def _arrays(f, k, seed):
    rng = np.random.default_rng(seed)
    return (np.float32(0.3), rng.normal(0, 0.1, f).astype(np.float32),
            rng.normal(0, 0.1, (f, k)).astype(np.float32))


def _hyper(g, k, seed):
    """A non-trivial MCMC state's hyperparameters (alpha, lam_w, mu_w,
    lam_v, mu_v)."""
    rng = np.random.default_rng(seed)
    return (np.float32(2.0), rng.uniform(0.5, 2, g).astype(np.float32),
            rng.normal(0, 0.1, g).astype(np.float32),
            rng.uniform(0.5, 2, (g, k)).astype(np.float32),
            rng.normal(0, 0.1, (g, k)).astype(np.float32))


def _as_port_calls(jax_calls, k):
    """The JAX call log with lambda_v's (G, 1) gamma shape parameter read
    as the port's (G, K)."""
    return [("gamma", (c[1][0], k)) if c[0] == "gamma" and len(c[1]) == 2
            else c for c in jax_calls]


def _jcfg(cfg):
    return JFMConfig(num_features=cfg.num_features,
                     num_factors=cfg.num_factors, use_bias=cfg.use_bias,
                     use_linear=cfg.use_linear,
                     feature_groups=cfg.feature_groups)


def _assert_state(got, want, **tol):
    np.testing.assert_allclose(float(got.params.w0), float(want.params.w0),
                               **tol)
    for name in ("w", "v"):
        np.testing.assert_allclose(getattr(got.params, name).numpy(),
                                   np.asarray(getattr(want.params, name)),
                                   err_msg=name, **tol)
    for name in ("alpha", "lam_w", "mu_w", "mu_v"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   err_msg=name, **tol)
    # JAX's (G, 1) gamma broadcast against the port's (G, K): equal under
    # the fake, which returns the shape parameter
    np.testing.assert_allclose(got.lam_v.numpy(),
                               np.broadcast_to(np.asarray(want.lam_v),
                                               got.lam_v.shape), **tol)


CASES = {
    "one group, slot blocks": dict(blocks="slots"),
    "two groups, slot blocks": dict(blocks="slots", groups=2),
    "contiguous blocks": dict(blocks=16),
    "no bias, no linear": dict(blocks="slots", use_bias=False,
                               use_linear=False),
}


def _setup(case, k=4):
    ds = _data(1)
    f = ds.num_features
    groups = None
    if case.get("groups"):
        groups = tuple(int(g) for g in np.arange(f) % 2)
    cfg = FMConfig(num_features=f, num_factors=k,
                   use_bias=case.get("use_bias", True),
                   use_linear=case.get("use_linear", True),
                   feature_groups=groups)
    blocks = case["blocks"]
    acfg = (ALSConfig(feature_blocks=PA.slot_blocks(ds)) if blocks == "slots"
            else ALSConfig(block_size=blocks))
    return ds, cfg, acfg


@pytest.mark.parametrize("name", sorted(CASES))
def test_sweeps_match_jax_under_the_same_draws(name, jax_fakes):
    ds, cfg, acfg = _setup(CASES[name])
    g = cfg.num_groups
    arrays = _arrays(cfg.num_features, cfg.num_factors, 2)
    hyper = _hyper(g, cfg.num_factors, 3)
    state = PM.mcmc_state_from_numpy(*arrays, *hyper, device="cpu")
    ws, nb = PA.build_workspace(ds, cfg, acfg, device="cpu")
    bof, _ = PA.feature_blocks_of(cfg.num_features, acfg)
    cpure = PA.blocks_are_column_pure(ds, bof)
    uniform = cpure and PA.csc_blocks_uniform(ds, bof)
    ident = PA.csc_slice_identity(ws, nb, ds.num_examples) if uniform else ()
    assert cpure == (acfg.feature_blocks is not None)
    pgroups = (None if cfg.feature_groups is None
               else torch.tensor(cfg.feature_groups))

    from sparkfm_tpu.config import ALSConfig as JALSConfig
    jws, jnb = JA.build_workspace(ds, _jcfg(cfg), JALSConfig(
        block_size=acfg.block_size, feature_blocks=acfg.feature_blocks))
    jstate = JM.MCMCState(
        params=jfm.FMParams(*(jnp.asarray(a) for a in arrays)),
        alpha=jnp.asarray(hyper[0]), lam_w=jnp.asarray(hyper[1]),
        mu_w=jnp.asarray(hyper[2]), lam_v=jnp.asarray(hyper[3]),
        mu_v=jnp.asarray(hyper[4]))
    jgroups = (None if cfg.feature_groups is None
               else jnp.asarray(np.asarray(cfg.feature_groups, np.int32)))
    draws = FakeDraws()
    for sweep in range(3):
        state = PM.mcmc_sweep(
            state, ws, draws, nb, cfg.num_features, groups=pgroups,
            num_groups=g, alpha_0=1.5, beta_0=0.5, gamma_0=2.0,
            use_bias=cfg.use_bias, use_linear=cfg.use_linear,
            column_pure=cpure, csc_uniform=uniform, slice_identity=ident)
        jstate = JM.mcmc_sweep(
            jstate, jws, jax.random.PRNGKey(sweep), jnb, cfg.num_features,
            groups=jgroups, num_groups=g, alpha_0=1.5, beta_0=0.5,
            gamma_0=2.0, use_bias=cfg.use_bias, use_linear=cfg.use_linear)
        assert draws.calls == _as_port_calls(jax_fakes, cfg.num_factors)
        _assert_state(state, jstate, **SWEEP_TOL)
    absent = np.setdiff1d(np.arange(cfg.num_features), ws.present.numpy())
    assert absent.size == 3
    np.testing.assert_array_equal(state.params.v.numpy()[absent],
                                  arrays[2][absent])


def test_draw_order_and_shapes(jax_fakes):
    """K = 4 and two slot blocks: 16 draws a sweep, in the JAX sweep's
    order and shapes but for lambda_v's (G, K) shape parameter."""
    ds, cfg, acfg = _setup(CASES["one group, slot blocks"])
    ws, nb = PA.build_workspace(ds, cfg, acfg, device="cpu")
    state = PM.init_mcmc_state(params_from_numpy(
        *_arrays(cfg.num_features, 4, 0), device="cpu"))
    draws = FakeDraws()
    PM.mcmc_sweep(state, ws, draws, nb, cfg.num_features)
    f = cfg.num_features
    assert draws.calls == ([("gamma", ()), ("gamma", (1,)),
                            ("normal", (1,)), ("gamma", (1, 4)),
                            ("normal", (1, 4)), ("normal", ())]
                           + [("normal", (f,))] * (2 + 4 * 2))
    jws, jnb = JA.build_workspace(ds, _jcfg(cfg), JA.ALSConfig(
        feature_blocks=acfg.feature_blocks))
    JM.mcmc_sweep(JM.init_mcmc_state(jfm.FMParams(
        *(jnp.asarray(a) for a in _arrays(f, 4, 0)))), jws,
        jax.random.PRNGKey(0), jnb, f)
    assert len(jax_fakes) == 16
    assert [c for c in jax_fakes if c[0] == "gamma"][2] == ("gamma", (1, 1))
    assert ([c for c in draws.calls if c[0] == "normal"]
            == [c for c in jax_fakes if c[0] == "normal"])


def test_sweep_sums_through_segment_colsums(monkeypatch):
    """One B7 call per w block (1 stream) and per (factor, block) (2
    streams): (K + 1) x num_blocks per sweep, all on the CPU's plain
    version."""
    calls = []
    plain = segsum.segment_colsums

    def counting(streams, seg, num_segments):
        calls.append(len(streams))
        return plain(streams, seg, num_segments)

    monkeypatch.setattr(segsum, "segment_colsums", counting)
    ds = _data(4)
    cfg = FMConfig(num_features=ds.num_features, num_factors=3)
    res = PM.train_mcmc(cfg, MCMCConfig(
        epochs=2, burn_in=1, feature_blocks=PA.slot_blocks(ds)), ds,
        device="cpu")
    assert len(res.history) == 2
    assert calls == 2 * ([1, 1] + [2, 2] * 3)


def _trained(jax_fakes, eval_ds, train, cfg, mcfg, arrays):
    jres = JM.train_mcmc(
        _jcfg(cfg), JMCMCConfig(**{f: getattr(mcfg, f) for f in (
            "epochs", "burn_in", "block_size", "feature_blocks")}),
        train, eval_ds=eval_ds, key=jax.random.PRNGKey(0),
        params=jfm.FMParams(*(jnp.asarray(a) for a in arrays)))
    pres = PM.train_mcmc(cfg, mcfg, train, eval_ds=eval_ds,
                         params=params_from_numpy(*arrays, device="cpu"),
                         draws=FakeDraws(), device="cpu")
    return pres, jres


def test_train_mcmc_matches_jax_under_the_same_draws(jax_fakes):
    """History (alpha, lam_w, eval_rmse_avg, eval_rmse_sample) at rtol
    1e-4, the posterior-mean scores and the last sample at the sweep
    parity."""
    ds = psynth.synth_movielens(20, 25, 1200, rank=3, noise=0.1, seed=0)
    train, test = ds.slice(np.arange(1000)), ds.slice(np.arange(1000, 1200))
    cfg = FMConfig(num_features=ds.num_features, num_factors=4)
    mcfg = MCMCConfig(epochs=4, burn_in=1,
                      feature_blocks=PA.slot_blocks(train))
    arrays = _arrays(ds.num_features, 4, 7)
    pres, jres = _trained(jax_fakes, test, train, cfg, mcfg, arrays)
    assert [sorted(h) for h in pres.history] == [sorted(h)
                                                for h in jres.history]
    assert "eval_rmse_avg" not in pres.history[0]
    for got, want in zip(pres.history, jres.history):
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-4,
                                       err_msg=key)
    np.testing.assert_allclose(pres.extras["avg_scores"],
                               jres.extras["avg_scores"], **SWEEP_TOL)
    _assert_state(pres.extras["mcmc_state"], jres.extras["mcmc_state"],
                  **SWEEP_TOL)
    assert pres.params is pres.extras["mcmc_state"].params
    assert pres.examples_per_sec > 0


def test_default_draws_by_distribution():
    """TorchDraws: standard normals (mean 0, variance 1) and standard
    Gamma variates (mean = variance = the shape parameter), 2^16 each."""
    draws = PM.TorchDraws(torch.Generator().manual_seed(0))
    z = draws.normal((1 << 16,)).double()
    assert abs(float(z.mean())) < 0.02 and abs(float(z.var()) - 1) < 0.03
    a = torch.full((1 << 16,), 3.0)
    gam = draws.gamma(a).double()
    assert abs(float(gam.mean()) - 3) < 0.05
    assert abs(float(gam.var()) - 3) < 0.15
    assert bool((gam > 0).all())


def test_lambda_v_columns_draw_independently():
    """Defect 2 of the JAX sweep, fixed: lambda_v's K columns come from K
    Gamma variates. With V = 0 and mu_v = 0 every column has the same
    rate, so under one shared variate (JAX) the columns would be equal;
    here they differ, and over many sweeps each column's mean is the
    Gamma mean shape / rate."""
    ds = _data(5)
    f, k = ds.num_features, 8
    cfg = FMConfig(num_features=f, num_factors=k)
    ws, nb = PA.build_workspace(ds, cfg, ALSConfig(
        feature_blocks=PA.slot_blocks(ds)), device="cpu")
    params = params_from_numpy(np.float32(0), np.zeros(f, np.float32),
                               np.zeros((f, k), np.float32), device="cpu")
    draws = PM.TorchDraws(torch.Generator().manual_seed(1))
    lams = []
    for _ in range(400):
        st = PM.mcmc_sweep(PM.init_mcmc_state(params), ws, draws, nb, f,
                           use_linear=False)
        lams.append(st.lam_v[0])
    lams = torch.stack(lams).double()
    assert len(set(lams[0].tolist())) == k
    # shape 1 + (F + 1) / 2, rate 1 + gamma_0 mu^2 / 2 = 1
    np.testing.assert_allclose(lams.mean(0).numpy(), 1 + (f + 1) / 2,
                               rtol=0.03)
    corr = np.corrcoef(lams.numpy().T)[np.triu_indices(k, 1)]
    assert np.abs(corr).max() < 0.3


def test_same_seed_same_chain_and_refusals():
    ds = _data(6)
    cfg = FMConfig(num_features=ds.num_features, num_factors=3, seed=5)
    mcfg = MCMCConfig(epochs=3, burn_in=1,
                      feature_blocks=PA.slot_blocks(ds))
    a = PM.train_mcmc(cfg, mcfg, ds, eval_ds=ds, device="cpu")
    b = PM.train_mcmc(cfg, mcfg, ds, eval_ds=ds, device="cpu")
    assert a.history == b.history
    assert torch.equal(a.params.v, b.params.v)
    c = PM.train_mcmc(cfg.replace(seed=6), mcfg, ds, device="cpu")
    assert not torch.equal(a.params.v, c.params.v)
    with pytest.raises(ValueError, match="squared loss"):
        PM.train_mcmc(cfg.replace(task=Task.CLASSIFICATION), mcfg, ds,
                      device="cpu")
    with pytest.raises(ValueError, match="plain FM"):
        PM.train_mcmc(cfg.replace(num_fields=2), mcfg, ds, device="cpu")


def test_max_seconds_stops_after_one_sweep():
    ds = _data(7)
    cfg = FMConfig(num_features=ds.num_features, num_factors=2)
    res = PM.train_mcmc(cfg, MCMCConfig(epochs=50, max_seconds=1e-6), ds,
                        device="cpu")
    assert len(res.history) == 1


def test_workspace_derives_col_feat_and_mask_as_jax_stores_them():
    """The JAX workspace stores ``col_feat`` and an all-ones ``mask``; the
    port's derives them (present[col_rank], ones) and they are equal."""
    ds, cfg, acfg = _setup(CASES["contiguous blocks"])
    ws, _ = PA.build_workspace(ds, cfg, acfg, device="cpu")
    jws, _ = JA.build_workspace(ds, _jcfg(cfg), JA.ALSConfig(
        block_size=acfg.block_size))
    np.testing.assert_array_equal(ws.col_feat.numpy(),
                                  np.asarray(jws.col_feat))
    np.testing.assert_array_equal(ws.mask.numpy(), np.asarray(jws.mask))
