"""The port's reference ALS sweep and its sharded ALS and MCMC
(``solvers/als.py::als_sweep``, ``solvers/mcmc.py::mcmc_sweep_direct``,
``parallel/sharded_als.py``) against the JAX package's, from the same
numpy data and parameters.

The sharded port runs on 8 gloo ranks of this CPU, spawned once for the
file; the JAX side on the conftest's 8-device mesh. Tolerances are the
JAX tests' (``tests/test_sharded_als.py``): one sweep atol 1e-5 (w0 rtol
1e-5), three sweeps atol 5e-4, the MCMC chain rtol 2e-4 / atol 2e-5 and
its posterior-mean RMSE rtol 1e-3. JAX's PRNG and torch's differ, so the
MCMC chains draw from the fake pattern of ``tests/test_torch_mcmc.py``:
JAX traces its sweep once with ``jax.random`` patched, so every sweep
replays the draws of one trace, in which each loop body is traced once
(one draw for every w block, one for every (factor, block));
:class:`TracedDraws` gives the port the same draws.
"""

import numpy as np
import pytest
import torch

from sparkfm_tpu_torch.api import FM
from sparkfm_tpu_torch.config import ALSConfig, FMConfig, MCMCConfig, MeshConfig
from sparkfm_tpu_torch.data import synth
from sparkfm_tpu_torch.models import fm as fm_model
from sparkfm_tpu_torch.models.fm import params_from_numpy
from sparkfm_tpu_torch.parallel import mesh as M
from sparkfm_tpu_torch.parallel import multihost as MH
from sparkfm_tpu_torch.parallel import sharded_als as SA
from sparkfm_tpu_torch.solvers import als

torch.set_num_threads(1)
SWEEP_TOL = dict(atol=1e-5)
CHAIN_TOL = dict(rtol=2e-4, atol=2e-5)


def _ratings(n=999, seed=0):
    return synth.synth_movielens(num_users=30, num_items=40, num_examples=n,
                                 seed=seed)


def _params(f, k, seed):
    rng = np.random.default_rng(seed)
    return (np.float32(0.1), rng.normal(0, 0.05, f).astype(np.float32),
            rng.normal(0, 0.05, (f, k)).astype(np.float32))


SWEEPS = {   # name: (mesh, k, cfg kwargs, block_size, sweeps)
    "one_sweep_4x2": ((4, 2), 3, dict(reg0=0.1, reg_w=0.3, reg_v=0.5), 16,
                      1),
    "three_sweeps_8x1": ((8, 1), 2, dict(reg_w=0.1, reg_v=0.5), 8, 3),
}


def pattern(shape, call):
    """``tests/test_torch_mcmc.py``'s fake standard normal of the
    ``call``-th draw."""
    n = int(np.prod(shape, dtype=np.int64))
    return (((np.arange(n) + 3 * call) % 7) / 7 - 0.4).astype(
        np.float32).reshape(shape)


class TracedDraws:
    """The fake draws of one traced JAX sweep, replayed every sweep: the
    six prior and bias draws are calls 1-6 (call 0 is the init), every w
    block's draw call 7, every (factor, block)'s call 8; the gamma returns
    its shape parameter."""

    def __init__(self, blocks, k):
        self.per_sweep, self.blocks, self.i = 6 + blocks * (1 + k), blocks, 0

    def _next(self):
        j = self.i % self.per_sweep
        self.i += 1
        return 1 + j if j < 6 else (7 if j < 6 + self.blocks else 8)

    def normal(self, shape):
        return torch.as_tensor(pattern(tuple(shape), self._next()))

    def gamma(self, shape_param):
        self._next()
        return shape_param.clone()


def _mcmc_case():
    ds = synth.synth_movielens(num_users=30, num_items=40, num_examples=960,
                               seed=51)
    cfg = FMConfig(num_features=ds.num_features, num_factors=3, seed=51)
    blocks = als.slot_blocks(ds)
    mc = MCMCConfig(epochs=4, burn_in=1, feature_blocks=blocks)
    return ds, cfg, mc, max(blocks) + 1


def _port_mcmc(mesh):
    """train_mcmc_sharded with V from the fake pattern (call 0, as the
    JAX init draws it) and the replayed draws."""
    ds, cfg, mc, blocks = _mcmc_case()
    real = fm_model.init_params

    def pattern_init(cfg, generator=None, *, device):
        p = real(cfg, generator, device=device)
        v = cfg.init_mean + cfg.init_stdev * torch.as_tensor(
            pattern(tuple(p.v.shape), 0))
        return params_from_numpy(p.w0.numpy(), p.w.numpy(), v.numpy(),
                                 device=device)
    fm_model.init_params = pattern_init
    try:
        res = SA.train_mcmc_sharded(cfg, mc, ds, mesh, eval_ds=ds,
                                    draws=TracedDraws(blocks,
                                                      cfg.num_factors))
    finally:
        fm_model.init_params = real
    return dict(v=res.params.v.numpy(), history=res.history)


def _port_world(mesh8):
    meshes = {s: M.make_mesh(*s, device="cpu") for s in ((4, 2), (8, 1))}
    out = {}
    ds = _ratings()
    for name, (shape, k, kw, bs, n_sweeps) in SWEEPS.items():
        cfg = FMConfig(num_features=ds.num_features, num_factors=k, **kw)
        mesh = meshes[shape]
        ws, nb = SA.build_sharded_workspace(ds, cfg, ALSConfig(block_size=bs),
                                            mesh)
        sweep = SA.make_sharded_sweep(cfg, nb, mesh)
        p = params_from_numpy(*_params(ds.num_features, k, 7), device="cpu")
        for _ in range(n_sweeps):
            p = sweep(p, ws)
        out[name] = dict(w0=p.w0.numpy(), w=p.w.numpy(), v=p.v.numpy())
    out["mcmc"] = _port_mcmc(meshes[(8, 1)])

    fds = synth.synth_movielens(num_users=30, num_items=40,
                                num_examples=960, seed=52)
    out["facade_als"] = FM(num_factors=3, solver="als", max_iter=4,
                           reg_v=0.5, mesh=MeshConfig(data=8, model=1)).fit(
        fds, eval_ds=fds, device="cpu").history
    out["facade_mcmc"] = FM(num_factors=3, solver="mcmc", max_iter=4,
                            mesh="4x2").fit(fds, eval_ds=fds,
                                            device="cpu").history
    try:
        FM(solver="als", mesh=MeshConfig(data=8, model=1,
                                         exchange="unique")).fit(
            fds, device="cpu")
        out["exchange_refused"] = None
    except ValueError as e:
        out["exchange_refused"] = str(e)

    tiny = synth.synth_movielens(num_users=12, num_items=12, num_examples=64,
                                 seed=0)
    tcfg = FMConfig(num_features=tiny.num_features, num_factors=2,
                    reg_v=0.5, seed=0)
    out["als_budget"] = len(SA.train_als_sharded(
        tcfg, ALSConfig(epochs=200, block_size=8, max_seconds=1e-6), tiny,
        meshes[(4, 2)]).history)
    out["mcmc_budget"] = len(SA.train_mcmc_sharded(
        tcfg, MCMCConfig(epochs=200, burn_in=1, max_seconds=1e-6,
                         feature_blocks=als.slot_blocks(tiny)),
        tiny, meshes[(4, 2)]).history)
    return out


@pytest.fixture(scope="module")
def port():
    outs = MH.spawn(_port_world, (8, 1), "cpu", timeout=300)
    for o in outs[1:]:
        np.testing.assert_array_equal(o["mcmc"]["v"], outs[0]["mcmc"]["v"])
        np.testing.assert_array_equal(o["one_sweep_4x2"]["v"],
                                      outs[0]["one_sweep_4x2"]["v"])
    return outs[0]


def _jax_ds(ds):
    from sparkfm_tpu.data.batching import SparseDataset as JDataset
    return JDataset(ids=ds.ids, vals=ds.vals, y=ds.y,
                    num_features=ds.num_features)


def _jax_params(arrays):
    import jax.numpy as jnp

    from sparkfm_tpu.models.fm import FMParams as JParams
    return JParams(*(jnp.asarray(a) for a in arrays))


def test_direct_sweep_matches_jax_als_sweep():
    """The port's one-device reference sweep against JAX ``als_sweep``,
    and against the port's compact sweep (``train_als``'s), at block
    sizes 1 (exact Gauss-Seidel), 16 and slot blocks, with per-group L2."""
    from sparkfm_tpu.config import ALSConfig as JALSConfig
    from sparkfm_tpu.config import FMConfig as JFMConfig
    from sparkfm_tpu.solvers import als as JA

    ds = _ratings()
    f = ds.num_features
    groups = tuple([0] * 30 + [1] * (f - 30))
    for blocks, grouped in ((dict(block_size=1), False),
                            (dict(block_size=16), True),
                            (dict(feature_blocks=als.slot_blocks(ds)), False)):
        kw = dict(num_features=f, num_factors=3, reg0=0.1, reg_w=0.3,
                  reg_v=0.5)
        if grouped:
            kw.update(feature_groups=groups, group_reg_w=(0.1, 0.4),
                      group_reg_v=(0.3, 0.7))
        cfg, jcfg = FMConfig(**kw), JFMConfig(**kw)
        arrays = _params(f, 3, 3)
        jws, nb = JA.build_workspace(_jax_ds(ds), jcfg, JALSConfig(**blocks))
        rw, rv = jcfg.reg_vectors()
        want = JA.als_sweep(_jax_params(arrays), jws, nb, f, 0.1, rw, rv)
        ws, pnb = als.build_workspace(ds, cfg, ALSConfig(**blocks),
                                      device="cpu")
        prw, prv = (torch.as_tensor(r) for r in cfg.reg_vectors())
        got = als.als_sweep(params_from_numpy(*arrays, device="cpu"), ws,
                            pnb, f, 0.1, prw, prv)
        compact = als.als_sweep_compact(
            params_from_numpy(*arrays, device="cpu"), ws, pnb,
            ws.present.shape[0], 0.1, prw, prv)
        for p in (got, compact):
            np.testing.assert_allclose(float(p.w0), float(want.w0),
                                       rtol=1e-5)
            np.testing.assert_allclose(p.w.numpy(), np.asarray(want.w),
                                       **SWEEP_TOL)
            np.testing.assert_allclose(p.v.numpy(), np.asarray(want.v),
                                       **SWEEP_TOL)


def test_direct_sweep_sums_through_segment_colsums(monkeypatch):
    """Every per-feature sum of the reference sweep is kernel B7's
    function: one stream a w block, two a (factor, block), over the
    sorted feature ids with F ranks."""
    from sparkfm_tpu_torch.ops import segsum
    calls = []
    real = segsum.segment_colsums

    def counting(streams, seg, num_segments):
        calls.append((len(streams), num_segments))
        return real(streams, seg, num_segments)
    monkeypatch.setattr(segsum, "segment_colsums", counting)
    ds = _ratings()
    cfg = FMConfig(num_features=ds.num_features, num_factors=3)
    ws, nb = als.build_workspace(ds, cfg, ALSConfig(block_size=16),
                                 device="cpu")
    als.als_sweep(fm_model.init_params(cfg, device="cpu"), ws, nb,
                  ds.num_features, 0.0, 0.1, 0.5)
    f = ds.num_features
    assert calls == [(1, f)] * nb + [(2, f)] * (3 * nb)


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sharded_sweeps_match_jax(port, name):
    """One sweep at (4, 2), three at (8, 1): the port's sharded sweep
    against JAX's sharded sweep and JAX's one-device sweep."""
    from sparkfm_tpu.config import ALSConfig as JALSConfig
    from sparkfm_tpu.config import FMConfig as JFMConfig
    from sparkfm_tpu.parallel import mesh as JM
    from sparkfm_tpu.parallel import sharded_als as JSA
    from sparkfm_tpu.solvers import als as JA

    shape, k, kw, bs, n_sweeps = SWEEPS[name]
    ds = _jax_ds(_ratings())
    jcfg = JFMConfig(num_features=ds.num_features, num_factors=k, **kw)
    mesh = JM.make_mesh(*shape)
    ws_m, nb = JSA.build_sharded_workspace(ds, jcfg, JALSConfig(block_size=bs),
                                           mesh)
    ws_s, _ = JA.build_workspace(ds, jcfg, JALSConfig(block_size=bs))
    sweep = JSA.make_sharded_sweep(jcfg, nb, mesh)
    p_m = p_s = _jax_params(_params(ds.num_features, k, 7))
    for _ in range(n_sweeps):
        p_m = sweep(p_m, ws_m)
        p_s = JA.als_sweep(p_s, ws_s, nb, jcfg.num_features, jcfg.reg0,
                           jcfg.reg_w, jcfg.reg_v)
    got = port[name]
    tol = SWEEP_TOL if n_sweeps == 1 else dict(atol=5e-4)
    for want in (p_m, p_s):
        np.testing.assert_allclose(float(got["w0"]), float(want.w0),
                                   rtol=1e-5 if n_sweeps == 1 else 5e-4)
        np.testing.assert_allclose(got["w"], np.asarray(want.w), **tol)
        np.testing.assert_allclose(got["v"], np.asarray(want.v), **tol)


def test_sharded_mcmc_chain_matches_jax(port, monkeypatch):
    """train_mcmc_sharded at (8, 1) on the same fake draws as JAX's
    train_mcmc_sharded: the last sample and the posterior-mean RMSEs."""
    import jax
    import jax.numpy as jnp

    from sparkfm_tpu.config import FMConfig as JFMConfig
    from sparkfm_tpu.config import MCMCConfig as JMCMCConfig
    from sparkfm_tpu.parallel import mesh as JM
    from sparkfm_tpu.parallel.sharded_als import train_mcmc_sharded

    calls = []

    def normal(key, shape=(), dtype=jnp.float32):
        calls.append("normal")
        return jnp.asarray(pattern(tuple(shape), len(calls) - 1), dtype)

    def gamma(key, a, shape=None, dtype=jnp.float32):
        calls.append("gamma")
        return jnp.asarray(a, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    monkeypatch.setattr(jax.random, "gamma", gamma)
    ds, cfg, mc, _ = _mcmc_case()
    want = train_mcmc_sharded(
        JFMConfig(num_features=cfg.num_features, num_factors=3, seed=51),
        JMCMCConfig(epochs=mc.epochs, burn_in=mc.burn_in,
                    feature_blocks=mc.feature_blocks),
        _jax_ds(ds), JM.make_mesh(8, 1), eval_ds=_jax_ds(ds),
        key=jax.random.PRNGKey(51))
    assert len(calls) == 9              # the init, then one trace
    got = port["mcmc"]
    np.testing.assert_allclose(got["v"], np.asarray(want.params.v),
                               **CHAIN_TOL)
    for key in ("eval_rmse_avg", "alpha", "lam_w"):
        a = [h[key] for h in got["history"] if key in h]
        b = [h[key] for h in want.history if key in h]
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(a, b, rtol=1e-3)


def test_facade_als_and_mcmc_on_mesh(port):
    """FM(solver='als'|'mcmc', mesh=...) trains sharded end to end (the
    JAX test's bounds); an exchange pin is refused."""
    assert port["facade_als"][-1]["eval_rmse"] < 0.6
    assert port["facade_mcmc"][-1]["eval_rmse_avg"] < 1.0
    assert "exchange" in port["exchange_refused"]


def test_sharded_als_and_mcmc_honor_max_seconds(port):
    assert port["als_budget"] == 1
    assert port["mcmc_budget"] == 1
