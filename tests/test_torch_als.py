"""The port's ALS (``sparkfm_tpu_torch/solvers/als.py``) against the JAX
package's, from the same numpy data and parameters:

- the workspace arrays and the host structure checks: exactly equal;
- the compact sweep against JAX ``als_sweep_compact`` under each of its
  three forms, (column_pure, csc_uniform) = (F, F), (T, F), (T, T), and
  against the JAX reference sweep ``als_sweep``, over 3 sweeps at rtol
  2e-4 / atol 2e-5 (the JAX package's own tolerance between its two
  sweeps: the same updates, f32 sums in another order);
- one sweep with single-feature blocks against the sequential numpy oracle
  of ``tests/test_als.py``, at that test's tolerances;
- ``train_als``: the eval history at rtol 1e-4, the parameters at rtol
  2e-4 / atol 2e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.config import ALSConfig as JALSConfig
from sparkfm_tpu.config import FMConfig as JFMConfig
from sparkfm_tpu.config import Task as JTask
from sparkfm_tpu.data import split as jsplit
from sparkfm_tpu.data import synth as jsynth
from sparkfm_tpu.models import fm as jfm
from sparkfm_tpu.solvers import als as JA
from sparkfm_tpu_torch import ALSConfig, FMConfig, Task, train_als
from sparkfm_tpu_torch.config import ALSConfig as PALSConfig
from sparkfm_tpu_torch.data import split as psplit
from sparkfm_tpu_torch.data import synth as psynth
from sparkfm_tpu_torch.data.batching import SparseDataset
from sparkfm_tpu_torch.models.fm import FMParams, params_from_numpy
from sparkfm_tpu_torch.ops import segsum
from sparkfm_tpu_torch.solvers import als as PA
from test_als import _dense_to_sparse, numpy_als_oracle

torch.set_num_threads(1)
SWEEP_TOL = dict(rtol=2e-4, atol=2e-5)


def _two_slot(seed, n=600, users=40, movies=25):
    """User/movie one-hot pairs: slot-aligned, column-pure and
    CSC-uniform."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, users, n),
                    users + rng.integers(0, movies, n)], axis=1
                   ).astype(np.int32)
    return SparseDataset(ids=ids, vals=np.ones((n, 2), np.float32),
                         y=rng.normal(size=(n,)).astype(np.float32),
                         num_features=users + movies)


def _dense(seed, n=80, f=12):
    """Dense normal values, ~40% present: no slot structure at all."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, f)) * (rng.random((n, f)) < 0.4)
    y = rng.normal(size=n)
    j = _dense_to_sparse(dense, y, f)
    return dense, y, SparseDataset(ids=np.asarray(j.ids),
                                   vals=np.asarray(j.vals),
                                   y=np.asarray(j.y), num_features=f)


def _params(cfg, seed, stdev=0.1):
    rng = np.random.default_rng(seed)
    return (np.float32(0.2),
            rng.normal(0, stdev, cfg.num_features).astype(np.float32),
            rng.normal(0, stdev, (cfg.num_features, cfg.num_factors))
            .astype(np.float32))


def _jparams(arrays):
    w0, w, v = arrays
    return jfm.FMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                        v=jnp.asarray(v))


def _jcfg(cfg):
    return JFMConfig(num_features=cfg.num_features,
                     num_factors=cfg.num_factors, reg0=cfg.reg0,
                     reg_w=cfg.reg_w, reg_v=cfg.reg_v, seed=cfg.seed)


def _assert_params(got, want, **tol):
    np.testing.assert_allclose(float(got.w0), float(want.w0), **tol)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), **tol)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), **tol)


DATASETS = {
    "slot_blocks": lambda: (_two_slot(1), "slots"),
    "movielens_widened": lambda: (dataclasses.replace(
        psynth.synth_movielens(10, 12, 200, seed=5), num_features=29),
        "slots"),
    "dense_block1": lambda: (_dense(0)[2], 1),
    "dense_block4": lambda: (_dense(1, n=30, f=20)[2], 4),
}


def _als_cfgs(ds, blocks):
    if blocks == "slots":
        fb = PA.slot_blocks(ds)
        return ALSConfig(feature_blocks=fb), JALSConfig(feature_blocks=fb)
    return ALSConfig(block_size=blocks), JALSConfig(block_size=blocks)


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_workspace_equals_jax(name):
    ds, blocks = DATASETS[name]()
    cfg = FMConfig(num_features=ds.num_features, num_factors=3)
    pcfg, jcfg = _als_cfgs(ds, blocks)
    ws, nb = PA.build_workspace(ds, cfg, pcfg, device="cpu")
    jws, jnb = JA.build_workspace(ds, _jcfg(cfg), jcfg)
    assert nb == jnb
    pairs = {"slot_rank": jws.ids, "slot_val": jws.vals, "y": jws.y,
             "col_row": jws.col_row, "col_val": jws.col_val,
             "col_rank": jws.col_rank, "present": jws.present,
             "block_of_feat": jws.block_of_feat, "den_w": jws.den_w}
    for field, want in pairs.items():
        got = getattr(ws, field)
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, field
        np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
    # the fields the port leaves out follow from the ones it keeps
    np.testing.assert_array_equal(
        ws.present.numpy()[ws.col_rank.numpy()], np.asarray(jws.col_feat))
    assert np.all(np.asarray(jws.mask) == 1)


@pytest.mark.parametrize("name", ["uniform", "overlapping", "swapped_slot",
                                  "movielens", "dense"])
def test_structure_checks_equal_jax(name):
    if name == "uniform":
        ds = _two_slot(2)
    elif name == "overlapping":         # both slots draw from one range
        rng = np.random.default_rng(1)
        ds = SparseDataset(ids=rng.integers(0, 30, (100, 2)).astype(np.int32),
                           vals=np.ones((100, 2), np.float32),
                           y=np.zeros((100,), np.float32), num_features=30)
    elif name == "swapped_slot":
        ds = _two_slot(3)
        ids = ds.ids.copy()
        ids[0, 0], ids[0, 1] = ids[0, 1], ids[0, 0]
        ds = dataclasses.replace(ds, ids=ids)
    elif name == "movielens":
        ds = psynth.synth_movielens(30, 40, 1000, seed=61)
    else:
        ds = _dense(4)[2]
    fb = PA.slot_blocks(ds)
    assert fb == JA.slot_blocks(ds)
    bof = np.asarray(fb)
    assert PA.blocks_are_column_pure(ds, bof) == JA.blocks_are_column_pure(
        ds, bof)
    assert PA.csc_blocks_uniform(ds, bof) == JA.csc_blocks_uniform(ds, bof)
    cfg = FMConfig(num_features=ds.num_features, num_factors=2)
    ws, nb = PA.build_workspace(ds, cfg, ALSConfig(feature_blocks=fb),
                                device="cpu")
    jws, _ = JA.build_workspace(ds, _jcfg(cfg), JALSConfig(feature_blocks=fb))
    assert (PA.csc_slice_identity(ws, nb, ds.num_examples)
            == JA.csc_slice_identity(jws, nb, ds.num_examples))
    # a contiguous block map that puts both slots in one block
    half = (np.arange(ds.num_features) >= ds.num_features // 2).astype(
        np.int32)
    assert PA.csc_blocks_uniform(ds, half) == JA.csc_blocks_uniform(ds, half)


def test_expected_structure_flags():
    ds = _two_slot(4)
    bof = np.asarray(PA.slot_blocks(ds))
    assert PA.blocks_are_column_pure(ds, bof)
    assert PA.csc_blocks_uniform(ds, bof)
    cfg = FMConfig(num_features=ds.num_features, num_factors=2)
    ws, nb = PA.build_workspace(ds, cfg, ALSConfig(feature_blocks=tuple(bof)),
                                device="cpu")
    assert PA.csc_slice_identity(ws, nb, ds.num_examples) == (True, False)


def _sweeps(ds, cfg, arrays, flags, sweeps=3):
    """(port, JAX) params after ``sweeps`` compact sweeps under
    flags = (column_pure, csc_uniform)."""
    fb = PA.slot_blocks(ds)
    ws, nb = PA.build_workspace(ds, cfg, ALSConfig(feature_blocks=fb),
                                device="cpu")
    jws, _ = JA.build_workspace(ds, _jcfg(cfg), JALSConfig(feature_blocks=fb))
    cpure, uniform = flags
    ident = PA.csc_slice_identity(ws, nb, ds.num_examples) if uniform else ()
    nr = int(ws.present.shape[0])
    rw, rv = (torch.from_numpy(r) for r in cfg.reg_vectors())
    jrw, jrv = (jnp.asarray(r) for r in cfg.reg_vectors())
    p = params_from_numpy(*arrays, device="cpu")
    jp = _jparams(arrays)
    for _ in range(sweeps):
        p = PA.als_sweep_compact(p, ws, nb, nr, cfg.reg0, rw, rv,
                                 column_pure=cpure, csc_uniform=uniform,
                                 slice_identity=ident)
        jp = JA.als_sweep_compact(jp, jws, nb, cfg.num_features, nr,
                                  cfg.reg0, jrw, jrv, column_pure=cpure,
                                  csc_uniform=uniform, slice_identity=ident)
    return p, jp


@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (True, True)])
def test_compact_sweep_matches_jax(flags, monkeypatch):
    # JAX takes its csc_uniform form only above a padded-temp size; at 0
    # it takes it here too (as tests/test_als.py does)
    monkeypatch.setattr(JA, "_PAIRED_MINOR_MAX_BYTES", 0)
    ds = _two_slot(11 + flags[0] + flags[1], n=700, users=35)
    cfg = FMConfig(num_features=ds.num_features, num_factors=4, reg_w=0.1,
                   reg_v=0.5)
    p, jp = _sweeps(ds, cfg, _params(cfg, 11), flags)
    _assert_params(p, jp, **SWEEP_TOL)


def test_compact_sweep_matches_jax_reference_sweep():
    ds = psynth.synth_movielens(40, 60, 1500, seed=41)
    cfg = FMConfig(num_features=ds.num_features, num_factors=4, reg_w=0.1,
                   reg_v=0.5, reg0=0.05)
    arrays = _params(cfg, 41)
    fb = PA.slot_blocks(ds)
    ws, nb = PA.build_workspace(ds, cfg, ALSConfig(feature_blocks=fb),
                                device="cpu")
    jws, _ = JA.build_workspace(ds, _jcfg(cfg), JALSConfig(feature_blocks=fb))
    rw, rv = (torch.from_numpy(r) for r in cfg.reg_vectors())
    jrw, jrv = (jnp.asarray(r) for r in cfg.reg_vectors())
    p, jp = params_from_numpy(*arrays, device="cpu"), _jparams(arrays)
    nr = int(ws.present.shape[0])
    for _ in range(3):
        p = PA.als_sweep_compact(p, ws, nb, nr, cfg.reg0, rw, rv,
                                 column_pure=True, csc_uniform=True,
                                 slice_identity=(True, False))
        jp = JA.als_sweep(jp, jws, nb, cfg.num_features, cfg.reg0, jrw, jrv)
    _assert_params(p, jp, **SWEEP_TOL)


@pytest.mark.parametrize("use_bias,use_linear", [(False, True),
                                                 (True, False)])
def test_sweep_without_bias_or_linear_matches_jax(use_bias, use_linear):
    ds = _two_slot(17, n=300)
    cfg = FMConfig(num_features=ds.num_features, num_factors=3, reg_w=0.1,
                   reg_v=0.5)
    arrays = _params(cfg, 17)
    fb = PA.slot_blocks(ds)
    ws, nb = PA.build_workspace(ds, cfg, ALSConfig(feature_blocks=fb),
                                device="cpu")
    jws, _ = JA.build_workspace(ds, _jcfg(cfg), JALSConfig(feature_blocks=fb))
    nr = int(ws.present.shape[0])
    p = PA.als_sweep_compact(params_from_numpy(*arrays, device="cpu"), ws,
                             nb, nr, 0.0, 0.1, 0.5, use_bias, use_linear,
                             column_pure=True)
    jp = JA.als_sweep_compact(_jparams(arrays), jws, nb, cfg.num_features,
                              nr, 0.0, 0.1, 0.5, use_bias, use_linear,
                              column_pure=True)
    _assert_params(p, jp, **SWEEP_TOL)
    if not use_bias:
        assert float(p.w0) == float(arrays[0])
    if not use_linear:
        np.testing.assert_array_equal(p.w.numpy(), arrays[1])


def test_block1_matches_sequential_oracle():
    """Single-feature blocks make the blocked schedule the reference's
    sequential one (tests/test_als.py's oracle and tolerances)."""
    dense, y, ds = _dense(0)
    cfg = FMConfig(num_features=12, num_factors=3, reg0=0.1, reg_w=0.5,
                   reg_v=1.0, init_stdev=0.1)
    arrays = _params(cfg, 0)
    ws, nb = PA.build_workspace(ds, cfg, ALSConfig(block_size=1),
                                device="cpu")
    assert nb == 12
    nr = int(ws.present.shape[0])
    p = params_from_numpy(*arrays, device="cpu")
    for _ in range(2):
        p = PA.als_sweep_compact(p, ws, nb, nr, cfg.reg0, cfg.reg_w,
                                 cfg.reg_v)
    ow0, ow, ov = numpy_als_oracle(*arrays, dense, y, cfg.reg0, cfg.reg_w,
                                   cfg.reg_v, sweeps=2)
    np.testing.assert_allclose(float(p.w0), ow0, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(p.w.numpy(), ow, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(p.v.numpy(), ov, rtol=5e-3, atol=5e-3)


def test_absent_features_stay_untouched():
    ds = dataclasses.replace(psynth.synth_movielens(10, 12, 200, seed=5),
                             num_features=29)
    cfg = FMConfig(num_features=29, num_factors=3, reg_v=0.5)
    arrays = _params(cfg, 5)
    fb = PA.slot_blocks(ds)
    ws, nb = PA.build_workspace(ds, cfg, ALSConfig(feature_blocks=fb),
                                device="cpu")
    p0 = params_from_numpy(*arrays, device="cpu")
    p = PA.als_sweep_compact(p0, ws, nb, int(ws.present.shape[0]), 0.0,
                             cfg.reg_w, cfg.reg_v, column_pure=True,
                             csc_uniform=True)
    absent = np.setdiff1d(np.arange(29), ws.present.numpy())
    assert absent.size == 7
    np.testing.assert_array_equal(p.v.numpy()[absent], arrays[2][absent])
    np.testing.assert_array_equal(p.w.numpy()[absent], arrays[1][absent])
    # the sweep returns new parameters; its input is unchanged
    np.testing.assert_array_equal(p0.v.numpy(), arrays[2])
    assert not np.array_equal(p.v.numpy(), arrays[2])


def test_sweep_sums_through_segment_colsums(monkeypatch):
    """One B7 call per w block (1 stream) and one ``als_stream_sums`` call
    per (factor, block): (K + 1) x num_blocks per sweep. Block 0's CSC run
    is the example order (no rows); block 1 gathers by its rows."""
    calls = []
    colsums, stream_sums = segsum.segment_colsums, segsum.als_stream_sums

    def counting(streams, seg, num_segments):
        calls.append(len(streams))
        return colsums(streams, seg, num_segments)

    def counting_products(eq, x, row, seg, num_segments):
        calls.append("rows" if row is not None else "identity")
        return stream_sums(eq, x, row, seg, num_segments)

    monkeypatch.setattr(segsum, "segment_colsums", counting)
    monkeypatch.setattr(segsum, "als_stream_sums", counting_products)
    ds = _two_slot(5, n=200)
    cfg = FMConfig(num_features=ds.num_features, num_factors=3, reg_v=0.5)
    res = train_als(cfg, ALSConfig(epochs=2,
                                   feature_blocks=PA.slot_blocks(ds)), ds,
                    device="cpu")
    assert len(res.history) == 2
    assert calls == 2 * ([1, 1] + ["identity", "rows"] * 3)


@pytest.fixture(scope="module")
def trained():
    """train_als in both packages from the same numpy params, with evals
    every 2 sweeps (tests/test_als.py's convergence setting)."""
    jds = jsynth.synth_movielens(60, 80, 8000, rank=3, noise=0.1, seed=0)
    jc = jsplit.split_by_random(jds, 0.8, 0.2, seed=0)
    pds = psynth.synth_movielens(60, 80, 8000, rank=3, noise=0.1, seed=0)
    pc = psplit.split_by_random(pds, 0.8, 0.2, seed=0)
    cfg = FMConfig(num_features=pds.num_features, num_factors=8, reg_w=0.1,
                   reg_v=0.5)
    arrays = _params(cfg, 3, stdev=0.01)
    fb = PA.slot_blocks(pc.training)
    jres = JA.train_als(_jcfg(cfg), JALSConfig(epochs=5, feature_blocks=fb),
                        jc.training, jc.test, eval_every=2,
                        params=_jparams(arrays))
    pres = train_als(cfg, ALSConfig(epochs=5, feature_blocks=fb),
                     pc.training, pc.test, eval_every=2,
                     params=params_from_numpy(*arrays, device="cpu"),
                     device="cpu")
    return jres, pres, jc, pc


def test_synth_and_split_equal_jax(trained):
    _, _, jc, pc = trained
    for part in ("training", "test"):
        for field in ("ids", "vals", "y"):
            np.testing.assert_array_equal(
                getattr(getattr(pc, part), field),
                np.asarray(getattr(getattr(jc, part), field)))
    assert pc.num_features == jc.num_features == 140


def test_train_als_history_matches_jax(trained):
    jres, pres, _, pc = trained
    assert [sorted(h) for h in pres.history] == [sorted(h)
                                                 for h in jres.history]
    assert [h["epoch"] for h in pres.history] == [0, 1, 2, 3, 4]
    for g, w in zip(pres.history, jres.history):
        for key in g:
            if key.startswith("eval_"):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                           err_msg=key)
    final = pres.history[-1]["eval_rmse"]
    assert final < pres.history[0]["eval_rmse"]
    assert final < 0.7 * float(np.std(pc.test.y))
    assert pres.examples_per_sec > 0


def test_train_als_params_match_jax(trained):
    jres, pres, _, _ = trained
    _assert_params(pres.params, jres.params, **SWEEP_TOL)


def test_train_als_does_not_change_given_params():
    ds = _two_slot(6, n=100)
    cfg = FMConfig(num_features=ds.num_features, num_factors=2, reg_v=0.5)
    arrays = _params(cfg, 6)
    given = params_from_numpy(*arrays, device="cpu")
    res = train_als(cfg, ALSConfig(epochs=1), ds, params=given, device="cpu")
    np.testing.assert_array_equal(given.v.numpy(), arrays[2])
    assert not np.array_equal(res.params.v.numpy(), arrays[2])


def test_train_als_default_init_uses_the_generator():
    ds = _two_slot(7, n=100)
    cfg = FMConfig(num_features=ds.num_features, num_factors=2, seed=3)
    a = train_als(cfg, ALSConfig(epochs=0), ds, device="cpu").params
    b = train_als(cfg, ALSConfig(epochs=0), ds, generator=torch.Generator(
        ).manual_seed(3), device="cpu").params
    c = train_als(cfg, ALSConfig(epochs=0), ds, generator=torch.Generator(
        ).manual_seed(4), device="cpu").params
    assert torch.equal(a.v, b.v) and not torch.equal(a.v, c.v)


def test_max_seconds_stops_after_one_sweep():
    ds = _two_slot(8, n=100)
    cfg = FMConfig(num_features=ds.num_features, num_factors=2)
    res = train_als(cfg, ALSConfig(epochs=50, max_seconds=1e-9), ds,
                    device="cpu")
    assert [h["epoch"] for h in res.history] == [0]


def test_empty_dataset_leaves_params_unchanged():
    """No entries, nothing to update: the parameters stay as they were
    (the JAX package's reference-sweep branch; its build_workspace cannot
    index an empty CSC view, so only the port is run)."""
    ds = SparseDataset(ids=np.zeros((0, 2), np.int32),
                       vals=np.zeros((0, 2), np.float32),
                       y=np.zeros((0,), np.float32), num_features=9)
    cfg = FMConfig(num_features=9, num_factors=2)
    arrays = _params(cfg, 9)
    res = train_als(cfg, ALSConfig(epochs=2), ds,
                    params=params_from_numpy(*arrays, device="cpu"),
                    device="cpu")
    assert len(res.history) == 2
    np.testing.assert_array_equal(res.params.v.numpy(), arrays[2])
    np.testing.assert_array_equal(res.params.w.numpy(), arrays[1])


def test_hbm_budget_check_raises_clearly(monkeypatch):
    ds = psynth.synth_movielens(50, 60, 500, seed=0)
    cfg = FMConfig(num_features=ds.num_features, num_factors=4)
    need = PA.workspace_hbm_bytes(ds, cfg)
    assert need < 1 << 20                  # a tiny problem, a sane estimate
    assert need > ds.ids.size * 4 * 6      # at least the workspace itself
    monkeypatch.setenv("SPARKFM_HBM_BUDGET", str(int(need * 0.5)))
    with pytest.raises(ValueError, match="GiB HBM"):
        train_als(cfg, ALSConfig(epochs=1), ds, device="cpu")
    monkeypatch.setenv("SPARKFM_HBM_BUDGET", str(int(need * 100)))
    train_als(cfg, ALSConfig(epochs=1), ds, device="cpu")
    monkeypatch.delenv("SPARKFM_HBM_BUDGET")
    train_als(cfg, ALSConfig(epochs=1), ds, device="cpu")   # CPU: no limit


@pytest.mark.parametrize("task,num_fields", [("classification", 0),
                                             ("regression", 3)])
def test_rejects_classification_and_ffm(task, num_fields):
    ds = psynth.synth_movielens(5, 5, 50)
    kw = dict(num_features=10, num_factors=2, num_fields=num_fields)
    with pytest.raises(ValueError) as got:
        train_als(FMConfig(task=Task(task), **kw), ALSConfig(epochs=1), ds,
                  device="cpu")
    with pytest.raises(ValueError) as want:
        JA.train_als(JFMConfig(task=JTask(task), **kw), JALSConfig(epochs=1),
                     ds)
    assert str(got.value) == str(want.value)


def test_bad_feature_blocks_raise():
    ds = _two_slot(9, n=50)
    cfg = FMConfig(num_features=ds.num_features, num_factors=2)
    with pytest.raises(ValueError, match="feature_blocks"):
        PA.build_workspace(ds, cfg, ALSConfig(feature_blocks=(0, 1)),
                           device="cpu")


def test_csc_uniform_needs_column_pure():
    ds = _two_slot(10, n=50)
    cfg = FMConfig(num_features=ds.num_features, num_factors=2)
    ws, nb = PA.build_workspace(ds, cfg, ALSConfig(), device="cpu")
    p = params_from_numpy(*_params(cfg, 10), device="cpu")
    with pytest.raises(ValueError, match="column_pure"):
        PA.als_sweep_compact(p, ws, nb, int(ws.present.shape[0]), 0.0, 0.0,
                             1.0, csc_uniform=True)


def test_als_config_matches_jax_field_for_field():
    jf = [(f.name, f.default) for f in dataclasses.fields(JALSConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(PALSConfig)]
    assert pf == jf


def test_params_type():
    ds = _two_slot(12, n=60)
    cfg = FMConfig(num_features=ds.num_features, num_factors=2)
    res = train_als(cfg, ALSConfig(epochs=1), ds, device="cpu")
    assert isinstance(res.params, FMParams)
    assert res.params.v.shape == (ds.num_features, 2)
    assert res.params.w.dtype == torch.float32


def _former_patch(eq, table, rank, vals, q_next=None):
    """The compact sweep's patch of a column-pure block as it was before
    ``segsum.als_patch``: ``BlockViews.patch`` on the block's row, copied
    into e and q (eq's columns), then the next factor's q where given."""
    e, q = eq[:, 0], eq[:, 1]
    views = PA.BlockViews(rank.shape[0], column_pure=True)
    q_new = q + views.patch(table[:, 0], rank[None], vals[None], 0)
    e.copy_(e + 0.5 * (q_new.square() - q.square())
            - 0.5 * views.patch(table[:, 1], rank[None],
                                vals.square()[None], 0))
    q.copy_(q_new if q_next is None else q_next)


@pytest.mark.parametrize("column_pure", [True, False])
def test_sweep_patch_gives_the_former_parameters(column_pure, monkeypatch):
    """A CPU compact sweep patches a column-pure block by
    ``segsum.als_patch``, once a (factor, block), the factor's last patch
    with the next factor's q, and gives the parameters
    of the sweep's former lines bit for bit; without column_pure it keeps
    the torch lines over all slots, calls no ``als_patch``, and on these
    column-pure blocks gives the same parameters too."""
    ds = _two_slot(23, n=301)
    cfg = FMConfig(num_features=ds.num_features, num_factors=3, reg_w=0.1,
                   reg_v=0.5)
    fb = PA.slot_blocks(ds)
    ws, nb = PA.build_workspace(ds, cfg, ALSConfig(feature_blocks=fb),
                                device="cpu")
    nr = int(ws.present.shape[0])
    rw, rv = (torch.from_numpy(r) for r in cfg.reg_vectors())

    def sweeps(pure):
        p = params_from_numpy(*_params(cfg, 23), device="cpu")
        for _ in range(2):
            p = PA.als_sweep_compact(p, ws, nb, nr, cfg.reg0, rw, rv,
                                     column_pure=pure)
        return p

    calls = []
    patch = segsum.als_patch

    def counting(*a, **k):
        calls.append((a[2].storage_offset(), a[4] is not None))
        return patch(*a, **k)

    monkeypatch.setattr(segsum, "als_patch", counting)
    got = sweeps(column_pure)
    # (block 0's row, block 1's), the last block's carrying the next
    # factor's q but in the last factor; 3 factors, 2 sweeps
    n = ds.num_examples
    assert calls == (([(0, False), (n, True)] * 2 + [(0, False), (n, False)])
                     * 2 if column_pure else [])
    monkeypatch.setattr(segsum, "als_patch", _former_patch)
    want = sweeps(True)
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("name,column_pure,k", [("slot_blocks", False, 3),
                                                ("slot_blocks", True, 3),
                                                ("dense_block4", False, 3),
                                                ("slot_blocks", True, 0)])
def test_compact_sweep_matches_the_direct_sweep(name, column_pure, k):
    """The compact sweep, its factor loop on the (N, 2) pairs of e and q,
    against the port's direct sweep ``als_sweep`` (the full-F form, e and
    q two vectors) over 3 sweeps at the JAX package's tolerance between
    its two sweeps: on slot blocks by the torch patch lines (not
    column-pure) and by ``segsum.als_patch``, on dense blocks of 4
    features, which no patch kernel takes, and with no factors (w0 and w
    alone, no pairs)."""
    ds, blocks = DATASETS[name]()
    cfg = FMConfig(num_features=ds.num_features, num_factors=k, reg_w=0.1,
                   reg_v=0.5, reg0=0.05)
    als_cfg, _ = _als_cfgs(ds, blocks)
    ws, nb = PA.build_workspace(ds, cfg, als_cfg, device="cpu")
    assert column_pure <= PA.blocks_are_column_pure(
        ds, PA.feature_blocks_of(cfg.num_features, als_cfg)[0])
    nr = int(ws.present.shape[0])
    rw, rv = (torch.from_numpy(r) for r in cfg.reg_vectors())
    compact = direct = params_from_numpy(*_params(cfg, 31), device="cpu")
    for _ in range(3):
        compact = PA.als_sweep_compact(compact, ws, nb, nr, cfg.reg0, rw, rv,
                                       column_pure=column_pure)
        direct = PA.als_sweep(direct, ws, nb, cfg.num_features, cfg.reg0,
                              rw, rv)
    _assert_params(compact, direct, **SWEEP_TOL)


def test_counters_read_paired_gathers_and_q_next_patches():
    """In a profiler session a column-pure sweep of K factors over two
    slot blocks counts on ``als.paired_gather_slots`` the N slots of each
    factor's gathering block (block 1; block 0 is the example order) and
    on ``als.q_next_patches`` the K - 1 factors whose last patch loads the
    next factor's q; contiguous blocks of 20 features (not column-pure:
    every block gathers over all 2 N entries) count no such patch."""
    from torch.profiler import profile
    from sparkfm_tpu_torch.utils import profiling
    ds = _two_slot(29, n=257)
    k, sweeps, n = 4, 2, ds.num_examples
    cfg = FMConfig(num_features=ds.num_features, num_factors=k, reg_v=0.5)
    for als_cfg, want in (
            (ALSConfig(epochs=sweeps, feature_blocks=PA.slot_blocks(ds)),
             {"als.paired_gather_slots": sweeps * k * n,
              "als.q_next_patches": sweeps * (k - 1)}),
            (ALSConfig(epochs=sweeps, block_size=20),
             {"als.paired_gather_slots":
              sweeps * k * -(-ds.num_features // 20) * (2 * n)})):
        profiling.clear()
        try:
            with profile():
                train_als(cfg, als_cfg, ds, device="cpu")
            counters = profiling.recorded()["counters"]
        finally:
            profiling.clear()
        assert {c: counters[c] for c in counters if c.startswith("als.")} \
            == want
