"""The port's relational data path (``sparkfm_tpu_torch/data/relational.py``)
and relational SGD (``training/trainer.py::train_sgd_relational``) against
the JAX package's, on the same numpy inputs:

- ``transform_relational`` and ``load_movielens_relational`` on the
  MovieLens fixture, ``materialize``, ``slice``, ``compose_batch`` and the
  iterator's padded, masked tail batch: arrays equal;
- composed scores against materialized scores and JAX's (rtol 1e-6);
- the relational train step's loss at rtol 1e-5 and tables at rtol 1e-4,
  atol 1e-6, step by step (the SGD step parity of
  ``tests/test_torch_sgd.py``); ``train_sgd_relational``'s history at rtol
  1e-5 and parameters at rtol 2e-4, atol 2e-5 (the whole-run tolerance of
  ``tests/test_torch_trainer.py``), and the facade's
  relational "sgd", from the same numpy initial weights (both packages'
  ``init_params`` patched);
- defect 1 of ROADMAP C: from 2^16 features the JAX package's "auto"
  resolves to a fused-record path its relational step cannot take, and
  raises; the port's "auto" trains on "dedup" and equals JAX's explicit
  ``update_path="dedup"``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparkfm_tpu as sfm
from sparkfm_tpu.data import datasets as JD
from sparkfm_tpu.data import relational as JR
from sparkfm_tpu.data import schema as JS
from sparkfm_tpu.data import vectorizer as JV
from sparkfm_tpu.models import fm as jfm
from sparkfm_tpu.solvers import sgd as jsgd
from sparkfm_tpu.training import trainer as jtrainer
from sparkfm_tpu_torch import FM, FMConfig, SGDConfig
from sparkfm_tpu_torch.data import datasets as PD
from sparkfm_tpu_torch.data import relational as PR
from sparkfm_tpu_torch.data import schema as PS
from sparkfm_tpu_torch.data import vectorizer as PV
from sparkfm_tpu_torch.models import fm as pfm
from sparkfm_tpu_torch.solvers import sgd as psgd
from sparkfm_tpu_torch.training import trainer as ptrainer

torch.set_num_threads(1)
ML = os.path.join(os.path.dirname(__file__), "fixtures", "ml_fixture")
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
RUN_TOL = dict(rtol=2e-4, atol=2e-5)    # whole runs, as test_torch_trainer


def _fixture_vec(S, V, n=1500):
    """The MovieLens fixture's ratings with the users.dat side table, in
    either package; returns (vectorizer, rows)."""
    vec = V.RelationVectorizer([S.Identity("user"), S.Identity("item"),
                                S.Target("rating"), S.Ignored("ts")])
    vec.add_relation(S.read_delimited(os.path.join(ML, "users.dat"), "::"),
                     [S.Target("uid"), S.Identity("gender"),
                      S.Identity("age"), S.Identity("occ"),
                      S.Ignored("zip")], join_column=0)
    rows = list(S.read_delimited(os.path.join(ML, "ratings.dat"), "::"))[:n]
    vec.fit(rows)
    return vec, rows


def assert_same_relational(got, want):
    for name in ("main_ids", "main_vals", "y", "keys"):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.num_features == want.num_features
    assert len(got.tables) == len(want.tables)
    for t, u in zip(got.tables, want.tables):
        assert t.offset == u.offset
        np.testing.assert_array_equal(np.asarray(t.ids), np.asarray(u.ids))
        np.testing.assert_array_equal(np.asarray(t.vals), np.asarray(u.vals))


@pytest.fixture(scope="module")
def fixture_pair():
    """(port, JAX) RelationalDatasets of 1500 fixture ratings, with two
    unseen users whose joins miss (the null row)."""
    pv, rows = _fixture_vec(PS, PV)
    jv, _ = _fixture_vec(JS, JV)
    rows = rows + [["999999", rows[0][1], "3", "0"],
                   ["999998", rows[1][1], "4", "0"]]
    return pv.transform_relational(rows), jv.transform_relational(rows)


def test_transform_relational_matches_jax(fixture_pair):
    prel, jrel = fixture_pair
    assert_same_relational(prel, jrel)
    assert prel.keys[-1, 0] == prel.tables[0].num_rows - 1     # null row
    assert prel.total_nnz_per_example == jrel.total_nnz_per_example
    with pytest.raises(RuntimeError, match="fit"):
        PV.RelationVectorizer([PS.Identity("u"), PS.Target("y")]
                              ).transform_relational([["a", "1"]])


def test_materialize_slice_and_from_numpy_match_jax(fixture_pair):
    prel, jrel = fixture_pair
    pm, jm = prel.materialize(), jrel.materialize()
    for name in ("ids", "vals", "y"):
        a, b = getattr(pm, name), np.asarray(getattr(jm, name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    idx = np.arange(3, 900, 7)
    assert_same_relational(prel.slice(idx), jrel.slice(idx))
    assert_same_relational(PR.relational_from_numpy(jrel), jrel)


def test_load_movielens_relational_matches_jax():
    (pds, pvec), (jds, jvec) = (PD.load_movielens_relational(ML, 2000),
                                JD.load_movielens_relational(ML, 2000))
    for name in ("ids", "vals", "y"):
        np.testing.assert_array_equal(getattr(pds, name),
                                      getattr(jds, name))
    assert pds.num_features == jds.num_features == pvec.dimension
    assert PV.feature_groups_of(pvec) == JV.feature_groups_of(jvec)
    with pytest.raises(FileNotFoundError, match="users.dat"):
        PD.load_movielens_relational(os.path.dirname(ML))


@pytest.mark.parametrize("batch_size", [512, 1502, 2048])
def test_batches_and_composition_match_jax(fixture_pair, batch_size):
    """Shuffled batches with a padded, masked tail (padding keys the null
    rows), and their composition, equal JAX's."""
    prel, jrel = fixture_pair
    ptabs = PR.tables_to_device(prel.tables, device="cpu")
    jtabs = JR.tables_to_device(jrel.tables)
    pit = PR.relational_batch_iterator(prel, batch_size, device="cpu",
                                       shuffle=True, seed=3, epoch=1)
    jit_ = JR.relational_batch_iterator(jrel, batch_size, shuffle=True,
                                        seed=3, epoch=1)
    n = 0
    for pb, jb in zip(pit, jit_, strict=True):
        for name in ("main_ids", "main_vals", "y", "keys", "mask"):
            np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                          np.asarray(getattr(jb, name)),
                                          err_msg=name)
        pc, jc = PR.compose_batch(pb, ptabs), JR.compose_batch(jb, jtabs)
        np.testing.assert_array_equal(pc.ids.numpy(), np.asarray(jc.ids))
        np.testing.assert_array_equal(pc.vals.numpy(), np.asarray(jc.vals))
        n += int(pb.mask.sum())
    assert n == prel.num_examples
    last = list(PR.relational_batch_iterator(prel, 512, device="cpu"))[-1]
    pad = ~last.mask
    assert pad.any()
    assert (last.keys[pad] == prel.tables[0].num_rows - 1).all()
    assert (last.main_vals[pad] == 0).all()
    assert len(list(PR.relational_batch_iterator(
        prel, 512, device="cpu", drop_remainder=True))) == 2


def _weights(f, k, seed=0):
    rng = np.random.default_rng([f, k, seed])
    return (np.float32(0.0), np.zeros(f, np.float32),
            rng.normal(0, 0.05, (f, k)).astype(np.float32))


@pytest.fixture
def same_init(monkeypatch):
    """Both packages' init_params give the same numpy weights."""
    monkeypatch.setattr(jfm, "init_params", lambda cfg, key=None: (
        jfm.FMParams(*(jnp.asarray(x) for x in _weights(
            cfg.num_features, cfg.num_factors)))))
    monkeypatch.setattr(pfm, "init_params", lambda cfg, generator=None, *,
                        device: pfm.params_from_numpy(*_weights(
                            cfg.num_features, cfg.num_factors),
                            device=device))


def test_composed_scores_match_materialized_and_jax(fixture_pair):
    prel, jrel = fixture_pair
    f = prel.num_features
    arrays = _weights(f, 4, 1)
    arrays = (np.float32(0.2), np.linspace(-0.1, 0.1, f, dtype=np.float32),
              arrays[2])
    cfg = FMConfig(num_features=f, num_factors=4)
    params = pfm.params_from_numpy(*arrays, device="cpu")
    batch = next(PR.relational_batch_iterator(prel, prel.num_examples,
                                              device="cpu"))
    got = PR.make_relational_score_fn(cfg)(
        params, batch, PR.tables_to_device(prel.tables, device="cpu"))
    flat = prel.materialize()
    want = pfm.scores(params, cfg, torch.as_tensor(flat.ids),
                      torch.as_tensor(flat.vals))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    jcfg = sfm.FMConfig(num_features=f, num_factors=4)
    jgot = JR.make_relational_score_fn(jcfg)(
        jfm.FMParams(*(jnp.asarray(a) for a in arrays)),
        next(JR.relational_batch_iterator(jrel, jrel.num_examples)),
        JR.tables_to_device(jrel.tables))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-6,
                               atol=1e-6)


def _jstate(arrays):
    return jsgd.init_state(jfm.FMParams(*(jnp.asarray(a) for a in arrays)))


def _assert_tables(pstate, jstate, f):
    np.testing.assert_allclose(float(pstate.params.w0),
                               float(jstate.params.w0), rtol=1e-5)
    for name in ("w", "v"):
        np.testing.assert_allclose(
            getattr(pstate.params, name).numpy()[:f],
            np.asarray(getattr(jstate.params, name))[:f], err_msg=name,
            **STEP_TOL)


@pytest.mark.parametrize("optimizer,lr", [("adagrad", 0.1),
                                          ("adam", 0.001)])
def test_train_step_matches_jax(fixture_pair, optimizer, lr):
    """Five relational direct steps, loss at rtol 1e-5 and tables at rtol
    1e-4, atol 1e-6 after each. adam at the rate ``tests/test_torch_sgd.py``
    holds the direct step's adam at: it adds lr * m / (sqrt(v) + eps) per
    slot, which a tiny gradient's last-bit rounding moves by up to lr."""
    prel, jrel = fixture_pair
    f = prel.num_features
    cfg = FMConfig(num_features=f, num_factors=4, reg_v=0.01)
    sgd_cfg = SGDConfig(batch_size=256, learning_rate=lr,
                        optimizer=optimizer)
    assert PR.relational_update_path(cfg, sgd_cfg) == "direct"
    arrays = _weights(f, 4, 2)
    pstate = psgd.init_state(pfm.params_from_numpy(*arrays, device="cpu"),
                             optimizer=optimizer)
    jstate = _jstate(arrays)
    pstep = PR.make_relational_train_step(cfg, sgd_cfg)
    jstep = JR.make_relational_train_step(
        sfm.FMConfig(num_features=f, num_factors=4, reg_v=0.01),
        sfm.SGDConfig(batch_size=256, learning_rate=lr,
                      optimizer=optimizer))
    ptabs = PR.tables_to_device(prel.tables, device="cpu")
    jtabs = JR.tables_to_device(jrel.tables)
    for pb, jb, _ in zip(
            PR.relational_batch_iterator(prel, 256, device="cpu"),
            JR.relational_batch_iterator(jrel, 256), range(5)):
        pstate, paux = pstep(pstate, pb, ptabs)
        jstate, jaux = jstep(jstate, jb, jtabs)
        np.testing.assert_allclose(float(paux["loss"]), float(jaux["loss"]),
                                   rtol=1e-5)
        _assert_tables(pstate, jstate, f)


def _train_both(prel, jrel, epochs=3, update_path="auto", f=None, **kw):
    f = f or prel.num_features
    cfg = FMConfig(num_features=f, num_factors=4, reg_v=0.01)
    sgd_cfg = SGDConfig(batch_size=256, epochs=epochs, learning_rate=0.1,
                        update_path=update_path)
    jcfg = sfm.FMConfig(num_features=f, num_factors=4, reg_v=0.01)
    jsgd_cfg = sfm.SGDConfig(batch_size=256, epochs=epochs,
                             learning_rate=0.1, update_path=update_path)
    pres = ptrainer.train_sgd_relational(cfg, sgd_cfg, prel, eval_ds=prel,
                                         eval_every=2, device="cpu", **kw)
    jres = jtrainer.train_sgd_relational(jcfg, jsgd_cfg, jrel,
                                         eval_ds=jrel, eval_every=2)
    return pres, jres


def _assert_runs(pres, jres, f):
    assert [sorted(h) for h in pres.history] == [sorted(h)
                                                for h in jres.history]
    for got, want in zip(pres.history, jres.history):
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-5,
                                       err_msg=key)
    assert pres.params.v.shape[0] == f
    for name in ("w", "v"):
        np.testing.assert_allclose(getattr(pres.params, name).numpy(),
                                   np.asarray(getattr(jres.params,
                                                      name))[:f],
                                   err_msg=name, **RUN_TOL)


def test_train_sgd_relational_matches_jax(fixture_pair, same_init):
    prel, jrel = fixture_pair
    pres, jres = _train_both(prel, jrel)
    _assert_runs(pres, jres, prel.num_features)
    assert pres.history[-1]["train_loss"] < pres.history[0]["train_loss"]
    assert pres.examples_per_sec > 0


def test_auto_trains_on_dedup_from_2_16_features(fixture_pair, same_init):
    """Defect 1: at F >= 2^16 under "auto" the JAX relational trainer
    raises; the port takes "dedup" (device plans, a padded state, trimmed
    off the result) and equals JAX's explicit "dedup"."""
    prel, jrel = fixture_pair
    f = (1 << 16) + 17
    jwide = JR.RelationalDataset(
        main_ids=jrel.main_ids, main_vals=jrel.main_vals, y=jrel.y,
        keys=jrel.keys, tables=jrel.tables, num_features=f)
    pwide = PR.relational_from_numpy(jwide)
    jcfg = sfm.FMConfig(num_features=f, num_factors=4, reg_v=0.01)
    with pytest.raises(ValueError, match="resolved update path"):
        jtrainer.train_sgd_relational(jcfg, sfm.SGDConfig(batch_size=256,
                                                          epochs=1), jwide)
    cfg = FMConfig(num_features=f, num_factors=4, reg_v=0.01)
    assert PR.relational_update_path(cfg, SGDConfig()) == "dedup"
    assert psgd.resolve_update_path(cfg, SGDConfig()) == "hybrid"
    cfg_auto = SGDConfig(batch_size=256, epochs=2, learning_rate=0.1)
    pres = ptrainer.train_sgd_relational(cfg, cfg_auto, pwide,
                                         eval_ds=pwide, eval_every=2,
                                         device="cpu")
    jres = jtrainer.train_sgd_relational(
        jcfg, sfm.SGDConfig(batch_size=256, epochs=2, learning_rate=0.1,
                            update_path="dedup"), jwide, eval_ds=jwide,
        eval_every=2)
    _assert_runs(pres, jres, f)
    with pytest.raises(ValueError, match="FusedState"):
        PR.make_relational_train_step(cfg, SGDConfig(update_path="fused"))


def test_facade_relational_sgd_matches_jax(fixture_pair, same_init):
    """FM(solver="sgd").fit(RelationalDataset) trains on the composed
    batches, as the JAX facade does, to the same history and weights."""
    prel, jrel = fixture_pair
    kw = dict(num_factors=4, solver="sgd", max_iter=2, batch_size=256,
              learning_rate=0.1, reg_v=0.01)
    pm = FM(**kw).fit(prel, eval_ds=prel, device="cpu")
    jm = sfm.FM(**kw).fit(jrel, eval_ds=jrel)
    _assert_runs(pm, jm, prel.num_features)
    with pytest.raises(ValueError, match="relational"):
        FM(**kw).fit(prel, init_params=pm, device="cpu")


def test_dedup_updates_the_last_feature(same_init):
    """The JAX relational trainer builds its dedup step on an unpadded
    state, so the plan's fill id, num_features - 1, is a real feature:
    wherever that feature appears its updates are lost (its w stays at
    0). The port pads the state (the fill row is an extra row, trimmed
    off), so its "dedup" equals JAX's "direct", as the two paths update
    alike under adagrad."""
    rng = np.random.default_rng(0)
    n, f = 512, 40
    main_ids = rng.integers(0, 30, (n, 2)).astype(np.int32)
    main_ids[::3, 1] = f - 1
    table = JR.RelationTable(
        ids=jnp.asarray(np.r_[rng.integers(0, 9, (8, 1)), [[0]]].astype(
            np.int32)),
        vals=jnp.asarray(np.r_[np.ones((8, 1)), [[0.0]]].astype(np.float32)),
        offset=30)
    jds = JR.RelationalDataset(
        main_ids=main_ids, main_vals=np.ones((n, 2), np.float32),
        y=rng.normal(size=n).astype(np.float32),
        keys=rng.integers(0, 8, (n, 1)).astype(np.int32), tables=(table,),
        num_features=f)
    kw = dict(batch_size=128, epochs=1, learning_rate=0.1)
    jcfg = sfm.FMConfig(num_features=f, num_factors=4, reg_v=0.01)
    jdirect = jtrainer.train_sgd_relational(
        jcfg, sfm.SGDConfig(update_path="direct", **kw), jds)
    jdedup = jtrainer.train_sgd_relational(
        jcfg, sfm.SGDConfig(update_path="dedup", **kw), jds)
    assert float(jdedup.params.w[f - 1]) == 0.0
    assert float(jdirect.params.w[f - 1]) != 0.0
    pres = ptrainer.train_sgd_relational(
        FMConfig(num_features=f, num_factors=4, reg_v=0.01),
        SGDConfig(update_path="dedup", **kw), PR.relational_from_numpy(jds),
        device="cpu")
    _assert_runs(pres, jdirect, f)
