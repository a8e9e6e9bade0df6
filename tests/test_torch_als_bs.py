"""The port's BS-ALS (``sparkfm_tpu_torch/solvers/als_bs.py``) against the
JAX package's ``train_als_relational`` and against the port's own
``train_als`` on the materialized data, on the MovieLens fixture with its
users.dat side table, from the same numpy weights.

Tolerances are ``tests/test_als_bs.py``'s: w0 rtol 1e-4, w rtol 5e-2 /
atol 1e-3, V rtol 5e-2 / atol 5e-3, and the final eval RMSE within 1e-3
(hundreds of sequential block updates amplify f32 summation-order noise).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparkfm_tpu as sfm
from sparkfm_tpu.config import ALSConfig as JALSConfig
from sparkfm_tpu.config import FMConfig as JFMConfig
from sparkfm_tpu.models import fm as jfm
from sparkfm_tpu.solvers import als_bs as JBS
from sparkfm_tpu_torch import FM, ALSConfig, FMConfig, Task, train_als
from sparkfm_tpu_torch.data import relational as PR
from sparkfm_tpu_torch.models import fm as pfm
from sparkfm_tpu_torch.ops import segsum
from sparkfm_tpu_torch.solvers import als_bs as PBS
from test_als_bs import _relational

torch.set_num_threads(1)


def _pair(n=800, with_blocks=False):
    """(port, JAX) relational datasets of the fixture, and the JAX test's
    field-aligned blocks when asked."""
    out = _relational(n=n, with_blocks=with_blocks)
    jrel, blocks = out if with_blocks else (out, None)
    return PR.relational_from_numpy(jrel), jrel, blocks


def _arrays(f, k, seed=2):
    rng = np.random.default_rng(seed)
    return (np.float32(0.1), rng.normal(0, 0.05, f).astype(np.float32),
            rng.normal(0, 0.1, (f, k)).astype(np.float32))


def _assert_close(got, want):
    np.testing.assert_allclose(float(got.params.w0), float(want.params.w0),
                               rtol=1e-4)
    np.testing.assert_allclose(got.params.w.numpy(),
                               np.asarray(want.params.w), rtol=5e-2,
                               atol=1e-3)
    np.testing.assert_allclose(got.params.v.numpy(),
                               np.asarray(want.params.v), rtol=5e-2,
                               atol=5e-3)
    assert abs(got.history[-1]["eval_rmse"]
               - want.history[-1]["eval_rmse"]) < 1e-3


@pytest.mark.parametrize("block_mode", ["sequential", "field"])
def test_bs_sweep_matches_jax_and_materialized(block_mode):
    prel, jrel, blocks = _pair(with_blocks=block_mode == "field")
    f = prel.num_features
    if blocks is None:          # strict sequential Gauss-Seidel
        blocks = tuple(range(f))
    arrays = _arrays(f, 3)
    kw = dict(num_features=f, num_factors=3, reg_w=0.05, reg_v=0.1)
    jres = JBS.train_als_relational(
        JFMConfig(**kw), JALSConfig(epochs=3, feature_blocks=blocks), jrel,
        eval_ds=jrel, params=jfm.FMParams(*(jnp.asarray(a)
                                           for a in arrays)))
    pres = PBS.train_als_relational(
        FMConfig(**kw), ALSConfig(epochs=3, feature_blocks=blocks), prel,
        eval_ds=prel, params=pfm.params_from_numpy(*arrays, device="cpu"),
        device="cpu")
    _assert_close(pres, jres)
    flat = train_als(FMConfig(**kw), ALSConfig(epochs=3,
                                               feature_blocks=blocks),
                     prel.materialize(), eval_ds=prel.materialize(),
                     params=pfm.params_from_numpy(*arrays, device="cpu"),
                     device="cpu")
    _assert_close(pres, flat)


def test_slot_blocks_from_the_bs_structure_match_jax():
    """Without feature_blocks: one block per main slot (the item; the user
    column is the relation's key) and relation column (gender, age,
    occupation), the JAX ``_prep``'s map."""
    prel, jrel, _ = _pair()
    f = prel.num_features
    cfg = FMConfig(num_features=f, num_factors=2)
    arrs, statics = PBS._prep(prel, cfg, ALSConfig(), device="cpu")
    jarrs, jstatics = JBS._prep(jrel, JFMConfig(num_features=f,
                                                num_factors=2),
                                JALSConfig())
    assert statics.num_blocks == jstatics["num_blocks"] == 1 + 3
    np.testing.assert_array_equal(arrs.block_of_feat.numpy(),
                                  np.asarray(jarrs["block_of_feat"]))
    np.testing.assert_allclose(arrs.den_w.numpy(),
                               np.asarray(jarrs["den_w"]), rtol=1e-6)
    # slot blocks: each block's features sit on one side, in one column
    assert [len(s) for s in statics.main_slots] == [1, 0, 0, 0]
    assert [len(c) for c in statics.rel_cols[0]] == [0, 1, 1, 1]


def test_sums_go_through_segment_colsums_by_span(monkeypatch):
    """With slot blocks (1 main, 3 relation columns) a sweep sums by B7:
    a w block 1 stream on its side (main), or per key then per feature
    (relation); a (factor, block) 2 streams (main), or 4 per key and 2 per
    feature (relation)."""
    calls = []
    plain = segsum.segment_colsums

    def counting(streams, seg, num_segments):
        calls.append(len(streams))
        return plain(streams, seg, num_segments)

    monkeypatch.setattr(segsum, "segment_colsums", counting)
    prel, _, _ = _pair(n=300)
    cfg = FMConfig(num_features=prel.num_features, num_factors=2, reg_v=0.5)
    PBS.train_als_relational(cfg, ALSConfig(epochs=1), prel, device="cpu")
    per_factor = [2] + [4, 2] * 3
    assert calls == [1] + [1, 1] * 3 + per_factor * 2


def test_never_materializes_and_trains(monkeypatch):
    """materialize() patched to raise is never called, and BS-ALS reaches
    the JAX test's band on 4000 fixture ratings."""
    prel, _, blocks = _pair(n=4000, with_blocks=True)
    flat = prel.materialize()

    def refuse(self):
        raise AssertionError("BS-ALS materialized its dataset")

    monkeypatch.setattr(PR.RelationalDataset, "materialize", refuse)
    cfg = FMConfig(num_features=prel.num_features, num_factors=8,
                   reg_w=0.02, reg_v=0.05)
    res = PBS.train_als_relational(cfg, ALSConfig(epochs=8,
                                                  feature_blocks=blocks),
                                   prel, eval_ds=flat, eval_every=4,
                                   device="cpu")
    assert [h["epoch"] for h in res.history if "eval_rmse" in h] == [0, 4, 7]
    assert res.history[-1]["eval_rmse"] < 1.06


def test_max_seconds_and_refusals():
    prel, _, _ = _pair()
    cfg = FMConfig(num_features=prel.num_features, num_factors=2,
                   reg_v=0.1)
    res = PBS.train_als_relational(cfg, ALSConfig(epochs=200, block_size=4,
                                                  max_seconds=1e-6), prel,
                                   device="cpu")
    assert len(res.history) == 1
    with pytest.raises(ValueError, match="squared loss"):
        PBS.train_als_relational(cfg.replace(task=Task.CLASSIFICATION),
                                 ALSConfig(epochs=1), prel, device="cpu")
    with pytest.raises(ValueError, match="plain FM"):
        PBS.train_als_relational(cfg.replace(num_fields=2),
                                 ALSConfig(epochs=1), prel, device="cpu")


def test_facade_relational_als_routes_to_bs(monkeypatch):
    """FM(solver="als").fit(RelationalDataset) runs BS-ALS (its own blocks,
    no materialize of the training set) and equals the JAX facade from
    the same weights; other solvers train on the materialized data."""
    prel, jrel, _ = _pair(n=1000)
    f = prel.num_features
    arrays = _arrays(f, 4, 5)
    monkeypatch.setattr(jfm, "init_params", lambda cfg, key=None: (
        jfm.FMParams(*(jnp.asarray(a) for a in arrays))))
    monkeypatch.setattr(pfm, "init_params", lambda cfg, generator=None, *,
                        device: pfm.params_from_numpy(*arrays,
                                                      device=device))
    seen = []
    monkeypatch.setattr(PBS, "train_als_relational",
                        lambda *a, _f=PBS.train_als_relational, **k:
                        seen.append(1) or _f(*a, **k))
    kw = dict(solver="als", num_factors=4, max_iter=3, reg_v=0.1)
    pm = FM(**kw).fit(prel, eval_ds=prel, device="cpu")
    jm = sfm.FM(**kw).fit(jrel, eval_ds=jrel)
    assert seen == [1]
    _assert_close(pm, jm)
    mc = FM(solver="mcmc", num_factors=2, max_iter=2).fit(prel,
                                                          device="cpu")
    assert np.isfinite(mc.params.v.numpy()).all()
