"""The port's DeepFM under adam and tower dropout against the benchmark's
plain reference (``portbench/reference/deepfm.py``, float64), which the
JAX package cannot stand in for: it has neither. Three steps of
``make_train_step`` and of ``train_deepfm`` from the same seeded random
weights and batches, on "dedup" and "direct" (adam, dropout 0.5 and 0),
and on "fused" (adagrad, dropout 0.5); the dropout masks themselves; and
scoring, which never drops.

Tolerances, each from the float32 program against float64:

- losses rtol 1e-5: float32 forward sums over 64 examples of 8 fields
  read ~1e-7 apart (2e-8 to 1.1e-6 measured);
- per leaf, the norm of the difference of the parameters' change after
  3 steps within 1e-3 of the reference change's norm (atol 1e-7):
  Adam divides each coordinate's step by the root of its second moment,
  so a coordinate whose summed gradient nearly cancels carries float32's
  rounding of the terms into a visible share of its step (the worst
  coordinate measured 2% of a step on a tower weight); adagrad's sums
  read ~1e-5 apart;
- scores rtol 1e-5, atol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.gen import order
from portbench.reference import deepfm as R
from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.data import batching as PB
from sparkfm_tpu_torch.models import deepfm as DF

torch.set_num_threads(1)
F, K, FIELDS, B = 1 << 10, 10, 8, 64
HIDDEN = (16, 16, 16)
LR, REG = 1e-2, 1e-3
SEED = 77


def _cfg(dropout):
    return DF.DeepFMConfig(
        fm=FMConfig(num_features=F, num_factors=K, num_fields=FIELDS,
                    task=Task.CLASSIFICATION, reg_w=REG, reg_v=REG,
                    seed=SEED), hidden=HIDDEN, dropout=dropout)


def _data(seed=0, n=3 * B):
    """Field-major zipf-repeated ids, values 1, random labels: full
    batches only, so every slot of a batch is a real example's."""
    rng = np.random.default_rng(seed)
    per = F // FIELDS
    ids = ((rng.zipf(1.5, (n, FIELDS)) - 1) % per
           + per * np.arange(FIELDS)).astype(np.int32)
    vals = np.ones((n, FIELDS), np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    return PB.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)


def _weights(seed=1):
    rng = np.random.default_rng(seed)
    dims = (FIELDS * K,) + HIDDEN + (1,)
    mlp_w = [rng.normal(0, np.sqrt(2.0 / a), (a, b)).astype(np.float32)
             for a, b in zip(dims[:-1], dims[1:])]
    mlp_b = [rng.normal(0, 0.05, (b,)).astype(np.float32) for b in dims[1:]]
    return (np.float32(0.1), rng.normal(0, 0.1, F).astype(np.float32),
            rng.normal(0, 0.1, (F, K)).astype(np.float32), mlp_w, mlp_b)


def _reference(wts, ds, rows_of_step, dropout, optimizer):
    w0, w, v = (torch.as_tensor(x) for x in wts[:3])
    mlp_w, mlp_b = ([torch.as_tensor(x) for x in xs] for xs in wts[3:])
    batches = [{"idx": torch.as_tensor(ds.ids[r]),
                "vals": torch.as_tensor(ds.vals[r]),
                "y": torch.as_tensor(ds.y[r]), "step": t}
               for t, r in enumerate(rows_of_step)]
    return R.train_steps(w0, w, v, mlp_w, mlp_b, batches, lr=LR, reg_w=REG,
                         reg_v=REG, dropout=dropout, seed=SEED,
                         optimizer=optimizer)


def _assert_matches(params, losses, ref):
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    got = R.leaves(params.fm.w0, params.fm.w, params.fm.v, params.mlp_w,
                   params.mlp_b)
    init, fin = ref["init"], ref["params"][-1]
    for name, t in got.items():
        want = fin[name] - init[name]
        gap = float((t.double() - init[name] - want).norm())
        assert gap <= 1e-3 * float(want.norm()) + 1e-7, name


CASES = [("dedup", "adam", 0.5), ("direct", "adam", 0.5),
         ("dedup", "adam", 0.0), ("direct", "adam", 0.0),
         ("fused", "adagrad", 0.5)]


@pytest.mark.parametrize("path,opt,dropout", CASES)
def test_step_matches_the_reference(path, opt, dropout):
    """Three steps of ``make_train_step`` against the reference from the
    same weights, batches and masks (global steps 0, 1, 2)."""
    cfg = _cfg(dropout)
    sgd_cfg = SGDConfig(optimizer=opt, learning_rate=LR, batch_size=B,
                        update_path=path)
    wts = _weights()
    state = DF.initial_state(cfg, sgd_cfg,
                             start=DF.deepfm_params_from_numpy(
                                 *wts, device="cpu"), device="cpu")
    step = DF.make_train_step(cfg, sgd_cfg)
    ds = _data()
    losses = []
    for batch in PB.batch_iterator(ds, B, device="cpu"):
        out, aux = step(state, batch)
        assert out is state
        losses.append(float(aux["loss"]))
    assert int(state.fm.step) == 3
    rows = [np.arange(t * B, (t + 1) * B) for t in range(3)]
    _assert_matches(DF.params_of(state, cfg), losses,
                    _reference(wts, ds, rows, dropout, opt))
    if dropout == 0.0:
        # nothing dropped: the trained model scores as the reference
        p = DF.params_of(state, cfg)
        fin = _reference(wts, ds, rows, dropout, opt)["params"][-1]
        ids = torch.as_tensor(ds.ids)
        want = torch.sigmoid(R.scores(
            fin["w0"], fin["w"], fin["v"],
            [fin[f"mlp_w.{i}"] for i in range(4)],
            [fin[f"mlp_b.{i}"] for i in range(4)], ids,
            torch.as_tensor(ds.vals)))
        got = DF.predict(p, cfg, ids, torch.as_tensor(ds.vals))
        np.testing.assert_allclose(got.double(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("path,opt", [("dedup", "adam"),
                                      ("direct", "adam"),
                                      ("fused", "adagrad")])
def test_train_deepfm_matches_the_reference(path, opt):
    """One epoch of three batches through ``train_deepfm`` (shuffled by
    the trainer's (seed, epoch) order, whose frozen copy the benchmark
    keeps in ``portbench/gen/order.py``), dropout 0.5."""
    cfg = _cfg(0.5)
    wts = _weights(seed=4)
    ds = _data(seed=5)
    res = DF.train_deepfm(cfg, SGDConfig(
        optimizer=opt, learning_rate=LR, batch_size=B, epochs=1,
        update_path=path), ds, init_params=DF.deepfm_params_from_numpy(
            *wts, device="cpu"), device="cpu")
    rows = [order.batch_rows(3 * B, B, SEED, 0, t) for t in range(3)]
    ref = _reference(wts, ds, rows, 0.5, opt)
    _assert_matches(res.params, [], dict(ref, losses=[]))
    assert res.history[0]["train_loss"] == pytest.approx(
        np.mean(ref["losses"]), rel=1e-5)


def test_masks_are_the_reference_draws_and_keep_at_rate():
    """The step's masks are the reference's own draws of the documented
    rule, scaled by 1 / (1 - p); they keep about 1 - p of the units,
    differ between steps and layers and repeat for the same (seed, step,
    layer, shape)."""
    cfg = dataclasses.replace(_cfg(0.5), hidden=(4096, 4096))
    masks = DF.dropout_masks(cfg, 7, 64, "cpu")
    keep = R.keep_masks(SEED, 7, 64, (4096, 4096), 0.5, "cpu")
    for m, k in zip(masks, keep):
        assert torch.equal(m, k.float() * 2.0)
        assert abs(float(k.float().mean()) - 0.5) < 0.01
    assert not torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], DF.dropout_masks(cfg, 8, 64, "cpu")[0])
    again = DF.dropout_masks(cfg, 7, 64, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(masks, again))
    p2 = dataclasses.replace(cfg, dropout=0.25)
    k2 = DF.dropout_masks(p2, 7, 64, "cpu")[0]
    assert abs(float((k2 > 0).float().mean()) - 0.75) < 0.01
    assert float(k2.max()) == pytest.approx(1 / 0.75)
    assert DF.dropout_masks(_cfg(0.0), 7, 64, "cpu") is None
    for step, layer in ((0, 0), (3, 1), (2 ** 40, 2)):
        assert DF.dropout_seed(2 ** 62 + 5, step, layer) == R.mask_seed(
            2 ** 62 + 5, step, layer) < 2 ** 63


def test_masks_do_not_depend_on_the_batch(monkeypatch):
    """Two different batches at the same global step get the same masks:
    the step draws them from (seed, step, layer) and the batch's shape
    alone."""
    cfg = _cfg(0.5)
    sgd_cfg = SGDConfig(optimizer="adam", learning_rate=LR, batch_size=B,
                        update_path="dedup")
    drawn = []
    real = DF.dropout_draws

    def spy(*a, **k):
        drawn.append(real(*a, **k))
        return drawn[-1]
    monkeypatch.setattr(DF, "dropout_draws", spy)
    for seed in (0, 9):
        state = DF.initial_state(cfg, sgd_cfg, start=DF.
                                 deepfm_params_from_numpy(*_weights(),
                                                          device="cpu"),
                                 device="cpu")
        batch = next(PB.batch_iterator(_data(seed=seed), B, device="cpu"))
        DF.make_train_step(cfg, sgd_cfg)(state, batch)
    assert len(drawn) == 2
    assert all(torch.equal(a, b) for a, b in zip(*drawn))


def test_serving_drops_nothing():
    """Scores and predictions of a model trained with dropout use every
    unit: equal to the same weights under dropout 0 and to the
    reference's forward pass without masks."""
    wts = _weights()
    params = DF.deepfm_params_from_numpy(*wts, device="cpu")
    ds = _data()
    ids, vals = torch.as_tensor(ds.ids), torch.as_tensor(ds.vals)
    got = DF.scores(params, _cfg(0.5), ids, vals)
    assert torch.equal(got, DF.scores(params, _cfg(0.0), ids, vals))
    want = R.scores(*(torch.as_tensor(x) for x in wts[:3]),
                    [torch.as_tensor(x) for x in wts[3]],
                    [torch.as_tensor(x) for x in wts[4]], ids, vals)
    np.testing.assert_allclose(got.double(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        DF.predict(params, _cfg(0.5), ids, vals).double(),
        torch.sigmoid(want), rtol=1e-5, atol=1e-6)


def test_adam_paths_and_refusals():
    """"auto" takes "dedup" for adam at 2^16 rows and more, "fused" for
    adagrad; the fused record and the sharded step refuse adam; a state
    without second moments is refused under adam."""
    big = dataclasses.replace(_cfg(0.5), fm=dataclasses.replace(
        _cfg(0.5).fm, num_features=1 << 16))
    assert DF.resolve_deepfm_path(big, SGDConfig(optimizer="adam")) == "dedup"
    assert DF.resolve_deepfm_path(big, SGDConfig()) == "fused"
    assert DF.resolve_deepfm_path(_cfg(0.5),
                                  SGDConfig(optimizer="adam")) == "direct"
    with pytest.raises(ValueError, match="on the fused path"):
        DF.make_train_step(_cfg(0.0), SGDConfig(optimizer="adam",
                                                update_path="fused"))
    with pytest.raises(ValueError, match="dropout must lie"):
        DF.make_train_step(_cfg(1.0), SGDConfig())
    sgd_cfg = SGDConfig(optimizer="adam", batch_size=B, update_path="direct")
    lean = DF.init_state(DF.deepfm_params_from_numpy(*_weights(),
                                                     device="cpu"))
    assert lean.smw2 == () and lean.fm.slot2_v.dim() == 0
    batch = next(PB.batch_iterator(_data(), B, device="cpu"))
    with pytest.raises(ValueError, match="second moments"):
        DF.make_train_step(_cfg(0.0), sgd_cfg)(lean, batch)
