"""The port's xDeepFM (``DeepFMConfig.cin``: a Compressed Interaction
Network beside the tower, Lian et al. 2018) against the benchmark's plain
reference (``portbench/reference/xdeepfm.py``, float64), which the JAX
package cannot stand in for: it has no CIN. At a small size (m = 5
fields, D = 3, CIN (4, 4), tower (8,), B = 16): one CIN layer against a
literal loop over eq. (6) and its backward against autograd; scores, loss
and every leaf's step-1 gradient; three Adam steps of the train step and
of ``train_deepfm``; DeepFM (``cin=()``) left bit for bit as it was; the
step's spans and counter; save and ``load_model``; the sharded step's
refusal; TF32 left off.

Tolerances, each from the float32 program against float64:

- CIN layers and gradients in float64 against the literal forms: 1e-12
  (the same sums in another order);
- scores rtol 1e-5, atol 1e-6 and losses rtol 1e-5: float32 sums over
  5 fields, 16 maps and 8 units read ~1e-7 apart;
- step-1 gradients (Adam's first moment over 1 - beta1) per leaf within
  1e-4 of the reference's norm (atol 1e-9): a float32 GEMM of 75 terms
  rounds each coordinate at ~1e-7 relative, and rows summed over a
  batch cancel to ~1e-6 of their terms;
- per leaf, the parameters' change after 3 steps within 1e-3 of the
  reference change's norm (atol 1e-7): Adam divides each coordinate's
  step by the root of its second moment, so a coordinate whose summed
  gradient nearly cancels carries float32's rounding into a visible
  share of its step (``tests/test_torch_deepfm_reference.py``);
- served in chunks against ``predict`` on the whole batch: rtol 1e-6,
  atol 1e-7, the same float32 operations on matrices of other heights,
  which a GEMM may block and so round differently.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import profile

from portbench.gen import order
from portbench.reference import xdeepfm as R
from sparkfm_tpu_torch import FM, load_model
from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.data import batching as PB
from sparkfm_tpu_torch.models import deepfm as DF
from sparkfm_tpu_torch.ops import interaction as I
from sparkfm_tpu_torch.utils import checkpoint, profiling

torch.set_num_threads(1)
F, K, FIELDS, B = 1 << 10, 3, 5, 16
CIN, HIDDEN = (4, 4), (8,)
LR, REG, REG_DENSE = 1e-2, 1e-3, 1e-3
SEED = 91


def _cfg(cin=CIN, reg_dense=REG_DENSE):
    return DF.DeepFMConfig(
        fm=FMConfig(num_features=F, num_factors=K, num_fields=FIELDS,
                    task=Task.CLASSIFICATION, reg_w=REG, reg_v=REG,
                    seed=SEED), hidden=HIDDEN, cin=cin, reg_dense=reg_dense)


def _data(seed=0, n=3 * B):
    """Field-major zipf-repeated ids, values in (0.5, 1.5), random labels:
    full batches only."""
    rng = np.random.default_rng(seed)
    per = F // FIELDS
    ids = ((rng.zipf(1.5, (n, FIELDS)) - 1) % per
           + per * np.arange(FIELDS)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (n, FIELDS)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    return PB.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)


def _weights(seed=1):
    """(w0, w, v, tower weights, tower biases, CIN tensors) as numpy."""
    rng = np.random.default_rng(seed)
    dims = (FIELDS * K,) + HIDDEN + (1,)
    mlp_w = [rng.normal(0, np.sqrt(2.0 / a), (a, b)).astype(np.float32)
             for a, b in zip(dims[:-1], dims[1:])]
    mlp_b = [rng.normal(0, 0.05, (b,)).astype(np.float32) for b in dims[1:]]
    cin, prev = [], FIELDS
    for h in CIN:
        cin.append(rng.normal(0, 0.3, (h, prev * FIELDS)).astype(np.float32))
        prev = h
    cin.append(rng.normal(0, 0.3, (sum(CIN),)).astype(np.float32))
    return (np.float32(0.1), rng.normal(0, 0.1, F).astype(np.float32),
            rng.normal(0, 0.5, (F, K)).astype(np.float32), mlp_w, mlp_b,
            cin)


def _params(wts, device="cpu"):
    return DF.deepfm_params_from_numpy(*wts, device=device)


def _reference(wts, ds, rows_of_step, **kw):
    w0, w, v = (torch.as_tensor(x) for x in wts[:3])
    mlp_w, mlp_b, cin = ([torch.as_tensor(x) for x in xs] for xs in wts[3:])
    batches = [{"idx": torch.as_tensor(ds.ids[r]),
                "vals": torch.as_tensor(ds.vals[r]),
                "y": torch.as_tensor(ds.y[r]), "step": t}
               for t, r in enumerate(rows_of_step)]
    return R.train_steps(w0, w, v, mlp_w, mlp_b, cin, batches, lr=LR,
                         reg_w=REG, reg_v=REG, reg_dense=REG_DENSE, **kw)


def _leaves(p):
    return R.leaves(p.fm.w0, p.fm.w, p.fm.v, p.mlp_w, p.mlp_b, p.cin)


def _literal_layer(x_prev, x0, w):
    """Eq. (6) coordinate by coordinate: X^k_{h,*} = sum_i sum_j
    W_{h,i,j} (X^{k-1}_{i,*} o X^0_{j,*})."""
    b, hp, d = x_prev.shape
    m = x0.shape[1]
    wr = w.view(w.shape[0], hp, m)
    out = torch.zeros((b, w.shape[0], d), dtype=x0.dtype)
    for h in range(w.shape[0]):
        for i in range(hp):
            for j in range(m):
                out[:, h] += wr[h, i, j] * x_prev[:, i] * x0[:, j]
    return out


@pytest.mark.parametrize("widths", [(4,), (4, 3), (2, 5, 3)])
def test_cin_layers_are_eq6_literally(widths):
    g = torch.Generator().manual_seed(len(widths))
    e = torch.randn((6, FIELDS, K), generator=g, dtype=torch.float64)
    ws, prev = [], FIELDS
    for h in widths:
        ws.append(torch.randn((h, prev * FIELDS), generator=g,
                              dtype=torch.float64))
        prev = h
    got, (xs, zs) = I.cin_forward(e, ws)
    x, pools = e, []
    for k, w in enumerate(ws):
        x = _literal_layer(x, e, w)
        pools.append(x.sum(2))
        # the kept products: z_k = x_{k-1} o x_0 in D-major rows
        assert zs[k].shape == (6 * K, w.shape[1])
    torch.testing.assert_close(got, torch.cat(pools, 1), rtol=0, atol=1e-12)
    torch.testing.assert_close(got, R.cin_pool(e, ws), rtol=0, atol=1e-12)


@pytest.mark.parametrize("widths", [(4,), (4, 3), (2, 5, 3)])
def test_cin_backward_is_autograd_of_the_forward(widths):
    g = torch.Generator().manual_seed(7 + len(widths))
    e = torch.randn((6, FIELDS, K), generator=g, dtype=torch.float64)
    ws, prev = [], FIELDS
    for h in widths:
        ws.append(torch.randn((h, prev * FIELDS), generator=g,
                              dtype=torch.float64))
        prev = h
    g_p = torch.randn((6, sum(widths)), generator=g, dtype=torch.float64)
    p, saved = I.cin_forward(e, ws)
    g_e, g_w = I.cin_backward(e, ws, saved, g_p)
    leaves = [e.clone().requires_grad_()] + [
        w.clone().requires_grad_() for w in ws]
    want = torch.autograd.grad((R.cin_pool(leaves[0], leaves[1:]) * g_p)
                               .sum(), leaves)
    torch.testing.assert_close(g_e, want[0], rtol=0, atol=1e-12)
    for a, b in zip(g_w, want[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_scores_equal_the_reference():
    wts = _weights()
    ds = _data()
    ids, vals = torch.as_tensor(ds.ids), torch.as_tensor(ds.vals)
    got = DF.scores(_params(wts), _cfg(), ids, vals)
    w0, w, v = (torch.as_tensor(x) for x in wts[:3])
    want = R.scores(w0, w, v, *([torch.as_tensor(x) for x in xs]
                                for xs in wts[3:]), ids, vals, block=7)
    np.testing.assert_allclose(got.double(), want, rtol=1e-5, atol=1e-6)
    # the CIN's term is a real part of the score
    no_cin = R._score({k: t.double() for k, t in _leaves(_params(wts))
                       .items() if k not in ("w", "v")},
                      w.double()[ids.long()], v.double()[ids.long()],
                      vals.double(), "no_cin")
    assert float((want - no_cin).abs().max()) > 1e-2


@pytest.mark.parametrize("path", ["dedup", "direct"])
def test_step_one_loss_and_every_leafs_gradient_equal_the_reference(path):
    """Step 1's loss and, per leaf, its gradient (Adam's first moment over
    1 - beta1: rows summed over their slots)."""
    cfg = _cfg()
    sgd = SGDConfig(optimizer="adam", learning_rate=LR, batch_size=B,
                    update_path=path)
    wts = _weights()
    state = DF.initial_state(cfg, sgd, start=_params(wts), device="cpu")
    step = DF.make_train_step(cfg, sgd)
    ds = _data()
    batch = next(iter(PB.batch_iterator(ds, B, device="cpu")))
    _, aux = step(state, batch)
    ref = _reference(wts, ds, [np.arange(B)])
    assert float(aux["loss"]) == pytest.approx(ref["losses"][0], rel=1e-5)
    fm = state.fm
    moments = R.leaves(fm.slot_w0, fm.slot_w[:F], fm.slot_v[:F], state.smw,
                       state.smb, state.smc)
    assert set(moments) == set(ref["grad1"])
    for name, m1 in moments.items():
        got = m1.double() / (1 - R.BETAS[0])
        want = ref["grad1"][name]
        gap = float((got - want).norm())
        assert gap <= 1e-4 * float(want.norm()) + 1e-9, name
    assert float(ref["grad1"]["cin.1"].norm()) > 1e-3


def _assert_matches(params, losses, ref):
    np.testing.assert_allclose(losses, ref["losses"][:len(losses)],
                               rtol=1e-5)
    init, fin = ref["init"], ref["params"][-1]
    got = _leaves(params)
    assert set(got) == set(init)
    for name, t in got.items():
        want = fin[name] - init[name]
        gap = float((t.double() - init[name] - want).norm())
        assert gap <= 1e-3 * float(want.norm()) + 1e-7, name


@pytest.mark.parametrize("path", ["dedup", "direct"])
def test_three_adam_steps_equal_the_reference(path):
    cfg = _cfg()
    sgd = SGDConfig(optimizer="adam", learning_rate=LR, batch_size=B,
                    update_path=path)
    wts = _weights()
    state = DF.initial_state(cfg, sgd, start=_params(wts), device="cpu")
    step = DF.make_train_step(cfg, sgd)
    ds = _data()
    losses = []
    for batch in PB.batch_iterator(ds, B, device="cpu"):
        out, aux = step(state, batch)
        assert out is state
        losses.append(float(aux["loss"]))
    assert int(state.fm.step) == 3
    rows = [np.arange(t * B, (t + 1) * B) for t in range(3)]
    ref = _reference(wts, ds, rows)
    trained = DF.params_of(state, cfg)
    _assert_matches(trained, losses, ref)
    # the trained model scores as the reference scores its parameters
    ids, vals = torch.as_tensor(ds.ids), torch.as_tensor(ds.vals)
    want = R.scores(trained.fm.w0, trained.fm.w, trained.fm.v,
                    list(trained.mlp_w), list(trained.mlp_b),
                    list(trained.cin), ids, vals)
    got = DF.scores(trained, cfg, ids, vals)
    np.testing.assert_allclose(got.double(), want, rtol=1e-5, atol=1e-6)


def test_train_deepfm_matches_the_reference():
    """One epoch of three batches through ``train_deepfm`` (shuffled by
    the trainer's (seed, epoch) order, whose frozen copy the benchmark
    keeps in ``portbench/gen/order.py``)."""
    cfg = _cfg()
    wts = _weights(seed=4)
    ds = _data(seed=5)
    res = DF.train_deepfm(cfg, SGDConfig(
        optimizer="adam", learning_rate=LR, batch_size=B, epochs=1,
        update_path="dedup"), ds, init_params=_params(wts), device="cpu")
    rows = [order.batch_rows(3 * B, B, SEED, 0, t) for t in range(3)]
    ref = _reference(wts, ds, rows)
    _assert_matches(res.params, [], ref)
    assert res.history[0]["train_loss"] == pytest.approx(
        np.mean(ref["losses"]), rel=1e-5)


@pytest.mark.parametrize("fault", ["no_cin", "cin_short"])
def test_the_references_cin_faults_move_the_loss(fault):
    wts = _weights()
    ds = _data()
    good = _reference(wts, ds, [np.arange(B)])
    bad = _reference(wts, ds, [np.arange(B)], fault=fault)
    assert abs(bad["losses"][0] - good["losses"][0]) > 1e-4 * abs(
        good["losses"][0])


def _deepfm_cfg(reg_dense=0.0):
    return DF.DeepFMConfig(
        fm=FMConfig(num_features=F, num_factors=K, num_fields=FIELDS,
                    task=Task.CLASSIFICATION, reg_w=REG, reg_v=REG,
                    seed=SEED), hidden=HIDDEN, reg_dense=reg_dense)


def test_without_a_cin_deepfm_scores_and_gradients_are_as_before():
    """``cin=()``: the scores are the FM head plus the tower as DeepFM
    computed them, bit for bit, and the dense phase's loss and gradients
    are those of DeepFM's loss as it read (FM head, tower, per-appearance
    L2), bit for bit."""
    cfg = _deepfm_cfg()
    wts = _weights()[:5]
    p = DF.deepfm_params_from_numpy(*wts, device="cpu")
    assert len(p.cin) == 0
    ds = _data()
    ids, vals = torch.as_tensor(ds.ids[:B]), torch.as_tensor(ds.vals[:B])
    vw = torch.cat([p.fm.v[ids.long()], p.fm.w[ids.long()][..., None]], -1)
    w_rows, v_rows = vw[..., K], vw[..., :K]
    before = (I.fm_scores_from_gathered(p.fm.w0, w_rows, v_rows, vals)
              + DF._tower(p.mlp_w, p.mlp_b,
                          (v_rows * vals[..., None]).reshape(B, -1)))
    assert torch.equal(DF.scores(p, cfg, ids, vals), before)

    batch = next(iter(PB.batch_iterator(ds, B, device="cpu")))
    leaves = [t.detach().clone().requires_grad_() for t in
              (p.fm.w0, w_rows, v_rows, *p.mlp_w, *p.mlp_b)]
    w0, wr, vr = leaves[:3]
    mw, mb = leaves[3:5], leaves[5:]
    total, (s, data) = DF._deepfm_loss(cfg, batch, w0, wr, vr, mw, mb)
    got = torch.autograd.grad(total, leaves)
    leaves2 = [t.detach().clone().requires_grad_() for t in leaves]
    w0, wr, vr = leaves2[:3]
    s2 = (I.fm_scores_from_gathered(w0, wr, vr, batch.vals)
          + DF._tower(leaves2[3:5], leaves2[5:],
                      (vr * batch.vals[..., None]).reshape(B, -1)))
    weights = batch.mask.to(torch.float32)
    data2 = DF.L.loss_for_task(Task.CLASSIFICATION)(s2, batch.y, weights)
    active = (batch.vals != 0).to(torch.float32) * weights[:, None]
    total2 = data2 + (REG * (wr.square() * active).sum()
                      + REG * (vr.square() * active[..., None]).sum()
                      ) / weights.sum().clamp(min=1.0)
    want = torch.autograd.grad(total2, leaves2)
    assert torch.equal(s, s2) and torch.equal(data, data2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_without_a_cin_the_step_runs_deepfms_four_phases():
    cfg = _deepfm_cfg()
    sgd = SGDConfig(optimizer="adam", learning_rate=LR, batch_size=B,
                    update_path="dedup")
    state = DF.initial_state(cfg, sgd, start=DF.deepfm_params_from_numpy(
        *_weights()[:5], device="cpu"), device="cpu")
    assert not any(k.startswith(("cin", "smc"))
                   for k in checkpoint.state_tensors(state))
    step = DF.make_train_step(cfg, sgd)
    profiling.clear()
    try:
        with profile():
            for batch in PB.batch_iterator(_data(), B, device="cpu"):
                step(state, batch)
        rec = profiling.recorded()
    finally:
        profiling.clear()
    assert {n: s["calls"] for n, s in rec["spans"].items()
            if n.startswith("deepfm.")} == {
        "deepfm.gather": 3, "deepfm.dense": 3, "deepfm.update": 3,
        "deepfm.tower_update": 3}
    assert "deepfm.cin_rows" not in rec["counters"]


def test_the_cin_step_records_its_spans_and_counter():
    """Two ``deepfm.cin`` calls a step (the forward and the backward, in
    the order gather, cin, dense, cin, update, tower update) and B rows a
    step on ``deepfm.cin_rows``."""
    cfg = _cfg()
    sgd = SGDConfig(optimizer="adam", learning_rate=LR, batch_size=B,
                    update_path="dedup")
    state = DF.initial_state(cfg, sgd, start=_params(_weights()),
                             device="cpu")
    step = DF.make_train_step(cfg, sgd)
    profiling.clear()
    try:
        with profile():
            for batch in PB.batch_iterator(_data(), B, device="cpu"):
                step(state, batch)
        rec = profiling.recorded()
        order_ = [e[0] for e in profiling._spans
                  if e[0].startswith("deepfm.")][:6]
    finally:
        profiling.clear()
    calls = {n: s["calls"] for n, s in rec["spans"].items()
             if n.startswith("deepfm.")}
    assert calls == {"deepfm.gather": 3, "deepfm.cin": 6, "deepfm.dense": 3,
                     "deepfm.update": 3, "deepfm.tower_update": 3}
    assert order_ == ["deepfm.gather", "deepfm.cin", "deepfm.dense",
                      "deepfm.cin", "deepfm.update", "deepfm.tower_update"]
    assert rec["counters"]["deepfm.cin_rows"] == 3 * B


def test_init_draws_the_cin_glorot_uniform():
    cfg = DF.DeepFMConfig(fm=FMConfig(num_features=F, num_factors=10,
                                      num_fields=39, seed=3),
                          hidden=(400, 400), cin=(200, 200, 200))
    p = DF.init_params(cfg, device="cpu")
    shapes = [tuple(w.shape) for w in p.cin]
    assert shapes == [(200, 1521), (200, 7800), (200, 7800), (600,)]
    for w, (fan_in, fan_out) in zip(p.cin, DF.cin_shapes(cfg)[1]):
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.99 * bound
        # U(-b, b) has variance b^2 / 3
        assert float(w.var()) == pytest.approx(bound ** 2 / 3, rel=0.05)
    # DeepFM's draws are unchanged by the CIN's, which come after them
    base = DF.init_params(dataclasses.replace(cfg, cin=()), device="cpu")
    assert torch.equal(base.fm.v, p.fm.v)
    for a, b in zip(base.mlp_w, p.mlp_w):
        assert torch.equal(a, b)


def test_a_state_without_the_cin_is_refused():
    cfg = _cfg()
    sgd = SGDConfig(optimizer="adam", learning_rate=LR, batch_size=B,
                    update_path="dedup")
    state = DF.initial_state(_deepfm_cfg(), sgd,
                             start=DF.deepfm_params_from_numpy(
                                 *_weights()[:5], device="cpu"),
                             device="cpu")
    step = DF.make_train_step(cfg, sgd)
    batch = next(iter(PB.batch_iterator(_data(), B, device="cpu")))
    with pytest.raises(ValueError, match="CIN"):
        step(state, batch)


def test_the_facade_fits_xdeepfm_and_load_model_round_trips(tmp_path):
    ds = _data(n=8 * B)
    model = FM(model="xdeepfm", cin=(4, 3), hidden=(8,), num_fields=FIELDS,
               num_factors=K, solver="sgd", task="classification",
               max_iter=2, batch_size=B, optimizer="adam",
               learning_rate=1e-2, seed=5, reg_dense=1e-4).fit(
                   ds, device="cpu")
    assert model.cfg.cin == (4, 3) and model.cfg.reg_dense == 1e-4
    assert [tuple(w.shape) for w in model.params.cin] == [
        (4, 25), (3, 20), (7,)]
    model.save(str(tmp_path))
    meta = json.load(open(tmp_path / checkpoint.META_FILE))
    assert meta["model"] == "xdeepfm" and meta["cin"] == [4, 3]
    back = load_model(str(tmp_path), device="cpu")
    assert back.cfg == model.cfg
    np.testing.assert_array_equal(back.predict(ds.ids, ds.vals),
                                  model.predict(ds.ids, ds.vals))
    for a, b in zip(back.params.cin, model.params.cin):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kwargs", [
    {"model": "deepfm", "cin": (4, 3)}, {"model": "fm", "cin": (4, 3)},
    {"model": "xdeepfm"}, {"model": "fm", "reg_dense": 1e-4}])
def test_the_facade_takes_cin_with_xdeepfm_alone(kwargs):
    """One option decides the model: the CIN's widths come with
    model="xdeepfm" and no other, and xDeepFM needs them."""
    with pytest.raises(ValueError):
        FM(solver="sgd", **kwargs)


def test_train_deepfm_resumes_an_xdeepfm_checkpoint(tmp_path):
    """The CIN's tensors and Adam's slots go into the training checkpoint
    (``cin.<i>``, ``smc.<i>``, ``smc2.<i>``): two epochs then a third
    equal three straight epochs bit for bit."""
    cfg = _cfg()
    ds = _data(n=4 * B)
    wts = _weights()

    def fit(epochs, directory):
        return DF.train_deepfm(cfg, SGDConfig(
            optimizer="adam", learning_rate=LR, batch_size=B,
            epochs=epochs, update_path="dedup"), ds,
            checkpoint_dir=directory, init_params=_params(wts),
            device="cpu")
    fit(2, str(tmp_path / "a"))
    resumed = fit(3, str(tmp_path / "a"))
    straight = fit(3, None)
    for a, b in zip(resumed.params.cin, straight.params.cin):
        assert torch.equal(a, b)
    assert torch.equal(resumed.params.fm.v, straight.params.fm.v)
    assert resumed.history == straight.history


def test_the_sharded_step_refuses_a_cin():
    from sparkfm_tpu_torch.parallel import sharded_deepfm as SD
    sgd = SGDConfig(optimizer="adagrad", learning_rate=LR, batch_size=B)
    with pytest.raises(ValueError, match="Compressed Interaction Network"):
        SD.make_sharded_train_step(_cfg(), sgd, mesh=None)


def test_the_cin_runs_with_tf32_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    cfg = _cfg()
    sgd = SGDConfig(optimizer="adam", learning_rate=LR, batch_size=B,
                    update_path="dedup")
    state = DF.initial_state(cfg, sgd, start=_params(_weights()),
                             device="cpu")
    step = DF.make_train_step(cfg, sgd)
    for batch in PB.batch_iterator(_data(), B, device="cpu"):
        step(state, batch)
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("use_plans", [False, True])
def test_the_micro_batcher_serves_xdeepfm_as_predict(use_plans):
    """``MicroBatcher(model="deepfm")`` takes an xDeepFM's params and
    config: requests of mixed sizes, flushed in chunks (with or without a
    dedup plan a chunk), score as ``predict`` does on the whole batch."""
    from sparkfm_tpu_torch.serving import MicroBatcher
    cfg = _cfg()
    p = _params(_weights())
    ds = _data(n=40)
    mb = MicroBatcher(p, cfg, max_batch=16, use_plans=use_plans,
                      model="deepfm")
    cuts = [0, 1, 8, 25, 40]
    idx = [mb.submit(ds.ids[a:b], ds.vals[a:b])
           for a, b in zip(cuts[:-1], cuts[1:])]
    out = mb.flush()
    got = np.concatenate([out[i] for i in idx])
    want = DF.predict(p, cfg, torch.as_tensor(ds.ids),
                      torch.as_tensor(ds.vals)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
