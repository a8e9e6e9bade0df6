"""The port's DeepFM (``models/deepfm.py``, ``api.py::DeepFMModel``,
``serving.py`` with ``model="deepfm"``) against the JAX package's on the
same numpy weights and batches: scores, the direct, dedup and fused train
steps, ``train_deepfm``, the ``FM`` facade with save and load, and
``MicroBatcher``; plus the port's own checks (He init, checkpoint resume,
the raises).

Tolerances: scores rtol 1e-5 (atol 1e-6); after 3 steps, losses rtol 1e-5
(atol 1e-6), tables, slots and tower rtol 1e-4, atol 1e-6 (float32 sums
in another order where the port sums by sorted runs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu import api as japi
from sparkfm_tpu import serving as jserving
from sparkfm_tpu.config import FMConfig as JFMConfig
from sparkfm_tpu.config import SGDConfig as JSGDConfig
from sparkfm_tpu.config import Task as JTask
from sparkfm_tpu.data import batching as jbatching
from sparkfm_tpu.models import deepfm as JDF
from sparkfm_tpu.models.fm import FMParams as JFMParams
from sparkfm_tpu.ops import embedding as JE
from sparkfm_tpu.solvers import sgd_fused as jsgd_fused
from sparkfm_tpu_torch import api as papi
from sparkfm_tpu_torch import serving as pserving
from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.data import batching as pbatching
from sparkfm_tpu_torch.models import deepfm as PDF
from sparkfm_tpu_torch.ops import embedding as PE
from sparkfm_tpu_torch.solvers.sgd_fused import FusedState

torch.set_num_threads(1)
F, K, FIELDS, B = 300, 4, 5, 64
N = 3 * B - 10                  # three batches, the last a masked tail
HIDDEN = (8, 4)
USED = 2 * K + 2


def _cfgs(task="classification", **fm_kw):
    kw = dict(num_features=F, num_factors=K, num_fields=FIELDS, reg_w=0.02,
              reg_v=0.03, seed=3, **fm_kw)
    return (JDF.DeepFMConfig(fm=JFMConfig(task=JTask(task), **kw),
                             hidden=HIDDEN),
            PDF.DeepFMConfig(fm=FMConfig(task=Task(task), **kw),
                             hidden=HIDDEN))


def _data(task="classification", seed=0, n=N):
    """Field-major ids (slot l in field l's range of F // FIELDS ids),
    zipf-repeated; vals mostly near 1 with some zeros."""
    rng = np.random.default_rng(seed)
    per = F // FIELDS
    ids = ((rng.zipf(1.5, (n, FIELDS)) - 1) % per
           + per * np.arange(FIELDS)).astype(np.int32)
    vals = np.where(rng.random((n, FIELDS)) < 0.1, 0.0,
                    rng.normal(1.0, 0.3, (n, FIELDS))).astype(np.float32)
    y = (rng.integers(0, 2, n) if task == "classification"
         else rng.normal(3.0, 1.0, n)).astype(np.float32)
    return ids, vals, y


def _weights(seed=1):
    """w0, w, v and the tower as numpy, w non-zero so the linear term
    matters."""
    rng = np.random.default_rng(seed)
    dims = (FIELDS * K,) + HIDDEN + (1,)
    mlp_w = [rng.normal(0, np.sqrt(2.0 / a), (a, b)).astype(np.float32)
             for a, b in zip(dims[:-1], dims[1:])]
    mlp_b = [rng.normal(0, 0.05, (b,)).astype(np.float32) for b in dims[1:]]
    return (np.float32(0.1), rng.normal(0, 0.1, F).astype(np.float32),
            rng.normal(0, 0.1, (F, K)).astype(np.float32), mlp_w, mlp_b)


def _jparams(wts):
    w0, w, v, mlp_w, mlp_b = wts
    return JDF.DeepFMParams(
        fm=JFMParams(w0=jnp.asarray(w0), w=jnp.asarray(w), v=jnp.asarray(v)),
        mlp_w=tuple(jnp.asarray(x) for x in mlp_w),
        mlp_b=tuple(jnp.asarray(x) for x in mlp_b))


def _pparams(wts):
    return PDF.deepfm_params_from_numpy(*wts, device="cpu")


def _jfused(jcfg, jp):
    """The JAX package's init_fused_deepfm_state, from given params."""
    fused = jsgd_fused.fused_from_params(jp.fm,
                                         jcfg.fm.replace(num_fields=0))
    return {"table": fused.table, "w0": fused.w0,
            "slot_w0": jnp.zeros((), jnp.float32),
            "mlp_w": jp.mlp_w, "mlp_b": jp.mlp_b,
            "smw": tuple(jnp.zeros_like(x) for x in jp.mlp_w),
            "smb": tuple(jnp.zeros_like(x) for x in jp.mlp_b)}


def _states(path, jcfg, pcfg, wts):
    jp = _jparams(wts)
    if path == "fused":
        js = _jfused(jcfg, jp)
        a = np.asarray
        return js, PDF.fused_deepfm_state_from_numpy(
            a(js["table"]), a(js["w0"]), a(js["slot_w0"]),
            [a(x) for x in js["mlp_w"]], [a(x) for x in js["mlp_b"]],
            [a(x) for x in js["smw"]], [a(x) for x in js["smb"]], pcfg,
            device="cpu")
    js = JDF.init_state(jp)
    ps = PDF.init_state(_pparams(wts))
    if path == "dedup":
        js = JDF.pad_deepfm_state_for_dedup(js)
        ps = PDF.pad_deepfm_state_for_dedup(ps)
    return js, ps


def _close(got, want, what, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _assert_state_close(path, ps, js):
    if path == "fused":
        _close(ps.fm.table[:F, :USED], np.asarray(js["table"])[:F, :USED],
               "table")
        _close(ps.fm.w0, js["w0"], "w0")
        _close(ps.fm.slot_w0, js["slot_w0"], "slot_w0")
        tower = {n: js[n] for n in ("mlp_w", "mlp_b", "smw", "smb")}
    else:
        p, jp, sl = ps.fm.params, js["params"], js["slots"]
        for name, got, want in (("w", p.w, jp.fm.w), ("v", p.v, jp.fm.v),
                                ("slot_w", ps.fm.slot_w, sl["w"]),
                                ("slot_v", ps.fm.slot_v, sl["v"])):
            _close(got[:F], np.asarray(want)[:F], name)
        _close(p.w0, jp.fm.w0, "w0")
        _close(ps.fm.slot_w0, sl["w0"], "slot_w0")
        tower = {"mlp_w": jp.mlp_w, "mlp_b": jp.mlp_b, "smw": sl["mw"],
                 "smb": sl["mb"]}
    for name, want in tower.items():
        for i, (got, w) in enumerate(zip(getattr(ps, name), want)):
            _close(got, w, f"{name}[{i}]")


def test_init_params_he_distribution():
    """Shapes, zero biases and w, and the tower's He scale N(0, 2/fan_in)
    (checked by distribution: torch's numbers are not jax.random's)."""
    _, pcfg = _cfgs()
    cfg = dataclasses.replace(pcfg, hidden=(256, 128))
    p = PDF.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p.fm.v.shape == (F, K) and p.fm.w.abs().sum() == 0
    assert [tuple(w.shape) for w in p.mlp_w] == [(FIELDS * K, 256),
                                                (256, 128), (128, 1)]
    assert all(b.abs().sum() == 0 for b in p.mlp_b)
    for w in p.mlp_w[:2]:
        want = np.sqrt(2.0 / w.shape[0])
        assert abs(float(w.std()) / want - 1) < 0.05
        assert abs(float(w.mean())) < 0.05 * want
    np.testing.assert_allclose(float(p.fm.v.std()), 0.01, rtol=0.2)


@pytest.mark.parametrize("with_plan", [False, True])
def test_scores_match_jax(with_plan):
    """Scores and predictions against the JAX package's on the same
    weights, per slot and through a dedup plan (rtol 1e-5, atol 1e-6)."""
    for task in ("classification", "regression"):
        jcfg, pcfg = _cfgs(task)
        ids, vals, _ = _data(task)
        wts = _weights()
        plan = None
        if with_plan:
            plan = PE.plan_to_device(PE.host_dedup(ids, 1024, F - 1), "cpu")
        got = PDF.scores(_pparams(wts), pcfg, torch.from_numpy(ids),
                         torch.from_numpy(vals), plan)
        want = JDF.scores(_jparams(wts), jcfg, jnp.asarray(ids),
                          jnp.asarray(vals))
        _close(got, want, "scores", rtol=1e-5)
        _close(PDF.predict(_pparams(wts), pcfg, torch.from_numpy(ids),
                           torch.from_numpy(vals), plan),
               JDF.predict(_jparams(wts), jcfg, jnp.asarray(ids),
                           jnp.asarray(vals)), "predict", rtol=1e-5)


CASES = [  # (path, task, optimizer, momentum, host plans, extras)
    ("direct", "regression", "adagrad", 0.0, False, {}),
    ("direct", "classification", "sgd", 0.0, False, {}),
    ("direct", "regression", "sgd", 0.9, False, {}),
    ("dedup", "classification", "adagrad", 0.0, True, {}),
    ("dedup", "regression", "sgd", 0.0, False, {}),
    ("fused", "classification", "adagrad", 0.0, True, {}),
    ("fused", "regression", "sgd", 0.0, False, {}),
    ("fused", "classification", "adagrad", 0.0, True,
     dict(accumulate="segsum")),
    ("dedup", "regression", "adagrad", 0.0, False,
     dict(accumulate="segsum")),
    ("fused", "regression", "adagrad", 0.0, True,
     dict(fm=dict(use_bias=False, use_linear=False))),
]


@pytest.mark.parametrize("path,task,opt,momentum,host,extra", CASES)
def test_step_matches_jax(path, task, opt, momentum, host, extra):
    """3 steps of the port's step and of the JAX package's from the same
    state on the same batches (the last a masked tail): losses, then every
    table, slot and tower tensor; dedup and fused also the plans' unique
    counts. ``accumulate="segsum"`` takes the card's route (B6's plain
    version over id-sorted runs) on the CPU."""
    extra = dict(extra)
    jcfg, pcfg = _cfgs(task, **extra.pop("fm", {}))
    ids, vals, y = _data(task)
    lr = 0.01 if momentum else 0.1
    skw = dict(batch_size=B, learning_rate=lr, optimizer=opt,
               momentum=momentum, update_path=path, host_plan=host)
    jstep = JDF.make_train_step(jcfg, JSGDConfig(**skw))
    pstep = PDF.make_train_step(pcfg, SGDConfig(**skw, **extra))
    js, ps = _states(path, jcfg, pcfg, _weights())
    plan_kw = (dict(dedup_budget=512, dedup_fill=F)
               if host and path != "direct" else {})
    jb_it = jbatching.batch_iterator(jbatching.SparseDataset(
        ids=ids, vals=vals, y=y, num_features=F), B, **plan_kw)
    pb_it = pbatching.batch_iterator(pbatching.SparseDataset(
        ids=ids, vals=vals, y=y, num_features=F), B, device="cpu",
        **plan_kw)
    steps = 0
    for jb, pb in zip(jb_it, pb_it):
        js, jaux = jstep(js, jb)
        out, paux = pstep(ps, pb)
        assert out is ps                    # updated in place
        steps += 1
        _close(paux["loss"], jaux["loss"], "loss", rtol=1e-5)
        assert set(jaux) <= set(paux)
        if path != "direct":
            assert int(paux["unique_count"]) == int(jaux["unique_count"])
            assert not bool(paux["unique_overflow"])
    assert steps == 3 and int(ps.fm.step) == 3
    _assert_state_close(path, ps, js)


def test_paths_agree_with_each_other():
    """Under adagrad the three paths are one update: direct, dedup and
    fused from the same weights end equal (rtol 1e-4, atol 1e-6)."""
    _, pcfg = _cfgs()
    ids, vals, y = _data()
    ds = pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    params = {}
    for path in ("direct", "dedup", "fused"):
        sgd_cfg = SGDConfig(batch_size=B, update_path=path, epochs=1)
        if path == "fused":
            js, ps = _states(path, *_cfgs(), _weights())
        else:
            ps = PDF.init_state(_pparams(_weights()))
            if path == "dedup":
                ps = PDF.pad_deepfm_state_for_dedup(ps)
        step = PDF.make_train_step(pcfg, sgd_cfg)
        for b in pbatching.batch_iterator(ds, B, device="cpu",
                                          dedup_budget="ladder",
                                          dedup_fill=F):
            step(ps, b)
        params[path] = PDF.params_of(ps, pcfg)
    for path in ("dedup", "fused"):
        for a, b in zip(params[path].parameters(),
                        params["direct"].parameters()):
            _close(a, b, path)


def _patched_init(monkeypatch, wts):
    """Both packages' init_params return the same numpy weights, so their
    trainers and facades start from one state."""
    monkeypatch.setattr(JDF, "init_params",
                        lambda cfg, key=None: _jparams(wts))
    monkeypatch.setattr(PDF, "init_params",
                        lambda cfg, generator=None, *, device:
                        PDF.deepfm_params_from_numpy(*wts, device=device))


@pytest.mark.parametrize("path,task", [("direct", "regression"),
                                       ("fused", "classification"),
                                       ("dedup", "classification")])
def test_train_deepfm_history_matches_jax(monkeypatch, path, task):
    """train_deepfm against the JAX package's from the same weights: 3
    epochs, shuffled, with evals; train_loss rtol 1e-5, eval_rmse and
    eval_auc rtol 1e-4, eval_accuracy within one example; the final
    params rtol 1e-4, atol 1e-6."""
    _patched_init(monkeypatch, _weights())
    jcfg, pcfg = _cfgs(task)
    ids, vals, y = _data(task, n=4 * B)
    eids, evals_, ey = _data(task, seed=5, n=B + 7)
    skw = dict(batch_size=B, learning_rate=0.05, epochs=3, update_path=path)
    jres = JDF.train_deepfm(
        jcfg, JSGDConfig(**skw),
        jbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F),
        jbatching.SparseDataset(ids=eids, vals=evals_, y=ey,
                                num_features=F), eval_every=2)
    pres = PDF.train_deepfm(
        pcfg, SGDConfig(**skw),
        pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F),
        pbatching.SparseDataset(ids=eids, vals=evals_, y=ey,
                                num_features=F), eval_every=2,
        device="cpu")
    assert len(pres.history) == len(jres.history) == 3
    for ph, jh in zip(pres.history, jres.history):
        assert ph.keys() == jh.keys()
        _close(ph["train_loss"], jh["train_loss"], "train_loss", rtol=1e-5)
        for k in ("eval_rmse", "eval_auc"):
            if k in jh:
                _close(ph[k], jh[k], k, rtol=1e-4)
        if "eval_accuracy" in jh:
            assert abs(ph["eval_accuracy"] - jh["eval_accuracy"]) <= (
                1.0 / len(ey) + 1e-9)
    got, want = pres.params, jres.params
    _close(got.fm.w0, want.fm.w0, "w0")
    _close(got.fm.w, want.fm.w, "w")
    _close(got.fm.v, want.fm.v, "v")
    for a, b in zip(got.mlp_w, want.mlp_w):
        _close(a, b, "mlp_w")
    assert got.fm.v.shape == (F, K) and pres.examples_per_sec > 0


@pytest.mark.parametrize("path", ["direct", "dedup", "fused"])
def test_checkpoint_resume_is_bit_exact(tmp_path, path):
    """2 epochs into a checkpoint_dir, then a new run resumed to 4 equals
    4 straight epochs bit for bit (history and every parameter); a
    checkpoint of another path's layout raises ValueError."""
    _, pcfg = _cfgs()
    ids, vals, y = _data(n=3 * B)
    ds = pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)

    def run(epochs, path=path, **kw):
        return PDF.train_deepfm(pcfg, SGDConfig(
            batch_size=B, epochs=epochs, update_path=path), ds,
            generator=torch.Generator().manual_seed(0), device="cpu", **kw)
    ck = str(tmp_path / "ck")
    run(2, checkpoint_dir=ck)
    resumed = run(4, checkpoint_dir=ck)
    straight = run(4)
    assert resumed.history == straight.history
    for a, b in zip(resumed.params.parameters(),
                    straight.params.parameters()):
        assert torch.equal(a, b)
    other = "fused" if path != "fused" else "direct"
    with pytest.raises(ValueError, match="another state layout"):
        run(5, path=other, checkpoint_dir=ck)


def test_facade_fit_save_load_match_jax(monkeypatch, tmp_path):
    """FM(model="deepfm").fit against the JAX facade from the same
    weights (predictions rtol 1e-4, atol 1e-6); the port's DeepFMModel
    saved and loaded predicts the same bit for bit, load_model finds it
    by its tag and FMModel.load refuses it."""
    _patched_init(monkeypatch, _weights())
    ids, vals, y = _data(n=4 * B)
    kw = dict(num_factors=K, num_fields=FIELDS, model="deepfm",
              solver="sgd", hidden=HIDDEN, max_iter=2, batch_size=B,
              task="classification", reg_v=0.03, learning_rate=0.05)
    jm = japi.FM(**kw).fit(jbatching.SparseDataset(ids=ids, vals=vals, y=y,
                                                   num_features=F))
    pm = papi.FM(**kw).fit(pbatching.SparseDataset(ids=ids, vals=vals, y=y,
                                                   num_features=F),
                           device="cpu")
    assert isinstance(pm, papi.DeepFMModel)
    _close(pm.predict(ids, vals), jm.predict(ids, vals), "predict")
    np.testing.assert_array_equal(        # numpy's default dtypes, cast
        pm.predict(ids.astype(np.int64), vals.astype(np.float64)),
        pm.predict(ids, vals))
    pds = pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    jds = jbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    _close(pm.predict_dataset(pds, batch_size=B),
           jm.predict_dataset(jds, batch_size=B), "predict_dataset")
    pe, je = pm.evaluate(pds), jm.evaluate(jds)
    assert pe.keys() == je.keys()
    for k in pe:
        _close(pe[k], je[k], k, rtol=1e-4)
    pm.save(str(tmp_path / "m"))
    for loaded in (papi.DeepFMModel.load(str(tmp_path / "m"), device="cpu"),
                   papi.load_model(str(tmp_path / "m"), device="cpu")):
        assert isinstance(loaded, papi.DeepFMModel)
        assert loaded.cfg == pm.cfg
        np.testing.assert_array_equal(loaded.predict(ids, vals),
                                      pm.predict(ids, vals))
    with pytest.raises(ValueError, match="DeepFMModel.load"):
        papi.FMModel.load(str(tmp_path / "m"), device="cpu")


def test_facade_raises():
    ids, vals, y = _data()
    ds = pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    kw = dict(num_factors=K, num_fields=FIELDS, model="deepfm", max_iter=1,
              batch_size=B)
    with pytest.raises(ValueError, match="requires solver='sgd'"):
        papi.FM(solver="als", **kw).fit(ds, device="cpu")
    with pytest.raises(ValueError, match="warm start"):
        papi.FM(solver="sgd", **kw).fit(ds, init_params=object(),
                                        device="cpu")
    with pytest.raises(ValueError, match="world of 2 processes"):
        papi.FM(solver="sgd", mesh="2x1", **kw).fit(ds, device="cpu")


@pytest.mark.parametrize("use_plans", [None, True])
def test_microbatcher_matches_jax(use_plans):
    """MicroBatcher(model="deepfm") over requests of mixed sizes, with the
    default (no plans, as in JAX) and with use_plans=True (one two-table
    gather per chunk, which the JAX batcher accepts and ignores): each
    output equals the JAX batcher's (rtol 1e-5, atol 1e-6) and the port's
    DeepFMModel.predict on the same rows."""
    jcfg, pcfg = _cfgs()
    wts = _weights()
    ids, vals, _ = _data(n=150)
    sizes = [1, 3, 40, 70, 36]
    starts = np.cumsum([0] + sizes)
    jmb = jserving.MicroBatcher(_jparams(wts), jcfg, max_batch=64,
                                use_plans=use_plans, model="deepfm")
    pmb = pserving.MicroBatcher(_pparams(wts), pcfg, max_batch=64,
                                use_plans=use_plans, model="deepfm")
    assert pmb.use_plans == bool(use_plans)
    for a, b in zip(starts[:-1], starts[1:]):
        req = (ids[a:b], vals[a:b]) if b - a > 1 else (ids[a], vals[a])
        jmb.submit(*req)
        pmb.submit(*req)
    model = papi.DeepFMModel(params=_pparams(wts), cfg=pcfg)
    for (a, b), got, want in zip(zip(starts[:-1], starts[1:]), pmb.flush(),
                                 jmb.flush()):
        _close(got, want, "flush", rtol=1e-5)
        _close(got, model.predict(ids[a:b], vals[a:b]), "predict",
               rtol=1e-5)


def test_microbatcher_refuses_field_ids():
    """The JAX DeepFM batcher ignores field_ids silently; the port's
    refuses them (DeepFM input is field-major)."""
    _, pcfg = _cfgs()
    mb = pserving.MicroBatcher(_pparams(_weights()), pcfg, model="deepfm")
    ids, vals, _ = _data(n=2)
    with pytest.raises(ValueError, match="field-major"):
        mb.submit(ids, vals, np.broadcast_to(np.arange(FIELDS), ids.shape))


def test_slots_must_equal_num_fields():
    """L != num_fields raises a ValueError that says so, where the JAX
    package's reshape fails inside the tower."""
    jcfg, pcfg = _cfgs()
    wts = _weights()
    ids, vals, y = _data()
    ids6 = np.concatenate([ids, ids[:, :1]], 1)
    vals6 = np.concatenate([vals, vals[:, :1]], 1)
    with pytest.raises(Exception):
        JDF.scores(_jparams(wts), jcfg, jnp.asarray(ids6),
                   jnp.asarray(vals6))
    with pytest.raises(ValueError, match="num_fields = 5"):
        PDF.scores(_pparams(wts), pcfg, torch.from_numpy(ids6),
                   torch.from_numpy(vals6))
    step = PDF.make_train_step(pcfg, SGDConfig(batch_size=B))
    batch = next(pbatching.batch_iterator(pbatching.SparseDataset(
        ids=ids6, vals=vals6, y=y, num_features=F), B, device="cpu"))
    with pytest.raises(ValueError, match="one slot per field"):
        step(PDF.init_state(_pparams(wts)), batch)


@pytest.mark.parametrize("path,kw,match", [
    ("direct", dict(optimizer="adam"), "'adagrad' or 'sgd'"),
    ("fused", dict(optimizer="adagrad_row"), "'adagrad' or 'sgd'"),
    ("fused", dict(optimizer="sgd", momentum=0.9), "momentum"),
    ("dedup", dict(optimizer="sgd", momentum=0.9), "momentum"),
    ("hybrid", {}, "direct/dedup/fused"),
])
def test_optimizer_and_path_raises_match_jax(path, kw, match):
    jcfg, pcfg = _cfgs()
    for make, cfg, sgd in ((JDF.make_train_step, jcfg, JSGDConfig),
                           (PDF.make_train_step, pcfg, SGDConfig)):
        with pytest.raises(ValueError, match=match):
            make(cfg, sgd(update_path=path, **kw))


def test_auto_path_and_state_kinds():
    """"auto": direct below 2^16 rows, fused above, as in JAX; a step
    given the other path's state raises."""
    for feats, want in ((F, "direct"), (1 << 16, "fused")):
        for mod, cfg_t, sgd_t in ((JDF, JFMConfig, JSGDConfig),
                                  (PDF, FMConfig, SGDConfig)):
            cfg = mod.DeepFMConfig(fm=cfg_t(num_features=feats,
                                            num_fields=FIELDS))
            assert mod.resolve_deepfm_path(cfg, sgd_t()) == want
    _, pcfg = _cfgs()
    fused = PDF.init_fused_deepfm_state(pcfg, device="cpu")
    assert isinstance(fused.fm, FusedState)
    assert fused.fm.table.shape == (F + 1, 12)      # 2K+2 = 10 -> 12
    ids, vals, y = _data()
    batch = next(pbatching.batch_iterator(pbatching.SparseDataset(
        ids=ids, vals=vals, y=y, num_features=F), B, device="cpu"))
    with pytest.raises(ValueError, match="takes an SGD"):
        PDF.make_train_step(pcfg, SGDConfig(update_path="direct"))(fused,
                                                                   batch)


def test_feature_groups_refused():
    """The JAX DeepFM ignores feature_groups; the port refuses them."""
    _, pcfg = _cfgs(feature_groups=tuple(i % 2 for i in range(F)))
    with pytest.raises(ValueError, match="feature_groups"):
        PDF.make_train_step(pcfg, SGDConfig())


def test_record_width_at_config_5():
    """BASELINE config 5's record: 2 * 16 + 2 = 34 floats padded to 36
    (the JAX package pads to 128)."""
    cfg = PDF.DeepFMConfig(fm=FMConfig(num_features=1 << 10, num_factors=16,
                                       num_fields=39), hidden=(256, 128))
    state = PDF.init_fused_deepfm_state(cfg, device="cpu")
    assert state.fm.table.shape == (1025, 36)
    jstate = JDF.init_fused_deepfm_state(
        JDF.DeepFMConfig(fm=JFMConfig(num_features=1 << 10, num_factors=16,
                                      num_fields=39), hidden=(256, 128)),
        jax.random.PRNGKey(0))
    assert jstate["table"].shape == (1025, 128)
    assert JE.auto_budget(8192 * 39) == PE.auto_budget(8192 * 39) == 1 << 18


def test_train_deepfm_time_budget_and_mesh():
    """max_seconds stops after the epoch that reaches it, as in the JAX
    trainer; a 2 x 1 mesh in a one-process run raises naming the world
    it needs."""
    _, pcfg = _cfgs()
    ids, vals, y = _data()
    ds = pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    res = PDF.train_deepfm(pcfg, SGDConfig(batch_size=B, epochs=50,
                                           max_seconds=1e-6), ds,
                           device="cpu")
    assert [h["epoch"] for h in res.history] == [0]
    with pytest.raises(ValueError, match="world of 2 processes"):
        PDF.train_deepfm(pcfg, SGDConfig(batch_size=B), ds, mesh="2x1",
                         device="cpu")
