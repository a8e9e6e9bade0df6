"""The port's field-aware FM (FFM) against the JAX package: the three
interaction forms and their gradients, scoring and ``predict``, the fused
record step on an FFM table, the update-path policy, the facade's
slot-major detection and ``MicroBatcher`` with field_ids.

Tolerances: the interaction forms and scores rtol 2e-5, atol 2e-5 (the
JAX package's own bound between its forms, ``tests/test_ffm.py``); the
fused step after several steps: losses rtol 1e-5, tables ``[:F, :2vk+2]``
rtol 1e-4, atol 1e-6 (float32 sums in another order).

One divergence from the JAX package, on purpose: under a slot-major
config, field_ids given at score time that are not ``arange(L)`` score by
the field-aggregated form, where the JAX package ignores them
(``sparkfm_tpu/models/fm.py:97-100``;
:func:`test_slot_major_config_honours_other_field_ids`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparkfm_tpu as sfm
from sparkfm_tpu.config import FMConfig as JFMConfig
from sparkfm_tpu.config import SGDConfig as JSGDConfig
from sparkfm_tpu.config import Task as JTask
from sparkfm_tpu.data import batching as jbatching
from sparkfm_tpu.data import synth as jsynth
from sparkfm_tpu.models import fm as jfm
from sparkfm_tpu.ops import interaction as JI
from sparkfm_tpu.serving import MicroBatcher as JMicroBatcher
from sparkfm_tpu.solvers import sgd as jsgd
from sparkfm_tpu.solvers import sgd_fused as jfused
from sparkfm_tpu_torch import FM, FMConfig, MicroBatcher, SGDConfig, Task
from sparkfm_tpu_torch.api import _detect_slot_major
from sparkfm_tpu_torch.data import batching as pbatching
from sparkfm_tpu_torch.data import synth
from sparkfm_tpu_torch.models import fm as pfm
from sparkfm_tpu_torch.ops import interaction as PI
from sparkfm_tpu_torch.solvers import sgd as psgd
from sparkfm_tpu_torch.solvers import sgd_fused

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
NF, K, F, B = 4, 3, 400, 64


def _rand_case(seed, b=5, l=9, nf=4, k=3):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(b, l)).astype(np.float32)
    vals[:, -2:] = 0.0                       # padding slots
    fids = rng.integers(0, nf, (b, l)).astype(np.int32)
    vr = rng.normal(size=(b, l, nf, k)).astype(np.float32)
    wr = rng.normal(size=(b, l)).astype(np.float32)
    return vals, fids, vr, wr


def _slot_major_case(seed, b=4, nf=6, k=3):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(b, nf)).astype(np.float32)
    vals[:, -1] = 0.0
    fids = np.broadcast_to(np.arange(nf, dtype=np.int32), (b, nf)).copy()
    vr = rng.normal(size=(b, nf, nf, k)).astype(np.float32)
    wr = rng.normal(size=(b, nf)).astype(np.float32)
    return vals, fids, vr, wr


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("form,flat", [
    ("aggregated", False), ("aggregated", True), ("pairwise", False),
    ("slot_major", False), ("slot_major", True)])
def test_forms_match_jax(form, flat):
    """Each FFM form against its JAX counterpart, with multi-hot fields
    and padded slots (aggregated, pairwise) or one slot per field
    (slot-major), on (B, L, F, K) rows or the flat storage layout."""
    vals, fids, vr, wr = (_slot_major_case(2) if form == "slot_major"
                          else _rand_case(0))
    nf = vr.shape[2]
    if flat:
        vr = vr.reshape(vr.shape[0], vr.shape[1], -1)
    w0 = np.float32(0.37)
    if form == "pairwise":
        want = JI.ffm_scores_pairwise(*_j(w0, wr, vr, vals, fids), nf)
        got = PI.ffm_scores_pairwise(*_t(w0, wr, vr, vals, fids), nf)
    else:
        sm = form == "slot_major"
        want = JI.ffm_scores_from_gathered(*_j(w0, wr, vr, vals, fids), nf,
                                           slot_major=sm)
        got = PI.ffm_scores_from_gathered(*_t(w0, wr, vr, vals, fids), nf,
                                          slot_major=sm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("slot_major", [False, True])
def test_gradients_match_jax(slot_major):
    """d(sum of squared scores)/d(rows) by torch autograd against
    jax.grad, for the aggregated and slot-major forms; and the two forms'
    gradients agree with each other where both apply."""
    vals, fids, vr, wr = _slot_major_case(3)
    nf = vr.shape[2]
    w0 = np.float32(0.2)

    def jloss(v, w):
        s = JI.ffm_scores_from_gathered(jnp.asarray(w0), w, v,
                                        jnp.asarray(vals), jnp.asarray(fids),
                                        nf, slot_major=slot_major)
        return jnp.sum(jnp.square(s))
    jgv, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(vr),
                                              jnp.asarray(wr))
    tv, tw = (torch.from_numpy(a).requires_grad_() for a in (vr, wr))
    s = PI.ffm_scores_from_gathered(torch.tensor(w0), tw, tv,
                                    torch.from_numpy(vals),
                                    torch.from_numpy(fids), nf,
                                    slot_major=slot_major)
    gv, gw = torch.autograd.grad(s.square().sum(), (tv, tw))
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), **TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), **TOL)
    other = PI.ffm_scores_from_gathered(torch.tensor(w0), tw, tv,
                                        torch.from_numpy(vals),
                                        torch.from_numpy(fids), nf,
                                        slot_major=not slot_major)
    gv2 = torch.autograd.grad(other.square().sum(), tv)[0]
    np.testing.assert_allclose(gv2.numpy(), gv.numpy(), **TOL)


def test_slot_major_rejects_ragged_shapes():
    vals, fids, vr, wr = _rand_case(4)     # L=9 != F=4
    with pytest.raises(ValueError, match="slot-major"):
        PI.ffm_scores_from_gathered(*_t(np.float32(0), wr, vr, vals, fids),
                                    4, slot_major=True)


def _ffm_params(seed=0, f=F, nf=NF, k=K):
    rng = np.random.default_rng(seed)
    return (np.float32(0.1), rng.normal(0, 0.3, f).astype(np.float32),
            rng.normal(0, 0.3, (f, nf * k)).astype(np.float32))


def _both_params(params):
    w0, w, v = params
    return (jfm.FMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                         v=jnp.asarray(v)),
            pfm.params_from_numpy(w0, w, v, device="cpu"))


@pytest.mark.parametrize("slot_major,task", [
    (False, "regression"), (True, "classification")])
def test_scores_and_predict_match_jax(slot_major, task):
    rng = np.random.default_rng(5)
    l = NF if slot_major else 7
    ids = rng.integers(0, F, (B, l)).astype(np.int32)
    vals = rng.normal(1, 0.5, (B, l)).astype(np.float32)
    fids = (np.broadcast_to(np.arange(NF, dtype=np.int32), (B, l)).copy()
            if slot_major else rng.integers(0, NF, (B, l)).astype(np.int32))
    kw = dict(num_features=F, num_factors=K, num_fields=NF,
              slot_major_fields=slot_major)
    jp, pp = _both_params(_ffm_params())
    jcfg, pcfg = JFMConfig(task=JTask(task), **kw), FMConfig(task=Task(task),
                                                             **kw)
    for fn_j, fn_p in ((jfm.scores, pfm.scores), (jfm.predict, pfm.predict)):
        want = fn_j(jp, jcfg, *_j(ids, vals, fids))
        got = fn_p(pp, pcfg, *_t(ids, vals, fids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if slot_major:          # field_ids may be omitted
        got = pfm.scores(pp, pcfg, *_t(ids, vals))
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jfm.scores(jp, jcfg, *_j(ids, vals))),
            **TOL)
    else:
        with pytest.raises(ValueError, match="field_ids"):
            pfm.scores(pp, pcfg, *_t(ids, vals))


def test_slot_major_config_honours_other_field_ids():
    """The JAX package's defect, fixed: a slot-major config given field_ids
    that are not arange(L) scores them by the aggregated form, which
    equals the per-pair oracle; the JAX package scores them as if they
    were arange (its output equals the port's with arange field_ids)."""
    rng = np.random.default_rng(6)
    ids = rng.integers(0, F, (B, NF)).astype(np.int32)
    vals = rng.normal(1, 0.5, (B, NF)).astype(np.float32)
    fids = rng.integers(0, NF, (B, NF)).astype(np.int32)
    fids[0] = [1, 0, 3, 2]                  # not arange in any case
    ar = np.broadcast_to(np.arange(NF, dtype=np.int32), (B, NF)).copy()
    kw = dict(num_features=F, num_factors=K, num_fields=NF,
              slot_major_fields=True)
    jp, pp = _both_params(_ffm_params(1))
    pcfg = FMConfig(**kw)
    got = pfm.scores(pp, pcfg, *_t(ids, vals, fids))
    w_rows, v_rows = pp.w[ids.astype(np.int64)], pp.v[ids.astype(np.int64)]
    oracle = PI.ffm_scores_pairwise(pp.w0, w_rows, v_rows,
                                    torch.from_numpy(vals),
                                    torch.from_numpy(fids), NF)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)
    jax_out = np.asarray(jfm.scores(jp, JFMConfig(**kw),
                                    *_j(ids, vals, fids)))
    np.testing.assert_allclose(
        jax_out, pfm.scores(pp, pcfg, *_t(ids, vals, ar)).numpy(), **TOL)
    assert not np.allclose(jax_out, got.numpy(), rtol=1e-3)


def test_init_params_is_flat():
    cfg = FMConfig(num_features=64, num_factors=2, num_fields=3, seed=4)
    p = pfm.init_params(cfg, device="cpu")
    assert p.v.shape == (64, 6) and p.w.shape == (64,)
    assert float(p.v.std()) == pytest.approx(cfg.init_stdev, rel=0.3)


def _ctr(n, seed, nf=NF, f=F):
    return jsynth.synth_ctr(num_examples=n, num_fields=nf, num_buckets=f,
                            seed=seed)


@pytest.mark.parametrize("accumulate,host", [
    ("scatter", True), ("segsum", True), ("auto", False)])
def test_fused_ffm_step_matches_jax(accumulate, host):
    """The fused record step on an FFM table (record width 2*NF*K + 2
    rounded up to a multiple of 4) against the JAX fused step, 8 steps,
    slot-major batches."""
    ds = _ctr(8 * B, 7)
    kw = dict(num_features=F, num_factors=K, num_fields=NF, reg_w=0.01,
              reg_v=0.02, task=JTask.CLASSIFICATION, slot_major_fields=True)
    skw = dict(batch_size=B, learning_rate=0.1, update_path="fused",
               accumulate=accumulate, host_plan=host, unique_budget=256)
    jcfg = JFMConfig(**kw)
    pcfg = FMConfig(**dict(kw, task=Task.CLASSIFICATION))
    jp, _ = _both_params(_ffm_params(2))
    jstate = jfused.fused_from_params(jp, jcfg)
    pstate = sgd_fused.fused_state_from_numpy(
        np.asarray(jstate.table), np.asarray(jstate.w0),
        np.asarray(jstate.slot_w0), np.asarray(jstate.step), pcfg,
        device="cpu")
    assert pstate.table.shape == (F + 1, sgd_fused.record_width(K, NF))
    assert sgd_fused.record_width(K, NF) == 28
    jstep = jfused.make_fused_train_step(jcfg, JSGDConfig(**skw))
    pstep = sgd_fused.make_fused_train_step(pcfg, SGDConfig(**skw))
    pds = pbatching.SparseDataset(ids=ds.ids, vals=ds.vals, y=ds.y,
                                  num_features=F, field_ids=ds.field_ids)
    plan_kw = dict(dedup_budget=256, dedup_fill=F) if host else {}
    for jb, pb in zip(jbatching.batch_iterator(ds, B, **plan_kw),
                      pbatching.batch_iterator(pds, B, device="cpu",
                                               **plan_kw)):
        jstate, jaux = jstep(jstate, jb)
        pstate, paux = pstep(pstate, pb)
        np.testing.assert_allclose(float(paux["loss"]), float(jaux["loss"]),
                                   rtol=1e-5)
    used = 2 * NF * K + 2
    np.testing.assert_allclose(pstate.table[:F, :used].numpy(),
                               np.asarray(jstate.table)[:F, :used],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(pstate.w0), float(jstate.w0),
                               rtol=1e-5)
    assert int(pstate.step) == int(jstate.step) == 8
    back = sgd_fused.params_from_fused(pstate, pcfg)
    assert back.v.shape == (F, NF * K)


@pytest.mark.parametrize("f,sgd_kw", [
    (1 << 10, {}), (1 << 20, {}), (1 << 20, dict(optimizer="adam")),
    (1 << 20, dict(optimizer="sgd", momentum=0.9)),
    (1 << 20, dict(optimizer="adagrad_row")),
    (1 << 20, dict(update_path="hybrid"))])
def test_resolve_update_path_ffm_matches_jax(f, sgd_kw):
    kw = dict(num_features=f, num_factors=K, num_fields=NF)
    want = jsgd.resolve_update_path(JFMConfig(**kw), JSGDConfig(**sgd_kw))
    assert psgd.resolve_update_path(FMConfig(**kw),
                                    SGDConfig(**sgd_kw)) == want


def test_hybrid_and_sorted_refuse_ffm_as_jax():
    from sparkfm_tpu_torch.solvers import sgd_hybrid, sgd_sorted
    cfg = FMConfig(num_features=1 << 20, num_factors=K, num_fields=NF)
    for make in (sgd_hybrid.make_hybrid_train_step,
                 sgd_sorted.make_sorted_train_step):
        with pytest.raises(ValueError, match="plain FM"):
            make(cfg, SGDConfig())


@pytest.mark.parametrize("nf,fids,want", [
    (4, "arange", True), (4, "shuffled", False), (4, None, False),
    (0, "arange", False), (3, "arange", False)])
def test_detect_slot_major_matches_jax(nf, fids, want):
    from sparkfm_tpu.api import _detect_slot_major as jdetect
    ds = synth.synth_ctr(num_examples=32, num_fields=4, num_buckets=64,
                         seed=0)
    if fids is None:
        ds = dataclasses.replace(ds, field_ids=None)
    elif fids == "shuffled":
        ds.field_ids[3] = [1, 0, 2, 3]
    assert _detect_slot_major(ds, nf) == jdetect(ds, nf) == want


def test_facade_ffm_fit_and_predict_match_jax():
    """FM(num_fields=4, solver="sgd") on a 400-row table (the direct path
    under "auto") against the JAX facade from the same initial
    parameters: slot-major detected in both, epoch losses, parameters and
    predictions."""
    jds, pds = _ctr(600, 8), synth.synth_ctr(num_examples=600, num_fields=NF,
                                             num_buckets=F, seed=8)
    kw = dict(num_factors=K, num_fields=NF, solver="sgd", max_iter=3,
              batch_size=128, learning_rate=0.05, reg_v=0.001,
              task="classification")
    jp, pp = _both_params(_ffm_params(3))
    jm = sfm.FM(**kw).fit(jds, init_params=jp)
    pm = FM(**kw).fit(pds, init_params=pp, device="cpu")
    assert pm.cfg.slot_major_fields and jm.cfg.slot_major_fields
    for g, h in zip(pm.history, jm.history):
        np.testing.assert_allclose(g["train_loss"], h["train_loss"],
                                   rtol=1e-5)
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(pm.params, name).numpy(),
                                   np.asarray(getattr(jm.params, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(
        pm.predict(pds.ids[:50], pds.vals[:50], pds.field_ids[:50]),
        np.asarray(jm.predict(pds.ids[:50], pds.vals[:50],
                              pds.field_ids[:50])), **TOL)
    np.testing.assert_allclose(pm.predict_dataset(pds),
                               np.asarray(jm.predict_dataset(jds)), **TOL)


def test_micro_batcher_ffm_flush_matches_jax():
    """Requests with field_ids, of mixed sizes over two chunks, against
    the JAX MicroBatcher on the same parameters."""
    rng = np.random.default_rng(9)
    kw = dict(num_features=F, num_factors=K, num_fields=NF,
              task=JTask.CLASSIFICATION)
    jp, pp = _both_params(_ffm_params(4))
    jmb = JMicroBatcher(jp, JFMConfig(**kw), max_batch=32)
    pmb = MicroBatcher(pp, FMConfig(**dict(kw, task=Task.CLASSIFICATION)),
                       max_batch=32)
    assert not pmb.use_plans
    for n in (1, 5, 20, 9):
        ids = rng.integers(0, F, (n, 6)).astype(np.int32)
        vals = rng.normal(1, 0.5, (n, 6)).astype(np.float32)
        fids = rng.integers(0, NF, (n, 6)).astype(np.int32)
        for mb in (jmb, pmb):
            mb.submit(ids, vals, fids)
    for got, want in zip(pmb.flush(), jmb.flush()):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("slot_major", [True, False])
def test_bf16_compute_step_matches_jax(slot_major):
    """compute_dtype='bfloat16' on the fused FFM step (the interaction in
    bfloat16, the tables float32): one step from the same table against
    the JAX step in bfloat16, and against the port's float32 step, losses
    at rtol 2e-2 (bfloat16 keeps 8 bits of mantissa; the JAX package
    holds its bf16 step to its f32 one at this tolerance,
    ``tests/test_ffm.py``)."""
    rng = np.random.default_rng(8)
    nf, k, f, b = 4, 2, 64, 16
    per = f // nf
    ids = (rng.integers(0, per, (b, nf)).astype(np.int32)
           + per * np.arange(nf, dtype=np.int32)[None, :])
    y = rng.integers(0, 2, b).astype(np.float32)
    fids = np.broadcast_to(np.arange(nf, dtype=np.int32), (b, nf)).copy()
    jds = jbatching.SparseDataset(ids=ids, vals=np.ones((b, nf), np.float32),
                                  y=y, num_features=f, field_ids=fids)
    pds = pbatching.SparseDataset(ids=ids, vals=np.ones((b, nf), np.float32),
                                  y=y, num_features=f, field_ids=fids)
    plan_kw = dict(dedup_budget=64, dedup_fill=f)
    losses = {}
    for cdt in ("float32", "bfloat16"):
        jp, _ = _both_params(_ffm_params(5, f, nf, k))  # the step donates
        kw = dict(num_features=f, num_factors=k, num_fields=nf, reg_v=0.01,
                  slot_major_fields=slot_major, compute_dtype=cdt)
        skw = dict(batch_size=b, learning_rate=0.1, update_path="fused")
        jcfg = JFMConfig(task=JTask.CLASSIFICATION, **kw)
        pcfg = FMConfig(task=Task.CLASSIFICATION, **kw)
        jstate = jfused.fused_from_params(jp, jcfg)
        pstate = sgd_fused.fused_state_from_numpy(
            np.asarray(jstate.table), np.asarray(jstate.w0),
            np.asarray(jstate.slot_w0), np.asarray(jstate.step), pcfg,
            device="cpu")
        _, jaux = jfused.make_fused_train_step(jcfg, JSGDConfig(**skw))(
            jstate, next(jbatching.batch_iterator(jds, b, **plan_kw)))
        _, paux = sgd_fused.make_fused_train_step(pcfg, SGDConfig(**skw))(
            pstate, next(pbatching.batch_iterator(pds, b, device="cpu",
                                                  **plan_kw)))
        np.testing.assert_allclose(float(paux["loss"]), float(jaux["loss"]),
                                   rtol=2e-2, err_msg=cdt)
        losses[cdt] = float(paux["loss"])
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"],
                               rtol=2e-2)
