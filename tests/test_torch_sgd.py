"""The port's "direct" and "dedup" train steps (``solvers/sgd.py``)
against the JAX package's ``make_train_step``, from the same state
(carried across by ``state_from_numpy``) on the same batches: adagrad,
plain sgd, sgd with momentum and adam, host and device plans, both tasks,
FFM, attribute groups and no bias; and the state helpers, the
duplicate-id rule of the direct step, lean slot2 and the B6 accumulate.

Tolerance after 8 steps: losses rtol 1e-5 (atol 1e-6), tables and slots
rtol 1e-4, atol 1e-6 (float32 sums in another order: the port sums by
sorted runs where the JAX package scatter-adds)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.config import FMConfig as JFMConfig
from sparkfm_tpu.config import SGDConfig as JSGDConfig
from sparkfm_tpu.config import Task as JTask
from sparkfm_tpu.data import batching as jbatching
from sparkfm_tpu.models.fm import FMParams as JFMParams
from sparkfm_tpu.ops import embedding as JE
from sparkfm_tpu.solvers import sgd as jsgd
from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.data import batching as pbatching
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.solvers import sgd as psgd

torch.set_num_threads(1)
F, K, L, B, N = 300, 4, 5, 64, 520
BUDGET = 512
FIELDS = 5
GROUPS = dict(feature_groups=tuple(i % 3 for i in range(F)),
              group_reg_w=(0.01, 0.0, 0.05), group_reg_v=(0.03, 0.1, 0.0))
NAMES = ("slot_w0", "slot_w", "slot_v", "slot2_w0", "slot2_w", "slot2_v")


def _data(task, seed=0, vk=K):
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.5, (N, L)) % F).astype(np.int32)
    vals = np.where(rng.random((N, L)) < 0.1, 0.0,
                    rng.normal(1.0, 0.5, (N, L))).astype(np.float32)
    y = (rng.integers(0, 2, N) if task == "classification"
         else rng.normal(3.0, 1.0, N)).astype(np.float32)
    fids = np.broadcast_to(np.arange(L, dtype=np.int32), (N, L)).copy()
    params = (np.float32(0.2), rng.normal(0, 0.1, F).astype(np.float32),
              rng.normal(0, 0.1, (F, vk)).astype(np.float32))
    return ids, vals, y, fids, params


def _to_port(jstate):
    a = np.asarray
    p = jstate.params
    return psgd.state_from_numpy(
        a(p.w0), a(p.w), a(p.v), *(a(getattr(jstate, n)) for n in NAMES),
        a(jstate.step), device="cpu")


def _states(params, opt, path):
    w0, w, v = params
    jstate = jsgd.init_state(JFMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                                       v=jnp.asarray(v)), optimizer=opt)
    if path == "dedup":
        jstate = jsgd.pad_state_for_dedup(jstate)
    return jstate, _to_port(jstate)


def _assert_state_close(pstate, jstate, rtol=1e-4, atol=1e-6):
    for name in ("w0", "w", "v"):
        got, want = (getattr(pstate.params, name).numpy(),
                     np.asarray(getattr(jstate.params, name)))
        if got.ndim:
            got, want = got[:F], want[:F]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)
    for name in NAMES:
        got, want = (getattr(pstate, name).numpy(),
                     np.asarray(getattr(jstate, name)))
        assert got.shape == want.shape, name
        if got.ndim:
            got, want = got[:F], want[:F]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)
    assert int(pstate.step) == int(jstate.step)


CASES = [  # (path, task, optimizer, momentum, host plans, FMConfig extras)
    ("direct", "regression", "adagrad", 0.0, False, None),
    ("direct", "classification", "sgd", 0.0, False, None),
    ("direct", "regression", "sgd", 0.9, False, None),
    ("direct", "classification", "adam", 0.0, False, None),
    ("direct", "regression", "adam", 0.0, False, dict(num_fields=FIELDS)),
    ("direct", "classification", "adagrad", 0.0, False, GROUPS),
    ("dedup", "regression", "adagrad", 0.0, True, None),
    ("dedup", "classification", "sgd", 0.0, True, None),
    ("dedup", "regression", "sgd", 0.9, True, None),
    ("dedup", "classification", "adam", 0.0, True, None),
    ("dedup", "regression", "adam", 0.0, False, None),
    ("dedup", "classification", "sgd", 0.9, False, None),
    ("dedup", "classification", "adagrad", 0.0, True,
     dict(num_fields=FIELDS, slot_major_fields=True)),
    ("dedup", "regression", "adagrad", 0.0, False,
     dict(use_bias=False, use_linear=False)),
]


@pytest.mark.parametrize("path,task,opt,momentum,host,fm_kw", CASES)
def test_step_matches_jax(path, task, opt, momentum, host, fm_kw):
    """8 steps of the port's step and of the JAX package's, batch by batch
    (every 5th a masked tail): losses, scores, tables, every slot and the
    step; dedup also the plan's unique count and overflow."""
    fm_kw = fm_kw or {}
    vk = K * max(1, fm_kw.get("num_fields", 0))
    ids, vals, y, fids, params = _data(task, vk=vk)
    kw = dict(num_features=F, num_factors=K, reg0=0.01, reg_w=0.02,
              reg_v=0.03, seed=7, **fm_kw)
    # adam and momentum at a rate that keeps the loss from growing: a
    # diverging run amplifies the float32 rounding of the sums. The direct
    # step's adam adds one step lr * m / (sqrt(v) + eps) per SLOT, about
    # lr * g / (|g| + eps) at first, and a tiny g's last-bit rounding moves
    # that term by up to lr: a hot row's sum of them is held at a smaller
    # rate
    lr = {"adam": 0.001 if path == "direct" else 0.01}.get(
        opt, 0.01 if momentum else 0.1)
    skw = dict(batch_size=B, learning_rate=lr,
               optimizer=opt, momentum=momentum, update_path=path,
               host_plan=host, unique_budget=0 if host else BUDGET)
    jstate, pstate = _states(params, opt, path)
    jstep = jsgd.make_train_step(JFMConfig(task=JTask(task), **kw),
                                 JSGDConfig(**skw))
    pstep = psgd.make_train_step(FMConfig(task=Task(task), **kw),
                                 SGDConfig(**skw))
    plan_kw = (dict(dedup_budget=BUDGET, dedup_fill=F)
               if host and path == "dedup" else {})
    jds = jbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F,
                                  field_ids=fids)
    pds = pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F,
                                  field_ids=fids)
    for jb, pb in zip(jbatching.batch_iterator(jds, B, **plan_kw),
                      pbatching.batch_iterator(pds, B, device="cpu",
                                               **plan_kw)):
        jstate, jaux = jstep(jstate, jb)
        pstate, paux = pstep(pstate, pb)
        np.testing.assert_allclose(float(paux["loss"]), float(jaux["loss"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(paux["scores"].numpy(),
                                   np.asarray(jaux["scores"]), rtol=1e-4,
                                   atol=1e-5)
        assert paux.keys() == jaux.keys()
        if path == "dedup":
            assert int(paux["unique_count"]) == int(jaux["unique_count"])
            assert bool(paux["unique_overflow"]) == bool(
                jaux["unique_overflow"])
    assert int(pstate.step) == 9                    # 520 / 64 -> 9 batches
    _assert_state_close(pstate, jstate)


@pytest.mark.parametrize("opt,momentum", [("adam", 0.0), ("sgd", 0.9)])
def test_direct_duplicate_ids_keep_the_last_slot(opt, momentum):
    """The direct step SETS the slots of repeated ids: the last slot in
    row-major order wins, as the JAX package's ``.at[].set`` does on its
    CPU backend, while every slot's table term is added. Checked on a
    batch whose ids repeat inside and across examples, against JAX and
    against the rule written out for one id."""
    ids = np.array([[1, 2, 1], [1, 3, 2]], np.int32)
    vals = np.array([[1.0, 0.5, 2.0], [-1.0, 1.0, 3.0]], np.float32)
    y = np.array([1.0, -2.0], np.float32)
    rng = np.random.default_rng(1)
    params = (np.float32(0.0), rng.normal(0, 0.5, 8).astype(np.float32),
              rng.normal(0, 0.5, (8, 2)).astype(np.float32))
    kw = dict(num_features=8, num_factors=2, reg_v=0.0, use_bias=False)
    skw = dict(batch_size=2, learning_rate=0.1, optimizer=opt,
               momentum=momentum, update_path="direct")
    jstate, pstate = _states(params, opt, "direct")
    jstate.slot_v = jnp.full_like(jstate.slot_v, 0.3)
    pstate.slot_v.fill_(0.3)
    jb = jbatching.SparseBatch(ids=jnp.asarray(ids), vals=jnp.asarray(vals),
                               y=jnp.asarray(y))
    pb = pbatching.SparseBatch(ids=torch.from_numpy(ids),
                               vals=torch.from_numpy(vals),
                               y=torch.from_numpy(y))
    jstate, _ = jsgd.make_train_step(JFMConfig(**kw), JSGDConfig(**skw))(
        jstate, jb)
    before_v = pstate.params.v.clone()
    pstep = psgd.make_train_step(FMConfig(**kw), SGDConfig(**skw))
    # the per-slot gradients of w for id 1 (slots 0, 2, 3 in row-major
    # order): the slot vector must come from slot 3, the last
    w_rows = torch.from_numpy(params[1][ids]).requires_grad_()
    s = (w_rows * pb.vals).sum(1) + 0.5 * (
        (before_v[ids.astype(np.int64)] * pb.vals[..., None]).sum(1).square()
        .sum(-1) - (before_v[ids.astype(np.int64)] * pb.vals[..., None])
        .square().sum((1, 2)))
    g = torch.autograd.grad(((s - pb.y) ** 2).mean(), w_rows)[0]
    pstate, _ = pstep(pstate, pb)
    g_last = float(g[1, 0])
    if opt == "adam":
        want_slot = 0.1 * g_last                      # (1 - b1) g, m0 = 0
    else:
        want_slot = 0.9 * 0.0 + g_last                # slot_w starts at 0
    np.testing.assert_allclose(float(pstate.slot_w[1]), want_slot,
                               rtol=1e-5)
    _assert_state_close(pstate, jstate, rtol=1e-5)


def test_direct_step_touches_only_batch_rows():
    """The direct table has no fill row: the plan's unused slots point at
    row F-1 and write back what they read, so under adam (which changes a
    row even at zero gradient) rows no slot touches stay bit for bit,
    the last row among them."""
    ids, vals, y, _, params = _data("regression", seed=2)
    ids = np.minimum(ids, F - 2)                  # row F-1 never in a batch
    _, pstate = _states(params, "adam", "direct")
    before = {n: getattr(pstate.params, n).clone() for n in ("w", "v")}
    step = psgd.make_train_step(
        FMConfig(num_features=F, num_factors=K),
        SGDConfig(batch_size=B, optimizer="adam", update_path="direct"))
    pds = pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    touched = np.zeros(F, bool)
    for b in pbatching.batch_iterator(pds, B, device="cpu"):
        pstate, aux = step(pstate, b)
        touched[b.ids.numpy().reshape(-1)] = True
    assert "unique_count" not in aux
    for n, t in before.items():
        now = getattr(pstate.params, n)
        assert torch.equal(now[~torch.from_numpy(touched)],
                           t[~torch.from_numpy(touched)]), n
        assert not torch.equal(now, t)
    assert not touched[F - 1]


@pytest.mark.parametrize("opt,lean", [("adagrad", True), ("sgd", True),
                                      ("adam", False), (None, False)])
def test_init_state_lean_slot2_matches_jax(opt, lean):
    """Non-adam optimizers get 0-d slot2 placeholders; adam and None full
    ones, as the JAX package's init_state; the dedup pad keeps 0-d
    placeholders 0-d; a step leaves them untouched."""
    _, _, _, _, params = _data("regression")
    jstate, pstate = _states(params, opt, "dedup")
    for name in NAMES:
        assert tuple(getattr(pstate, name).shape) == tuple(
            np.shape(getattr(jstate, name))), name
    assert (pstate.slot2_v.dim() == 0) == lean
    assert pstate.step.dtype == torch.int32
    if lean:
        step = psgd.make_train_step(
            FMConfig(num_features=F, num_factors=K),
            SGDConfig(batch_size=B, optimizer=opt, update_path="dedup"))
        ids, vals, y, _, _ = _data("regression")
        pds = pbatching.SparseDataset(ids=ids, vals=vals, y=y,
                                      num_features=F)
        pstate, _ = step(pstate, next(pbatching.batch_iterator(
            pds, B, device="cpu", dedup_budget="ladder", dedup_fill=F)))
        assert pstate.slot2_v.dim() == 0 and float(pstate.slot2_v) == 0


def test_pad_state_and_trim_params():
    _, _, _, _, (w0, w, v) = _data("regression")
    params = FMParams(*(torch.from_numpy(np.array(a)) for a in (w0, w, v)))
    state = psgd.init_state(params, optimizer="adam")
    padded = psgd.pad_state_for_dedup(state)
    assert padded.params.v.shape == (F + 1, K)
    assert padded.slot2_w.shape == (F + 1,)
    assert torch.equal(padded.params.v[:F], params.v)
    assert not padded.params.v[F].any()
    trimmed = psgd.trim_params(padded.params, F)
    assert trimmed.v.shape == (F, K) and trimmed.w.shape == (F,)
    assert psgd.trim_params(params, F) is params


def test_state_from_numpy_copies():
    _, _, _, _, params = _data("regression")
    jstate, pstate = _states(params, "adagrad", "direct")
    src = np.asarray(jstate.params.v)
    pstate.params.v.add_(1.0)
    assert np.array_equal(np.asarray(jstate.params.v), src)
    assert pstate.step.dtype == torch.int32 and pstate.slot2_v.dim() == 0


@pytest.mark.parametrize("width,host", [(K + 1, True), (33, False)])
def test_b6_accumulate_matches_jax_scatter_sums(width, host):
    """``accumulate_sq_to_unique_sorted`` (B6's plain version on the CPU)
    against the JAX dedup step's four scatter sums, ``Σg`` and ``Σg²`` of
    the per-slot gradients by the plan's ranks, on host and device
    plans."""
    rng = np.random.default_rng(3)
    ids = (rng.zipf(1.3, (B, L)) % F).astype(np.int32)
    g = rng.normal(size=(B, L, width)).astype(np.float32)
    plan = (E.plan_to_device(E.host_dedup(ids, BUDGET, F), "cpu") if host
            else E.dedup_ids(torch.from_numpy(ids), BUDGET, F))
    jplan = JE.dedup_ids(jnp.asarray(ids), BUDGET, fill=F)
    got = E.accumulate_sq_to_unique_sorted(torch.from_numpy(g), plan,
                                           BUDGET).numpy()
    want_g = np.asarray(JE.accumulate_to_unique(jnp.asarray(g), jplan,
                                                BUDGET))
    want_sq = np.asarray(JE.accumulate_to_unique(jnp.square(jnp.asarray(g)),
                                                 jplan, BUDGET))
    np.testing.assert_allclose(got[:, :width], want_g, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, width:], want_sq, rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="order/plan.seg"):
        E.accumulate_sq_to_unique_sorted(torch.from_numpy(g),
                                         plan._replace(order=None), BUDGET)


PATH_CASES = [  # (num_features, FMConfig extras, SGDConfig extras)
    (1000, {}, {}), (1 << 16, {}, {}), (1 << 16, {}, dict(host_plan=False)),
    (1 << 16, {}, dict(optimizer="adam")),
    (1 << 16, {}, dict(optimizer="sgd", momentum=0.9)),
    (1 << 16, {}, dict(optimizer="adagrad_row")),
    (1000, {}, dict(optimizer="adagrad_row")),
    (1 << 16, dict(compute_dtype="bfloat16"), {}),
    (1 << 16, dict(feature_groups=(0,) * (1 << 16)), {}),
    (1000, {}, dict(update_path="dedup")),
]


@pytest.mark.parametrize("f,fm_kw,sgd_kw", PATH_CASES)
def test_resolve_update_path_matches_jax(f, fm_kw, sgd_kw):
    kw = dict(num_features=f, num_factors=K, **fm_kw)
    want = jsgd.resolve_update_path(JFMConfig(**kw), JSGDConfig(**sgd_kw))
    assert psgd.resolve_update_path(FMConfig(**kw),
                                    SGDConfig(**sgd_kw)) == want


@pytest.mark.parametrize("sgd_kw,match", [
    (dict(update_path="fused"), "FusedState"),
    (dict(update_path="hybrid"), "FusedState"),
    (dict(update_path="direct", optimizer="adagrad_row"), "adagrad_row"),
    (dict(update_path="dedup", optimizer="rmsprop"), "rmsprop"),
])
def test_make_train_step_refuses_as_jax(sgd_kw, match):
    """The JAX package's ValueErrors: the record paths' state, and
    optimizers the direct and dedup steps lack (JAX raises at the first
    call, when it traces the step; the port already when building it)."""
    ids = np.zeros((2, L), np.int32)
    vals = np.ones((2, L), np.float32)
    y = np.zeros(2, np.float32)
    _, _, _, _, params = _data("regression")
    jstate, pstate = _states(params, None, sgd_kw["update_path"])
    with pytest.raises(ValueError, match=match):
        jsgd.make_train_step(JFMConfig(num_features=F, num_factors=K),
                             JSGDConfig(**sgd_kw))(
            jstate, jbatching.SparseBatch(ids=jnp.asarray(ids),
                                          vals=jnp.asarray(vals),
                                          y=jnp.asarray(y)))
    with pytest.raises(ValueError, match=match):
        psgd.make_train_step(FMConfig(num_features=F, num_factors=K),
                             SGDConfig(**sgd_kw))


def test_dedup_step_needs_sorted_plans():
    _, _, _, _, params = _data("regression")
    _, pstate = _states(params, "adagrad", "dedup")
    ids, vals, y, _, _ = _data("regression")
    pds = pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    b = next(pbatching.batch_iterator(pds, B, device="cpu",
                                      dedup_budget=BUDGET, dedup_fill=F))
    step = psgd.make_train_step(FMConfig(num_features=F, num_factors=K),
                                SGDConfig(update_path="dedup"))
    with pytest.raises(ValueError, match="order/plan.seg"):
        step(pstate, dataclasses.replace(b, plan=b.plan._replace(seg=None)))
