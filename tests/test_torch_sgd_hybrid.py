"""The port's hybrid train step against the JAX package's
(``make_hybrid_train_step(..., segsum_force="xla")``, the exact-f32
branch), both started from the same fused table.

Tolerance: rtol 1e-5, atol 1e-6 after one step; rtol 1e-4, atol 1e-6 after
20 steps, the tolerance the JAX package holds its own hybrid step to
against the fused step (float32 sums in another order, compounded by the
adagrad accumulators)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.config import FMConfig as JFMConfig
from sparkfm_tpu.config import SGDConfig as JSGDConfig
from sparkfm_tpu.config import Task as JTask
from sparkfm_tpu.data import batching as jbatching
from sparkfm_tpu.models.fm import FMParams as JFMParams
from sparkfm_tpu.solvers import sgd_fused as jfused
from sparkfm_tpu.solvers import sgd_hybrid as jhybrid
from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.data import batching as pbatching
from sparkfm_tpu_torch.ops import rowio
from sparkfm_tpu_torch.solvers import sgd_fused, sgd_hybrid

torch.set_num_threads(1)
F, K, L, B, N = 500, 4, 6, 128, 700
BUDGET = 512
STEPS = 20


def _data(task: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.5, (N, L)) % F).astype(np.int32)
    vals = np.where(rng.random((N, L)) < 0.1, 0.0,
                    rng.normal(1.0, 0.5, (N, L))).astype(np.float32)
    y = (rng.integers(0, 2, N) if task == "classification"
         else rng.normal(3.0, 1.0, N)).astype(np.float32)
    params = (np.float32(0.2), rng.normal(0, 0.1, F).astype(np.float32),
              rng.normal(0, 0.1, (F, K)).astype(np.float32))
    return ids, vals, y, params


def _configs(task: str, opt: str, **fm_kw):
    kw = dict(num_features=F, num_factors=K, reg0=0.01, reg_w=0.02,
              reg_v=0.03, seed=7, **fm_kw)
    skw = dict(batch_size=B, learning_rate=0.1, optimizer=opt,
               unique_budget=BUDGET)
    return (JFMConfig(task=JTask(task), **kw), JSGDConfig(**skw),
            FMConfig(task=Task(task), **kw), SGDConfig(**skw))


def _batches(pkg, ds, **kw):
    """STEPS batches over shuffled epochs (every 6th is a masked tail)."""
    out = []
    epoch = 0
    while len(out) < STEPS:
        it = (jbatching.batch_iterator(ds, B, **kw, epoch=epoch)
              if pkg == "jax" else
              pbatching.batch_iterator(ds, B, device="cpu", **kw,
                                       epoch=epoch))
        out.extend(it)
        epoch += 1
    return out[:STEPS]


def _states(jcfg, pcfg, params):
    w0, w, v = params
    jstate = jfused.fused_from_params(
        JFMParams(w0=jnp.asarray(w0), w=jnp.asarray(w), v=jnp.asarray(v)),
        jcfg)
    pstate = sgd_fused.fused_state_from_numpy(
        np.asarray(jstate.table), np.asarray(jstate.w0),
        np.asarray(jstate.slot_w0), np.asarray(jstate.step), pcfg,
        device="cpu")
    return jstate, pstate


def _assert_close(jstate, jaux, pstate, paux, rtol):
    np.testing.assert_allclose(float(paux["loss"]), float(jaux["loss"]),
                               rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(paux["scores"].numpy(),
                               np.asarray(jaux["scores"]),
                               rtol=rtol, atol=1e-6)
    used = 2 * K + 2
    np.testing.assert_allclose(pstate.table[:F, :used].numpy(),
                               np.asarray(jstate.table)[:F, :used],
                               rtol=rtol, atol=1e-6)
    for name in ("w0", "slot_w0"):
        np.testing.assert_allclose(getattr(pstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   rtol=rtol, atol=1e-6, err_msg=name)
    assert int(pstate.step) == int(jstate.step)
    assert int(paux["unique_count"]) == int(jaux["unique_count"])
    assert bool(paux["unique_overflow"]) == bool(jaux["unique_overflow"])


@pytest.mark.parametrize("task", ["regression", "classification"])
@pytest.mark.parametrize("opt", ["adagrad", "adagrad_row", "sgd"])
def test_hybrid_step_matches_jax(task, opt):
    ids, vals, y, params = _data(task)
    jcfg, jsgd, pcfg, psgd = _configs(task, opt)
    ds = jbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    pds = pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    kw = dict(shuffle=True, seed=7, dedup_budget=BUDGET, dedup_fill=F)
    jb, pb = _batches("jax", ds, **kw), _batches("torch", pds, **kw)
    assert not bool(pb[5].mask.all())                 # a masked tail
    jstep = jhybrid.make_hybrid_train_step(jcfg, jsgd, segsum_force="xla")
    pstep = sgd_hybrid.make_hybrid_train_step(pcfg, psgd)
    jstate, pstate = _states(jcfg, pcfg, params)
    table = pstate.table
    for i in range(STEPS):
        jstate, jaux = jstep(jstate, jb[i])
        pstate, paux = pstep(pstate, pb[i])
        assert pstate.table is table                  # updated in place
        if i == 0:
            _assert_close(jstate, jaux, pstate, paux, rtol=1e-5)
    _assert_close(jstate, jaux, pstate, paux, rtol=1e-4)


def test_only_the_batch_rows_change_and_fill_writes_agree(monkeypatch):
    """Rows outside the batch are left as they were; every write to the
    fill row (the plan's unused budget slots) carries the same zero
    record, so which one wins does not matter."""
    ids, vals, y, params = _data("classification", seed=1)
    _, _, pcfg, psgd = _configs("classification", "adagrad")
    pds = pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    batch = next(pbatching.batch_iterator(pds, B, device="cpu",
                                          dedup_budget=BUDGET,
                                          dedup_fill=F))
    _, pstate = _states(_configs("classification", "adagrad")[0], pcfg,
                        params)
    before = pstate.table.clone()
    writes = []
    orig = rowio.scatter_set_rows

    def spy(table, sids, rows):
        writes.append(rows[sids == F].clone())
        return orig(table, sids, rows)

    monkeypatch.setattr(rowio, "scatter_set_rows", spy)
    pstate, _ = sgd_hybrid.make_hybrid_train_step(pcfg, psgd)(pstate, batch)
    (fill,) = writes
    assert fill.shape[0] == BUDGET - int(batch.plan.count) > 1
    assert not fill.any()
    touched = np.zeros(F + 1, bool)
    touched[batch.plan.uids.numpy()] = True
    assert torch.equal(pstate.table[~torch.from_numpy(touched)],
                       before[~torch.from_numpy(touched)])
    assert not torch.equal(pstate.table[:F], before[:F])


@pytest.mark.parametrize("fm_kw,sgd_kw,exc", [
    (dict(num_fields=2), {}, ValueError),
    ({}, dict(optimizer="adam"), ValueError),
    ({}, dict(optimizer="sgd", momentum=0.9), ValueError),
    (dict(feature_groups=(0,) * F), {}, ValueError),
    (dict(compute_dtype="bfloat16"), {}, ValueError),
    ({}, dict(host_plan=False), ValueError),
])
def test_restrictions_raise(fm_kw, sgd_kw, exc):
    _, _, pcfg, psgd = _configs("regression", "adagrad", **fm_kw)
    with pytest.raises(exc):
        sgd_hybrid.make_hybrid_train_step(
            pcfg, dataclasses.replace(psgd, **sgd_kw))


def test_step_does_not_read_update_path():
    """As the JAX hybrid step: update_path is the trainer's to read, so a
    step built with another value trains exactly as one built with
    "hybrid"."""
    ids, vals, y, params = _data("regression", seed=3)
    jcfg, _, pcfg, psgd = _configs("regression", "adagrad")
    pds = pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    batch = next(pbatching.batch_iterator(pds, B, device="cpu",
                                          dedup_budget=BUDGET, dedup_fill=F))
    tables = []
    for path in ("hybrid", "direct"):
        _, pstate = _states(jcfg, pcfg, params)
        step = sgd_hybrid.make_hybrid_train_step(
            pcfg, dataclasses.replace(psgd, update_path=path))
        tables.append(step(pstate, batch)[0].table)
    assert torch.equal(*tables)


def test_step_does_not_read_steps_per_dispatch():
    """As the JAX hybrid step, which a lax.scan groups: a step built with
    steps_per_dispatch=2 trains exactly as one built with 1 (grouping is
    the trainer's and make_hybrid_multi_step's)."""
    ids, vals, y, params = _data("classification", seed=4)
    jcfg, _, pcfg, psgd = _configs("classification", "adagrad")
    pds = pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    batch = next(pbatching.batch_iterator(pds, B, device="cpu",
                                          dedup_budget=BUDGET, dedup_fill=F))
    tables = []
    for spd in (1, 2):
        _, pstate = _states(jcfg, pcfg, params)
        step = sgd_hybrid.make_hybrid_train_step(
            pcfg, dataclasses.replace(psgd, steps_per_dispatch=spd))
        tables.append(step(pstate, batch)[0].table)
    assert torch.equal(*tables)


def test_plan_without_sorted_payloads_raises():
    ids, vals, y, params = _data("regression")
    _, _, pcfg, psgd = _configs("regression", "adagrad")
    pds = pbatching.SparseDataset(ids=ids, vals=vals, y=y, num_features=F)
    step = sgd_hybrid.make_hybrid_train_step(pcfg, psgd)
    _, pstate = _states(_configs("regression", "adagrad")[0], pcfg, params)
    batch = next(pbatching.batch_iterator(pds, B, device="cpu",
                                          dedup_budget=BUDGET, dedup_fill=F))
    for plan in (None, batch.plan._replace(svals=None, sex=None)):
        with pytest.raises(ValueError, match="svals/sex"):
            step(pstate, dataclasses.replace(batch, plan=plan))


def test_record_width_pads_to_four_floats():
    assert sgd_fused.record_width(32) == 68
    assert sgd_fused.record_width(4) == 12
    assert sgd_fused.record_width(1) == 4
    assert sgd_fused.record_width(3, num_fields=2) == 16


def test_init_fused_state_distribution():
    """torch and jax.random draw different numbers from one seed, so init
    is held to its distribution: V ~ N(mean, stdev), everything else 0."""
    cfg = FMConfig(num_features=1 << 12, num_factors=8, init_mean=0.5,
                   init_stdev=0.02, seed=3)
    st = sgd_fused.init_fused_state(cfg, device="cpu")
    assert st.table.shape == (4097, 20) and st.table.dtype == torch.float32
    v = st.table[:4096, :8]
    assert abs(float(v.mean()) - 0.5) < 1e-3
    assert abs(float(v.std()) - 0.02) < 1e-3
    assert not st.table[:, 8:].any() and not st.table[4096].any()
    assert float(st.w0) == float(st.slot_w0) == int(st.step) == 0
    again = sgd_fused.init_fused_state(cfg, device="cpu")
    assert torch.equal(st.table, again.table)         # seeded by cfg.seed
    small = dataclasses.replace(cfg, num_features=10)
    gen = torch.Generator().manual_seed(1)
    assert not torch.equal(
        sgd_fused.init_fused_state(small, gen, device="cpu").table,
        sgd_fused.init_fused_state(small, device="cpu").table)


def test_chunked_init_matches_one_draw(monkeypatch):
    """Drawing V in chunks of rows gives the same table as one draw."""
    cfg = FMConfig(num_features=1000, num_factors=4, seed=2)
    whole = sgd_fused.init_fused_state(cfg, device="cpu").table
    monkeypatch.setattr(sgd_fused, "_INIT_CHUNK_BYTES", 4 * 4 * 64)
    assert torch.equal(sgd_fused.init_fused_state(cfg, device="cpu").table,
                       whole)


def test_params_round_trip_through_the_record():
    ids, vals, y, params = _data("regression")
    jcfg, _, pcfg, _ = _configs("regression", "sgd")
    jstate, pstate = _states(jcfg, pcfg, params)
    back = sgd_fused.params_from_fused(pstate, pcfg)
    np.testing.assert_array_equal(back.v.numpy(), params[2])
    np.testing.assert_array_equal(back.w.numpy(), params[1])
    assert float(back.w0) == float(params[0])
    again = sgd_fused.fused_from_params(back, pcfg, device="cpu")
    assert torch.equal(again.table, pstate.table)
    assert back.v.is_contiguous() and back.w.is_contiguous()


def test_fused_state_from_numpy_checks_shape():
    _, _, pcfg, _ = _configs("regression", "sgd")
    with pytest.raises(ValueError, match="record table"):
        sgd_fused.fused_state_from_numpy(np.zeros((F, 128), np.float32),
                                         0.0, 0.0, 0, pcfg, device="cpu")
