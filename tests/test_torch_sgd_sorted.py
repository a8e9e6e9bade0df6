"""The port's sorted path against the JAX package's: ``sorted_plan``, and
``make_sorted_train_step`` against JAX ``make_sorted_train_step(
kernel_mode="xla")`` on the four parity cases of
``tests/test_sgd_sorted.py`` (both started from one fused table, carried
across by ``fused_state_from_numpy``), and the loss-decrease case.

Tolerance: the plans' ``uids``/``seg``/``count`` exactly, and
``svals``/``sex`` exactly once each run is ordered by example (the JAX
sort need not keep equal ids in slot order); steps at rtol 1e-4 on losses
and scores and rtol 2e-4, atol 2e-5 on tables ``[:F, :2k+2]`` after the
last step, the JAX test's own tolerance for this path."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.config import FMConfig as JFMConfig
from sparkfm_tpu.config import SGDConfig as JSGDConfig
from sparkfm_tpu.config import Task as JTask
from sparkfm_tpu.data.batching import SparseBatch as JBatch
from sparkfm_tpu.ops import embedding as JE
from sparkfm_tpu.solvers import sgd_fused as jfused
from sparkfm_tpu.solvers import sgd_sorted as jsorted
from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.data.batching import SparseBatch
from sparkfm_tpu_torch.ops import embedding as PE
from sparkfm_tpu_torch.ops import segsum
from sparkfm_tpu_torch.solvers import sgd_fused, sgd_sorted

torch.set_num_threads(1)


def _canonical(plan):
    """svals/sex with each run ordered by (example, value)."""
    seg, sex, sv = (np.asarray(a) for a in (plan.seg, plan.sex, plan.svals))
    order = np.lexsort((sv, sex, seg))
    return sex[order], sv[order]


@pytest.mark.parametrize("budget", [64, 12])
def test_sorted_plan_matches_jax(budget):
    rng = np.random.default_rng(budget)
    ids = (rng.zipf(1.4, (16, 5)) % 30).astype(np.int32)
    vals = rng.normal(size=(16, 5)).astype(np.float32)
    want = JE.sorted_plan(jnp.asarray(ids), jnp.asarray(vals), budget,
                          fill=30)
    got = PE.sorted_plan(torch.from_numpy(ids), torch.from_numpy(vals),
                         budget, fill=30)
    for name in ("uids", "seg", "count", "overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for a, b in zip(_canonical(got), _canonical(want)):
        np.testing.assert_array_equal(a, b)
    assert got.sex.dtype == got.seg.dtype == got.uids.dtype == torch.int32
    assert bool(got.overflow) == (budget == 12)


def _batches(rng, b, l, f, steps, dup_heavy=False, with_mask=False):
    """tests/test_sgd_sorted.py's batches, for both packages."""
    out = []
    for _ in range(steps):
        hi = max(2, f // 8) if dup_heavy else f
        ids = rng.integers(0, hi, (b, l)).astype(np.int32)
        vals = rng.normal(size=(b, l)).astype(np.float32)
        pad = rng.random((b, l)) < 0.2
        ids[pad] = 0
        vals[pad] = 0.0
        y = rng.normal(size=(b,)).astype(np.float32)
        mask = (np.ones((b,), bool) if not with_mask
                else rng.random(b) < 0.8)
        out.append((ids, vals, y, mask))
    return out


def _jax_batch(ids, vals, y, mask):
    return JBatch(ids=jnp.asarray(ids), vals=jnp.asarray(vals),
                  y=jnp.asarray(y), mask=jnp.asarray(mask))


def _torch_batch(ids, vals, y, mask):
    t = torch.from_numpy
    return SparseBatch(ids=t(ids), vals=t(vals), y=t(y), mask=t(mask))


def _run_parity(fm_kw, sgd_kw, batches, task="regression"):
    jcfg = JFMConfig(task=JTask(task), **fm_kw)
    pcfg = FMConfig(task=Task(task), **fm_kw)
    jstate = jfused.init_fused_state(jcfg, jax.random.PRNGKey(0))
    pstate = sgd_fused.fused_state_from_numpy(
        np.asarray(jstate.table), np.asarray(jstate.w0),
        np.asarray(jstate.slot_w0), np.asarray(jstate.step), pcfg,
        device="cpu")
    jstep = jsorted.make_sorted_train_step(jcfg, JSGDConfig(**sgd_kw),
                                           kernel_mode="xla")
    pstep = sgd_sorted.make_sorted_train_step(pcfg, SGDConfig(**sgd_kw),
                                              kernel_mode="xla")
    before = segsum.ROWSUM_SQ.launches
    calls = []
    b6 = segsum.segment_rowsum_sq

    def counted(g, seg, u):
        calls.append(tuple(g.shape))
        return b6(g, seg, u)
    # each step sums [g_v | g_w] (N, k+1) by B6, which forms the squares;
    # B5 is not called (None would raise)
    with mock.patch.object(segsum, "segment_rowsum_sq", counted), \
            mock.patch.object(segsum, "segment_rowsum", None):
        for arrays in batches:
            jstate, jaux = jstep(jstate, _jax_batch(*arrays))
            pstate, paux = pstep(pstate, _torch_batch(*arrays))
            np.testing.assert_allclose(float(paux["loss"]),
                                       float(jaux["loss"]), rtol=1e-4)
            np.testing.assert_allclose(paux["scores"].numpy(),
                                       np.asarray(jaux["scores"]), rtol=1e-4,
                                       atol=1e-5)
            assert int(paux["unique_count"]) == int(jaux["unique_count"])
    assert calls == [(a[0].size, pcfg.num_factors + 1) for a in batches]
    assert segsum.ROWSUM_SQ.launches == before        # CPU: plain version
    f, used = pcfg.num_features, 2 * pcfg.num_factors + 2
    np.testing.assert_allclose(pstate.table[:f, :used].numpy(),
                               np.asarray(jstate.table)[:f, :used],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(pstate.w0), float(jstate.w0), rtol=1e-5)
    assert int(pstate.step) == int(jstate.step)


def test_parity_regression_adagrad():
    rng = np.random.default_rng(0)
    _run_parity(dict(num_features=64, num_factors=4, reg_w=0.01, reg_v=0.02,
                     reg0=0.1, seed=3),
                dict(batch_size=16, learning_rate=0.1, optimizer="adagrad",
                     unique_budget=128),
                _batches(rng, 16, 5, 64, 4))


def test_parity_classification_plain_sgd_dup_heavy():
    rng = np.random.default_rng(1)
    bs = [(i, v, (y > 0).astype(np.float32), m)
          for i, v, y, m in _batches(rng, 8, 6, 32, 4, dup_heavy=True)]
    _run_parity(dict(num_features=32, num_factors=3, reg_v=0.01, seed=7),
                dict(batch_size=8, learning_rate=0.05, optimizer="sgd",
                     unique_budget=64), bs, task="classification")


def test_parity_with_example_mask():
    rng = np.random.default_rng(2)
    _run_parity(dict(num_features=48, num_factors=4, reg_w=0.005,
                     reg_v=0.01, seed=11),
                dict(batch_size=16, learning_rate=0.1, optimizer="adagrad",
                     unique_budget=128),
                _batches(rng, 16, 4, 48, 3, with_mask=True))


def test_parity_no_linear_no_bias():
    rng = np.random.default_rng(3)
    _run_parity(dict(num_features=32, num_factors=2, use_linear=False,
                     use_bias=False, seed=5),
                dict(batch_size=8, learning_rate=0.2, optimizer="adagrad",
                     unique_budget=64),
                _batches(rng, 8, 4, 32, 3))


def test_parity_with_steps_per_dispatch():
    """steps_per_dispatch groups hybrid steps only, in both packages: a
    sorted step built with 2 trains as the JAX sorted step built with 2,
    at the parity tolerance."""
    rng = np.random.default_rng(5)
    _run_parity(dict(num_features=64, num_factors=4, reg_w=0.01, reg_v=0.02,
                     reg0=0.1, seed=3),
                dict(batch_size=16, learning_rate=0.1, optimizer="adagrad",
                     unique_budget=128, steps_per_dispatch=2),
                _batches(rng, 16, 5, 64, 4))


def test_steps_per_dispatch_changes_nothing():
    """A sorted step built with steps_per_dispatch=2 is the step built
    with 1, bit for bit, over several steps."""
    rng = np.random.default_rng(6)
    cfg = FMConfig(num_features=64, num_factors=4, reg_v=0.02, seed=3)
    states, steps = [], []
    for spd in (1, 2):
        states.append(sgd_fused.init_fused_state(
            cfg, torch.Generator().manual_seed(1), device="cpu"))
        steps.append(sgd_sorted.make_sorted_train_step(cfg, SGDConfig(
            batch_size=16, learning_rate=0.1, unique_budget=128,
            steps_per_dispatch=spd)))
    for arrays in _batches(rng, 16, 5, 64, 4):
        for i in range(2):
            states[i], _ = steps[i](states[i], _torch_batch(*arrays))
    assert torch.equal(states[0].table, states[1].table)
    assert torch.equal(states[0].w0, states[1].w0)


def test_example_sums_need_no_atomics():
    """The slot terms reach the (B, k+2) example space through the plan's
    permutation (every natural slot written once) and a sum over each
    example's L slots: the sorted plan's order is the stable id sort, and
    sex = order // L."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 20, (6, 4)).astype(np.int32)
    vals = rng.normal(size=(6, 4)).astype(np.float32)
    plan = PE.sorted_plan(torch.from_numpy(ids), torch.from_numpy(vals), 32,
                          fill=20)
    order = plan.order.long()
    assert plan.order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(24))
    np.testing.assert_array_equal(ids.reshape(-1)[order.numpy()],
                                  np.sort(ids.reshape(-1), kind="stable"))
    assert torch.equal(plan.sex.long(), order // 4)
    np.testing.assert_array_equal(plan.svals.numpy(),
                                  vals.reshape(-1)[order.numpy()])


def test_loss_decreases_end_to_end():
    """The sorted path alone on a learnable problem: the loss must drop
    below a fifth of its first value in 60 steps."""
    rng = np.random.default_rng(4)
    f, b, l = 256, 64, 6
    cfg = FMConfig(num_features=f, num_factors=8, seed=0)
    true_w = rng.normal(size=f).astype(np.float32)
    state = sgd_fused.init_fused_state(cfg, torch.Generator().manual_seed(2),
                                       device="cpu")
    step = sgd_sorted.make_sorted_train_step(
        cfg, SGDConfig(batch_size=b, learning_rate=0.2, optimizer="adagrad",
                       unique_budget=512))
    losses = []
    for _ in range(60):
        ids = rng.integers(0, f, (b, l)).astype(np.int32)
        y = true_w[ids].sum(axis=1).astype(np.float32)
        state, aux = step(state, _torch_batch(
            ids, np.ones((b, l), np.float32), y, np.ones((b,), bool)))
        losses.append(float(aux["loss"]))
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])


@pytest.mark.parametrize("fm_kw,sgd_kw,exc", [
    (dict(num_fields=2), {}, ValueError),
    ({}, dict(optimizer="adagrad_row"), ValueError),
    ({}, dict(optimizer="sgd", momentum=0.9), ValueError),
])
def test_restrictions_raise(fm_kw, sgd_kw, exc):
    with pytest.raises(exc):
        sgd_sorted.make_sorted_train_step(
            FMConfig(num_features=64, **fm_kw), SGDConfig(**sgd_kw))


def test_step_does_not_read_update_path():
    """As the JAX sorted step: update_path is the trainer's to read, so a
    step built with "dedup" trains exactly as one built with "sorted"."""
    rng = np.random.default_rng(4)
    cfg = FMConfig(num_features=64, num_factors=3)
    ids = rng.integers(0, 64, (16, 5)).astype(np.int32)
    batch = SparseBatch(ids=torch.from_numpy(ids), vals=torch.ones((16, 5)),
                        y=torch.from_numpy(rng.normal(size=16).astype(
                            np.float32)))
    tables = []
    for path in ("sorted", "dedup"):
        state = sgd_fused.init_fused_state(cfg, device="cpu")
        step = sgd_sorted.make_sorted_train_step(
            cfg, SGDConfig(batch_size=16, update_path=path))
        tables.append(step(state, batch)[0].table)
    assert torch.equal(*tables)
