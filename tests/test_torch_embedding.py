"""The port's dedup plans against the JAX package's, element for element:
``host_dedup`` on its native and numpy paths, the on-device
``dedup_ids``, and the budget rules."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.ops import embedding as JE
from sparkfm_tpu_torch.data import native_io
from sparkfm_tpu_torch.ops import embedding as PE
from sparkfm_tpu_torch.utils.build import BUILD_DIR

torch.set_num_threads(1)

FIELDS = ("uids", "ranks", "count", "overflow", "order", "seg")

# (rows, slots, id range, budget): budget below the unique count overflows
CASES = [(16, 4, 50, 64), (32, 8, 1 << 16, 512), (64, 8, 1000, 40),
         (1, 1, 10, 1), (8, 3, 5, 4)]


def _ids_vals(rows, slots, id_range, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, id_range, (rows, slots)).astype(np.int32)
    vals = rng.normal(size=(rows, slots)).astype(np.float32)
    return ids, vals


def _assert_plans_equal(got, want, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("rows,slots,id_range,budget", CASES)
def test_host_dedup_matches_jax(monkeypatch, native, rows, slots, id_range,
                                budget):
    if not native:
        monkeypatch.setenv("SPARKFM_NO_NATIVE", "1")
    ids, vals = _ids_vals(rows, slots, id_range, seed=rows * slots)
    fill = id_range - 1
    got = PE.host_dedup(ids, budget, fill, vals=vals)
    monkeypatch.setenv("SPARKFM_NO_NATIVE", "1")     # JAX's numpy path
    want = JE.host_dedup(ids, budget, fill, vals=vals)
    _assert_plans_equal(got, want, FIELDS + ("svals", "sex"))
    assert bool(got.overflow) == (len(np.unique(ids)) > budget)


def test_native_is_built_from_source_not_the_tracked_binary():
    assert native_io.available()
    path = native_io._load()._name
    assert os.path.dirname(path) == BUILD_DIR
    assert os.path.basename(path).startswith("dedup_plan-")
    ids, _ = _ids_vals(32, 8, 300, seed=5)
    nat = native_io.dedup_plan_native(ids, 256, 299)
    assert nat is not None and nat[6] is None       # no vals, no svals


@pytest.mark.parametrize("rows,slots,id_range,budget", CASES)
def test_dedup_ids_matches_jax(rows, slots, id_range, budget):
    ids, _ = _ids_vals(rows, slots, id_range, seed=rows + slots)
    fill = id_range - 1
    got = PE.dedup_ids(torch.from_numpy(ids), budget, fill)
    want = JE.dedup_ids(jnp.asarray(ids), budget, fill)
    _assert_plans_equal(got, want)
    assert got.uids.dtype == got.ranks.dtype == torch.int32
    assert got.order.dtype == got.seg.dtype == torch.int32


def test_device_and_host_plans_agree():
    ids, _ = _ids_vals(64, 6, 700, seed=9)
    host = PE.host_dedup(ids, 512, 699)
    dev = PE.dedup_ids(torch.from_numpy(ids), 512, 699)
    _assert_plans_equal(dev, host)


def test_budgets_match_jax():
    for n in list(range(0, 3000)) + [40289, 1 << 18, (1 << 18) + 1, 639_000]:
        assert PE.auto_budget(n) == JE.auto_budget(n), n
        assert PE.ladder_budget(n) == JE.ladder_budget(n), n
        assert PE.ladder_budget(n, cap=4096) == JE.ladder_budget(n, cap=4096)
        assert PE.auto_budget(n, cap=1 << 10) == JE.auto_budget(n,
                                                                cap=1 << 10)


def test_plan_to_device_moves_slot_arrays_only():
    ids, vals = _ids_vals(8, 4, 100, seed=2)
    hp = PE.host_dedup(ids, 64, 99, vals=vals)
    plan = PE.plan_to_device(hp, "cpu")
    for f in ("uids", "ranks", "order", "seg", "svals", "sex"):
        assert isinstance(getattr(plan, f), torch.Tensor), f
        np.testing.assert_array_equal(getattr(plan, f).numpy(),
                                      getattr(hp, f))
    assert plan.count is hp.count and plan.overflow is hp.overflow
