"""The port's mesh, collectives, process launcher and stacked plans
(``sparkfm_tpu_torch/parallel/{mesh,multihost}.py``,
``ops/embedding.py::stack_plans`` / ``stack_hybrid_extras``).

The collectives run on a (2, 2) world of gloo ranks on this CPU, spawned
once (``multihost.spawn``); the plan stacks are held array for array
against the JAX package's. The rank functions live here, so this module
imports jax only inside its tests.
"""

import time

import numpy as np
import pytest
import torch

from sparkfm_tpu_torch.api import _parse_mesh
from sparkfm_tpu_torch.config import MeshConfig
from sparkfm_tpu_torch.data.batching import SparseBatch
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.parallel import mesh as M
from sparkfm_tpu_torch.parallel import multihost as MH

torch.set_num_threads(1)


def _world(mesh):
    """What each rank of a (2, 2) world sees of every collective."""
    rank = torch.distributed.get_rank()
    out = dict(rank=rank, data=M.axis_index(M.DATA_AXIS, mesh),
               model=M.axis_index(M.MODEL_AXIS, mesh),
               device=str(M.device_of(mesh)))
    x = torch.full((3,), float(rank))
    out["psum_model"] = M.psum(x.clone(), M.MODEL_AXIS, mesh).tolist()
    out["psum_data"] = M.psum(x.clone(), M.DATA_AXIS, mesh).tolist()
    out["psum_both"] = M.psum(x.clone(), (M.DATA_AXIS, M.MODEL_AXIS),
                              mesh).tolist()
    out["pmax_data"] = M.pmax(x.clone(), M.DATA_AXIS, mesh).tolist()
    y = torch.tensor([[rank, 10 * rank]], dtype=torch.int32)
    out["gather_tiled"] = M.all_gather(y, M.DATA_AXIS, mesh).tolist()
    out["gather_stacked"] = M.all_gather(y, M.MODEL_AXIS, mesh,
                                         tiled=False).shape
    out["any"] = M.any_rank(rank == 3, mesh)
    out["none"] = M.any_rank(False, mesh)
    table = torch.arange(12.0).view(6, 2)
    out["row_shard"] = M.row_shard(table, mesh).tolist()
    out["collect"] = MH.collect(M.row_shard(table, mesh), mesh).tolist()
    out["data_slice"] = M.data_slice(8, mesh)
    # a global batch's rows and the three plan layouts
    ids = np.arange(16, dtype=np.int32).reshape(8, 2) % 5
    batch = SparseBatch(ids=torch.as_tensor(ids), vals=torch.ones((8, 2)),
                        y=torch.arange(8.0),
                        mask=torch.ones((8,), dtype=torch.bool),
                        field_ids=torch.zeros((8, 2), dtype=torch.int32))
    gb = MH.global_batch(mesh, batch)
    out["batch_y"] = gb.y.tolist()
    out["batch_fields"] = gb.field_ids
    stacked = E.stack_plans(ids, 2, 8, 9)
    sp = MH.global_batch(mesh, batch, plan=stacked, plan_mode="stacked").plan
    out["stacked"] = (sp.uids.tolist(), sp.ranks.tolist(),
                      np.asarray(sp.count).tolist())
    hp = E.host_dedup(ids, 8, 9, vals=np.ones((8, 2), np.float32))
    seg, sv, sex, gmap, _ = E.stack_hybrid_extras(hp.ranks,
                                                  np.ones((8, 2)), 2)
    hb = MH.global_batch(mesh, batch, plan=hp._replace(
        order=gmap, seg=seg, svals=sv, sex=sex), plan_mode="global_hybrid")
    out["hybrid"] = (hb.plan.uids.tolist(), hb.plan.order.tolist(),
                     hb.plan.seg.tolist(), hb.plan.count)
    with pytest.raises(ValueError, match="world of 8"):
        M.make_mesh(4, 2, device="cpu")
    out["mesh_-1"] = tuple(M.make_mesh(-1, 2, device="cpu").mesh.shape)
    out["process_index"] = MH.process_index()
    return out


@pytest.fixture(scope="module")
def world():
    return MH.spawn(_world, (2, 2), "cpu", timeout=120)


def test_axis_indices_and_devices(world):
    assert [(w["rank"], w["data"], w["model"]) for w in world] == [
        (0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
    assert {w["device"] for w in world} == {"cpu"}
    assert [w["process_index"] for w in world] == [0, 1, 2, 3]
    assert {w["mesh_-1"] for w in world} == {(2, 2)}


def test_psum_pmax_over_axes(world):
    assert [w["psum_model"][0] for w in world] == [1, 1, 5, 5]
    assert [w["psum_data"][0] for w in world] == [2, 4, 2, 4]
    assert {w["psum_both"][0] for w in world} == {6}
    assert [w["pmax_data"][0] for w in world] == [2, 3, 2, 3]


def test_all_gather_and_any_rank(world):
    assert world[0]["gather_tiled"] == [[0, 0], [2, 20]]
    assert world[3]["gather_tiled"] == [[1, 10], [3, 30]]
    assert {tuple(w["gather_stacked"]) for w in world} == {(2, 1, 2)}
    assert all(w["any"] for w in world)
    assert not any(w["none"] for w in world)


def test_row_shard_data_slice_and_collect(world):
    assert world[0]["row_shard"] == [[0, 1], [2, 3], [4, 5]]
    assert world[1]["row_shard"] == [[6, 7], [8, 9], [10, 11]]
    assert all(w["collect"] == torch.arange(12.0).view(6, 2).tolist()
               for w in world)
    assert [w["data_slice"] for w in world] == [slice(0, 4), slice(0, 4),
                                                 slice(4, 8), slice(4, 8)]


def test_global_batch_layouts(world):
    """Each rank keeps its data coordinate's rows; stacked plans and the
    hybrid extras keep the rank's (1, ...) row, global uids whole."""
    assert world[1]["batch_y"] == [0, 1, 2, 3]
    assert world[2]["batch_y"] == [4, 5, 6, 7]
    assert all(w["batch_fields"] is None for w in world)
    ids = np.arange(16, dtype=np.int32).reshape(8, 2) % 5
    stacked = E.stack_plans(ids, 2, 8, 9)
    for w in world:
        d = w["data"]
        uids, ranks, count = w["stacked"]
        assert uids == stacked.uids[d:d + 1].tolist()
        assert ranks == stacked.ranks[4 * d:4 * d + 4].tolist()
        assert count == stacked.count[d:d + 1].tolist()
        h_uids, gmap, seg, h_count = w["hybrid"]
        assert len(h_uids) == 8 and len(gmap) == 1 and len(seg) == 1
        assert h_count == 5


def test_one_process_mesh_sizes_and_parsing():
    """Without a process group only 1 x 1 starts; anything larger raises
    naming the world it needs. "DxM" strings and MeshConfig parse as in
    the JAX facade."""
    with pytest.raises(ValueError, match="world of 8 processes"):
        M.make_mesh(4, 2, device="cpu")
    with pytest.raises(ValueError, match="world of 2 processes"):
        M.make_mesh(-1, 2, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        M.make_mesh(0, 1, device="cpu")
    assert not MH.initialize(device="cpu")
    assert M.pad_to_multiple(10, 4) == 12 and M.pad_to_multiple(12, 4) == 12
    assert _parse_mesh(None) is None
    assert _parse_mesh("4x2") == MeshConfig(data=4, model=2)
    assert _parse_mesh("2X4", "global") == MeshConfig(data=2, model=4,
                                                      exchange="global")
    assert _parse_mesh(MeshConfig(8, 1), "dense").exchange == "dense"
    with pytest.raises(ValueError, match="DxM"):
        _parse_mesh(8)


def _fails_on_rank_1(mesh):
    if torch.distributed.get_rank() == 1:
        raise KeyError("rank one")
    return "rank 0 done"


def _hangs(mesh):
    time.sleep(600)


def test_spawn_reraises_and_times_out():
    """A rank's exception reaches the caller as itself, with the rank's
    traceback as its cause; a hung world is killed at the timeout."""
    with pytest.raises(KeyError, match="rank one") as info:
        MH.spawn(_fails_on_rank_1, (2, 1), "cpu", timeout=120)
    assert "rank 1 of 2" in str(info.value.__cause__)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        MH.spawn(_hangs, (2, 1), "cpu", timeout=8)
    assert time.monotonic() - t0 < 30


def test_stacked_plans_equal_jax():
    from sparkfm_tpu.ops import embedding as JE
    rng = np.random.default_rng(0)
    ids = (rng.zipf(1.3, (64, 7)) % 300).astype(np.int32)
    vals = rng.normal(size=(64, 7)).astype(np.float32)
    for d, budget in ((1, 512), (4, 64), (8, 16)):
        got, want = E.stack_plans(ids, d, budget, 299), JE.stack_plans(
            ids, d, budget=budget, fill=299)
        for name in ("uids", "ranks", "count", "overflow"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
            assert (np.asarray(getattr(got, name)).dtype
                    == np.asarray(getattr(want, name)).dtype)
        assert got.order is None and got.seg is None
        hp = JE.host_dedup(ids, 512, 299, vals=vals)
        for cap in (0, 64):
            got = E.stack_hybrid_extras(hp.ranks, vals, d, u_cap=cap)
            want = JE.stack_hybrid_extras(hp.ranks, vals, d, u_cap=cap)
            assert got[4] == want[4]
            for a, b in zip(got[:4], want[:4]):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
