"""The port's sharded SGD (``sparkfm_tpu_torch/parallel/sharded_sgd.py``
and ``train_sgd(mesh=...)``) against the JAX package's, from the same
numpy data, initial state and host plans.

The port runs on 8 gloo ranks of this CPU (``multihost.spawn``, once for
the whole file, every case in that one world); the JAX side on the
conftest's 8-device virtual mesh in the test process. Each case is also
held against the port's one-device direct step on the same padded state.
Tolerances are the JAX tests' (``tests/test_sharding.py``): losses rtol
1e-5, tables rtol 1e-4 / atol 1e-6. The rank functions live here, so this
module imports jax only inside its tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sparkfm_tpu_torch.config import FMConfig, MeshConfig, SGDConfig, Task
from sparkfm_tpu_torch.data import synth
from sparkfm_tpu_torch.data.batching import batch_iterator
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.parallel import mesh as M
from sparkfm_tpu_torch.parallel import multihost as MH
from sparkfm_tpu_torch.parallel import sharded_sgd as S
from sparkfm_tpu_torch.solvers import sgd as sgd_solver

torch.set_num_threads(1)
LOSS_TOL = dict(rtol=1e-5)
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
SPAWN_TIMEOUT = 300

CASES = {
    **{f"mesh_{d}x{m}": dict(mesh=(d, m), data=("ml", 50, 70, 2000, 0),
                             cfg=dict(num_factors=4, reg_w=0.01, reg_v=0.05),
                             sgd=dict(batch_size=256, learning_rate=0.1,
                                      optimizer="adagrad"))
       for d, m in ((8, 1), (1, 8), (4, 2), (2, 4))},
    "tail_batch_mask": dict(mesh=(4, 2), data=("ml", 30, 30, 300, 1),
                            cfg=dict(num_factors=2),
                            sgd=dict(batch_size=256, learning_rate=0.05,
                                     optimizer="sgd"), steps=2),
    **{f"ffm_slot_major_{sm}": dict(
        mesh=(2, 4), data=("ctr", 1024, 4, 64, 2),
        cfg=dict(num_factors=3, num_fields=4, task=Task.CLASSIFICATION,
                 reg_v=0.01, slot_major_fields=sm),
        sgd=dict(batch_size=256, learning_rate=0.05, optimizer="adagrad"))
       for sm in (False, True)},
    **{f"exchange_{ex}" + (f"_{plan}" if plan == "stacked" else ""): dict(
        mesh=(4, 2), data=("ctr", 2048, 6, 512, 5),
        cfg=dict(num_factors=4, task=Task.CLASSIFICATION, reg_w=1e-4,
                 reg_v=1e-4),
        sgd=dict(batch_size=256, learning_rate=0.1, optimizer="adagrad",
                 unique_budget=512), exchange=ex, plan=plan, steps=4)
       for ex, plan in (("unique", None), ("dense", None),
                        ("global", "global"), ("unique", "stacked"))},
    **{f"hybrid_{d}x{m}_{p}": dict(
        mesh=(d, m), data=("ctr", 1024, 5, 512, 19),
        cfg=dict(num_factors=4, task=Task.CLASSIFICATION, reg_w=1e-4,
                 reg_v=1e-4),
        sgd=dict(batch_size=256, learning_rate=0.1, optimizer="adagrad",
                 unique_budget=512), exchange="global", plan=p)
       for d, m in ((4, 2), (2, 4)) for p in ("hybrid", "global")},
    "groups_padding": dict(mesh=(2, 4), data=("ml", 30, 40, 1200, 1),
                           cfg=dict(num_factors=4, groups=30,
                                    group_reg_w=(0.01, 0.2),
                                    group_reg_v=(0.05, 0.3)),
                           sgd=dict(batch_size=128, learning_rate=0.1,
                                    optimizer="adagrad")),
    # adam and momentum take the dense exchange; with a model axis the
    # JAX step moves each shard's row 0 by other shards' slots
    # (_shard_first_rows), which then feeds later steps: one step there
    **{f"{name}_dense_{d}x{m}": dict(
        mesh=(d, m), data=("ml", 40, 50, 1000, 9), cfg=dict(num_factors=3),
        sgd=dict(batch_size=256, learning_rate=0.01, **opt),
        steps=3 if m == 1 else 1)
       for name, opt in (("adam", dict(optimizer="adam")),
                         ("momentum", dict(optimizer="sgd", momentum=0.9)))
       for d, m in ((8, 1), (4, 2) if name == "adam" else (2, 4))},
}
TRAINER_CASES = {
    f"train_sgd_{ex}": dict(mesh=(4, 2), data=("ml", 50, 60, 1600, 23),
                            cfg=dict(num_factors=4, reg_v=0.01),
                            sgd=dict(batch_size=256, learning_rate=0.1,
                                     optimizer="adagrad", epochs=2,
                                     shuffle_each_epoch=False),
                            exchange=ex)
    for ex in ("auto", "unique")}


def _dataset(spec):
    kind, *a = spec["data"]
    if kind == "ml":
        users, items, n, seed = a
        return synth.synth_movielens(num_users=users, num_items=items,
                                     num_examples=n, seed=seed)
    n, fields, buckets, seed = a
    return synth.synth_ctr(num_examples=n, num_fields=fields,
                           num_buckets=buckets, seed=seed)


def _cfg_kwargs(spec, num_features):
    kw = dict(spec["cfg"], num_features=num_features, seed=0)
    if "groups" in kw:
        n0 = kw.pop("groups")
        kw["feature_groups"] = tuple([0] * n0 + [1] * (num_features - n0))
    return kw


def _init(spec, f_pad, kf):
    """The numpy initial state over the padded tables: small random w and
    V, zero optimizer slots."""
    rng = np.random.default_rng(f_pad)
    z = np.zeros
    return dict(w0=np.float32(0.05),
                w=rng.normal(0, 0.05, f_pad).astype(np.float32),
                v=rng.normal(0, 0.05, (f_pad, kf)).astype(np.float32),
                slot_w0=np.float32(0), slot_w=z(f_pad, np.float32),
                slot_v=z((f_pad, kf), np.float32), slot2_w0=np.float32(0),
                slot2_w=z(f_pad, np.float32),
                slot2_v=z((f_pad, kf), np.float32), step=np.int32(0))


def _batches(spec, ds, fill, d):
    """[(port CPU batch, numpy plan or None, plan mode)] for the case."""
    out = []
    budget = spec["sgd"].get("unique_budget", 512)
    for i, b in enumerate(batch_iterator(ds, spec["sgd"]["batch_size"],
                                         device="cpu")):
        if i == spec.get("steps", 3):
            break
        ids, vals = np.asarray(b.ids), np.asarray(b.vals)
        kind = spec.get("plan")
        plan = mode = None
        if kind == "stacked":
            plan, mode = E.stack_plans(ids, d, budget, fill), "stacked"
        elif kind == "global":
            plan = E.host_dedup(ids, budget, fill)._replace(order=None,
                                                            seg=None)
            mode = "global"
        elif kind == "hybrid":
            hp = E.host_dedup(ids, budget, fill, vals=vals)
            seg, sv, sex, gmap, _ = E.stack_hybrid_extras(hp.ranks, vals, d)
            plan = hp._replace(order=gmap, seg=seg, svals=sv, sex=sex)
            mode = "global_hybrid"
        out.append((b, plan, mode))
    return out


def _port_case(spec, mesh):
    ds = _dataset(spec)
    cfg = FMConfig(**_cfg_kwargs(spec, ds.num_features))
    pcfg = S.padded_config(cfg, M.size(mesh, M.MODEL_AXIS))
    init = _init(spec, pcfg.num_features, S._kf(cfg))
    state = S.sharded_state_from_numpy(*init.values(), mesh)
    step = S.make_sharded_train_step(pcfg, SGDConfig(**spec["sgd"]), mesh,
                                     spec.get("exchange", "auto"))
    losses = []
    for b, plan, mode in _batches(spec, ds, pcfg.num_features - 1,
                                  M.size(mesh, M.DATA_AXIS)):
        state, aux = step(state, MH.global_batch(mesh, b, cfg.num_fields > 0,
                                                 plan, mode))
        losses.append(float(aux["loss"]))
    out = S.collect_state(state, mesh)
    out["loss"] = losses
    return out


def _port_trainer_case(spec, mesh):
    """train_sgd(mesh=MeshConfig) with the sharded init replaced by the
    case's numpy state, so the JAX trainer can start from the same one."""
    ds = _dataset(spec)
    cfg = FMConfig(**_cfg_kwargs(spec, ds.num_features))
    real = S.init_sharded_state

    def from_numpy(cfg, mesh, generator=None, optimizer=None):
        pcfg = S.padded_config(cfg, M.size(mesh, M.MODEL_AXIS))
        init = _init(spec, pcfg.num_features, S._kf(cfg))
        return S.sharded_state_from_numpy(*init.values(), mesh), pcfg
    S.init_sharded_state = from_numpy
    try:
        from sparkfm_tpu_torch.training import trainer
        res = trainer.train_sgd(
            cfg, SGDConfig(**spec["sgd"]), ds, eval_ds=ds,
            mesh=MeshConfig(*spec["mesh"], exchange=spec["exchange"]),
            device="cpu")
    finally:
        S.init_sharded_state = real
    return dict(history=res.history, w0=res.params.w0.numpy(),
                w=res.params.w.numpy(), v=res.params.v.numpy())


def _port_world(mesh8):
    """Every case on this 8-rank world, each on its own mesh shape."""
    meshes = {}
    out = {}
    for name, spec in {**CASES, **TRAINER_CASES}.items():
        shape = spec["mesh"]
        if shape not in meshes:
            meshes[shape] = M.make_mesh(*shape, device="cpu")
        run = _port_trainer_case if name in TRAINER_CASES else _port_case
        out[name] = run(spec, meshes[shape])
    return out


@pytest.fixture(scope="module")
def port():
    outs = MH.spawn(_port_world, (8, 1), "cpu", timeout=SPAWN_TIMEOUT)
    for o in outs[1:]:
        for name in CASES:
            np.testing.assert_array_equal(o[name]["v"], outs[0][name]["v"])
    return outs[0]


# ---------------------------------------------------------------------------
# The JAX side and the port's one-device step

def _jax_case(spec, trainer_case=False):
    import jax
    import jax.numpy as jnp

    from sparkfm_tpu.config import FMConfig as JFMConfig
    from sparkfm_tpu.config import SGDConfig as JSGDConfig
    from sparkfm_tpu.config import Task as JTask
    from sparkfm_tpu.data.batching import SparseBatch as JBatch
    from sparkfm_tpu.models.fm import FMParams as JParams
    from sparkfm_tpu.ops.embedding import DedupBatch as JPlan
    from sparkfm_tpu.parallel import mesh as JM
    from sparkfm_tpu.parallel import sharded_sgd as JS
    from sparkfm_tpu.solvers.sgd import SGDState as JState

    ds = _dataset(spec)
    kw = _cfg_kwargs(spec, ds.num_features)
    kw["task"] = JTask(kw.get("task", Task.REGRESSION).value)
    jcfg = JFMConfig(**kw)
    mesh = JM.make_mesh(*spec["mesh"])
    _, pcfg = JS.init_sharded_state(jcfg, mesh, jax.random.PRNGKey(0))
    init = _init(spec, pcfg.num_features,
                 jcfg.num_factors * max(1, jcfg.num_fields))
    j = {k: jnp.asarray(v) for k, v in init.items()}
    state = JState(params=JParams(w0=j["w0"], w=j["w"], v=j["v"]),
                   slot_w0=j["slot_w0"], slot_w=j["slot_w"],
                   slot_v=j["slot_v"], slot2_w0=j["slot2_w0"],
                   slot2_w=j["slot2_w"], slot2_v=j["slot2_v"],
                   step=j["step"])
    state = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, JM.named(mesh, s)), state,
        JM.state_pspecs())
    if trainer_case:
        return state, pcfg, jcfg, mesh, ds
    step = JS.make_sharded_train_step(pcfg, JSGDConfig(**spec["sgd"]), mesh,
                                      exchange=spec.get("exchange", "auto"))
    losses = []
    for b, plan, _ in _batches(spec, ds, pcfg.num_features - 1,
                               spec["mesh"][0]):
        a = lambda x: None if x is None else jnp.asarray(np.asarray(x))
        jplan = None
        if plan is not None:
            jplan = JPlan(uids=a(plan.uids), ranks=a(plan.ranks),
                          count=a(plan.count), overflow=a(plan.overflow),
                          order=a(plan.order), seg=a(plan.seg),
                          svals=a(plan.svals), sex=a(plan.sex))
        jb = JBatch(ids=a(b.ids), vals=a(b.vals), y=a(b.y), mask=a(b.mask),
                    field_ids=a(b.field_ids) if jcfg.num_fields else None,
                    plan=jplan)
        state, aux = step(state, jb)
        losses.append(float(aux["loss"]))
    out = {k: np.asarray(getattr(state, k)) for k in ("slot_v", "slot_w")}
    out.update(w0=np.asarray(state.params.w0), w=np.asarray(state.params.w),
               v=np.asarray(state.params.v), loss=losses)
    return out


def _single_device(spec, f_pad):
    """The port's one-device direct step on the same padded state."""
    ds = _dataset(spec)
    cfg = FMConfig(**_cfg_kwargs(spec, ds.num_features))
    pcfg = S.padded_config(cfg, spec["mesh"][1])
    assert pcfg.num_features == f_pad
    init = _init(spec, f_pad, S._kf(cfg))
    state = sgd_solver.state_from_numpy(*init.values(), device="cpu")
    step = sgd_solver.make_train_step(
        pcfg, SGDConfig(**{**spec["sgd"], "update_path": "direct"}))
    losses = []
    for b, _, _ in _batches(spec, ds, f_pad - 1, 1):
        state, aux = step(state, b)
        losses.append(float(aux["loss"]))
    return dict(loss=losses, w0=state.params.w0.numpy(),
                w=state.params.w.numpy(), v=state.params.v.numpy())


def _assert_tables(got, want, f, names=("w", "v"), skip=()):
    """Losses, w0 and the tables' true rows, but the rows in ``skip``."""
    np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL)
    np.testing.assert_allclose(got["w0"], want["w0"], rtol=1e-5, atol=1e-7)
    rows = np.setdiff1d(np.arange(f), skip)
    for n in names:
        np.testing.assert_allclose(got[n][rows], want[n][rows], **TABLE_TOL)


def _per_slot_moments(spec):
    return spec["sgd"]["optimizer"] == "adam" or spec["sgd"].get("momentum")


def _shard_first_rows(spec, f_pad):
    """Each model shard's local row 0: where the JAX dense exchange sets
    adam/momentum moments from slots of other shards (masked there with
    zero gradients) and adds their step; the port does not."""
    m = spec["mesh"][1]
    return np.arange(m) * (f_pad // m) if _per_slot_moments(spec) and m > 1 \
        else ()


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_jax(port, name):
    spec = CASES[name]
    want = _jax_case(spec)
    got = port[name]
    f = _dataset(spec).num_features
    assert got["v"].shape == want["v"].shape       # the same padding
    names = ("w", "v", "slot_v") if spec["sgd"]["optimizer"] != "sgd" \
        or spec["sgd"].get("momentum") else ("w", "v")
    _assert_tables(got, want, f, names,
                   _shard_first_rows(spec, got["v"].shape[0]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_step_matches_single_device(port, name):
    """The mesh changes only where rows live: the direct step on one
    device gives the same update, adam and momentum included (whose
    dense JAX exchange differs on each model shard's row 0, see
    :func:`_shard_first_rows`)."""
    spec = CASES[name]
    got = port[name]
    want = _single_device(spec, got["v"].shape[0])
    _assert_tables(got, want, _dataset(spec).num_features)


def test_exchanges_agree(port):
    """unique (device plans), unique (stacked host plans), dense and
    global compute the same update (float order aside)."""
    ref = port["exchange_unique"]
    f = _dataset(CASES["exchange_unique"]).num_features
    for other in ("exchange_dense", "exchange_global",
                  "exchange_unique_stacked"):
        _assert_tables(port[other], ref, f, ("w", "v", "slot_v"))


def test_global_hybrid_matches_plain_global(port):
    """The per-shard analytic backward (B3's plain version on the CPU)
    against the autograd global exchange, at (4, 2) and (2, 4)."""
    for shape in ("4x2", "2x4"):
        h, g = port[f"hybrid_{shape}_hybrid"], port[f"hybrid_{shape}_global"]
        f = _dataset(CASES[f"hybrid_{shape}_hybrid"]).num_features
        _assert_tables(h, g, f, ("w", "v", "slot_v"))


def test_groups_pad_with_a_zero_l2_group():
    cfg = FMConfig(num_features=70, num_factors=2,
                   feature_groups=tuple([0] * 30 + [1] * 40),
                   group_reg_w=(0.01, 0.2), group_reg_v=(0.05, 0.3))
    pcfg = S.padded_config(cfg, 4)
    assert pcfg.num_features == 72
    rw, rv = pcfg.reg_vectors()
    np.testing.assert_array_equal(rw[70:], 0.0)
    np.testing.assert_array_equal(rv[70:], 0.0)
    np.testing.assert_allclose(rw[:30], 0.01)
    np.testing.assert_allclose(rv[30:70], 0.3)


def test_routing_and_refusals():
    """adam and momentum route to dense under "auto"; unique and global
    refuse them; the global step refuses a missing or stacked plan."""
    assert S.resolve_exchange(SGDConfig(optimizer="adam")) == "dense"
    assert S.resolve_exchange(SGDConfig(optimizer="sgd",
                                        momentum=0.9)) == "dense"
    assert S.resolve_exchange(SGDConfig()) == "unique"
    for ex in ("unique", "global"):
        with pytest.raises(ValueError, match="adagrad/plain sgd"):
            S.make_sharded_train_step(
                FMConfig(num_features=100, num_factors=2),
                SGDConfig(optimizer="sgd", momentum=0.9), None, exchange=ex)
    step = S.make_sharded_train_step(FMConfig(num_features=64,
                                              num_factors=2),
                                     SGDConfig(), None, exchange="global")
    b = next(batch_iterator(_dataset(CASES["tail_batch_mask"]), 64,
                            device="cpu"))
    with pytest.raises(ValueError, match="global"):
        step(None, b)
    stacked = E.DedupBatch(uids=torch.zeros((1, 8), dtype=torch.int32),
                           ranks=torch.zeros_like(b.ids), count=1,
                           overflow=False)
    with pytest.raises(ValueError, match="global"):
        step(None, dataclasses.replace(b, plan=stacked))


@pytest.mark.parametrize("name", sorted(TRAINER_CASES))
def test_train_sgd_mesh_matches_jax_trainer(port, name, monkeypatch):
    """train_sgd(mesh=MeshConfig(4, 2)) end to end against the JAX
    trainer's _train_sgd_sharded from the same state: "auto" takes the
    global exchange with hybrid extras (B3) in both, "unique" stacked
    host plans."""
    from sparkfm_tpu.config import MeshConfig as JMeshConfig
    from sparkfm_tpu.config import SGDConfig as JSGDConfig
    from sparkfm_tpu.data.batching import SparseDataset as JDataset
    from sparkfm_tpu.parallel import sharded_sgd as JS
    from sparkfm_tpu.training import trainer as jtrainer

    spec = TRAINER_CASES[name]
    state, pcfg, jcfg, _, pds = _jax_case(spec, trainer_case=True)
    ds = JDataset(ids=pds.ids, vals=pds.vals, y=pds.y,
                  num_features=pds.num_features, field_ids=pds.field_ids)
    monkeypatch.setattr(JS, "init_sharded_state",
                        lambda cfg, mesh, key=None: (state, pcfg))
    want = jtrainer.train_sgd(
        jcfg, JSGDConfig(**spec["sgd"]), ds, eval_ds=ds,
        mesh=JMeshConfig(*spec["mesh"], exchange=spec["exchange"]))
    got = port[name]
    assert [sorted(r) for r in got["history"]] == [sorted(r) for r in
                                                   want.history]
    for g, w in zip(got["history"], want.history):
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5)
    np.testing.assert_allclose(got["w0"], np.asarray(want.params.w0),
                               rtol=1e-5)
    for n in ("w", "v"):
        np.testing.assert_allclose(got[n], np.asarray(getattr(want.params,
                                                              n)),
                                   **TABLE_TOL)
