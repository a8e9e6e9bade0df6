"""The port's sharded DeepFM (``parallel/sharded_deepfm.py``,
``train_deepfm(mesh=...)``, ``FM(model="deepfm", mesh=...)``) against the
JAX package's sharded step and the port's own one-device dedup step, from
the same numpy state; the exchange routes, the refusals, and a sharded
checkpoint resumed bit for bit.

The port runs on 8 gloo ranks of this CPU, spawned once for the file; the
JAX side on the conftest's 8-device mesh. Tolerances are the JAX tests'
(``tests/test_deepfm_sharded.py``): losses rtol 1e-5, tables and tower
rtol 1e-4 / atol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sparkfm_tpu_torch.api import FM
from sparkfm_tpu_torch.config import FMConfig, MeshConfig, SGDConfig, Task
from sparkfm_tpu_torch.data import synth
from sparkfm_tpu_torch.data.batching import batch_iterator
from sparkfm_tpu_torch.models import deepfm as DF
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.parallel import mesh as M
from sparkfm_tpu_torch.parallel import multihost as MH
from sparkfm_tpu_torch.parallel import sharded_deepfm as SD

torch.set_num_threads(1)
LOSS_TOL = dict(rtol=1e-5)
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)

STEPS = {   # name: (mesh, optimizer, data, k, hidden, budget, global plan)
    **{f"step_{d}x{m}_{opt}": ((d, m), opt, (2048, 8, 512, 0), 4, (16, 8),
                               2048, False)
       for (d, m), opt in (((4, 2), "adagrad"), ((2, 4), "sgd"),
                           ((8, 1), "adagrad"), ((1, 8), "adagrad"))},
    **{f"plan_{kind}": ((4, 2), "adagrad", (1024, 5, 256, 27), 4, (16,), 256,
                        kind == "global") for kind in ("global", "device")},
}


def _data(n, fields, buckets, seed):
    return synth.synth_ctr(num_examples=n, num_fields=fields,
                           num_buckets=buckets, seed=seed)


def _cfgs(spec, num_features):
    _, opt, (_, fields, _, _), k, hidden, budget, _ = spec
    fm = dict(num_features=num_features, num_factors=k,
              task=Task.CLASSIFICATION, reg_w=0.01, reg_v=0.02,
              num_fields=fields, seed=0)
    sgd = dict(batch_size=256, learning_rate=0.1, optimizer=opt,
               update_path="dedup", unique_budget=budget)
    return fm, hidden, sgd


def _init(f_pad, k, fields, hidden):
    """The numpy state over the padded tables: small random tables, a He
    tower, zero slots."""
    rng = np.random.default_rng(f_pad + k)
    dims = (fields * k,) + tuple(hidden) + (1,)
    mlp_w = [(rng.normal(size=(a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
             for a, b in zip(dims[:-1], dims[1:])]
    mlp_b = [rng.normal(0, 0.01, b).astype(np.float32) for b in dims[1:]]
    return dict(w0=np.float32(0.05),
                w=rng.normal(0, 0.05, f_pad).astype(np.float32),
                v=rng.normal(0, 0.05, (f_pad, k)).astype(np.float32),
                slot_w0=np.float32(0), slot_w=np.zeros(f_pad, np.float32),
                slot_v=np.zeros((f_pad, k), np.float32), mlp_w=mlp_w,
                mlp_b=mlp_b, smw=[np.zeros_like(x) for x in mlp_w],
                smb=[np.zeros_like(x) for x in mlp_b])


def _batches(spec, ds, fill):
    out = []
    for i, b in enumerate(batch_iterator(ds, 256, device="cpu")):
        if i == 3:
            break
        plan = None
        if spec[6]:
            plan = E.host_dedup(np.asarray(b.ids), spec[5], fill)._replace(
                order=None, seg=None)
        out.append((b, plan))
    return out


def _port_step_case(spec, mesh):
    ds = _data(*spec[2])
    fm, hidden, sgd = _cfgs(spec, ds.num_features)
    pcfg = SD.padded_config(DF.DeepFMConfig(fm=FMConfig(**fm),
                                            hidden=hidden),
                            M.size(mesh, M.MODEL_AXIS))
    init = _init(pcfg.fm.num_features, fm["num_factors"], fm["num_fields"],
                 hidden)
    state = SD.sharded_state_from_numpy(*init.values(), mesh)
    step = SD.make_sharded_train_step(pcfg, SGDConfig(**sgd), mesh)
    losses = []
    for b, plan in _batches(spec, ds, pcfg.fm.num_features - 1):
        state, aux = step(state, MH.global_batch(
            mesh, b, plan=plan, plan_mode="global"))
        assert not bool(aux["unique_overflow"])
        losses.append(float(aux["loss"]))
    out = {name: MH.collect(t, mesh) for name, t in
           (("w", state.fm.params.w), ("v", state.fm.params.v),
            ("slot_v", state.fm.slot_v))}
    out.update(loss=losses, w0=state.fm.params.w0.numpy(),
               mlp_w=[x.numpy() for x in state.mlp_w],
               mlp_b=[x.numpy() for x in state.mlp_b])
    return out


def _port_world(mesh8, ckpt_root):
    meshes = {}
    out = {}
    for name, spec in STEPS.items():
        if spec[0] not in meshes:
            meshes[spec[0]] = M.make_mesh(*spec[0], device="cpu")
        out[name] = _port_step_case(spec, meshes[spec[0]])

    ds = _data(768, 4, 128, 18)
    kw = dict(num_factors=4, task="classification", solver="sgd",
              model="deepfm", hidden=(8,), num_fields=4, batch_size=128,
              learning_rate=0.05, seed=18)
    mesh = MeshConfig(data=4, model=2)
    full = FM(max_iter=4, mesh=mesh, **kw).fit(ds, device="cpu")
    ck = f"{ckpt_root}/dfm_mesh_ck"
    FM(max_iter=2, mesh=mesh, **kw).fit(ds, checkpoint_dir=ck, device="cpu")
    resumed = FM(max_iter=4, mesh=mesh, **kw).fit(ds, checkpoint_dir=ck,
                                                  device="cpu")
    out["resume"] = [(a.numpy(), b.numpy()) for a, b in (
        (full.params.fm.v, resumed.params.fm.v),
        (full.params.fm.w, resumed.params.fm.w),
        *zip(full.params.mlp_w, resumed.params.mlp_w))]
    out["resume_history"] = (full.history, resumed.history)

    ds = _data(768, 4, 128, 31)
    kw = dict(num_factors=4, task="classification", solver="sgd",
              max_iter=2, model="deepfm", hidden=(8,), num_fields=4,
              batch_size=128, learning_rate=0.05, seed=31)
    try:
        FM(mesh=MeshConfig(data=4, model=2, exchange="dense"),
           **kw).fit(ds, device="cpu")
        out["dense_refused"] = None
    except ValueError as e:
        out["dense_refused"] = str(e)
    out["auc_unique"] = FM(mesh=MeshConfig(data=4, model=2,
                                           exchange="unique"), **kw).fit(
        ds, eval_ds=ds, device="cpu").history[-1]["eval_auc"]
    out["auc_global"] = FM(mesh=MeshConfig(data=4, model=2), **kw).fit(
        ds, eval_ds=ds, device="cpu").history[-1]["eval_auc"]

    ds = _data(4096, 8, 512, 0)
    model = FM(model="deepfm", solver="sgd", task="classification",
               num_factors=4, num_fields=8, hidden=(16, 8), learning_rate=0.1,
               batch_size=512, max_iter=3, mesh="4x2", seed=0).fit(
        ds, eval_ds=ds, device="cpu")
    out["facade_aucs"] = [r["eval_auc"] for r in model.history
                          if "eval_auc" in r]
    out["facade_predict_finite"] = bool(np.isfinite(
        model.predict_dataset(ds)).all())
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded_deepfm"))
    outs = MH.spawn(_port_world, (8, 1), "cpu", timeout=300, args=(root,))
    for o in outs[1:]:
        for name in STEPS:
            np.testing.assert_array_equal(o[name]["v"], outs[0][name]["v"])
    return outs[0]


def _jax_step_case(spec):
    import jax
    import jax.numpy as jnp

    from sparkfm_tpu.config import FMConfig as JFMConfig
    from sparkfm_tpu.config import SGDConfig as JSGDConfig
    from sparkfm_tpu.config import Task as JTask
    from sparkfm_tpu.data.batching import SparseBatch as JBatch
    from sparkfm_tpu.models import deepfm as JDF
    from sparkfm_tpu.models.fm import FMParams as JParams
    from sparkfm_tpu.ops.embedding import DedupBatch as JPlan
    from sparkfm_tpu.parallel import mesh as JM
    from sparkfm_tpu.parallel import sharded_deepfm as JSD

    ds = _data(*spec[2])
    fm, hidden, sgd = _cfgs(spec, ds.num_features)
    fm["task"] = JTask.CLASSIFICATION
    mesh = JM.make_mesh(*spec[0])
    _, pcfg = JSD.init_sharded_state(
        JDF.DeepFMConfig(fm=JFMConfig(**fm), hidden=hidden), mesh,
        jax.random.PRNGKey(1))
    init = _init(pcfg.fm.num_features, fm["num_factors"], fm["num_fields"],
                 hidden)
    a = jnp.asarray
    state = {"params": JDF.DeepFMParams(
                 fm=JParams(w0=a(init["w0"]), w=a(init["w"]),
                            v=a(init["v"])),
                 mlp_w=tuple(map(a, init["mlp_w"])),
                 mlp_b=tuple(map(a, init["mlp_b"]))),
             "slots": {"w0": a(init["slot_w0"]), "w": a(init["slot_w"]),
                       "v": a(init["slot_v"]),
                       "mw": tuple(map(a, init["smw"])),
                       "mb": tuple(map(a, init["smb"]))}}
    state = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, JM.named(mesh, s)), state,
        JSD.state_pspecs(pcfg))
    step = JSD.make_sharded_train_step(pcfg, JSGDConfig(**sgd), mesh)
    losses = []
    for b, plan in _batches(spec, ds, pcfg.fm.num_features - 1):
        n = lambda x: jnp.asarray(np.asarray(x))
        jplan = None if plan is None else JPlan(
            uids=n(plan.uids), ranks=n(plan.ranks), count=n(plan.count),
            overflow=n(plan.overflow), order=None, seg=None)
        state, aux = step(state, JBatch(ids=n(b.ids), vals=n(b.vals),
                                        y=n(b.y), mask=n(b.mask),
                                        plan=jplan))
        losses.append(float(aux["loss"]))
    p, sl = state["params"], state["slots"]
    return dict(loss=losses, w0=np.asarray(p.fm.w0), w=np.asarray(p.fm.w),
                v=np.asarray(p.fm.v), slot_v=np.asarray(sl["v"]),
                mlp_w=[np.asarray(x) for x in p.mlp_w],
                mlp_b=[np.asarray(x) for x in p.mlp_b])


def _single_device(spec, f_pad):
    """The port's one-device dedup step from the same state: the padded
    table's last row is the dedup fill row (the JAX test's ref_cfg)."""
    ds = _data(*spec[2])
    fm, hidden, sgd = _cfgs(spec, ds.num_features)
    cfg = DF.DeepFMConfig(fm=FMConfig(**{**fm, "num_features": f_pad - 1}),
                          hidden=hidden)
    init = _init(f_pad, fm["num_factors"], fm["num_fields"], hidden)
    params = DF.deepfm_params_from_numpy(
        init["w0"], init["w"][:-1], init["v"][:-1], init["mlp_w"],
        init["mlp_b"], device="cpu")
    state = DF.pad_deepfm_state_for_dedup(DF.init_state(params))
    step = DF.make_train_step(cfg, SGDConfig(**sgd))
    losses = []
    for b, _ in _batches(spec, ds, f_pad - 1):
        state, aux = step(state, b)
        losses.append(float(aux["loss"]))
    return dict(loss=losses, w0=state.fm.params.w0.numpy(),
                w=state.fm.params.w.numpy(), v=state.fm.params.v.numpy(),
                slot_v=state.fm.slot_v.numpy(),
                mlp_w=[x.numpy() for x in state.mlp_w],
                mlp_b=[x.numpy() for x in state.mlp_b])


def _assert_same(got, want, f):
    np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL)
    np.testing.assert_allclose(got["w0"], want["w0"], rtol=1e-5)
    for n in ("w", "v", "slot_v"):
        np.testing.assert_allclose(got[n][:f], want[n][:f], **TABLE_TOL)
    for a, b in zip(got["mlp_w"] + got["mlp_b"],
                    want["mlp_w"] + want["mlp_b"]):
        np.testing.assert_allclose(a, b, **TABLE_TOL)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_sharded_step_matches_jax(port, name):
    spec = STEPS[name]
    want = _jax_step_case(spec)
    assert port[name]["v"].shape == want["v"].shape
    _assert_same(port[name], want, _data(*spec[2]).num_features)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_sharded_step_matches_one_device_dedup(port, name):
    """The JAX test's claim for the port: the mesh changes where rows and
    examples live, not the update. Only the true F rows are compared (the
    fill row is garbage by contract on both paths)."""
    spec = STEPS[name]
    got = port[name]
    want = _single_device(spec, got["v"].shape[0])
    _assert_same(got, want, _data(*spec[2]).num_features)


def test_global_plan_matches_device_dedup(port):
    f = _data(*STEPS["plan_global"][2]).num_features
    _assert_same(port["plan_global"], port["plan_device"], f)


def test_sharded_deepfm_refuses_adam_and_dense():
    cfg = DF.DeepFMConfig(fm=FMConfig(num_features=64, num_factors=2,
                                      num_fields=4), hidden=(8,))
    for bad in (SGDConfig(optimizer="adam"),
                SGDConfig(optimizer="sgd", momentum=0.9)):
        with pytest.raises(ValueError, match="adagrad"):
            SD.make_sharded_train_step(cfg, bad, None)


def test_exchange_honoured_or_refused(port):
    assert "dense" in port["dense_refused"]
    assert abs(port["auc_unique"] - port["auc_global"]) < 5e-3


def test_checkpoint_resumes_bit_for_bit(port):
    """A sharded DeepFM run of 4 epochs equals 2 epochs, a checkpoint per
    rank, and a resumed run to 4, bit for bit."""
    for a, b in port["resume"]:
        np.testing.assert_array_equal(a, b)
    full, resumed = port["resume_history"]
    assert full == resumed


def test_facade_deepfm_on_mesh_end_to_end(port):
    assert port["facade_aucs"][-1] > 0.62, port["facade_aucs"]
    assert port["facade_predict_finite"]


def test_state_round_trips_through_numpy():
    """sharded_state_from_numpy keeps a rank's rows; on a (1, 1) layout
    the shard is the whole table."""
    class One:
        device_type = "cpu"

        def size(self, i):
            return 1

        mesh_dim_names = ("data", "model")

        def get_local_rank(self, axis):
            return 0
    init = _init(10, 2, 4, (4,))
    st = SD.sharded_state_from_numpy(*init.values(), One())
    np.testing.assert_array_equal(st.fm.params.v.numpy(), init["v"])
    np.testing.assert_array_equal(st.mlp_w[0].numpy(), init["mlp_w"][0])
    assert dataclasses.is_dataclass(st)
