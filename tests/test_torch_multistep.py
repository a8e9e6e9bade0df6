"""Several steps per dispatch in the port (``utils/graphs.py``,
``sgd_hybrid.make_hybrid_multi_step``, ``sgd_fused.make_fused_multi_step``
and ``train_sgd(steps_per_dispatch=G)``) against the JAX package's
``lax.scan`` multi-steps and trainer, and against the port's own single
steps.

On the CPU a multi-step runs its G steps one after another, so it must
equal G single steps exactly. Against the JAX package the tolerances are
those of ``tests/test_sgd_hybrid.py``'s single-step comparison (losses
rtol 1e-5; w0 rtol 1e-5, atol 1e-7; tables rtol 1e-4, atol 1e-6: float32
sums in another order); the trainers are held at
``tests/test_torch_trainer.py``'s (rtol 2e-4, atol 2e-5 on parameters,
1e-5 on losses). The CUDA graphs themselves are held to eager steps bit
for bit in ``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.config import FMConfig as JFMConfig
from sparkfm_tpu.config import SGDConfig as JSGDConfig
from sparkfm_tpu.config import Task as JTask
from sparkfm_tpu.data import synth as jsynth
from sparkfm_tpu.data.batching import SparseBatch as JSparseBatch
from sparkfm_tpu.models.fm import FMParams as JFMParams
from sparkfm_tpu.ops import embedding as JE
from sparkfm_tpu.solvers import sgd_fused as jfused
from sparkfm_tpu.solvers import sgd_hybrid as jhybrid
from sparkfm_tpu.training import trainer as jtrainer
from sparkfm_tpu_torch import FMConfig, SGDConfig, Task, train_sgd
from sparkfm_tpu_torch.data import synth as psynth
from sparkfm_tpu_torch.data.batching import SparseBatch, batch_iterator
from sparkfm_tpu_torch.models.fm import params_from_numpy
from sparkfm_tpu_torch.ops import embedding as PE
from sparkfm_tpu_torch.solvers import sgd_fused, sgd_hybrid
from sparkfm_tpu_torch.utils import graphs

torch.set_num_threads(1)
B, L, F, K, G = 64, 6, 512, 4, 4


def _arrays(seed=7):
    """G batches of tests/test_sgd_hybrid.py's multi-step setup, as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(G):
        ids = rng.integers(0, F, (B, L)).astype(np.int32)
        vals = np.ones((B, L), np.float32)
        y = rng.integers(0, 2, (B,)).astype(np.float32)
        out.append((ids, vals, y))
    return out


def _jax_batch(ids, vals, y):
    hp = JE.host_dedup(ids, 512, F, vals=vals)
    plan = JE.DedupBatch(
        uids=jnp.asarray(hp.uids), ranks=jnp.asarray(hp.ranks),
        count=jnp.asarray(hp.count), overflow=jnp.asarray(hp.overflow),
        order=jnp.asarray(hp.order), seg=jnp.asarray(hp.seg),
        svals=jnp.asarray(hp.svals), sex=jnp.asarray(hp.sex))
    return JSparseBatch(ids=jnp.asarray(ids), vals=jnp.asarray(vals),
                        y=jnp.asarray(y), mask=jnp.ones((B,), bool),
                        plan=plan)


def _port_batch(ids, vals, y, plan=True):
    return SparseBatch(
        ids=torch.from_numpy(ids), vals=torch.from_numpy(vals),
        y=torch.from_numpy(y), mask=torch.ones((B,), dtype=torch.bool),
        plan=(PE.plan_to_device(PE.host_dedup(ids, 512, F, vals=vals),
                                "cpu") if plan else None))


def _configs(opt="adagrad"):
    kw = dict(num_features=F, num_factors=K, reg_w=1e-4, reg_v=1e-4,
              seed=7)
    skw = dict(batch_size=B, learning_rate=0.1, optimizer=opt,
               unique_budget=512)
    return (JFMConfig(task=JTask.CLASSIFICATION, **kw), JSGDConfig(**skw),
            FMConfig(task=Task.CLASSIFICATION, **kw), SGDConfig(**skw))


def _states(jcfg, pcfg, seed=1):
    rng = np.random.default_rng(seed)
    p = JFMParams(w0=jnp.float32(0.1),
                  w=jnp.asarray(rng.normal(0, 0.05, F), jnp.float32),
                  v=jnp.asarray(rng.normal(0, 0.05, (F, K)), jnp.float32))
    jstate = jfused.fused_from_params(p, jcfg)
    # numpy copies first: the JAX multi-steps donate the state
    arrays = [np.array(x) for x in (jstate.table, jstate.w0,
                                    jstate.slot_w0, jstate.step)]

    def port():
        return sgd_fused.fused_state_from_numpy(*arrays, pcfg, device="cpu")
    return jstate, port


def _close_to_jax(pstate, jstate, paux, jaux):
    used = 2 * K + 2
    np.testing.assert_allclose(pstate.table[:F, :used].numpy(),
                               np.asarray(jstate.table)[:F, :used],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(pstate.w0), float(jstate.w0),
                               rtol=1e-5, atol=1e-7)
    assert int(pstate.step) == int(jstate.step) == G
    np.testing.assert_allclose(float(paux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(paux["loss_mean"]),
                               float(jaux["loss_mean"]), rtol=1e-5)
    assert paux["unique_overflow"] is False
    assert not bool(jaux["unique_overflow"])


def _equal_states(a, b):
    for name in ("table", "w0", "slot_w0", "step"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_hybrid_multi_step_matches_jax_and_single_steps():
    """The port's stack_batches + make_hybrid_multi_step against the JAX
    package's on tests/test_sgd_hybrid.py's setup, and against G single
    port steps exactly."""
    jcfg, jsgd, pcfg, psgd = _configs()
    arrays = _arrays()
    jstate, port = _states(jcfg, pcfg)
    jmulti = jhybrid.make_hybrid_multi_step(jcfg, jsgd, group=G,
                                            segsum_force="xla",
                                            bf16x2=False)
    jstate, jaux = jmulti(jstate, jhybrid.stack_batches(
        [_jax_batch(*a) for a in arrays]))
    batches = [_port_batch(*a) for a in arrays]
    stacked = sgd_hybrid.stack_batches(batches)
    assert stacked.ids.shape == (G, B, L)
    assert stacked.plan.count.shape == (G,)
    assert stacked.plan.overflow.shape == (G,)
    multi = sgd_hybrid.make_hybrid_multi_step(pcfg, psgd, group=G)
    pstate = port()
    table = pstate.table
    out, paux = multi(pstate, stacked)
    assert out is pstate and pstate.table is table    # in place
    _close_to_jax(pstate, jstate, paux, jaux)

    single = port()
    step = sgd_hybrid.make_hybrid_train_step(pcfg, psgd)
    losses = []
    for b in batches:
        single, aux = step(single, b)
        losses.append(aux["loss"])
    _equal_states(pstate, single)
    assert torch.equal(paux["loss"], losses[-1])
    assert float(paux["loss_mean"]) == float(
        torch.stack(losses).double().mean())
    assert multi.captures == 0                        # no graph on the CPU


def test_fused_multi_step_matches_jax_and_single_steps():
    """make_fused_multi_step against the JAX package's
    (sgd_fused.py:314), on host plans and without plans (each step builds
    a device plan of a fixed budget), and against G single steps
    exactly."""
    jcfg, jsgd, pcfg, psgd = _configs()
    arrays = _arrays(seed=3)
    for plans in (True, False):
        jstate, port = _states(jcfg, pcfg, seed=2)
        jbatches = [_jax_batch(*a) for a in arrays]
        if not plans:
            jbatches = [b._replace(plan=None) if hasattr(b, "_replace")
                        else JSparseBatch(ids=b.ids, vals=b.vals, y=b.y,
                                          mask=b.mask) for b in jbatches]
        jstate, jaux = jfused.make_fused_multi_step(jcfg, jsgd)(
            jstate, jhybrid.stack_batches(jbatches))
        batches = [_port_batch(*a, plan=plans) for a in arrays]
        pstate = port()
        _, paux = sgd_fused.make_fused_multi_step(pcfg, psgd)(
            pstate, sgd_hybrid.stack_batches(batches))
        _close_to_jax(pstate, jstate, paux, jaux)
        single = port()
        step = sgd_fused.make_fused_train_step(pcfg, psgd)
        for b in batches:
            single, aux = step(single, b)
        _equal_states(pstate, single)
        assert torch.equal(paux["loss"], aux["loss"])


def test_stack_batches_keeps_host_overflow_and_ors_it():
    """The plans' overflow flags stay on the host and the multi-step ORs
    them over the group, as the JAX aux does."""
    _, _, pcfg, psgd = _configs()
    arrays = _arrays(seed=5)
    batches = [_port_batch(*a) for a in arrays]
    batches[2].plan = batches[2].plan._replace(overflow=np.bool_(True))
    for b in batches:
        b.mask = None
    stacked = sgd_hybrid.stack_batches(batches)
    assert stacked.plan.overflow.tolist() == [False, False, True, False]
    assert stacked.mask is None
    _, aux = sgd_hybrid.make_hybrid_multi_step(pcfg, psgd)(
        _states(*_configs()[::2])[1](), stacked)
    assert aux["unique_overflow"] is True


def test_batch_fields_round_trip():
    ids, vals, y = _arrays()[0]
    b = _port_batch(ids, vals, y)
    fields = graphs.batch_fields(b)
    assert set(fields) == {"ids", "vals", "y", "mask", "plan.uids",
                           "plan.ranks", "plan.count", "plan.order",
                           "plan.seg", "plan.svals", "plan.sex"}
    assert fields["plan.count"].shape == ()
    back = graphs.batch_from_fields(fields, overflow=False)
    for name in ("ids", "vals", "y", "mask"):
        assert getattr(back, name) is getattr(b, name)
    assert int(back.plan.count) == int(b.plan.count)
    assert back.plan.overflow is False and back.field_ids is None
    sig = graphs.signature(fields)
    assert sig[0] == ("ids", (B, L), torch.int32)


def _ctr_runs(spd_values, **sgd_kw):
    ds = psynth.synth_ctr(num_examples=1024, num_fields=5,
                          num_buckets=1 << 17, seed=9)
    cfg = FMConfig(num_features=1 << 17, num_factors=4,
                   task=Task.CLASSIFICATION, reg_v=1e-4, seed=9)
    common = dict(batch_size=128, learning_rate=0.1, optimizer="adagrad",
                  epochs=2, shuffle_each_epoch=True, update_path="hybrid",
                  **sgd_kw)
    return [train_sgd(cfg, SGDConfig(steps_per_dispatch=spd, **common), ds,
                      generator=torch.Generator().manual_seed(9),
                      device="cpu") for spd in spd_values]


@pytest.mark.parametrize("spd", [2, 4])
def test_grouped_train_sgd_equals_single_steps_bit_for_bit(spd):
    """train_sgd(steps_per_dispatch=G) on the hybrid path: the same
    parameters and histories as G = 1, bit for bit (the epoch mean in
    float64 makes a group's mean logged G times exact for G = 2, 4)."""
    one, grouped = _ctr_runs([1, spd])
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(one.params, name),
                           getattr(grouped.params, name)), name
    assert one.history == grouped.history


@pytest.mark.parametrize("spd", [2, 4])
def test_grouped_train_sgd_counts_overflowed_steps(spd):
    """With a unique budget below some batches' unique counts, G > 1
    records each epoch's overflowed steps, not groups, as G = 1 does:
    the same histories and parameters, bit for bit."""
    one, grouped = _ctr_runs([1, spd], unique_budget=286)
    counts = [h["unique_overflow_steps"] for h in one.history]
    assert 0 < min(counts) and max(counts) < 8
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(one.params, name),
                           getattr(grouped.params, name)), name
    assert one.history == grouped.history


def test_grouped_train_sgd_dispatches_full_groups(monkeypatch):
    """Full groups of one rung go to the multi-step as lists of batches
    (MultiStep.run, nothing stacked); each group's batches share the plan
    shape."""
    groups = []
    orig = graphs.MultiStep.run

    def spy(self, state, batches):
        groups.append({graphs.signature(graphs.batch_fields(b))
                       for b in batches})
        return orig(self, state, batches)

    def unstacked(batches):
        raise AssertionError("the trainer stacked a group")

    monkeypatch.setattr(graphs.MultiStep, "run", spy)
    monkeypatch.setattr(graphs, "stack_batches", unstacked)
    (res,) = _ctr_runs([2])
    assert len(groups) == 8 and all(len(g) == 1 for g in groups)
    assert [h["unique_overflow_steps"] for h in res.history] == [0, 0]


def test_grouped_train_sgd_matches_jax_trainer():
    """tests/test_sgd_hybrid.py:149's run: the port's
    steps_per_dispatch=2 against the JAX trainer's, from the same numpy
    parameters."""
    ds_kw = dict(num_examples=1024, num_fields=5, num_buckets=1 << 17,
                 seed=9)
    cfg_kw = dict(num_features=1 << 17, num_factors=4, reg_v=1e-4, seed=9)
    common = dict(batch_size=128, learning_rate=0.1, optimizer="adagrad",
                  epochs=2, shuffle_each_epoch=True, update_path="hybrid",
                  steps_per_dispatch=2)
    rng = np.random.default_rng(9)
    w0, w, v = (np.float32(0.05),
                rng.normal(0, 0.05, 1 << 17).astype(np.float32),
                rng.normal(0, 0.05, (1 << 17, 4)).astype(np.float32))
    jres = jtrainer.train_sgd(
        JFMConfig(task=JTask.CLASSIFICATION, **cfg_kw), JSGDConfig(**common),
        jsynth.synth_ctr(**ds_kw), key=jax.random.PRNGKey(9),
        init_params=JFMParams(w0=jnp.asarray(w0), w=jnp.asarray(w),
                              v=jnp.asarray(v)))
    pres = train_sgd(FMConfig(task=Task.CLASSIFICATION, **cfg_kw),
                     SGDConfig(**common), psynth.synth_ctr(**ds_kw),
                     init_params=params_from_numpy(w0, w, v, device="cpu"),
                     device="cpu")
    for g, h in zip(pres.history, jres.history):
        np.testing.assert_allclose(g["train_loss"], h["train_loss"],
                                   rtol=1e-5)
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(pres.params, name).numpy(),
                                   np.asarray(getattr(jres.params, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_run_steps_copies_the_scalars_into_the_state():
    """run_steps leaves the bias, its slot and the step count in the
    state's own tensors, as a graph needs them."""
    _, _, pcfg, psgd = _configs()
    _, port = _states(*_configs()[::2])
    state = port()
    w0 = state.w0
    step = sgd_hybrid.make_hybrid_train_step(pcfg, psgd)
    batches = [_port_batch(*a) for a in _arrays(seed=14)]
    auxes = graphs.run_steps(step, state, batches)
    assert len(auxes) == G and state.w0 is w0 and int(state.step) == G
    ref = port()
    for b in batches:
        ref, _ = step(ref, b)
    _equal_states(state, ref)


def test_grouped_iterator_batches_match_single_ones():
    """The grouped trainer's feed, batch_iterator(pinned=True) grouped by
    trainer._groups: full groups of one signature, and single batches
    where the rung changes or the epoch ends; in order they are the
    batches the single path reads."""
    from sparkfm_tpu_torch.training import trainer

    ds = psynth.synth_ctr(num_examples=600, num_fields=5, num_buckets=4096,
                          seed=3)
    kw = dict(shuffle=True, seed=3, epoch=1, dedup_budget="ladder",
              dedup_fill=4096)
    items = list(trainer._groups(
        batch_iterator(ds, 64, device="cpu", pinned=True, **kw), 2))
    direct = list(batch_iterator(ds, 64, device="cpu", **kw))
    assert all(len(i) in (1, 2) for i in items)
    groups = [i for i in items if len(i) == 2]
    assert groups
    for g in groups:
        a, b = (graphs.signature(graphs.batch_fields(x)) for x in g)
        assert a == b
    flat = [b for i in items for b in i]
    assert len(flat) == len(direct) == 10
    for a, b in zip(flat, direct):
        for name in ("ids", "vals", "y", "mask"):
            assert torch.equal(getattr(a, name), getattr(b, name))
        for name in ("uids", "ranks", "order", "seg", "svals", "sex"):
            assert torch.equal(getattr(a.plan, name), getattr(b.plan, name))
        assert int(a.plan.count) == int(b.plan.count)
        assert a.plan.overflow == bool(b.plan.overflow)


_TOWER3 = [f"{name}.{i}" for name in ("mlp_w", "mlp_b", "smw", "smb")
           for i in range(3)]
_LAYOUTS = {
    "fm fused": ["table", "w0", "slot_w0", "step"],
    "deepfm dedup": [
        "fm.params.w0", "fm.params.w", "fm.params.v", "fm.slot_w0",
        "fm.slot_w", "fm.slot_v", "fm.slot2_w0", "fm.slot2_w", "fm.slot2_v",
        "fm.step", *_TOWER3,
        *[f"{name}.{i}" for name in ("smw2", "smb2") for i in range(3)]],
    "deepfm fused": ["fm.table", "fm.w0", "fm.slot_w0", "fm.step", *_TOWER3],
}


@pytest.mark.parametrize("path,opt", [("fm fused", "adagrad"),
                                      ("deepfm dedup", "adam"),
                                      ("deepfm fused", "adagrad")])
def test_graph_key_covers_every_state_tensor(path, opt):
    """A graph cache's key holds the address of every tensor a captured
    step reads and writes, walked by graphs.state_tensors through a
    FusedState and a DeepFMState (an SGDState with FMParams and adam's
    moments, or a FusedState, and the tower of two hidden layers and the
    output): each tensor once, under the names that the checkpoint
    layout (utils/checkpoint.py, the same walk) has always written."""
    from sparkfm_tpu_torch.models import deepfm as PDF
    from sparkfm_tpu_torch.utils import checkpoint

    if path == "fm fused":
        state = _states(*_configs()[::2])[1]()
    else:
        cfg = PDF.DeepFMConfig(fm=FMConfig(num_features=F, num_factors=K,
                                           num_fields=L, seed=2),
                               hidden=(8, 4))
        sgd = SGDConfig(batch_size=B, optimizer=opt,
                        update_path=path.split()[1])
        state = PDF.initial_state(cfg, sgd, torch.Generator().manual_seed(2),
                                  device="cpu")
    got = graphs.state_tensors(state)
    assert list(got) == _LAYOUTS[path]
    assert len({id(t) for t in got.values()}) == len(got)
    assert ({k: id(t) for k, t in checkpoint.state_tensors(state).items()}
            == {k: id(t) for k, t in got.items()})
    if path != "fm fused":
        assert got["fm.step"] is state.fm.step
        assert got["mlp_w.2"] is state.mlp_w[2]


def test_kernels_refuse_to_build_inside_a_capture(monkeypatch):
    """A build or an SM-count lookup inside a graph capture raises (the
    eager warm-up group does both first); every kernel is in
    launch_counts, which the graphs read around a capture."""
    from sparkfm_tpu_torch.ops import rowio, segsum
    from sparkfm_tpu_torch.utils import build

    counts = build.launch_counts()
    for k in (rowio.GATHER, rowio.GATHER_VW, rowio.SCATTER, segsum.FACTORED,
              segsum.FM_GRAD, segsum.ROWSUM, segsum.ROWSUM_SQ,
              segsum.COLSUMS):
        assert counts[k] == k.launches
    kernel = build.CudaKernel("nolib", "missing.cu", "sfm_none", [])
    monkeypatch.setattr(build, "_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        kernel.build()
    with pytest.raises(RuntimeError, match="capture"):
        kernel.num_sms(torch.device("cuda", 0))
    build.CudaKernel.instances.remove(kernel)
