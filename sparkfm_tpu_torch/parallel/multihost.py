"""Multi-process runs: the process group, each rank's part of a global
batch, gathers to the host, a launcher for local worlds, and a dry run of
every sharded path. Port of ``sparkfm_tpu/parallel/multihost.py`` onto
``torch.distributed``, with one process per rank (the JAX package runs one
process per host over all its devices).

Every rank runs the same program. Each draws the same global batches from
the same seed, builds any host plan from the whole global batch, and keeps
the rows of its ``data`` coordinate (:func:`process_batch_slice`,
:func:`global_batch`): the JAX "process slice" is the rank's data index.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import queue as queue_mod
import socket
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sparkfm_tpu_torch.data.batching import SparseBatch
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.parallel import mesh as M
from sparkfm_tpu_torch.utils import device as device_util

log = logging.getLogger("sparkfm_tpu_torch")
PG_TIMEOUT_S = 600      # a collective that waits longer raises


def free_port() -> int:
    """A TCP port on localhost that the OS reports free."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, *, device="cuda",
               backend: Optional[str] = None,
               timeout_s: float = PG_TIMEOUT_S) -> bool:
    """Join the process group; True once this process is in one.

    With no arguments it reads the ``torchrun`` environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) and
    does nothing without it (a one-process run). Explicit arguments, or
    that environment, name a topology the caller asked for: failing to
    join it raises, never leaving a one-process "cluster" that would train
    on a fraction of the data and report success.

    The backend is NCCL for ``device`` on the card (which must be
    available) and gloo on the CPU, unless ``backend`` says otherwise
    (gloo carries CUDA tensors through the host). On the card the rank's
    device is ``device``'s index, else ``LOCAL_RANK``, else the rank
    modulo the card count."""
    if dist.is_initialized():
        return True
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if init_method is None and world_size is None and rank is None \
            and not env:
        return False
    device = device_util.resolve(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("NCCL is not available in this torch build; a "
                           "mesh on the card needs it")
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if init_method is None:
        init_method = ("env://" if env
                       else f"tcp://localhost:{free_port()}")
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = int(os.environ.get(
                "LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(index)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    log.info("distributed: rank %d/%d, backend %s, %s", rank, world_size,
             backend, device)
    return True


def process_index() -> int:
    """This process's rank, 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_batch_slice(n_global: int, mesh) -> slice:
    """This rank's contiguous rows of a global batch: its data
    coordinate's block (``mesh.data_slice``)."""
    return M.data_slice(n_global, mesh)


def _rows(x, sl: slice, device):
    if x is None:
        return None
    return torch.as_tensor(np.asarray(x)[sl]).to(device)


def global_batch(mesh, batch: SparseBatch, has_fields: bool = False,
                 plan: Optional[E.DedupBatch] = None,
                 plan_mode: str = "stacked") -> SparseBatch:
    """This rank's part of a global host batch, on the mesh's device: the
    rows of its data coordinate, and the plan in the rank's layout.

    ``plan`` (host numpy) is one of the JAX package's three layouts:
    "stacked" (:func:`ops.embedding.stack_plans`: uids (D, U), count and
    overflow (D,), ranks (B, L)); "global" (one plan over the whole batch:
    uids (U_g,) on every rank, ranks (B, L)); "global_hybrid" (a global
    plan whose order/seg/svals/sex are ``stack_hybrid_extras``' (D, ...)
    gmap and sorted streams). The rank keeps its rows of the ranks and its
    data coordinate's row of every (D, ...) array, as a (1, ...) array,
    which is what a JAX shard sees of it; count and overflow stay on the
    host. ``field_ids`` ride only with ``has_fields``."""
    device = M.device_of(mesh)
    sl = process_batch_slice(batch.ids.shape[0], mesh)
    d = M.axis_index(M.DATA_AXIS, mesh)
    lifted = None
    if plan is not None:
        if plan_mode not in ("stacked", "global", "global_hybrid"):
            raise ValueError(f"unknown plan_mode={plan_mode!r}")

        def row(x):     # the rank's row of a (D, ...) stack, kept (1, ...)
            return None if x is None else torch.as_tensor(
                np.asarray(x)[d:d + 1]).to(device)
        if plan_mode == "stacked":
            lifted = E.DedupBatch(
                uids=row(plan.uids), ranks=_rows(plan.ranks, sl, device),
                count=np.asarray(plan.count)[d:d + 1],
                overflow=np.asarray(plan.overflow)[d:d + 1])
        else:
            hybrid = plan_mode == "global_hybrid"
            lifted = E.DedupBatch(
                uids=torch.as_tensor(np.asarray(plan.uids)).to(device),
                ranks=_rows(plan.ranks, sl, device),
                count=int(plan.count), overflow=bool(plan.overflow),
                order=row(plan.order) if hybrid else None,
                seg=row(plan.seg) if hybrid else None,
                svals=row(plan.svals) if hybrid else None,
                sex=row(plan.sex) if hybrid else None)
    return SparseBatch(
        ids=_rows(batch.ids, sl, device), vals=_rows(batch.vals, sl, device),
        y=_rows(batch.y, sl, device), mask=_rows(batch.mask, sl, device),
        field_ids=(_rows(batch.field_ids, sl, device) if has_fields
                   else None),
        plan=lifted)


def collect(x: torch.Tensor, mesh, axis: str = M.MODEL_AXIS) -> np.ndarray:
    """The whole of an array sharded on its leading dimension over
    ``axis`` (a row-sharded table over ``model``, per-rank scores over
    ``data``), as host numpy, the same on every rank."""
    return M.all_gather(x, axis, mesh).cpu().numpy()


# ---------------------------------------------------------------------------
# A local world of processes

def _rank_main(rank, world, port, mesh_shape, device, backend, timeout_s,
               fn, args, results):
    torch.set_num_threads(1)
    try:
        initialize(f"tcp://localhost:{port}", world, rank, device=device,
                   backend=backend, timeout_s=timeout_s)
        mesh = M.make_mesh(*mesh_shape, device=device)
        out = fn(mesh, *args)
        results.put((rank, True, out))
    except BaseException as e:     # handed to the parent, which re-raises
        try:
            pickle.dumps(e)
        except Exception:
            e = RuntimeError(repr(e))
        results.put((rank, False, (e, traceback.format_exc())))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _shares_a_card(device: torch.device, world: int) -> bool:
    """Whether ranks of a ``world`` on ``device`` share a card: all on the
    named card, or more ranks than cards (rank r takes card r mod count)."""
    return device.type == "cuda" and world > 1 and (
        device.index is not None or world > torch.cuda.device_count())


def spawn(fn: Callable, mesh_shape: Sequence[int], device="cuda",
          timeout: float = 120.0, args: tuple = (),
          backend: Optional[str] = None) -> list:
    """Run ``fn(mesh, *args)`` on a (data, model) = ``mesh_shape`` world of
    fresh processes, one rank each, and return each rank's result in rank
    order. The ranks join on a free localhost port, take one CPU thread
    each, and run on ``device``: the card unless the caller asks for the
    CPU, raising here without one (``utils/device.py``). ``"cuda"`` gives
    rank r card r modulo the card count, ``"cuda:0"`` puts every rank on
    card 0. ``backend`` as :func:`initialize`, except that ranks sharing a
    card default to gloo, since NCCL refuses two ranks on one card. ``fn``
    must be importable by name from a fresh interpreter (a module-level
    function).

    The parent waits at most ``timeout`` seconds in all; then, or as soon
    as a rank fails, it kills every rank still running and raises: the
    rank's own exception (with its traceback as the cause), or
    ``TimeoutError``. No process outlives the call."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    world = int(np.prod(mesh_shape))
    resolved = device_util.resolve(device)
    if backend is None and _shares_a_card(resolved, world):
        backend = "gloo"
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, tuple(mesh_shape), device,
                               backend, timeout, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out = {}
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: {world - len(out)} of {world} ranks did not "
                    f"finish {getattr(fn, '__name__', fn)} within "
                    f"{timeout:g} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"spawn: rank(s) exited without a "
                                       f"result (rank, exit code): {dead}")
                continue
            if not ok:
                exc, tb = payload
                raise exc from RuntimeError(f"rank {rank} of {world}:\n{tb}")
            out[rank] = payload
        for p in procs:
            p.join(max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        results.close()
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# A dry run of every sharded path

def dryrun(mesh) -> dict:
    """One step (or sweep) of every sharded path on ``mesh``, at toy
    shapes, in the JAX package's order (``__graft_entry__.py::
    dryrun_multichip``): the unique exchange and a sharded score pass;
    the global exchange, then with hybrid extras; a sharded ALS sweep and
    a sharded MCMC run; per-group L2; sharded FFM on the unique and
    global exchanges; sharded DeepFM, unique then global. Each stop must
    give finite numbers. Returns {stop: its loss, or the mean |v|}, the
    same on every rank."""
    from sparkfm_tpu_torch.config import (ALSConfig, FMConfig, MCMCConfig,
                                          SGDConfig, Task)
    from sparkfm_tpu_torch.data import synth
    from sparkfm_tpu_torch.models import deepfm as DF
    from sparkfm_tpu_torch.models import fm as fm_model
    from sparkfm_tpu_torch.parallel import sharded_als as SA
    from sparkfm_tpu_torch.parallel import sharded_deepfm as SD
    from sparkfm_tpu_torch.parallel import sharded_sgd as S
    from sparkfm_tpu_torch.solvers import als

    data = M.size(mesh, M.DATA_AXIS)
    dev = M.device_of(mesh)
    out = {}

    def record(name, value):
        value = float(value)
        if not np.isfinite(value):
            raise AssertionError(f"dryrun: {name} gave {value}")
        out[name] = value

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    rng = np.random.default_rng(0)
    b, l = 8 * data, 4

    def batch_of(feats, y, fields=False):
        return SparseBatch(
            ids=torch.as_tensor(rng.integers(0, feats, (b, l),
                                             dtype=np.int32)),
            vals=torch.ones((b, l)), y=torch.as_tensor(y),
            mask=torch.ones((b,), dtype=torch.bool),
            field_ids=(torch.arange(l, dtype=torch.int32).expand(b, l)
                       if fields else None))

    def global_plan(batch, fill, vals=None):
        return E.host_dedup(np.asarray(batch.ids), 64, fill, vals=vals)

    cfg = FMConfig(num_features=64, num_factors=4,
                   task=Task.CLASSIFICATION, reg_v=0.01)
    sgd_cfg = SGDConfig(batch_size=b, learning_rate=0.1,
                        optimizer="adagrad")
    state, pcfg = S.init_sharded_state(cfg, mesh, gen(0), "adagrad")
    fill = pcfg.num_features - 1
    batch = batch_of(64, rng.integers(0, 2, b).astype(np.float32))
    state, aux = S.make_sharded_train_step(pcfg, sgd_cfg, mesh, "unique")(
        state, global_batch(mesh, batch))
    record("unique step loss", aux["loss"])
    gb = global_batch(mesh, batch)
    scores = collect(S.make_sharded_score_fn(pcfg, mesh)(
        state.params, gb.ids, gb.vals), mesh, M.DATA_AXIS)
    record("sharded score mean", scores.mean())

    gstep = S.make_sharded_train_step(pcfg, sgd_cfg, mesh, "global")
    plan = global_plan(batch, fill)._replace(order=None, seg=None)
    state, aux = gstep(state, global_batch(mesh, batch, plan=plan,
                                           plan_mode="global"))
    record("global step loss", aux["loss"])
    hp = global_plan(batch, fill, vals=np.asarray(batch.vals))
    seg, sv, sex, gmap, _ = E.stack_hybrid_extras(
        hp.ranks, np.asarray(batch.vals), data)
    plan = hp._replace(order=gmap, seg=seg, svals=sv, sex=sex)
    state, aux = gstep(state, global_batch(mesh, batch, plan=plan,
                                           plan_mode="global_hybrid"))
    record("global hybrid step loss", aux["loss"])

    ds = synth.synth_movielens(num_users=16, num_items=16,
                               num_examples=8 * data + 3, seed=0)
    acfg = FMConfig(num_features=ds.num_features, num_factors=2, reg_v=0.5)
    ws, nb = SA.build_sharded_workspace(ds, acfg, ALSConfig(block_size=8),
                                        mesh)
    p1 = SA.make_sharded_sweep(acfg, nb, mesh)(
        fm_model.init_params(acfg, gen(1), device=dev), ws)
    record("ALS sweep mean |v|", p1.v.abs().mean())
    mres = SA.train_mcmc_sharded(
        FMConfig(num_features=ds.num_features, num_factors=2, seed=0),
        MCMCConfig(epochs=2, burn_in=1, feature_blocks=als.slot_blocks(ds)),
        ds, mesh, eval_ds=ds, generator=gen(4))
    record("MCMC eval_rmse_avg", mres.history[-1]["eval_rmse_avg"])

    gcfg = FMConfig(num_features=60, num_factors=2,
                    feature_groups=tuple([0] * 30 + [1] * 30),
                    group_reg_w=(0.01, 0.1), group_reg_v=(0.02, 0.2))
    gstate, gpcfg = S.init_sharded_state(gcfg, mesh, gen(2), "adagrad")
    gbatch = batch_of(60, rng.normal(size=b).astype(np.float32))
    _, aux = S.make_sharded_train_step(gpcfg, sgd_cfg, mesh)(
        gstate, global_batch(mesh, gbatch))
    record("per-group L2 step loss", aux["loss"])

    fcfg = FMConfig(num_features=64, num_factors=2, num_fields=l,
                    task=Task.CLASSIFICATION, reg_v=0.01)
    fstate, fpcfg = S.init_sharded_state(fcfg, mesh, gen(5), "adagrad")
    fbatch = batch_of(64, rng.integers(0, 2, b).astype(np.float32),
                      fields=True)
    fstate, aux = S.make_sharded_train_step(fpcfg, sgd_cfg, mesh, "unique")(
        fstate, global_batch(mesh, fbatch, has_fields=True))
    record("FFM unique step loss", aux["loss"])
    plan = global_plan(fbatch, fpcfg.num_features - 1)._replace(
        order=None, seg=None)
    _, aux = S.make_sharded_train_step(fpcfg, sgd_cfg, mesh, "global")(
        fstate, global_batch(mesh, fbatch, True, plan, "global"))
    record("FFM global step loss", aux["loss"])

    dcfg = DF.DeepFMConfig(fm=FMConfig(num_features=64, num_factors=4,
                                       task=Task.CLASSIFICATION,
                                       num_fields=l), hidden=(8, 4))
    dstate, dpcfg = SD.init_sharded_state(dcfg, mesh, gen(3))
    dstep = SD.make_sharded_train_step(dpcfg, sgd_cfg, mesh)
    dbatch = batch_of(64, rng.integers(0, 2, b).astype(np.float32))
    dstate, aux = dstep(dstate, global_batch(mesh, dbatch))
    record("DeepFM unique step loss", aux["loss"])
    plan = global_plan(dbatch, dpcfg.fm.num_features - 1)._replace(
        order=None, seg=None)
    _, aux = dstep(dstate, global_batch(mesh, dbatch, plan=plan,
                                        plan_mode="global"))
    record("DeepFM global step loss", aux["loss"])
    return out


def dryrun_multichip(n_ranks: int, device="cuda",
                     timeout: float = 300.0) -> dict:
    """:func:`dryrun` on an n-rank world started by :func:`spawn` on
    ``device`` (the card unless the caller asks for the CPU), the mesh
    (n/2, 2) for even n, else (n, 1). Returns rank 0's stops, after
    checking that every rank reports the same."""
    shape = (n_ranks // 2, 2) if n_ranks % 2 == 0 else (n_ranks, 1)
    outs = spawn(dryrun, shape, device=device, timeout=timeout)
    if any(o != outs[0] for o in outs[1:]):
        raise AssertionError(f"dryrun: the ranks disagree: {outs}")
    return outs[0]
