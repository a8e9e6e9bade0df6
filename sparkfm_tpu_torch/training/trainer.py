"""Training loop: SGD epochs with per-epoch loss and evaluation. Port of
``sparkfm_tpu/training/trainer.py`` (``train_sgd``, ``evaluate``,
``TrainResult``) for one device, on every single-device update path of the
JAX package: "direct" and "dedup" (separate tables,
``solvers/sgd.py::make_train_step``), "hybrid", "fused" (host or device
plans) and "sorted" (the fused record table); with several hybrid steps
per dispatch (``SGDConfig.steps_per_dispatch``: CUDA graphs on the card,
``utils/graphs.py``) and checkpointed, resumable training
(``checkpoint_dir``, ``utils/checkpoint.py::Checkpointer``); the sharded
path over a (data, model) mesh of ranks (``mesh``,
``parallel/sharded_sgd.py``, with :func:`evaluate_sharded`); and
``train_sgd_relational`` on block-structure data (``data/relational.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from sparkfm_tpu_torch.api import FMModel, _metrics
from sparkfm_tpu_torch.config import FMConfig, SGDConfig
from sparkfm_tpu_torch.data.batching import (SparseDataset, batch_iterator,
                                             prefetch)
from sparkfm_tpu_torch.models import fm as fm_model
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.parallel import mesh as M
from sparkfm_tpu_torch.solvers import sgd as sgd_solver
from sparkfm_tpu_torch.solvers import sgd_fused, sgd_hybrid, sgd_sorted
from sparkfm_tpu_torch.utils import device as device_util
from sparkfm_tpu_torch.utils import graphs, profiling
from sparkfm_tpu_torch.utils.checkpoint import (Checkpointer, LayoutMismatch,
                                                state_tensors)

log = logging.getLogger("sparkfm_tpu_torch")
PREFETCH_DEPTH = 2      # batches the background thread builds ahead


def evaluate(params: FMParams, cfg: FMConfig, ds: SparseDataset,
             batch_size: int = 8192) -> Dict[str, float]:
    """Full-dataset metrics on the parameters' device. Regression: rmse,
    mae. Classification: logloss, accuracy, auc. Big plain-FM tables
    score through host ladder plans, one unique-row gather per batch;
    small tables and FFM gather per slot (``FMModel.evaluate``). The
    parameters may carry the dedup path's extra fill row."""
    return FMModel(params=params, cfg=cfg).evaluate(ds, batch_size)


@dataclasses.dataclass
class TrainResult:
    """A run's parameters, per-epoch history records and examples per
    second; ``extras`` holds what a solver returns besides (MCMC: its
    posterior-mean scores and its last state)."""

    params: FMParams
    history: List[Dict[str, float]]
    examples_per_sec: float = 0.0
    extras: dict = dataclasses.field(default_factory=dict)


def _time_budget_reached(t0: float, max_seconds: float, epoch: int) -> bool:
    """The wall-clock budget (``SGDConfig.max_seconds``), checked at
    epoch boundaries: the epoch in flight always completes."""
    if max_seconds and (time.perf_counter() - t0) >= max_seconds:
        log.info("wall-clock budget max_seconds=%.3f reached after epoch "
                 "%d; stopping early", max_seconds, epoch)
        return True
    return False


def train_sgd(cfg: FMConfig, sgd_cfg: SGDConfig, train: SparseDataset,
              eval_ds: Optional[SparseDataset] = None,
              eval_every: int = 1,
              generator: Optional[torch.Generator] = None,
              hooks: Optional[List[Callable]] = None,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 1,
              resume: bool = True,
              mesh=None,
              init_params: Optional[FMParams] = None, *,
              device=device_util.DEFAULT) -> TrainResult:
    """SGD training on ``device`` (default: the card; without one it
    raises, ``utils/device.py``) through the train step of the update
    path that ``solvers/sgd.py::resolve_update_path`` picks, as the JAX
    trainer dispatches: "direct" or "dedup" on an ``SGDState`` (the dedup
    tables padded by one fill row, trimmed off the result), "hybrid",
    "fused" or "sorted" on a ``FusedState``.

    ``init_params`` warm-starts from a copy of given parameters on
    ``device``; otherwise V is drawn from ``generator`` (default: seeded
    from ``cfg.seed``). Batches are shuffled per epoch with the JAX
    package's (seed, epoch) order, built in a background thread. The
    hybrid path, and the dedup and fused paths under ``host_plan=True``,
    get host ladder plans (or plans of ``SGDConfig.unique_budget``) with
    them; the direct and sorted paths, and the dedup and fused paths under
    ``host_plan=False``, build their plans on the device. Each history
    record holds the epoch's mean ``train_loss`` (in float64),
    its ``unique_overflow_steps`` on every path but "direct" (whose plans
    cannot overflow) and, every ``eval_every`` epochs and after the last,
    ``eval_*`` metrics of ``eval_ds``. ``hooks`` are called as
    ``hook(epoch, state, record)``.

    On the hybrid path ``SGDConfig.steps_per_dispatch`` = G > 1 groups
    consecutive batches whose plans share a ladder rung and runs each
    full group by ``sgd_hybrid.make_hybrid_multi_step``: on the card one
    CUDA graph of G steps per rung, captured at the rung's first group,
    whose static inputs are filled from batches that the background
    thread copies through pinned memory (``batch_iterator(pinned=True)``);
    tails and rung changes run single.
    A group's ``loss_mean`` is logged once for each of its steps, as the
    JAX trainer does. The steps are those of G = 1, so the tables and
    histories equal G = 1's bit for bit (the epoch mean in float64: for G
    a power of two, a group's mean logged G times sums exactly to its
    steps' losses). The other paths run one step at a time for any G.

    With ``checkpoint_dir`` the state is saved (``Checkpointer``) every
    ``checkpoint_every`` epochs, after the last one and when
    ``SGDConfig.max_seconds`` stops the run, with the epoch and the
    history. With ``resume`` and a checkpoint there, training restores it
    into the state's own tensors (before any graph is captured) and goes
    on at the next epoch with the same (seed, epoch)-keyed batch order, so
    a resumed run equals an uninterrupted one bit for bit. A checkpoint of
    another state layout (another update path) raises ``ValueError``; a
    missing or corrupt file raises as itself.

    ``examples_per_sec`` leaves out the first dispatch, its time and its
    examples (kernel builds, warm-up, the first graph's capture), as the
    JAX trainer leaves out its compile; a capture for a rung first met
    later is counted. The epoch loop is :func:`run_epochs`.

    ``mesh`` (a ``DeviceMesh`` from ``parallel/mesh.py``, a ``MeshConfig``,
    whose ``exchange`` is honoured, or "DxM") trains sharded on this rank:
    :func:`_train_sgd_sharded`. Every rank of the mesh makes the
    same call.
    """
    if mesh is not None:
        if init_params is not None:
            raise ValueError("init_params warm start is single-device for "
                             "now")
        return _train_sgd_sharded(
            cfg, sgd_cfg, train, eval_ds, eval_every, generator, hooks,
            checkpoint_dir, checkpoint_every, resume, mesh, device)
    path = sgd_solver.resolve_update_path(cfg, sgd_cfg)
    device = device_util.resolve(device)
    if init_params is not None and (init_params.v.shape[0]
                                    != cfg.num_features):
        raise ValueError(
            f"init_params table has {init_params.v.shape[0]} rows != "
            f"num_features {cfg.num_features}")
    if path in ("hybrid", "fused", "sorted"):
        if init_params is not None:
            state = sgd_fused.fused_from_params(init_params, cfg,
                                                device=device)
        else:
            state = sgd_fused.init_fused_state(cfg, generator, device=device)
        step_fn = {"hybrid": sgd_hybrid.make_hybrid_train_step,
                   "fused": sgd_fused.make_fused_train_step,
                   "sorted": sgd_sorted.make_sorted_train_step}[path](
                       cfg, sgd_cfg)

        def get_params(s):
            return sgd_fused.params_from_fused(s, cfg)
    else:
        step_fn = sgd_solver.make_train_step(cfg, sgd_cfg)
        if init_params is not None:
            params = FMParams(*(t.detach().to(device=device, copy=True)
                                for t in (init_params.w0, init_params.w,
                                          init_params.v)))
        else:
            params = fm_model.init_params(cfg, generator, device=device)
        state = sgd_solver.init_state(params, optimizer=sgd_cfg.optimizer)
        if path == "dedup":
            state = sgd_solver.pad_state_for_dedup(state)

        def get_params(s):
            return s.params

    dedup_budget = None
    if sgd_cfg.host_plan and path in ("dedup", "fused", "hybrid"):
        # unique_budget=0 -> the ladder: each plan sized to its batch's
        # unique count rounded to a rung; the fill id is the table's extra
        # last row
        dedup_budget = sgd_cfg.unique_budget or "ladder"
    group = (sgd_cfg.steps_per_dispatch
             if path == "hybrid" and sgd_cfg.steps_per_dispatch > 1 else 1)
    if group > 1:
        multi = sgd_hybrid.make_hybrid_multi_step(cfg, sgd_cfg)
        log.info("hybrid multi-step: %d steps a dispatch", group)

        def grouped(state, batches):
            if len(batches) < group:    # one batch, run as G = 1 runs it
                return state, graphs.run_steps(step_fn, state, batches)[0]
            state, aux = multi.run(state, batches)
            # the group's overflowed steps, as G single steps count them
            return state, dict(aux, unique_overflow=sum(
                bool(b.plan.overflow) for b in batches))

    def run_epoch(state, epoch, dispatch):
        batches = batch_iterator(
            train, sgd_cfg.batch_size, device=device,
            shuffle=sgd_cfg.shuffle_each_epoch, seed=cfg.seed,
            epoch=epoch, drop_remainder=False,
            dedup_budget=dedup_budget, dedup_fill=cfg.num_features,
            pinned=group > 1)
        if group == 1:
            return step_loop(state, step_fn, batches, dispatch)
        return step_loop(state, grouped, _groups(batches, group), dispatch,
                         steps=len)

    state, history, eps = run_epochs(
        state, sgd_cfg, train.num_examples, run_epoch, path=path,
        evaluate_state=None if eval_ds is None else (
            lambda s: evaluate(get_params(s), cfg, eval_ds,
                               sgd_cfg.batch_size)),
        eval_every=eval_every, hooks=hooks, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, resume=resume)
    return TrainResult(
        params=sgd_solver.trim_params(get_params(state), cfg.num_features),
        history=history, examples_per_sec=eps)


def _groups(batches: Iterable, group: int) -> Iterator[list]:
    """Consecutive ``batches`` of one signature (for ladder plans: one
    rung) in lists of ``group``; those left over where the signature
    changes or the batches end in lists of one."""
    buf, sig = [], None
    for b in batches:
        s = graphs.signature(graphs.batch_fields(b))
        if buf and s != sig:
            yield from ([x] for x in buf)
            buf = []
        buf.append(b)
        sig = s
        if len(buf) == group:
            yield buf
            buf = []
    yield from ([x] for x in buf)


def step_loop(state, step: Callable, batches: Iterable, dispatch: Callable,
              steps: Optional[Callable] = None):
    """An epoch's steps for :func:`run_epochs`' ``run_epoch``:
    ``batches`` are built ahead in a background thread, and each is one
    dispatch of ``step(state, batch) -> (state, aux)``, of
    ``steps(batch)`` steps (one without ``steps``). Returns ``(state,
    flags)``: the auxes' ``unique_overflow``, where they have one (a flag,
    or a number of overflowed steps)."""
    flags = []
    for batch in prefetch(batches, PREFETCH_DEPTH):
        def run(b=batch):
            nonlocal state
            state, aux = step(state, b)
            return aux
        aux = dispatch(run, 1 if steps is None else steps(batch))
        if "unique_overflow" in aux:
            flags.append(aux["unique_overflow"])
    return state, flags


def _rank_dir(checkpoint_dir: Optional[str], mesh) -> Optional[str]:
    """Each rank's own checkpoint directory under ``checkpoint_dir``."""
    if checkpoint_dir is None:
        return None
    return os.path.join(checkpoint_dir,
                        f"rank{M.axis_index(M.DATA_AXIS, mesh)}x"
                        f"{M.axis_index(M.MODEL_AXIS, mesh)}")


def _train_sgd_sharded(cfg: FMConfig, sgd_cfg: SGDConfig,
                       train: SparseDataset, eval_ds, eval_every, generator,
                       hooks, checkpoint_dir, checkpoint_every, resume, mesh,
                       device) -> TrainResult:
    """The sharded SGD epoch loop of this rank (JAX
    ``training/trainer.py::_train_sgd_sharded``).

    The exchange: ``MeshConfig.exchange`` when it pins one, else "global"
    with host plans and adagrad or sgd (one host plan over the whole
    global batch, built on every rank from the same batch; with the
    hybrid extras of ``stack_hybrid_extras`` for plain FM, float32,
    adagrad or sgd, no feature_groups: the per-shard backward is kernel
    B3), else "unique" (device plans) or "dense" (adam, momentum). A
    pinned "unique" with host plans takes stacked per-shard plans. The
    plans' ladder rungs and the extras' u_cap only grow, and are sized
    from the global batch, so every rank agrees on them.

    Every rank draws the same (seed, epoch) batch order and keeps its data
    coordinate's rows (``multihost.global_batch``). Checkpoints go to one
    directory per rank under ``checkpoint_dir``; the time budget stops
    all ranks after the same epoch. Evals score each rank's rows and
    gather the scores, so every rank reports the same metrics. Returns
    the whole parameters, trimmed to ``cfg.num_features``, on every
    rank."""
    from sparkfm_tpu_torch.parallel import multihost as MH
    from sparkfm_tpu_torch.parallel import sharded_sgd as S

    mesh, exchange_pref = M.resolve_mesh(mesh, device=device)
    d_shards = M.size(mesh, M.DATA_AXIS)
    if sgd_cfg.batch_size % d_shards:
        raise ValueError(f"batch_size={sgd_cfg.batch_size} not divisible by "
                         f"data axis size {d_shards}")
    ffm = cfg.num_fields > 0
    unique = (sgd_cfg.optimizer in ("adagrad", "sgd")
              and sgd_cfg.momentum == 0)
    if exchange_pref == "auto":
        use_global = sgd_cfg.host_plan and unique
        exchange = "global" if use_global else "auto"
    else:
        exchange = exchange_pref
        use_global = exchange == "global"
        if use_global and not sgd_cfg.host_plan:
            raise ValueError("exchange='global' requires host_plan=True "
                             "(it consumes a host dedup plan)")
    state, pcfg = S.init_sharded_state(cfg, mesh, generator,
                                       optimizer=sgd_cfg.optimizer)
    step_fn = S.make_sharded_train_step(pcfg, sgd_cfg, mesh, exchange)
    score_fn = S.make_sharded_score_fn(pcfg, mesh)
    fill = pcfg.num_features - 1
    global_hybrid = use_global and S.hybrid_eligible(cfg, sgd_cfg)
    stacked_budget = None
    if use_global:
        plan_cap = E.auto_budget(sgd_cfg.batch_size * train.max_nnz)
        log.info("mesh path: exchange=global backward=%s",
                 "hybrid (kernel B3 per shard, one psum)" if global_hybrid
                 else "autograd")
    elif exchange == "unique" and sgd_cfg.host_plan:
        stacked_budget = sgd_cfg.unique_budget or E.auto_budget(
            (sgd_cfg.batch_size // d_shards) * train.max_nnz)
        log.info("mesh path: exchange=unique (stacked host plans)")
    else:
        log.info("mesh path: exchange=%s",
                 S.resolve_exchange(sgd_cfg, exchange))
    rung = [1]          # the global plan's ladder rung, only growing
    u_cap = [1]         # the hybrid extras' per-shard cap, only growing

    def lift(batch):
        ids = np.asarray(batch.ids)
        if stacked_budget is not None:
            plan = E.stack_plans(ids, d_shards, stacked_budget, fill)
            return MH.global_batch(mesh, batch, ffm, plan, "stacked")
        if not use_global:
            return MH.global_batch(mesh, batch, ffm)
        if sgd_cfg.unique_budget:
            hp = E.host_dedup(ids, sgd_cfg.unique_budget, fill)
        else:
            hp = E.host_dedup(ids, plan_cap, fill)
            rung[0] = max(rung[0], E.ladder_budget(int(hp.count),
                                                   cap=plan_cap))
            hp = hp._replace(uids=hp.uids[:rung[0]])
        plan = hp._replace(order=None, seg=None, svals=None, sex=None)
        if not global_hybrid:
            return MH.global_batch(mesh, batch, ffm, plan, "global")
        seg, svals, sex, gmap, u_cap[0] = E.stack_hybrid_extras(
            np.asarray(hp.ranks), np.asarray(batch.vals), d_shards,
            u_cap=u_cap[0])
        plan = plan._replace(order=gmap, seg=seg, svals=svals, sex=sex)
        return MH.global_batch(mesh, batch, ffm, plan, "global_hybrid")

    def run_epoch(state, epoch, dispatch):
        batches = batch_iterator(train, sgd_cfg.batch_size, device="cpu",
                                 shuffle=sgd_cfg.shuffle_each_epoch,
                                 seed=cfg.seed, epoch=epoch,
                                 drop_remainder=False)
        return step_loop(state, step_fn, map(lift, batches), dispatch)

    state, history, eps = run_epochs(
        state, sgd_cfg, train.num_examples, run_epoch,
        path=f"sharded {exchange}",
        evaluate_state=None if eval_ds is None else (
            lambda s: evaluate_sharded(s.params, pcfg, eval_ds, mesh,
                                       score_fn, sgd_cfg.batch_size)),
        eval_every=eval_every, hooks=hooks,
        checkpoint_dir=_rank_dir(checkpoint_dir, mesh),
        checkpoint_every=checkpoint_every, resume=resume,
        stop_together=lambda stop: M.any_rank(stop, mesh))
    return TrainResult(params=S.trimmed_params(state, mesh, cfg.num_features),
                       history=history, examples_per_sec=eps)


def evaluate_sharded(params: FMParams, pcfg: FMConfig, ds: SparseDataset,
                     mesh, score_fn, batch_size: int = 8192
                     ) -> Dict[str, float]:
    """:func:`evaluate` on a mesh: each rank scores its rows of every
    batch with the sharded ``score_fn`` from its row-sharded ``params``;
    the scores are gathered over ``data``, so every rank computes the
    same metrics."""
    from sparkfm_tpu_torch.parallel import multihost as MH
    scores = []
    for b in batch_iterator(ds, batch_size, device="cpu"):
        gb = MH.global_batch(mesh, b, pcfg.num_fields > 0)
        s = score_fn(params, gb.ids, gb.vals, gb.field_ids)
        n_valid = int(b.mask.sum())
        scores.append(MH.collect(s, mesh, M.DATA_AXIS)[:n_valid])
    scores = np.concatenate(scores)
    return _metrics(scores, ds.y[:len(scores)], pcfg.task)


def train_sgd_relational(cfg: FMConfig, sgd_cfg: SGDConfig, train,
                         eval_ds=None, eval_every: int = 1,
                         generator: Optional[torch.Generator] = None, *,
                         device=device_util.DEFAULT) -> TrainResult:
    """SGD on a block-structure ``data/relational.py::RelationalDataset``
    on ``device`` (default: the card; without one it raises): the
    relation tables are copied to the device once and joined to each
    batch there (``compose_batch``), and the step is the "direct" or
    "dedup" step of ``relational_update_path`` ("auto": direct below 2^16
    features, dedup on device plans from 2^16 up, where the JAX package
    raises). V is drawn from ``generator`` (default: seeded from
    ``cfg.seed``). Each history record holds the epoch's mean
    ``train_loss`` and, every ``eval_every`` epochs and after the last,
    ``eval_*`` metrics of ``eval_ds``: a RelationalDataset (materialized
    once) or a SparseDataset. The epoch loop is :func:`run_epochs`."""
    from sparkfm_tpu_torch.data import relational as R

    device = device_util.resolve(device)
    path = R.relational_update_path(cfg, sgd_cfg)
    step_fn = R.make_relational_train_step(cfg, sgd_cfg)
    state = sgd_solver.init_state(
        fm_model.init_params(cfg, generator, device=device),
        optimizer=sgd_cfg.optimizer)
    if path == "dedup":
        state = sgd_solver.pad_state_for_dedup(state)
    tables = R.tables_to_device(train.tables, device=device)
    if eval_ds is not None and hasattr(eval_ds, "materialize"):
        eval_ds = eval_ds.materialize()

    def run_epoch(state, epoch, dispatch):
        batches = R.relational_batch_iterator(
            train, sgd_cfg.batch_size, device=device,
            shuffle=sgd_cfg.shuffle_each_epoch, seed=cfg.seed, epoch=epoch)
        return step_loop(state, lambda s, b: step_fn(s, b, tables), batches,
                         dispatch)

    state, history, eps = run_epochs(
        state, sgd_cfg, train.num_examples, run_epoch, path=path,
        evaluate_state=None if eval_ds is None else (
            lambda s: evaluate(s.params, cfg, eval_ds, sgd_cfg.batch_size)),
        eval_every=eval_every, record_overflows=False)
    return TrainResult(
        params=sgd_solver.trim_params(state.params, cfg.num_features),
        history=history, examples_per_sec=eps)


def run_epochs(state, sgd_cfg: SGDConfig, num_examples: int,
               run_epoch: Callable, *, path: str,
               evaluate_state: Optional[Callable] = None,
               eval_every: int = 1, hooks: Optional[List[Callable]] = None,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 1, resume: bool = True,
               record_overflows: bool = True,
               stop_together: Optional[Callable[[bool], bool]] = None):
    """The epoch loop that :func:`train_sgd` and
    ``models/deepfm.py::train_deepfm`` share: resume, the epochs, their
    history records and evals, the time budget, the checkpoints and the
    examples-per-second count.

    ``run_epoch(state, epoch, dispatch)`` runs one epoch's steps of
    ``num_examples`` examples and returns ``(state, flags)``, ``flags``
    the steps' plan overflow indicators (bools or 0-d tensors, or for a
    dispatch of several steps the number that overflowed). It runs
    each dispatch as ``dispatch(run, n)``: ``run()`` takes n steps and
    returns their aux, whose ``loss`` (n = 1) or ``loss_mean`` (n > 1) is
    logged once a step; ``dispatch`` returns the aux. A record holds the
    epoch's mean ``train_loss`` (in float64), its
    ``unique_overflow_steps`` when ``record_overflows`` and it has flags,
    and, every ``eval_every`` epochs and after the last, ``eval_*``
    metrics from ``evaluate_state(state)`` (None: no evals). ``hooks``
    are called as ``hook(epoch, state, record)``.

    With ``checkpoint_dir`` the state is saved every ``checkpoint_every``
    epochs, after the last one and when ``SGDConfig.max_seconds`` stops
    the run, with the epoch and the history. With ``resume`` and a
    checkpoint there, it is restored into the state's own tensors and the
    loop goes on at the next epoch; a checkpoint of another state layout
    (another update ``path``) raises ``ValueError``, a missing or corrupt
    file raises as itself. On a mesh, ``stop_together`` turns each rank's
    time-budget verdict into one that every rank shares (any rank's), so
    no rank stops while the others wait in a collective.

    ``examples_per_sec`` leaves out the first dispatch, its time and its
    examples (kernel builds, warm-up, a first graph capture), as the JAX
    trainer leaves out its compile; a run of one dispatch counts it.
    Returns ``(state, history, examples_per_sec)``.

    Spans (``utils/profiling.py::annotate``): each ``run()`` is
    ``train.dispatch``; what follows an epoch's steps (its loss mean and
    overflow count, the eval, the hooks, the checkpoint) is
    ``train.epoch_end``.
    """
    history: List[Dict[str, float]] = []
    start_epoch = 0
    ckpt = None
    if checkpoint_dir is not None:
        ckpt = Checkpointer(checkpoint_dir)
        if resume and ckpt.latest_step() is not None:
            try:
                saved, extra = ckpt.restore(template=state)
            except LayoutMismatch as e:
                raise ValueError(
                    f"the checkpoint at {checkpoint_dir} holds another "
                    f"state layout than the {path!r} update path's: it was "
                    "probably written under another update_path. Pin "
                    "SGDConfig.update_path to the path that wrote it, or "
                    "start afresh with resume=False") from e
            for dst, src in zip(state_tensors(state).values(),
                                state_tensors(saved).values()):
                dst.copy_(src)
            del saved
            start_epoch = int(extra.get("epoch", -1)) + 1
            history = list(extra.get("history", []))
            log.info("resumed from %s at epoch %d", checkpoint_dir,
                     start_epoch)

    n_examples = 0
    warmup = None           # (seconds, examples) of the first dispatch
    t0 = time.perf_counter()
    try:
        for epoch in range(start_epoch, sgd_cfg.epochs):
            losses = []     # per step, float64

            def dispatch(run, n):
                nonlocal warmup
                tw = time.perf_counter() if warmup is None else None
                with profiling.annotate("train.dispatch"):
                    aux = run()
                if tw is not None:
                    float(aux["loss"])  # waits for the dispatch to end
                    warmup = (time.perf_counter() - tw,
                              min(n * sgd_cfg.batch_size, num_examples))
                if n == 1:
                    losses.append(aux["loss"].double())
                else:
                    losses.extend([aux["loss_mean"]] * n)
                return aux

            state, flags = run_epoch(state, epoch, dispatch)
            n_examples += num_examples
            with profiling.annotate("train.epoch_end"):
                rec = {"epoch": epoch,
                       "train_loss": float(torch.stack(losses).mean())}
                on = next((f.device for f in flags if torch.is_tensor(f)),
                          None)
                overflows = int(torch.stack(
                    [torch.as_tensor(f, device=on) for f in flags]).sum()
                ) if flags else 0
                if flags and record_overflows:
                    rec["unique_overflow_steps"] = overflows
                if overflows:
                    log.warning(
                        "epoch %d: %d step(s) overflowed the unique-id "
                        "budget (updates aliased); raise "
                        "SGDConfig.unique_budget", epoch, overflows)
                if evaluate_state is not None and (
                        epoch % eval_every == 0
                        or epoch == sgd_cfg.epochs - 1):
                    rec.update({f"eval_{k}": v
                                for k, v in evaluate_state(state).items()})
                history.append(rec)
                log.info("epoch %d: %s", epoch,
                         " ".join(f"{k}={v:.5f}" for k, v in rec.items()
                                  if k != "epoch"))
                if hooks:
                    for h in hooks:
                        h(epoch, state, rec)
                stop = _time_budget_reached(t0, sgd_cfg.max_seconds, epoch)
                if stop_together is not None:
                    stop = stop_together(stop)
                if ckpt is not None and ((epoch + 1) % checkpoint_every == 0
                                         or epoch == sgd_cfg.epochs - 1
                                         or stop):
                    ckpt.save(epoch, state,
                              extra={"epoch": epoch, "history": history})
            if stop:
                break
    finally:
        if ckpt is not None:
            ckpt.close()
    elapsed = time.perf_counter() - t0
    if warmup is not None and n_examples > warmup[1]:
        elapsed -= warmup[0]
        n_examples -= warmup[1]
    return state, history, n_examples / max(elapsed, 1e-9)
