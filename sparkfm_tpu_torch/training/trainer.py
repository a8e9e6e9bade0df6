"""Training loop: SGD epochs with per-epoch loss and evaluation. Port of
``sparkfm_tpu/training/trainer.py`` (``train_sgd``, ``evaluate``,
``TrainResult``) for one device, on the update paths the port has:
"hybrid", "fused" (host or device plans) and "sorted".

Not ported yet, and raising ``NotImplementedError`` when asked for: the
sharded mesh path (``mesh``, ROADMAP A15), checkpointed training
(``checkpoint_dir``, ROADMAP A5) and several hybrid steps per dispatch
(``SGDConfig.steps_per_dispatch`` on the hybrid path, ROADMAP A3; the
other paths run their steps one by one for any value, as the JAX trainer
does).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional

import torch

from sparkfm_tpu_torch.api import FMModel
from sparkfm_tpu_torch.config import FMConfig, SGDConfig
from sparkfm_tpu_torch.data.batching import (SparseDataset, batch_iterator,
                                             prefetch)
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.solvers import sgd as sgd_solver
from sparkfm_tpu_torch.solvers import sgd_fused, sgd_hybrid, sgd_sorted

log = logging.getLogger("sparkfm_tpu_torch")


def evaluate(params: FMParams, cfg: FMConfig, ds: SparseDataset,
             batch_size: int = 8192) -> Dict[str, float]:
    """Full-dataset metrics on the parameters' device. Regression: rmse,
    mae. Classification: logloss, accuracy, auc. Big plain-FM tables
    score through host ladder plans, one unique-row gather per batch
    (``FMModel.evaluate``)."""
    return FMModel(params=params, cfg=cfg).evaluate(ds, batch_size)


@dataclasses.dataclass
class TrainResult:
    params: FMParams
    history: List[Dict[str, float]]
    examples_per_sec: float = 0.0


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
              device) -> TrainResult:
    """SGD training on ``device`` through the train step of the update
    path that ``solvers/sgd.py::resolve_update_path`` picks, as the JAX
    trainer dispatches: "hybrid", "fused" or "sorted".

    ``init_params`` warm-starts from given parameters (moved to
    ``device``); otherwise V is drawn from ``generator`` (default: seeded
    from ``cfg.seed``). Batches are shuffled per epoch with the JAX
    package's (seed, epoch) order, built in a background thread. The
    hybrid path, and the fused path under ``host_plan=True``, get host
    ladder plans (or plans of ``SGDConfig.unique_budget``) with them; the
    sorted path and the fused path under ``host_plan=False`` build their
    plans on the device. Each
    history record holds the epoch's mean ``train_loss``, its
    ``unique_overflow_steps`` and, every ``eval_every`` epochs and after
    the last, ``eval_*`` metrics of ``eval_ds``. ``hooks`` are called as
    ``hook(epoch, state, record)``. ``examples_per_sec`` leaves out the
    first step (kernel builds, warm-up), as the JAX trainer leaves out
    its compile.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the sharded mesh path is not ported yet (ROADMAP A15)")
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpointed training is not ported yet (ROADMAP A5)")
    del checkpoint_every, resume
    sgd_solver.check_supported(sgd_cfg)
    path = sgd_solver.resolve_update_path(cfg, sgd_cfg)
    sgd_solver.check_grouping(path, sgd_cfg)
    device = torch.device(device)
    if init_params is not None:
        if init_params.v.shape[0] != cfg.num_features:
            raise ValueError(
                f"init_params table has {init_params.v.shape[0]} rows != "
                f"num_features {cfg.num_features}")
        state = sgd_fused.fused_from_params(init_params, cfg, device=device)
    else:
        state = sgd_fused.init_fused_state(cfg, generator, device=device)
    step_fn = {"hybrid": sgd_hybrid.make_hybrid_train_step,
               "fused": sgd_fused.make_fused_train_step,
               "sorted": sgd_sorted.make_sorted_train_step}[path](cfg, sgd_cfg)
    dedup_budget = None
    if sgd_cfg.host_plan and path in ("fused", "hybrid"):
        # unique_budget=0 -> the ladder: each plan sized to its batch's
        # unique count rounded to a rung; the fill id is the table's extra
        # last row
        dedup_budget = sgd_cfg.unique_budget or "ladder"

    history: List[Dict[str, float]] = []
    n_examples = 0
    warmup = 0.0
    t0 = time.perf_counter()
    for epoch in range(sgd_cfg.epochs):
        losses = []
        flags = []          # overflow per step; device plans' on the card
        for batch in prefetch(batch_iterator(
                train, sgd_cfg.batch_size, device=device,
                shuffle=sgd_cfg.shuffle_each_epoch, seed=cfg.seed,
                epoch=epoch, drop_remainder=False,
                dedup_budget=dedup_budget, dedup_fill=cfg.num_features)):
            tw = time.perf_counter() if epoch == 0 and not losses else None
            state, aux = step_fn(state, batch)
            if tw is not None:
                float(aux["loss"])      # waits for the first step to end
                warmup = time.perf_counter() - tw
            losses.append(aux["loss"])
            flags.append(aux["unique_overflow"])
        n_examples += train.num_examples
        overflows = int(torch.stack([torch.as_tensor(f, device=device)
                                     for f in flags]).sum())
        rec = {"epoch": epoch,
               "train_loss": float(torch.stack(losses).mean()),
               "unique_overflow_steps": overflows}
        if overflows:
            log.warning(
                "epoch %d: %d step(s) overflowed the unique-id budget "
                "(updates aliased); raise SGDConfig.unique_budget",
                epoch, overflows)
        if eval_ds is not None and (epoch % eval_every == 0
                                    or epoch == sgd_cfg.epochs - 1):
            rec.update({f"eval_{k}": v for k, v in evaluate(
                sgd_fused.params_from_fused(state, cfg), cfg, eval_ds,
                sgd_cfg.batch_size).items()})
        history.append(rec)
        log.info("epoch %d: %s", epoch,
                 " ".join(f"{k}={v:.5f}" for k, v in rec.items()
                          if k != "epoch"))
        if hooks:
            for h in hooks:
                h(epoch, state, rec)
        if _time_budget_reached(t0, sgd_cfg.max_seconds, epoch):
            break
    elapsed = time.perf_counter() - t0 - warmup
    return TrainResult(
        params=sgd_solver.trim_params(sgd_fused.params_from_fused(state, cfg),
                                      cfg.num_features),
        history=history,
        examples_per_sec=n_examples / max(elapsed, 1e-9))
