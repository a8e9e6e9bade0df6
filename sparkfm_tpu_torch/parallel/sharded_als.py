"""Sharded ALS and MCMC: examples split over the ``data`` axis, parameters
replicated. Port of ``sparkfm_tpu/parallel/sharded_als.py`` onto
``torch.distributed``.

Each rank holds a contiguous slice of the examples as its own
feature-sorted CSC view, with local example rows. The sweep is the
reference sweep of one device (``solvers/als.py::als_sweep``,
``solvers/mcmc.py::mcmc_sweep_direct``) with a ``psum`` over ``data`` of
every per-feature sum (kernel B7 over the rank's view) and of the bias and
noise sums; every rank then makes the same coordinate updates (and, for
MCMC, the same draws from the same draw source), and patches its own
residual and q slices. The (F,) Σx² arrives divided by the data-axis size,
so that its psum puts it back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from sparkfm_tpu_torch.config import ALSConfig, FMConfig, MCMCConfig, Task
from sparkfm_tpu_torch.data.batching import SparseDataset
from sparkfm_tpu_torch.models import fm as fm_model
from sparkfm_tpu_torch.ops import segsum
from sparkfm_tpu_torch.parallel import mesh as M
from sparkfm_tpu_torch.solvers import als, mcmc
from sparkfm_tpu_torch.training.trainer import TrainResult


@dataclasses.dataclass
class ShardedWorkspace:
    """One rank's examples as the reference sweep reads them: y and mask
    (N/D,), the rank's feature-sorted CSC view col_feat / col_row (local
    example rows) / col_val (nnz/D,), block_of_feat (F,) and den_w (F,),
    the global Σx² divided by the data-axis size."""

    y: torch.Tensor
    mask: torch.Tensor
    col_feat: torch.Tensor
    col_row: torch.Tensor
    col_val: torch.Tensor
    block_of_feat: torch.Tensor
    den_w: torch.Tensor


def build_sharded_workspace(ds: SparseDataset, cfg: FMConfig,
                            als_cfg: ALSConfig, mesh) -> tuple:
    """(this rank's ShardedWorkspace, num_blocks). N is padded to a
    multiple of the data axis with masked empty examples; the rank's
    contiguous examples are sorted stably by feature into its CSC view.
    Every array equals the rank's shard of the JAX sharded workspace."""
    d = M.size(mesh, M.DATA_AXIS)
    n, l = ds.ids.shape
    n_pad = M.pad_to_multiple(n, d)
    f = cfg.num_features
    ids = np.zeros((n_pad, l), np.int32)
    vals = np.zeros((n_pad, l), np.float32)
    y = np.zeros((n_pad,), np.float32)
    mask = np.zeros((n_pad,), np.float32)
    ids[:n], vals[:n], y[:n], mask[:n] = ds.ids, ds.vals, ds.y, 1.0
    block_of_feat, num_blocks = als.feature_blocks_of(f, als_cfg)
    den_w = np.zeros((f,), np.float32)
    np.add.at(den_w, ids.reshape(-1), vals.reshape(-1) ** 2)
    sl = M.data_slice(n_pad, mesh)
    per = n_pad // d
    cf = ids[sl].reshape(-1)
    cr = np.repeat(np.arange(per, dtype=np.int32), l)
    cv = vals[sl].reshape(-1)
    order = np.argsort(cf, kind="stable")
    t = als.to_device(dict(
        y=y[sl], mask=mask[sl], col_feat=cf[order], col_row=cr[order],
        col_val=cv[order], block_of_feat=block_of_feat,
        den_w=den_w / np.float32(d)), M.device_of(mesh))
    return ShardedWorkspace(**t), num_blocks


def _allr(mesh):
    """The sweep's reduction: a psum over ``data``, in place."""
    def allr(t):
        if t.dim() == 0:
            return M.psum(t.reshape(1), M.DATA_AXIS, mesh)[0]
        return M.psum(t, M.DATA_AXIS, mesh)
    return allr


def make_sharded_sweep(cfg: FMConfig, num_blocks: int, mesh):
    """``sweep(params, ws) -> params``: one reference ALS sweep over the
    mesh, the parameters replicated."""
    reg_w, reg_v = cfg.reg_vectors()
    allr = _allr(mesh)
    dev = M.device_of(mesh)
    reg_w, reg_v = (torch.as_tensor(r, device=dev) for r in (reg_w, reg_v))

    def sweep(params, ws):
        return als.als_sweep(params, ws, num_blocks, cfg.num_features,
                             cfg.reg0, reg_w, reg_v, cfg.use_bias,
                             cfg.use_linear, allr=allr)
    return sweep


def _check_regression(cfg: FMConfig, what: str) -> None:
    if cfg.task != Task.REGRESSION:
        raise ValueError(f"{what} optimizes squared loss; use SGD for "
                         "classification")
    if cfg.num_fields > 0:
        raise ValueError(f"{what} supports plain FM (not FFM)")


def train_als_sharded(cfg: FMConfig, als_cfg: ALSConfig,
                      train: SparseDataset, mesh,
                      eval_ds: Optional[SparseDataset] = None,
                      eval_every: int = 1,
                      generator: Optional[torch.Generator] = None
                      ) -> TrainResult:
    """ALS over a (data, model) mesh: ``als_cfg.epochs`` sharded sweeps
    (the model axis holds copies). V is drawn from ``generator`` (default:
    seeded from ``cfg.seed``) on every rank alike. History records, evals
    (of the replicated parameters, on each rank) and ``max_seconds`` as
    ``train_als``; the budget stops every rank after the same sweep."""
    from sparkfm_tpu_torch.training.trainer import evaluate
    _check_regression(cfg, "ALS")
    dev = M.device_of(mesh)
    params = fm_model.init_params(cfg, generator, device=dev)
    ws, num_blocks = build_sharded_workspace(train, cfg, als_cfg, mesh)
    sweep = make_sharded_sweep(cfg, num_blocks, mesh)
    if dev.type == "cuda":
        segsum.COLSUMS.build()
    history = []
    n_examples = 0
    t0 = time.perf_counter()
    for epoch in range(als_cfg.epochs):
        params = sweep(params, ws)
        n_examples += train.num_examples
        rec = {"epoch": epoch}
        if eval_ds is not None and (epoch % eval_every == 0
                                    or epoch == als_cfg.epochs - 1):
            rec.update({f"eval_{k}": v for k, v in evaluate(
                params, cfg, eval_ds).items()})
        history.append(rec)
        if M.any_rank(bool(als_cfg.max_seconds) and time.perf_counter() - t0
                      >= als_cfg.max_seconds, mesh):
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    eps = n_examples / max(time.perf_counter() - t0, 1e-9)
    return TrainResult(params=params, history=history, examples_per_sec=eps)


def make_sharded_mcmc_sweep(cfg: FMConfig, mcmc_cfg: MCMCConfig,
                            num_blocks: int, mesh,
                            groups: Optional[torch.Tensor], num_groups: int):
    """``sweep(state, ws, draws) -> state``: one direct Gibbs sweep over
    the mesh (``mcmc.mcmc_sweep_direct`` with a psum over ``data``)."""
    allr = _allr(mesh)

    def sweep(state, ws, draws):
        return mcmc.mcmc_sweep_direct(
            state, ws, draws, num_blocks, cfg.num_features, groups=groups,
            num_groups=num_groups, alpha_0=mcmc_cfg.alpha_0,
            beta_0=mcmc_cfg.beta_0, alpha_l=mcmc_cfg.alpha_lambda,
            beta_l=mcmc_cfg.beta_lambda, mu_0=mcmc_cfg.mu_0,
            gamma_0=mcmc_cfg.gamma_0, use_bias=cfg.use_bias,
            use_linear=cfg.use_linear, allr=allr)
    return sweep


def train_mcmc_sharded(cfg: FMConfig, mcmc_cfg: MCMCConfig,
                       train: SparseDataset, mesh,
                       eval_ds: Optional[SparseDataset] = None,
                       generator: Optional[torch.Generator] = None, *,
                       draws=None) -> TrainResult:
    """Gibbs training over a (data, model) mesh, with ``train_mcmc``'s
    contract: the history's alpha, mean lam_w, and from ``burn_in`` on
    the posterior-mean and sample eval RMSE; ``extras`` holds
    ``avg_scores`` and the last ``mcmc_state``. Every rank draws from
    ``draws`` (default: ``mcmc.TorchDraws`` on ``generator``, seeded from
    ``cfg.seed`` on every rank alike), so the ranks hold the same chain.
    ``max_seconds`` stops every rank after the same sweep."""
    _check_regression(cfg, "MCMC-FM")
    dev = M.device_of(mesh)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    params = fm_model.init_params(cfg, generator, device=dev)
    if draws is None:
        draws = mcmc.TorchDraws(generator)
    ws, num_blocks = build_sharded_workspace(
        train, cfg, ALSConfig(block_size=mcmc_cfg.block_size,
                              feature_blocks=mcmc_cfg.feature_blocks), mesh)
    groups = (None if cfg.feature_groups is None
              else torch.as_tensor(np.asarray(cfg.feature_groups, np.int64),
                                   device=dev))
    sweep = make_sharded_mcmc_sweep(cfg, mcmc_cfg, num_blocks, mesh, groups,
                                    cfg.num_groups)
    if dev.type == "cuda":
        segsum.COLSUMS.build()
    state = mcmc.init_mcmc_state(params, cfg.num_groups)
    avg_scores = None
    n_avg = 0
    history = []
    n_examples = 0
    t0 = time.perf_counter()
    for epoch in range(mcmc_cfg.epochs):
        state = sweep(state, ws, draws)
        n_examples += train.num_examples
        rec = {"epoch": epoch, "alpha": float(state.alpha),
               "lam_w": float(state.lam_w.mean())}
        if eval_ds is not None and epoch >= mcmc_cfg.burn_in:
            s = mcmc.FMModel(params=state.params, cfg=cfg)._scores(
                eval_ds, mcmc.EVAL_BATCH)
            n_avg += 1
            avg_scores = (s if avg_scores is None
                          else avg_scores + (s - avg_scores) / n_avg)
            y = eval_ds.y[:len(avg_scores)]
            rec["eval_rmse_avg"] = float(
                np.sqrt(np.mean(np.square(avg_scores - y))))
            rec["eval_rmse_sample"] = float(
                np.sqrt(np.mean(np.square(s - y))))
        history.append(rec)
        if M.any_rank(bool(mcmc_cfg.max_seconds) and time.perf_counter() - t0
                      >= mcmc_cfg.max_seconds, mesh):
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    eps = n_examples / max(time.perf_counter() - t0, 1e-9)
    return TrainResult(params=state.params, history=history,
                       examples_per_sec=eps,
                       extras={"avg_scores": avg_scores,
                               "mcmc_state": state})
