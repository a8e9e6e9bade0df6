"""MCMC (Gibbs) solver: Bayesian FM with sampled hyperparameters, on one
device. Port of ``sparkfm_tpu/solvers/mcmc.py``.

The sweep is the compact ALS sweep (``solvers/als.py``) with draws in
place of minimizers:

- each coordinate is drawn from its conditional posterior,
  var = 1 / (alpha den + lambda_g), mean = var (alpha (theta den - num) +
  mu_g lambda_g), theta ~ N(mean, var), kept only where the draw is finite
  and the column is not empty; g is the parameter's group (w; each factor
  column of V, per attribute group);
- before the coordinates, the noise precision alpha and each group's
  lambda and mu are drawn from their conditionals (Rendle 2012, "Factorization
  Machines with libFM", sec. 4.3); w0 rides group 0 of w;
- Jacobi within a block, Gauss-Seidel across blocks with exact e/q
  patches, as ALS;
- the evaluation scores are averaged over the samples from ``burn_in``
  on: the posterior mean, as libFM reports it.

On the card every per-feature sum is kernel B7 (``ops/segsum.py::
segment_colsums``) over the feature-sorted CSC view in rank space: one
stream a w block (Σ e·x), two a (factor, block) (Σ e·h, Σ h² with h = x (q
- x v)). Per-example sums are column sums of the (L, N) slot view, and the
hyperprior sums over all F features (absent ones too, as in the JAX sweep)
are plain reductions, per group over the features sorted by group. No sum
uses atomic adds, so two sweeps from one state and one draw source give
the same bits.

The draws come from a source with ``normal(shape)`` (standard normals)
and ``gamma(shape_param)`` (standard Gamma variates, one per entry of the
shape parameter): :class:`TorchDraws` on a ``torch.Generator`` by default,
replaceable by a test. The sweep asks in the JAX sweep's order and shapes:
gamma for alpha, gamma for lambda_w, normal (G,) for mu_w, gamma for
lambda_v, normal (G, K) for mu_v, normal () for w0, one normal (F,) per w
block and one normal (F,) per (factor, block); each (F,) draw is read at
the present features.

One divergence from the JAX sweep, on purpose: lambda_v's shape parameter
is (G, K), one independent Gamma variate per factor column, as libFM draws
them. The JAX sweep passes a (G, 1) shape parameter and divides the one
draw by a (G, K) rate, so the K columns of a group share it
(``sparkfm_tpu/solvers/mcmc.py:194-195``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from sparkfm_tpu_torch.api import FMModel
from sparkfm_tpu_torch.config import ALSConfig, FMConfig, MCMCConfig, Task
from sparkfm_tpu_torch.data.batching import SparseDataset
from sparkfm_tpu_torch.models import fm as fm_model
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import segsum
from sparkfm_tpu_torch.solvers import als
from sparkfm_tpu_torch.training.trainer import TrainResult
from sparkfm_tpu_torch.utils import device as device_util

EVAL_BATCH = 8192       # the JAX trainer's eval batch


@dataclasses.dataclass
class MCMCState:
    """Parameters and sampled hyperparameters: alpha () the noise
    precision; lam_w, mu_w (G,) the linear priors per attribute group;
    lam_v, mu_v (G, K) the priors per (group, factor column). G = 1 without
    ``feature_groups``."""

    params: FMParams
    alpha: torch.Tensor
    lam_w: torch.Tensor
    mu_w: torch.Tensor
    lam_v: torch.Tensor
    mu_v: torch.Tensor


def init_mcmc_state(params: FMParams, num_groups: int = 1) -> MCMCState:
    """alpha = 1, lambdas 1, means 0, on the parameters' device."""
    k, g, dev = params.v.shape[-1], num_groups, params.device
    return MCMCState(params=params,
                     alpha=torch.ones((), device=dev),
                     lam_w=torch.ones((g,), device=dev),
                     mu_w=torch.zeros((g,), device=dev),
                     lam_v=torch.ones((g, k), device=dev),
                     mu_v=torch.zeros((g, k), device=dev))


def mcmc_state_from_numpy(w0, w, v, alpha, lam_w, mu_w, lam_v, mu_v, *,
                          device) -> MCMCState:
    """A JAX ``MCMCState`` carried into the port from its arrays as numpy
    (``np.asarray(state.alpha)``, ...): copies on ``device``."""
    def t(x):
        return torch.as_tensor(np.array(x, np.float32, copy=True),
                               device=device)
    return MCMCState(params=fm_model.params_from_numpy(w0, w, v,
                                                       device=device),
                     alpha=t(alpha), lam_w=t(lam_w), mu_w=t(mu_w),
                     lam_v=t(lam_v), mu_v=t(mu_v))


class TorchDraws:
    """The sweep's default draw source: standard normals and standard
    Gamma variates from ``generator``, on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.generator.device)

    def gamma(self, shape_param: torch.Tensor) -> torch.Tensor:
        return torch._standard_gamma(shape_param, generator=self.generator)


class _Groups:
    """Per-group sums over all F features with no atomic adds: the
    features sorted by group once, then one reduction a group (G = 1: one
    reduction). ``count`` (G,) f32 is the features of each group."""

    def __init__(self, groups: Optional[torch.Tensor], num_groups: int,
                 num_features: int, device):
        if groups is None or num_groups == 1:
            self.of_feat = self.order = None
            self.sizes = [num_features]
        else:
            self.of_feat = groups.to(device=device, dtype=torch.long)
            self.order = torch.argsort(self.of_feat, stable=True)
            self.sizes = np.bincount(groups.cpu().numpy(),
                                     minlength=num_groups).tolist()
        self.count = torch.tensor(self.sizes, dtype=torch.float32,
                                  device=device)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """(F, ...) -> (G, ...) sums per group."""
        if self.order is None:
            return x.sum(0, keepdim=True)
        xs = x.index_select(0, self.order)
        return torch.stack([part.sum(0) for part in xs.split(self.sizes)])

    def spread(self, per_group: torch.Tensor) -> torch.Tensor:
        """(G, ...) -> (F, ...) each feature's group entry; with one group
        the (1, ...) row itself, which broadcasts."""
        if self.of_feat is None:
            return per_group
        return per_group.index_select(0, self.of_feat)


def _draw_theta(theta, num, den, alpha, lam, mu, noise):
    """A draw from the coordinate's conditional posterior, kept only where
    it is finite and the column is not empty (den > 0)."""
    var = 1.0 / (alpha * den + lam)
    mean = var * (alpha * (theta * den - num) + mu * lam)
    draw = mean + torch.sqrt(var) * noise
    return torch.where(torch.isfinite(draw) & (den > 0), draw, theta)


def _draw_priors(state: MCMCState, draws, grp: "_Groups", n_valid,
                 sum_e2, alpha_0, beta_0, alpha_l, beta_l, mu_0,
                 gamma_0) -> tuple:
    """(alpha, lam_w, mu_w, lam_v, mu_v): the noise precision from the
    valid example count ``n_valid`` and Σe² (0-d tensors), then each
    group's priors over all F features, w0 in group 0 of w, one Gamma
    variate per (group, factor column); drawn in the JAX sweep's order."""
    params = state.params
    G, k = grp.count.shape[0], params.v.shape[1]
    dev = params.device
    alpha = draws.gamma(alpha_0 + 0.5 * n_valid) / (beta_0 + 0.5 * sum_e2)

    w0_onehot = torch.zeros((G,), device=dev)
    w0_onehot[0] = 1.0
    p_w = grp.count + w0_onehot
    sum_w_g = grp.sum(params.w) + w0_onehot * params.w0
    mu_w_mean = (sum_w_g + gamma_0 * mu_0) / (p_w + gamma_0)
    ssq_w = (grp.sum((params.w - grp.spread(state.mu_w)).square())
             + w0_onehot * (params.w0 - state.mu_w[0]).square()
             + gamma_0 * (state.mu_w - mu_0).square())
    lam_w = (draws.gamma(alpha_l + 0.5 * (p_w + 1))
             / (beta_l + 0.5 * ssq_w))
    mu_w = (mu_w_mean + draws.normal((G,))
            * torch.rsqrt((p_w + gamma_0) * lam_w))

    cnt = grp.count[:, None]
    mu_v_mean = (grp.sum(params.v) + gamma_0 * mu_0) / (cnt + gamma_0)
    ssq_v = (grp.sum((params.v - grp.spread(state.mu_v)).square())
             + gamma_0 * (state.mu_v - mu_0).square())
    lam_v = (draws.gamma((alpha_l + 0.5 * (cnt + 1)).expand(G, k)
                         .contiguous())
             / (beta_l + 0.5 * ssq_v))
    mu_v = (mu_v_mean + draws.normal((G, k))
            * torch.rsqrt((cnt + gamma_0) * lam_v))
    return alpha, lam_w, mu_w, lam_v, mu_v


def mcmc_sweep(state: MCMCState, ws: als.ALSWorkspace, draws,
               num_blocks: int, num_features: int,
               groups: Optional[torch.Tensor] = None, num_groups: int = 1,
               alpha_0: float = 1.0, beta_0: float = 1.0,
               alpha_l: float = 1.0, beta_l: float = 1.0,
               mu_0: float = 0.0, gamma_0: float = 1.0,
               use_bias: bool = True, use_linear: bool = True,
               column_pure: bool = False, csc_uniform: bool = False,
               slice_identity: tuple = ()) -> MCMCState:
    """One Gibbs sweep: the hyperparameters, w0, every w block, every
    (factor, block), with exact e/q patches between blocks. Returns a new
    state; ``state`` is not changed.

    ``draws`` is the draw source (:class:`TorchDraws` or a test's);
    ``groups`` an (F,) int tensor of attribute-group ids (None: one
    group); ``column_pure``, ``csc_uniform`` and ``slice_identity`` select
    the faster forms of the same sums (``als.BlockViews``): each block's
    sums then cover only its CSC run, which leaves every kept draw as it
    is, since a draw outside the block is thrown away."""
    params = state.params
    F, G = num_features, num_groups
    dev = params.device
    k = params.v.shape[1]
    n = ws.y.shape[0]
    views = als.BlockViews(n, column_pure, csc_uniform, slice_identity)
    csc = views.csc
    present = ws.present
    n_ranks = present.shape[0]
    rank_csr, vals_csr = ws.slot_rank, ws.slot_val
    vals_sq = vals_csr.square()
    col_row, x, col_rank = ws.col_row, ws.col_val, ws.col_rank
    w_c = params.w.index_select(0, present)
    v_t = params.v.index_select(0, present).t().contiguous()    # (K, Fp)
    den_w_c = ws.den_w.index_select(0, present)
    block_c = ws.block_of_feat.index_select(0, present)
    in_block = [block_c == b for b in range(num_blocks)]

    score, q_bank = als.compact_forward(ws, params.w0, w_c, v_t, use_bias,
                                        use_linear)
    e = score - ws.y

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    grp = _Groups(groups, G, F, dev)
    alpha, lam_w, mu_w, lam_v, mu_v = _draw_priors(
        state, draws, grp, scalar(float(n)), e.square().sum(), alpha_0,
        beta_0, alpha_l, beta_l, mu_0, gamma_0)

    # the priors at each present feature's group
    if grp.of_feat is None:
        lam_w_c, mu_w_c, lam_v_c, mu_v_c = lam_w[0], mu_w[0], lam_v, mu_v
    else:
        g_c = grp.of_feat.index_select(0, present)
        lam_w_c, mu_w_c, lam_v_c, mu_v_c = (
            t.index_select(0, g_c) for t in (lam_w, mu_w, lam_v, mu_v))

    def noise_at_present():
        return draws.normal((F,)).index_select(0, present)

    w0_new = params.w0.clone()
    if use_bias:
        w0_new = _draw_theta(params.w0, e.sum(), scalar(float(n)), alpha,
                             lam_w[0], mu_w[0], draws.normal(()))
        e = e + (w0_new - params.w0)

    if use_linear:
        for b in range(num_blocks):
            noise = noise_at_present()
            num = segsum.segment_colsums(
                [views.to_csc(e, col_row, b) * csc(x, b)],
                csc(col_rank, b), n_ranks)[:, 0]
            theta = _draw_theta(w_c, num, den_w_c, alpha, lam_w_c, mu_w_c,
                                noise)
            delta = torch.where(in_block[b], theta - w_c, 0.0)
            e = e + views.patch(delta, rank_csr, vals_csr, b)
            w_c = w_c + delta

    for f in range(k):
        vf, q = v_t[f], q_bank[f]
        lam_f, mu_f = lam_v_c[:, f], mu_v_c[:, f]
        for b in range(num_blocks):
            noise = noise_at_present()
            xb, rb = csc(x, b), csc(col_rank, b)
            h = xb * (views.to_csc(q, col_row, b)
                      - xb * vf.index_select(0, rb))
            sums = segsum.segment_colsums(
                [views.to_csc(e, col_row, b) * h, h * h], rb, n_ranks)
            theta = _draw_theta(vf, sums[:, 0], sums[:, 1], alpha, lam_f,
                                mu_f, noise)
            delta = torch.where(in_block[b], theta - vf, 0.0)
            vf_new = vf + delta
            dsq = torch.where(in_block[b], vf_new.square() - vf.square(), 0.0)
            q_new = q + views.patch(delta, rank_csr, vals_csr, b)
            e = (e + 0.5 * (q_new.square() - q.square())
                 - 0.5 * views.patch(dsq, rank_csr, vals_sq, b))
            vf, q = vf_new, q_new
        v_t[f] = vf

    new = als.scatter_compact(params, present, w0_new,
                              w_c if use_linear else None, v_t)
    return MCMCState(params=new, alpha=alpha, lam_w=lam_w, mu_w=mu_w,
                     lam_v=lam_v, mu_v=mu_v)


def mcmc_sweep_direct(state: MCMCState, ws, draws, num_blocks: int,
                      num_features: int,
                      groups: Optional[torch.Tensor] = None,
                      num_groups: int = 1, alpha_0: float = 1.0,
                      beta_0: float = 1.0, alpha_l: float = 1.0,
                      beta_l: float = 1.0, mu_0: float = 0.0,
                      gamma_0: float = 1.0, use_bias: bool = True,
                      use_linear: bool = True, allr=None) -> MCMCState:
    """:func:`mcmc_sweep` in the direct form of the JAX sweep
    (``sparkfm_tpu/solvers/mcmc.py::mcmc_sweep``) and of
    ``als.als_sweep``: per-feature state in the full F space, per-feature
    sums by kernel B7 over the sorted feature ids, per-example sums by
    ``index_add_`` (``als.DirectViews``). With ``allr``
    (the sharded sweep, ``parallel/sharded_als.py``) every sum over
    examples (the valid count, Σe², Σe, the per-feature num and den) is
    summed over the ranks holding them; the parameters stay replicated
    and every rank asks ``draws`` for the same draws, so the chain is the
    one-device chain. The draws are :func:`mcmc_sweep`'s, in its order."""
    d = als.DirectViews(ws, num_features, allr)
    params = state.params
    F, G = num_features, num_groups
    dev = params.device
    mask, bof = ws.mask, ws.block_of_feat
    n_valid = d.allr(mask.sum())
    den_w_g = d.allr(ws.den_w.clone())
    e = (d.score(params, use_bias, use_linear) - ws.y) * mask

    grp = _Groups(groups, G, F, dev)
    alpha, lam_w, mu_w, lam_v, mu_v = _draw_priors(
        state, draws, grp, n_valid, d.allr(e.square().sum()), alpha_0,
        beta_0, alpha_l, beta_l, mu_0, gamma_0)
    lam_w_f, mu_w_f = grp.spread(lam_w), grp.spread(mu_w)
    lam_v_f, mu_v_f = grp.spread(lam_v), grp.spread(mu_v)

    w0_new = params.w0.clone()
    if use_bias:
        w0_new = _draw_theta(params.w0, d.allr(e.sum()), n_valid, alpha,
                             lam_w[0], mu_w[0], draws.normal(()))
        e = e + (w0_new - params.w0) * mask

    w = params.w.clone()
    if use_linear:
        for b in range(num_blocks):
            noise = draws.normal((F,))
            num = d.by_feat(e.index_select(0, d.row) * d.x)[:, 0]
            theta = _draw_theta(w, num, den_w_g, alpha, lam_w_f, mu_w_f,
                                noise)
            delta = torch.where(bof == b, theta - w, 0.0)
            w = w + delta
            e = e + d.by_row(delta.index_select(0, d.feat) * d.x)

    v = params.v.clone()
    for f in range(v.shape[1]):
        vf = v[:, f].clone()
        q = d.by_row(vf.index_select(0, d.feat) * d.x)
        for b in range(num_blocks):
            noise = draws.normal((F,))
            h = d.h(q, vf)
            sums = d.by_feat(e.index_select(0, d.row) * h, h * h)
            theta = _draw_theta(vf, sums[:, 0], sums[:, 1], alpha,
                                lam_v_f[:, f], mu_v_f[:, f], noise)
            in_block = bof == b
            vf, q, e = d.patch(e, q, vf, torch.where(in_block, theta - vf,
                                                     0.0), in_block)
        v[:, f] = vf
    return MCMCState(params=FMParams(w0=w0_new, w=w, v=v), alpha=alpha,
                     lam_w=lam_w, mu_w=mu_w, lam_v=lam_v, mu_v=mu_v)


def train_mcmc(cfg: FMConfig, mcmc_cfg: MCMCConfig, train: SparseDataset,
               eval_ds: Optional[SparseDataset] = None,
               generator: Optional[torch.Generator] = None,
               params: Optional[FMParams] = None, *,
               draws=None, device=device_util.DEFAULT) -> TrainResult:
    """Gibbs training on ``device`` (default: the card; without one it
    raises): ``mcmc_cfg.epochs`` sweeps.

    ``params`` warm-starts (copied to ``device``); otherwise V is drawn
    from ``generator`` (default: seeded from ``cfg.seed`` on ``device``),
    which then feeds the sweeps' draws unless ``draws`` gives another
    source. Each history record holds the epoch, the sampled ``alpha``
    and the mean ``lam_w``, and from ``burn_in`` on, with ``eval_ds``,
    ``eval_rmse_avg`` (the running average of the samples' scores: the
    posterior mean) and ``eval_rmse_sample`` (this sample's). The result's
    params are the last sample; ``extras`` holds ``avg_scores`` and the
    last ``mcmc_state``. ``max_seconds`` is checked after each sweep.
    ``examples_per_sec`` counts swept examples over the sweeps' and
    evals' wall time; the workspace and the kernel build come before the
    clock starts."""
    if cfg.task != Task.REGRESSION:
        raise ValueError("MCMC-FM optimizes squared loss (Rendle 2012); "
                         "use SGD for classification")
    if cfg.num_fields > 0:
        raise ValueError("MCMC supports plain FM (not FFM)")
    device = device_util.resolve(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    if params is None:
        params = fm_model.init_params(cfg, generator, device=device)
    else:
        params = FMParams(*(t.detach().to(device, copy=True)
                            for t in (params.w0, params.w, params.v)))
    if draws is None:
        draws = TorchDraws(generator)
    als._check_hbm(train, cfg, device)
    als_cfg = ALSConfig(block_size=mcmc_cfg.block_size,
                        feature_blocks=mcmc_cfg.feature_blocks)
    ws, num_blocks = als.build_workspace(train, cfg, als_cfg, device=device)
    block_of_feat, _ = als.feature_blocks_of(cfg.num_features, als_cfg)
    n_ranks = ws.present.shape[0]
    cpure = bool(n_ranks) and als.blocks_are_column_pure(train,
                                                         block_of_feat)
    uniform = cpure and als.csc_blocks_uniform(train, block_of_feat)
    ident = (als.csc_slice_identity(ws, num_blocks, train.num_examples)
             if uniform else ())
    groups = (None if cfg.feature_groups is None
              else torch.as_tensor(np.asarray(cfg.feature_groups, np.int64),
                                   device=device))
    if device.type == "cuda" and n_ranks:
        segsum.COLSUMS.build()
    state = init_mcmc_state(params, cfg.num_groups)

    avg_scores = None
    n_avg = 0
    history = []
    n_examples = 0
    t0 = time.perf_counter()
    for epoch in range(mcmc_cfg.epochs):
        if n_ranks:     # a dataset with no entries: nothing to sample
            state = mcmc_sweep(
                state, ws, draws, num_blocks, cfg.num_features,
                groups=groups, num_groups=cfg.num_groups,
                alpha_0=mcmc_cfg.alpha_0, beta_0=mcmc_cfg.beta_0,
                alpha_l=mcmc_cfg.alpha_lambda, beta_l=mcmc_cfg.beta_lambda,
                mu_0=mcmc_cfg.mu_0, gamma_0=mcmc_cfg.gamma_0,
                use_bias=cfg.use_bias, use_linear=cfg.use_linear,
                column_pure=cpure, csc_uniform=uniform,
                slice_identity=ident)
        n_examples += train.num_examples
        rec = {"epoch": epoch, "alpha": float(state.alpha),
               "lam_w": float(state.lam_w.mean())}
        if eval_ds is not None and epoch >= mcmc_cfg.burn_in:
            s = FMModel(params=state.params, cfg=cfg)._scores(eval_ds,
                                                              EVAL_BATCH)
            n_avg += 1
            avg_scores = (s if avg_scores is None
                          else avg_scores + (s - avg_scores) / n_avg)
            y = eval_ds.y[:len(avg_scores)]
            rec["eval_rmse_avg"] = float(
                np.sqrt(np.mean(np.square(avg_scores - y))))
            rec["eval_rmse_sample"] = float(
                np.sqrt(np.mean(np.square(s - y))))
        history.append(rec)
        if mcmc_cfg.max_seconds and (time.perf_counter() - t0
                                     >= mcmc_cfg.max_seconds):
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    eps = n_examples / max(time.perf_counter() - t0, 1e-9)
    return TrainResult(params=state.params, history=history,
                       examples_per_sec=eps,
                       extras={"avg_scores": avg_scores,
                               "mcmc_state": state})
