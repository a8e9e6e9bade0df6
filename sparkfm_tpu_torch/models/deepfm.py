"""DeepFM: a shared-embedding FM plus an MLP tower (Guo et al. 2017). Port
of ``sparkfm_tpu/models/deepfm.py`` for one device; with
``DeepFMConfig.cin`` widths, xDeepFM (Lian et al. 2018).

The FM tables (w, V) double as the deep side's embedding tables, so one
gather feeds both heads; the tower's input is the (B, num_fields * K)
concatenation of each slot's V row scaled by its value. Input is
field-major: ids (B, L) with one active feature per field, so L must equal
``num_fields`` (``synth_ctr`` and the Criteo/Avazu loaders give that
layout).

The tower is plain ``torch.matmul`` + bias + relu in float32, as the JAX
package computes it with ``jnp.dot`` outside any Pallas kernel; the port
never turns on TF32. The tables go through the port's row kernels:

* scoring gathers ``[v | w]`` per slot, or per unique id of a dedup plan,
  in one launch of the two-table gather (kernel B1,
  ``ops/rowio.py::gather_vw_rows``);
* the train steps (:func:`make_train_step`) gather the unique rows before
  autograd and sum and write them back after it, so no kernel needs a
  ``torch.autograd.Function``: "direct" and "dedup" on separate tables
  (an ``SGDState``: two-table gathers B1, one row write B2 per table),
  "fused" on one record table (a ``FusedState`` of width 2K+2 rounded up
  to 4 floats, 36 at K = 16, against the JAX package's 128: one gather
  B1 and one write B2). The per-unique sums of ``[g_v | g_w]`` and their
  squares are those of the fused FM step
  (``solvers/sgd_fused.py::segsum_accumulate``): kernel B6 over id-sorted
  runs on CUDA tensors, whose sums repeat bit for bit, ``index_add_`` of
  the ``[g | g²]`` pack on CPU tensors, the JAX package's choice. The
  direct step under momentum sums its per-slot terms by kernel B5, as the
  FM direct step does (``solvers/sgd.py::_update_direct_per_slot``).

Optimizers: adagrad and sgd everywhere, sgd with momentum on "direct"
only, adam on "direct" and "dedup" (the JAX package's DeepFM refuses
adam). Under adam the touched rows take the FM dedup step's lazy rule
(``solvers/sgd.py::_update_unique`` on each unique row's summed
gradient, bias corrections from the global step) on both paths, and
the tower and w0 the dense rule (``_dense_scalar_update``); rows no
example of the step touches keep their moments, where TF1's dense
``AdamOptimizer`` would decay them.

Dropout (``DeepFMConfig.dropout`` = p > 0) multiplies each hidden
layer's output after its ReLU by ``keep / (1 - p)`` in the train steps
only; scoring never drops. The keep mask of hidden layer ``l`` at global
step ``t`` (0 the first, the state's step counter) of a run seeded
``cfg.fm.seed`` is ``torch.rand((B, width), generator=g) >= p`` for a
generator ``g`` of the step's device seeded with
:func:`dropout_seed` ``(seed, t, l)``: a function of those three and the
batch's shape alone, which any code can draw again on the same device.

xDeepFM (``DeepFMConfig.cin`` = (H_1, ..., H_K), KDD 2018, eq. (9))
replaces the FM head's pairwise term by a Compressed Interaction Network
over the same field embeddings (``ops/interaction.py::cin_forward``):
the score is w0 + sum_l w[i_l] x_l + w_cin . p+ + the tower, where p+
(B, sum H_k) pools every CIN layer's maps. The CIN's weights W^k
(H_k, H_{k-1} m) and w_cin (sum H_k,) are dense tensors beside the
tower's (``cin`` of the params and the state, ``smc``/``smc2`` their
optimizer slots), Glorot-uniform at init, trained by the dense rule.
The CIN runs in float32 with TF32 off; its forward and backward are
phases, and spans, of their own in the train step (``deepfm.cin``), and
the counter ``deepfm.cin_rows`` counts the examples through it.
``DeepFMConfig.reg_dense`` adds an L2 term reg_dense * |W|^2 on every
weight matrix of the tower and the CIN (not the biases, w0 or rows).
"""

from __future__ import annotations

import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.data.batching import (SparseBatch, batch_iterator,
                                             epoch_order)
from sparkfm_tpu_torch.models import fm as fm_model
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.ops import interaction as I
from sparkfm_tpu_torch.ops import losses as L
from sparkfm_tpu_torch.ops import metrics as M
from sparkfm_tpu_torch.ops import rowio
from sparkfm_tpu_torch.solvers import sgd as sgd_solver
from sparkfm_tpu_torch.solvers import sgd_fused
from sparkfm_tpu_torch.solvers.sgd import SGDState
from sparkfm_tpu_torch.solvers.sgd_fused import FusedState
from sparkfm_tpu_torch.utils import device as device_util
from sparkfm_tpu_torch.utils import graphs, profiling

_OPTIMIZERS = ("adagrad", "sgd")            # the fused record's
_ROW_OPTIMIZERS = ("adagrad", "adam", "sgd")  # "direct" and "dedup"
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    """fm: the tables' shape and regularization (``num_fields`` = slots
    per example); hidden: the tower's widths (the scalar output layer is
    implicit); dropout: the probability of dropping a hidden unit in a
    train step (0: none, the JAX package's tower); cin: the CIN layers'
    map counts H_k (empty: DeepFM, else xDeepFM without the FM head's
    pairwise term); reg_dense: L2 on the tower's and the CIN's weight
    matrices (0: none, DeepFM's)."""

    fm: FMConfig
    hidden: Tuple[int, ...] = (128, 64)
    dropout: float = 0.0
    cin: Tuple[int, ...] = ()
    reg_dense: float = 0.0

    @property
    def tower_in(self) -> int:
        return self.num_fields * self.fm.num_factors

    @property
    def num_fields(self) -> int:
        if self.fm.num_fields <= 0:
            raise ValueError("DeepFMConfig requires fm.num_fields > 0 "
                             "(slots-per-example = field count)")
        return self.fm.num_fields


class DeepFMParams(nn.Module):
    """fm: the shared tables (one (F, K) V, whatever ``num_fields``);
    mlp_w: the tower's (in, out) weights; mlp_b: its (out,) biases; cin:
    xDeepFM's W^1..W^K (H_k, H_{k-1} m) and w_cin (sum H_k,), empty for
    DeepFM. The train steps differentiate with respect to gathered rows
    and detached copies, never these, so they need no gradient."""

    def __init__(self, fm: FMParams, mlp_w: Sequence[torch.Tensor],
                 mlp_b: Sequence[torch.Tensor],
                 cin: Sequence[torch.Tensor] = ()):
        super().__init__()
        self.fm = fm
        self.mlp_w = nn.ParameterList(
            [nn.Parameter(w, requires_grad=False) for w in mlp_w])
        self.mlp_b = nn.ParameterList(
            [nn.Parameter(b, requires_grad=False) for b in mlp_b])
        self.cin = nn.ParameterList(
            [nn.Parameter(w, requires_grad=False) for w in cin])

    @property
    def device(self) -> torch.device:
        return self.fm.device


def init_params(cfg: DeepFMConfig,
                generator: Optional[torch.Generator] = None, *,
                device) -> DeepFMParams:
    """The FM tables as ``models/fm.py::init_params`` makes them for a
    plain FM (one shared (F, K) V), then He-initialized tower weights
    N(0, 2 / fan_in) and zero biases, then the CIN's weights
    Glorot-uniform (:func:`cin_shapes`), all from one generator on
    ``device`` (default: seeded from ``cfg.fm.seed``). torch's numbers
    differ from jax.random's for the same seed."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.fm.seed)
    fm = fm_model.init_params(cfg.fm.replace(num_fields=0), generator,
                              device=device)
    dims = (cfg.tower_in,) + tuple(cfg.hidden) + (1,)
    ws, bs = [], []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=device)
        ws.append(w * math.sqrt(2.0 / fan_in))
        bs.append(torch.zeros((fan_out,), device=device))
    cin = []
    for shape, (fan_in, fan_out) in zip(*cin_shapes(cfg)):
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(shape, generator=generator, device=device)
        cin.append(u * (2.0 * bound) - bound)
    return DeepFMParams(fm=fm, mlp_w=ws, mlp_b=bs, cin=cin)


def cin_shapes(cfg: DeepFMConfig):
    """(shapes, (fan_in, fan_out) pairs) of the CIN's tensors: W^k
    (H_k, H_{k-1} m) with H_0 = m, fans (H_{k-1} m, H_k), as the 1 x 1
    convolutions of the paper's code count them; then w_cin (sum H_k,),
    fans (sum H_k, 1). Empty without a CIN."""
    if not cfg.cin:
        return [], []
    m, prev = cfg.num_fields, cfg.num_fields
    shapes, fans = [], []
    for h in cfg.cin:
        shapes.append((int(h), prev * m))
        fans.append((prev * m, int(h)))
        prev = int(h)
    total = sum(int(h) for h in cfg.cin)
    return shapes + [(total,)], fans + [(total, 1)]


def deepfm_params_from_numpy(w0, w, v, mlp_w, mlp_b, cin=(), *,
                             device) -> DeepFMParams:
    """DeepFMParams on ``device`` from numpy arrays, e.g. the JAX
    package's as ``np.asarray(params.fm.w)``, ``[np.asarray(x) for x in
    params.mlp_w]``; ``cin``: xDeepFM's W^1..W^K and w_cin."""
    def t(x):
        return torch.as_tensor(np.array(x, np.float32, copy=True),
                               device=device)
    return DeepFMParams(fm=fm_model.params_from_numpy(w0, w, v,
                                                      device=device),
                        mlp_w=[t(x) for x in mlp_w],
                        mlp_b=[t(x) for x in mlp_b],
                        cin=[t(x) for x in cin])


def _tower(mlp_w, mlp_b, h: torch.Tensor, masks=None) -> torch.Tensor:
    """(B,) tower output: matmul + bias, relu between layers, each relu's
    output times its dropout multiplier ``masks[i]`` when given."""
    n = len(mlp_w)
    for i, (w, b) in enumerate(zip(mlp_w, mlp_b)):
        h = torch.matmul(h, w) + b
        if i < n - 1:
            h = torch.relu(h)
            if masks is not None:
                h = h * masks[i]
    return h[:, 0]


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def dropout_seed(seed: int, step: int, layer: int) -> int:
    """The generator seed of hidden layer ``layer``'s dropout mask at
    global step ``step`` of a run seeded ``seed``: ``splitmix64(
    splitmix64(splitmix64(seed mod 2^64) ^ step) ^ layer) >> 1``, with
    splitmix64 Steele, Lea and Flood's finalizer of ``z + 0x9E37...7C15``
    (a 63-bit number)."""
    z = _splitmix64(int(seed) & _MASK64)
    z = _splitmix64(z ^ int(step))
    return _splitmix64(z ^ int(layer)) >> 1


def dropout_draws(cfg: DeepFMConfig, step: int, rows: int, device,
                  generator: Optional[torch.Generator] = None, out=None):
    """The uniform draws behind :func:`dropout_masks` (float32, (rows,
    width) a hidden layer) of global step ``step``, or None without
    dropout: written into ``out``'s tensors when given. ``generator`` (of
    ``device``) is reseeded for each layer."""
    if cfg.dropout <= 0.0:
        return None
    if generator is None:
        generator = torch.Generator(device=device)
    draws = []
    for layer, width in enumerate(cfg.hidden):
        generator.manual_seed(dropout_seed(cfg.fm.seed, step, layer))
        if out is None:
            draws.append(torch.rand((rows, width), generator=generator,
                                    device=device))
        else:
            draws.append(torch.rand(out[layer].shape, generator=generator,
                                    out=out[layer]))
    return draws


def _masks_of(cfg: DeepFMConfig, draws):
    p = float(cfg.dropout)
    return [(r >= p) * (1.0 / (1.0 - p)) for r in draws]


def dropout_masks(cfg: DeepFMConfig, step: int, rows: int, device,
                  generator: Optional[torch.Generator] = None):
    """The multipliers ``keep / (1 - p)`` (float32, (rows, width) a hidden
    layer) of global step ``step``, or None without dropout; the module
    doc defines them."""
    draws = dropout_draws(cfg, step, rows, device, generator)
    return None if draws is None else _masks_of(cfg, draws)


def _check_field_major(cfg: DeepFMConfig, slots: int) -> None:
    if slots != cfg.num_fields:
        raise ValueError(
            f"DeepFM takes field-major input, one slot per field: the batch "
            f"has L = {slots} slots but num_fields = {cfg.num_fields}, so "
            f"its embeddings are not the tower's {cfg.tower_in} inputs")


def scores_from_rows(w0: torch.Tensor, mlp_w, mlp_b, cfg: DeepFMConfig,
                     w_rows: torch.Tensor, v_rows: torch.Tensor,
                     vals: torch.Tensor, masks=None, cin=(),
                     pooled=None) -> torch.Tensor:
    """(B,) raw scores, FM head + deep head, from gathered rows: w_rows
    (B, L), v_rows (B, L, K), vals (B, L); ``masks``: the train step's
    dropout multipliers (:func:`dropout_masks`), None when scoring. With
    ``cfg.cin`` the FM head is w0 + <w, x> + w_cin . p+: ``cin`` holds
    W^1..W^K and w_cin, and ``pooled`` p+ when the caller computed it."""
    _check_field_major(cfg, vals.shape[1])
    if cfg.cin:
        fm_s = I.fm_linear_from_gathered(w0, w_rows, vals,
                                         use_bias=cfg.fm.use_bias,
                                         use_linear=cfg.fm.use_linear)
    else:
        fm_s = I.fm_scores_from_gathered(
            w0, w_rows, v_rows, vals, use_bias=cfg.fm.use_bias,
            use_linear=cfg.fm.use_linear,
            compute_dtype=getattr(torch, cfg.fm.compute_dtype))
    emb = v_rows * vals[..., None]
    if cfg.cin:
        if pooled is None:
            pooled = I.cin_forward(emb, cin[:-1])[0]
        fm_s = fm_s + torch.mv(pooled, cin[-1])
    return fm_s + _tower(mlp_w, mlp_b, emb.reshape(vals.shape[0], -1), masks)


def scores(params: DeepFMParams, cfg: DeepFMConfig, ids: torch.Tensor,
           vals: torch.Tensor,
           plan: Optional[E.DedupBatch] = None) -> torch.Tensor:
    """(B,) raw scores of a field-major batch on the parameters' device.
    ``[v | w]`` comes from one two-table gather launch: per slot, or with
    ``plan`` (a dedup plan of ``ids`` on that device whose count fits its
    budget) per unique id, spread to the slots by the plan's ranks."""
    _check_field_major(cfg, ids.shape[1])
    k = cfg.fm.num_factors
    fm = params.fm
    if plan is None:
        vw = rowio.gather_vw_rows(fm.v, fm.w, ids.reshape(-1).to(
            torch.int32)).view(*ids.shape, k + 1)
    else:
        vw = E.spread(rowio.gather_vw_rows(fm.v, fm.w, plan.uids), plan)
    return scores_from_rows(fm.w0, params.mlp_w, params.mlp_b, cfg,
                            vw[..., k], vw[..., :k], vals, cin=params.cin)


def predict(params: DeepFMParams, cfg: DeepFMConfig, ids: torch.Tensor,
            vals: torch.Tensor,
            plan: Optional[E.DedupBatch] = None) -> torch.Tensor:
    """Predictions in output space: raw score (regression) or P(y=1)."""
    return L.predict_for_task(cfg.fm.task,
                              scores(params, cfg, ids, vals, plan))


# ---------------------------------------------------------------------------
# Training state

@dataclasses.dataclass
class DeepFMState:
    """A DeepFM train state on one device: ``fm`` holds the tables and
    their slots, an ``SGDState`` on "direct" and "dedup" (the dedup
    tables with the plan's fill row) or a ``FusedState`` on "fused"; the
    tower's weights and biases and their optimizer slots ride beside it
    (``smw``/``smb``: adagrad's sums, momentum's velocities or adam's
    first moments; ``smw2``/``smb2``: adam's second moments, empty under
    the other optimizers); xDeepFM's CIN tensors ``cin`` (W^1..W^K,
    w_cin) with their slots ``smc`` and ``smc2`` likewise, all three
    empty for DeepFM. The train steps update every tensor in place."""

    fm: Union[SGDState, FusedState]
    mlp_w: Tuple[torch.Tensor, ...]
    mlp_b: Tuple[torch.Tensor, ...]
    smw: Tuple[torch.Tensor, ...]
    smb: Tuple[torch.Tensor, ...]
    smw2: Tuple[torch.Tensor, ...] = ()
    smb2: Tuple[torch.Tensor, ...] = ()
    cin: Tuple[torch.Tensor, ...] = ()
    smc: Tuple[torch.Tensor, ...] = ()
    smc2: Tuple[torch.Tensor, ...] = ()


def _tower_state(fm_state, mlp_w, mlp_b, adam: bool = False,
                 cin=()) -> DeepFMState:
    mlp_w = tuple(w.detach().clone() for w in mlp_w)
    mlp_b = tuple(b.detach().clone() for b in mlp_b)
    cin = tuple(w.detach().clone() for w in cin)

    def zeros(xs):
        return tuple(torch.zeros_like(x) for x in xs)
    return DeepFMState(fm=fm_state, mlp_w=mlp_w, mlp_b=mlp_b,
                       smw=zeros(mlp_w), smb=zeros(mlp_b),
                       smw2=zeros(mlp_w) if adam else (),
                       smb2=zeros(mlp_b) if adam else (),
                       cin=cin, smc=zeros(cin),
                       smc2=zeros(cin) if adam else ())


def init_state(params: DeepFMParams,
               optimizer: Optional[str] = None) -> DeepFMState:
    """Fresh (zero) optimizer state around ``params`` for the direct and
    dedup paths; the tables are the params' own tensors, the tower a
    copy (the CIN's too). Under ``optimizer="adam"`` the tables', the
    tower's and the CIN's second moments are full zeros; otherwise the
    tables' are 0-d placeholders and the others empty."""
    adam = optimizer == "adam"
    return _tower_state(
        sgd_solver.init_state(params.fm,
                              optimizer="adam" if adam else "sgd"),
        params.mlp_w, params.mlp_b, adam, params.cin)


def pad_deepfm_state_for_dedup(state: DeepFMState) -> DeepFMState:
    """The dedup path's state: every table and slot with one extra row,
    the dedup plan's fill row (garbage by contract)."""
    return dataclasses.replace(state,
                               fm=sgd_solver.pad_state_for_dedup(state.fm))


def init_fused_deepfm_state(cfg: DeepFMConfig,
                            generator: Optional[torch.Generator] = None, *,
                            device) -> DeepFMState:
    """The fused path's state: the FM tables and their adagrad slots in
    one (F+1, W) record table ``[v (K) | slot_v (K) | w | slot_w | pad]``
    (W = ``sgd_fused.record_width(K)``), from the same init as
    :func:`init_params`; the tower dense beside it."""
    params = init_params(cfg, generator, device=device)
    fused = sgd_fused.fused_from_params(
        params.fm, cfg.fm.replace(num_fields=0), device=device)
    return _tower_state(fused, params.mlp_w, params.mlp_b, cin=params.cin)


def fused_deepfm_state_from_numpy(table, w0, slot_w0, mlp_w, mlp_b, smw,
                                  smb, cfg: DeepFMConfig, *,
                                  device) -> DeepFMState:
    """A JAX fused DeepFM state carried into the port, from its arrays as
    numpy (``np.asarray(state["table"])``, ...): the record's 2K+2 used
    columns are kept, the JAX package's lane padding dropped."""
    fused = sgd_fused.fused_state_from_numpy(
        table, w0, slot_w0, 0, cfg.fm.replace(num_fields=0), device=device)

    def t(xs):
        return tuple(torch.as_tensor(np.array(x, np.float32, copy=True),
                                     device=device) for x in xs)
    return DeepFMState(fm=fused, mlp_w=t(mlp_w), mlp_b=t(mlp_b), smw=t(smw),
                       smb=t(smb))


def params_from_fused_deepfm(state: DeepFMState,
                             cfg: DeepFMConfig) -> DeepFMParams:
    """DeepFMParams copied out of a fused state (F rows)."""
    return DeepFMParams(
        fm=sgd_fused.params_from_fused(state.fm,
                                       cfg.fm.replace(num_fields=0)),
        mlp_w=[w.clone() for w in state.mlp_w],
        mlp_b=[b.clone() for b in state.mlp_b],
        cin=[w.clone() for w in state.cin])


def params_of(state: DeepFMState, cfg: DeepFMConfig) -> DeepFMParams:
    """DeepFMParams of any path's state: F rows (the dedup fill row
    dropped), the tower copied."""
    if isinstance(state.fm, FusedState):
        return params_from_fused_deepfm(state, cfg)
    fm = sgd_solver.trim_params(state.fm.params, cfg.fm.num_features)
    return DeepFMParams(fm=FMParams(fm.w0.clone(), fm.w, fm.v),
                        mlp_w=[w.clone() for w in state.mlp_w],
                        mlp_b=[b.clone() for b in state.mlp_b],
                        cin=[w.clone() for w in state.cin])


# ---------------------------------------------------------------------------
# Train steps

def resolve_deepfm_path(cfg: DeepFMConfig, sgd_cfg: SGDConfig) -> str:
    """The JAX package's "auto": tables below 2^16 rows take "direct",
    bigger ones the fused record, or "dedup" under adam (whose moments
    the record does not carry), as ``solvers/sgd.py::
    resolve_update_path`` sends the FM's adam; a pinned ``update_path``
    stands."""
    path = sgd_cfg.update_path
    if path == "auto":
        if cfg.fm.num_features < (1 << 16):
            return "direct"
        return "dedup" if sgd_cfg.optimizer == "adam" else "fused"
    return path


def _check_deepfm_optimizer(sgd_cfg: SGDConfig, path: str) -> None:
    """adagrad and plain sgd everywhere, momentum on "direct" only, adam
    on "direct" and "dedup": the fused record holds one slot a
    coordinate, not adam's two moments."""
    allowed = _ROW_OPTIMIZERS if path in ("direct", "dedup") else _OPTIMIZERS
    if sgd_cfg.optimizer not in allowed:
        where = ("" if path in ("direct", "dedup") else
                 f" on the {path} path (adam also on 'direct' and 'dedup')")
        raise ValueError(
            f"deepfm supports optimizer 'adagrad' or 'sgd'{where}, got "
            f"{sgd_cfg.optimizer!r} — it would otherwise train with a "
            "different optimizer than requested")
    if path in ("dedup", "fused") and sgd_cfg.momentum > 0:
        raise ValueError(f"deepfm {path} path does not support momentum; "
                         "use update_path='direct' or momentum=0")


def _deepfm_loss(cfg: DeepFMConfig, batch, w0, w_rows, v_rows, mlp_w,
                 mlp_b, masks=None, cin=(), pooled=None):
    """The loss of all three paths: both heads from gathered rows (the
    tower under the dropout multipliers ``masks``; with a CIN, p+
    ``pooled`` times w_cin, the last of ``cin``), plus per-appearance L2
    on the touched rows (each active slot of a valid example, over
    max(Σmask, 1)) and ``reg_dense`` |W|^2 on the tower's weights and
    w_cin (the train step adds the CIN layers'). Returns (data loss + L2,
    (scores, data loss))."""
    fm_cfg = cfg.fm
    s = scores_from_rows(w0, mlp_w, mlp_b, cfg, w_rows, v_rows, batch.vals,
                         masks, cin, pooled)
    weights = None if batch.mask is None else batch.mask.to(torch.float32)
    data_loss = L.loss_for_task(fm_cfg.task)(s, batch.y, weights)
    active = (batch.vals != 0).to(torch.float32)
    if weights is not None:
        active = active * weights[:, None]
        denom = weights.sum().clamp(min=1.0)
    else:
        denom = max(float(batch.vals.shape[0]), 1.0)
    reg = (fm_cfg.reg_w * (w_rows.square() * active).sum()
           + fm_cfg.reg_v * (v_rows.square() * active[..., None]).sum()
           ) / denom
    if cfg.reg_dense > 0:
        reg = reg + cfg.reg_dense * sum(
            w.square().sum() for w in (*mlp_w, *cin[-1:]))
    return data_loss + reg, (s, data_loss)


def _unique_sums(g_v: torch.Tensor, g_w: torch.Tensor, plan, budget: int,
                 sorted_runs: bool) -> torch.Tensor:
    """(U, 2K+2) ``[Σg_v | Σg_w | Σg_v² | Σg_w²]`` per unique id of the
    per-slot gradients: by kernel B6 over id-sorted runs, or by
    ``index_add_`` of the ``[g | g²]`` pack by rank."""
    g = torch.cat([g_v.reshape(-1, g_v.shape[-1]), g_w.reshape(-1, 1)], 1)
    if sorted_runs:
        return E.accumulate_sq_to_unique_sorted(g, plan, budget)
    packed = torch.cat([g, g.square()], 1)
    return E.accumulate_to_unique(packed.view(*plan.ranks.shape, -1), plan,
                                  budget)


def make_train_step(cfg: DeepFMConfig, sgd_cfg: SGDConfig, *,
                    cuda_graphs: bool = True):
    """(DeepFMState, SparseBatch) -> (DeepFMState, aux) on the path that
    :func:`resolve_deepfm_path` picks; every tensor of the state is
    updated in place and the same state returned. aux holds ``loss`` and
    ``scores`` (tensors on the device) and, on "dedup" and "fused", the
    plan's ``unique_count`` and ``unique_overflow``.

    Each step runs four phases, each a span
    (``utils/profiling.py::annotate``, with CUDA-event device times on
    the card):

    1. ``deepfm.gather``: a dedup plan of the batch: on "direct" one
       built on the device whose budget holds every distinct id, fill id
       F - 1; on "dedup" and "fused" the batch's host plan, else one built
       on the device (``unique_budget`` or ``auto_budget``), fill id F;
       the unique rows gathered by kernel B1 (two-table ``[v | w]``,
       ``[slot_v | slot_w]`` and under adam ``[slot2_v | slot2_w]`` on
       "direct"/"dedup", the record on "fused"), rows past the plan's
       count zeroed, and spread to the slots;
    2. ``deepfm.dense``: the dropout masks, both heads and
       ``torch.autograd.grad`` of :func:`_deepfm_loss` with respect to
       w0, the slot rows and the tower;
    3. ``deepfm.update``: the per-unique sums (:func:`_unique_sums`, or
       kernel B5 on the direct step under momentum), the update of the
       unique rows and their write-back by kernel B2 (one per table, or
       one record);
    4. ``deepfm.tower_update``: the bias and the tower by the dense rule
       (adagrad, sgd, momentum, adam), and the step count.

    xDeepFM (``cfg.cin``) has two phases more, both in the span
    ``deepfm.cin``: after the gather the CIN's forward
    (``ops/interaction.py::cin_forward``: p+ from the spread rows, its
    products kept), and after the dense phase, which then differentiates
    with respect to p+ and w_cin too, the CIN's backward
    (:func:`~sparkfm_tpu_torch.ops.interaction.cin_backward`: the W^k's
    gradients plus reg_dense's, and the embeddings' added into the v
    rows' gradient). The tower update covers the CIN's tensors. Each
    step adds its batch's rows to the counter ``deepfm.cin_rows``.

    On the card (``cuda_graphs``), a batch without a host plan runs as
    four CUDA graphs (six with a CIN), one a phase, replayed inside its
    span, so that the host makes a handful of calls a step where the
    phases launch ~400 kernels. They are the step function's ``utils/graphs.py::GraphCache``,
    captured per state and batch shape after that shape's first step ran
    eagerly. A graph reads the batch from static device buffers, filled
    by device copies, and the dropout masks from static uniform draws,
    drawn before the dense phase's replay from the generator seeded for
    the step (:func:`dropout_draws`); its outputs are cloned into aux.
    Host plans, whose budget moves with the batch, and CPU tensors run
    the phases eagerly.

    With dropout the step keeps the global step on the host: it reads
    the state's counter at its first call (one wait for the device) and
    counts on from there, so a state whose counter is written from
    outside after that call (a checkpoint restored into it) needs a new
    step function.
    """
    path = resolve_deepfm_path(cfg, sgd_cfg)
    if path not in ("direct", "dedup", "fused"):
        raise ValueError(f"deepfm supports update_path direct/dedup/fused, "
                         f"got {path!r}")
    _check_deepfm_optimizer(sgd_cfg, path)
    if cfg.fm.feature_groups is not None:
        raise ValueError("deepfm has no per-group L2 (feature_groups); the "
                         "JAX package ignores them here, the port refuses")
    if sgd_cfg.accumulate not in ("auto", "scatter", "segsum"):
        raise ValueError(
            f"unknown accumulate={sgd_cfg.accumulate!r}; expected "
            "'auto', 'scatter' or 'segsum'")
    if not 0.0 <= cfg.dropout < 1.0:
        raise ValueError(f"dropout must lie in [0, 1), got {cfg.dropout!r}")
    opt, lr = sgd_cfg.optimizer, sgd_cfg.learning_rate
    adam = opt == "adam"
    k = cfg.fm.num_factors
    per_slot = path == "direct" and opt == "sgd" and sgd_cfg.momentum > 0
    writes_slot = opt != "sgd" or sgd_cfg.momentum > 0
    spans = _spans_of(cfg)
    clock: list = []                # the global step of the next call
    generators: Dict[torch.device, torch.Generator] = {}
    cache = graphs.GraphCache()

    def plan_of(batch, rows: int):
        if path == "direct":
            budget = min(batch.ids.numel(), rows)
            return E.dedup_ids(batch.ids, budget, fill=rows - 1), budget
        if batch.plan is not None:
            return batch.plan, batch.plan.uids.shape[0]
        budget = sgd_cfg.unique_budget or E.auto_budget(batch.ids.numel())
        return E.dedup_ids(batch.ids, budget, fill=rows - 1), budget

    def phases(state: DeepFMState, batch, draws):
        """The step's phases (``spans``), yielding after each; the last
        yields aux. ``draws``: the dropout masks' uniform draws, or
        None."""
        fm = state.fm
        fused = isinstance(fm, FusedState)
        table = fm.table if fused else fm.params.v
        device = table.device

        # 1. deepfm.gather
        plan, budget = plan_of(batch, table.shape[0])
        sorted_runs = per_slot or sgd_fused.segsum_accumulate(
            sgd_cfg.accumulate, device)
        if sorted_runs and (plan.order is None or plan.seg is None):
            raise ValueError(
                f"the {path} step sums by sorted runs on {device} and "
                "requires a plan with the id-sort permutation "
                "(plan.order/plan.seg); both dedup_ids and host_dedup "
                "emit it - this plan was built without it")
        with torch.no_grad():
            valid = sgd_fused.valid_slots(plan.count, budget,
                                          device)[:, None]
            if fused:
                rec_u = torch.where(valid, E.gather_unique(table, plan),
                                    0.0)
                vw_u = torch.cat([rec_u[:, :k],
                                  rec_u[:, 2 * k:2 * k + 1]], 1)
            else:
                p = fm.params
                t_u = rowio.gather_vw_rows(p.v, p.w, plan.uids)
                s_u = rowio.gather_vw_rows(fm.slot_v, fm.slot_w,
                                           plan.uids)
                s2_u = (rowio.gather_vw_rows(fm.slot2_v, fm.slot2_w,
                                             plan.uids)
                        if adam else None)
                vw_u = torch.where(valid, t_u, 0.0)
            vw_rows = E.spread(vw_u, plan)              # (B, L, K+1)
            w0_t = fm.w0 if fused else fm.params.w0
        w0 = w0_t.detach().requires_grad_()
        w_rows = vw_rows[..., k].detach().requires_grad_()
        v_rows = vw_rows[..., :k].detach().requires_grad_()
        mlp_w = [x.detach().requires_grad_() for x in state.mlp_w]
        mlp_b = [x.detach().requires_grad_() for x in state.mlp_b]
        n_layers = len(mlp_w)
        yield

        cin, pooled = (), None
        if cfg.cin:
            # deepfm.cin: the forward
            with torch.no_grad():
                emb = v_rows * batch.vals[..., None]
                pooled, saved = I.cin_forward(emb, state.cin[:-1])
            pooled.requires_grad_()
            cin = (*state.cin[:-1], state.cin[-1].detach().requires_grad_())
            yield

        # 2. deepfm.dense
        masks = None if draws is None else _masks_of(cfg, draws)
        with torch.enable_grad():
            total, (s, data_loss) = _deepfm_loss(
                cfg, batch, w0, w_rows, v_rows, mlp_w, mlp_b, masks, cin,
                pooled)
            # w0 is off the graph without use_bias: a zero gradient
            extra = (cin[-1], pooled) if cfg.cin else ()
            grads = torch.autograd.grad(
                total, (w0, w_rows, v_rows, *mlp_w, *mlp_b, *extra),
                materialize_grads=True)
        g_w0, g_wrows, g_vrows = grads[:3]
        g_mw = grads[3:3 + n_layers]
        g_mb = grads[3 + n_layers:3 + 2 * n_layers]
        yield

        g_cin = ()
        if cfg.cin:
            # deepfm.cin: the backward
            g_wcin, g_pooled = grads[3 + 2 * n_layers:]
            with torch.no_grad():
                g_emb, g_layers = I.cin_backward(emb, state.cin[:-1], saved,
                                                 g_pooled)
                del saved
                if cfg.reg_dense > 0:
                    g_layers = [g + (2.0 * cfg.reg_dense) * w
                                for g, w in zip(g_layers, state.cin)]
                g_vrows = g_vrows + g_emb * batch.vals[..., None]
            g_cin = (*g_layers, g_wcin)
            yield

        # 3. deepfm.update
        with torch.no_grad():
            if per_slot:
                g = torch.cat([g_vrows.reshape(-1, k),
                               g_wrows.reshape(-1, 1)], 1)
                t_new, s_new, _ = sgd_solver._update_direct_per_slot(
                    opt, sgd_cfg, t_u, s_u, None,
                    g.index_select(0, plan.order.long()), plan, budget,
                    fm.step)
            else:
                acc = _unique_sums(g_vrows, g_wrows, plan, budget,
                                   sorted_runs)
            if fused:
                E.scatter_set_unique(table, plan, sgd_fused.update_records(
                    opt, sgd_cfg, rec_u, acc, k))
            else:
                if not per_slot:
                    t_new, s_new, s2_new = sgd_solver._update_unique(
                        opt, sgd_cfg, t_u, s_u, s2_u, acc[:, :k + 1],
                        acc[:, k + 1:], fm.step)
                # slots past the plan's count keep the rows they read
                writes = [(p.v, p.w, torch.where(valid, t_new, t_u))]
                if writes_slot:
                    writes.append((fm.slot_v, fm.slot_w,
                                   torch.where(valid, s_new, s_u)))
                if adam:
                    writes.append((fm.slot2_v, fm.slot2_w,
                                   torch.where(valid, s2_new, s2_u)))
                for tv, tw, new in writes:
                    rowio.scatter_set_rows(tv, plan.uids,
                                           new[:, :k].contiguous())
                    rowio.scatter_set_rows(tw.view(-1, 1), plan.uids,
                                           new[:, k:].contiguous())
        yield

        # 4. deepfm.tower_update
        with torch.no_grad():
            slot2_w0 = fm.slot2_w0 if adam else None
            dense = [(w0_t, fm.slot_w0, slot2_w0, g_w0)]
            dense += list(zip(state.mlp_w, state.smw,
                              state.smw2 or (None,) * n_layers, g_mw))
            dense += list(zip(state.mlp_b, state.smb,
                              state.smb2 or (None,) * n_layers, g_mb))
            dense += list(zip(state.cin, state.smc,
                              state.smc2 or (None,) * len(g_cin), g_cin))
            for x, slot, slot2, g in dense:
                x_new, slot_new, slot2_new = sgd_solver._dense_scalar_update(
                    opt, lr, sgd_cfg, x, slot, slot2, g, fm.step)
                x.copy_(x_new)
                slot.copy_(slot_new)
                if adam:
                    slot2.copy_(slot2_new)
            fm.step.add_(1)
        aux = {"loss": data_loss.detach(), "scores": s.detach()}
        if path != "direct":
            aux.update(unique_count=plan.count,
                       unique_overflow=plan.overflow)
        yield aux

    def draws_of(t: int, rows: int, device, out=None):
        if cfg.dropout <= 0:
            return None
        gen = generators.get(device)
        if gen is None:
            gen = generators[device] = torch.Generator(device=device)
        return dropout_draws(cfg, t, rows, device, gen, out)

    def eager(state, batch, t: int, on_card: bool) -> dict:
        run = phases(state, batch, draws_of(t, batch.vals.shape[0],
                                            batch.vals.device))
        for name in spans:
            with profiling.annotate(name, device=on_card):
                aux = next(run)
        return aux

    def graphed(state, batch, t: int) -> dict:
        rows = batch.vals.shape[0]
        drawn = () if cfg.dropout <= 0 else tuple(
            (f"draws.{layer}", (rows, width), torch.float32)
            for layer, width in enumerate(cfg.hidden))

        def before(i, static):
            if drawn and spans[i] == "deepfm.dense":
                draws_of(t, rows, batch.vals.device,
                         [static[name] for name, _, _ in drawn])

        def run(static):
            return phases(state, SparseBatch(**{
                name: static[name] for name in _INPUTS if name in static}),
                [static[name] for name, _, _ in drawn] or None)

        return cache(state, {name: getattr(batch, name) for name in _INPUTS
                             if getattr(batch, name) is not None},
                     run, drawn=drawn, before=before, spans=spans)

    def train_step(state: DeepFMState, batch):
        fm = state.fm
        fused = isinstance(fm, FusedState)
        if fused != (path == "fused"):
            raise ValueError(f"the {path} step takes "
                             + ("a fused" if path == "fused" else "an SGD")
                             + " DeepFMState")
        if adam and (not state.smw2 or fm.slot2_v.dim() == 0):
            raise ValueError("adam needs the second moments of a state "
                             "from init_state(params, optimizer='adam')")
        if len(state.cin) != len(cfg.cin) + bool(cfg.cin):
            raise ValueError(f"the config's CIN has {len(cfg.cin)} layers "
                             f"but the state holds {len(state.cin)} CIN "
                             "tensors (W^1..W^K and w_cin)")
        if cfg.cin:
            profiling.count("deepfm.cin_rows", batch.vals.shape[0])
        t = 0
        if cfg.dropout > 0:
            if not clock:
                clock.append(int(fm.step))
            t = clock[0]
        on_card = batch.ids.device.type == "cuda"
        if cuda_graphs and on_card and batch.plan is None:
            aux = graphed(state, batch, t)
        else:
            aux = eager(state, batch, t, on_card)
        if clock:
            clock[0] += 1
        return state, aux

    return train_step


_SPANS = ("deepfm.gather", "deepfm.dense", "deepfm.update",
          "deepfm.tower_update")
_INPUTS = ("ids", "vals", "y", "mask")       # what the step reads


def _spans_of(cfg: DeepFMConfig) -> Tuple[str, ...]:
    """The step's phases by span: DeepFM's four, or xDeepFM's six, the
    CIN's forward after the gather and its backward after the dense
    phase."""
    if not cfg.cin:
        return _SPANS
    return ("deepfm.gather", "deepfm.cin", "deepfm.dense", "deepfm.cin",
            "deepfm.update", "deepfm.tower_update")


# ---------------------------------------------------------------------------
# Training loop

def _metrics_of(s: torch.Tensor, y: np.ndarray,
                task: Task) -> Dict[str, float]:
    """The JAX trainer's eval keys from every example's score: rmse
    (regression), or auc and accuracy (classification)."""
    y = torch.from_numpy(y[:s.shape[0]])
    if task == Task.REGRESSION:
        return {"rmse": float((s.double() - y.double()).square().mean()
                              .sqrt())}
    prob = torch.sigmoid(s.double())
    return {"auc": float(M.auc(s, y)),
            "accuracy": float(((prob >= 0.5) == (y > 0)).double().mean())}


def _eval_metrics(params: DeepFMParams, cfg: DeepFMConfig, ds,
                  batch_size: int) -> Dict[str, float]:
    """:func:`_metrics_of` the scores of every example."""
    outs = []
    for b in batch_iterator(ds, batch_size, device=params.device):
        outs.append(scores(params, cfg, b.ids, b.vals)[b.mask])
    return _metrics_of(torch.cat(outs).cpu(), ds.y, cfg.fm.task)


def initial_state(cfg: DeepFMConfig, sgd_cfg: SGDConfig,
                  generator: Optional[torch.Generator] = None,
                  start: Optional[DeepFMParams] = None, *,
                  device) -> DeepFMState:
    """The train state of :func:`resolve_deepfm_path`'s path on
    ``device``: from a copy of the parameters ``start`` when given, else
    drawn from ``generator`` (:func:`init_params`); with adam's second
    moments under adam, and the dedup path's fill row."""
    device = torch.device(device)
    path = resolve_deepfm_path(cfg, sgd_cfg)
    if start is None:
        if path == "fused":
            return init_fused_deepfm_state(cfg, generator, device=device)
        params = init_params(cfg, generator, device=device)
    else:
        params = DeepFMParams(
            fm=FMParams(*(t.detach().to(device, copy=True) for t in (
                start.fm.w0, start.fm.w, start.fm.v))),
            mlp_w=list(start.mlp_w), mlp_b=list(start.mlp_b),
            cin=list(start.cin))
        if path == "fused":
            fused = sgd_fused.fused_from_params(
                params.fm, cfg.fm.replace(num_fields=0), device=device)
            return _tower_state(fused, params.mlp_w, params.mlp_b,
                                cin=params.cin)
    state = init_state(params, sgd_cfg.optimizer)
    if path == "dedup":
        state = pad_deepfm_state_for_dedup(state)
    return state


def train_deepfm(cfg: DeepFMConfig, sgd_cfg: SGDConfig, train,
                 eval_ds=None, eval_every: int = 1,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, resume: bool = True, *,
                 init_params: Optional[DeepFMParams] = None,
                 hooks: Optional[list] = None,
                 device=device_util.DEFAULT):
    """DeepFM training on ``device`` (default: the card; without one it
    raises), the JAX package's loop for one device.

    The path is :func:`resolve_deepfm_path`'s; the state comes from a
    copy of ``init_params`` when given, else from ``generator`` (default:
    seeded from ``cfg.fm.seed``; :func:`initial_state`). Batches are
    shuffled per epoch with the JAX package's (seed, epoch) order and
    built in a background thread; on "dedup" and "fused" under
    ``host_plan`` they carry host ladder plans (or plans of
    ``unique_budget``), fill id F. Each history record holds the epoch's
    mean ``train_loss`` (in float64) and, every ``eval_every`` epochs and
    after the last, ``eval_rmse`` or ``eval_auc`` and ``eval_accuracy``.
    ``max_seconds`` stops after the epoch that reaches it. ``hooks`` are
    called as ``hook(epoch, state, record)`` after each epoch.

    With ``checkpoint_dir`` the state is saved every ``checkpoint_every``
    epochs, after the last and on a ``max_seconds`` stop; with ``resume``
    a checkpoint there is restored into the state's own tensors and
    training goes on at the next epoch with the same batch order, so a
    resumed run equals an uninterrupted one bit for bit. A checkpoint of
    another path's layout raises ``ValueError``. ``examples_per_sec``
    leaves out the first step, its time and its examples (kernel builds,
    warm-up). The epoch loop is ``training/trainer.py::run_epochs``, the
    one ``train_sgd`` runs. ``mesh`` (a ``DeviceMesh``, a ``MeshConfig``,
    whose ``exchange`` is honoured, or "DxM") trains sharded on this rank:
    :func:`_train_deepfm_sharded`. Returns a ``TrainResult`` whose
    params are DeepFMParams of F rows.
    """
    # imported here: the trainer imports this module
    from sparkfm_tpu_torch.training.trainer import (TrainResult, run_epochs,
                                                    step_loop)

    device = device_util.resolve(device)
    if mesh is not None:
        if init_params is not None or hooks:
            raise ValueError("sharded DeepFM takes no init_params or hooks")
        return _train_deepfm_sharded(cfg, sgd_cfg, train, eval_ds,
                                     eval_every, generator, mesh,
                                     checkpoint_dir, checkpoint_every,
                                     resume, device)
    path = resolve_deepfm_path(cfg, sgd_cfg)
    step_fn = make_train_step(cfg, sgd_cfg)
    state = initial_state(cfg, sgd_cfg, generator, init_params,
                          device=device)
    dedup_budget = None
    if path in ("dedup", "fused") and sgd_cfg.host_plan:
        dedup_budget = sgd_cfg.unique_budget or "ladder"
    # the next epoch's order is shuffled while this one trains: on the
    # card's host a 2^20 shuffle (~50 ms, outside the GIL) left the card
    # idle at every epoch's start
    ahead = ThreadPoolExecutor(max_workers=1)
    orders = {}

    def order_of(epoch: int):
        return epoch_order(train.num_examples,
                           shuffle=sgd_cfg.shuffle_each_epoch,
                           seed=cfg.fm.seed, epoch=epoch)

    def run_epoch(state, epoch, dispatch):
        pending = orders.pop(epoch, None)
        order = order_of(epoch) if pending is None else pending.result()
        orders[epoch + 1] = ahead.submit(order_of, epoch + 1)
        return step_loop(state, step_fn, batch_iterator(
            train, sgd_cfg.batch_size, device=device,
            dedup_budget=dedup_budget, dedup_fill=cfg.fm.num_features,
            pinned=True, order=order), dispatch)

    # the JAX package's DeepFM records hold no unique_overflow_steps
    try:
        state, history, eps = run_epochs(
            state, sgd_cfg, train.num_examples, run_epoch, path=path,
            evaluate_state=None if eval_ds is None else (
                lambda s: _eval_metrics(params_of(s, cfg), cfg, eval_ds,
                                        sgd_cfg.batch_size)),
            eval_every=eval_every, hooks=hooks,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, resume=resume,
            record_overflows=False)
    finally:
        ahead.shutdown(wait=False, cancel_futures=True)
    return TrainResult(params=params_of(state, cfg), history=history,
                       examples_per_sec=eps)


def _train_deepfm_sharded(cfg: DeepFMConfig, sgd_cfg: SGDConfig, train,
                          eval_ds, eval_every: int, generator, mesh,
                          checkpoint_dir, checkpoint_every, resume, device):
    """The sharded DeepFM loop of this rank (JAX
    ``models/deepfm.py::_train_deepfm_sharded``) through
    ``parallel/sharded_deepfm.py``'s step. The exchange
    (``MeshConfig.exchange``, honoured or refused): "auto" takes global
    host plans with ``host_plan``, else per-shard device plans; "global"
    one host ladder plan over the global batch (needs ``host_plan``);
    "unique" per-shard plans, stacked host plans with ``host_plan``;
    "dense" is refused (DeepFM's table updates are per unique row). The
    batches, checkpoints (one directory per rank), time budget and evals
    as ``training/trainer.py::_train_sgd_sharded``."""
    from sparkfm_tpu_torch.parallel import mesh as Mesh
    from sparkfm_tpu_torch.parallel import multihost as MH
    from sparkfm_tpu_torch.parallel import sharded_deepfm as SD
    from sparkfm_tpu_torch.training.trainer import (TrainResult, _rank_dir,
                                                    run_epochs, step_loop)

    mesh, exchange = Mesh.resolve_mesh(mesh, device=device)
    if exchange not in ("auto", "global", "unique"):
        raise ValueError(
            f"sharded DeepFM supports exchange auto/global/unique, got "
            f"{exchange!r} (dense slot exchange does not apply: DeepFM "
            "table updates are per-unique-row)")
    if exchange == "global" and not sgd_cfg.host_plan:
        raise ValueError("exchange='global' requires host_plan=True "
                         "(it consumes a host dedup plan)")
    mode = exchange
    if mode == "auto":
        mode = "global" if sgd_cfg.host_plan else "unique"
    d_shards = Mesh.size(mesh, Mesh.DATA_AXIS)
    if sgd_cfg.batch_size % d_shards:
        raise ValueError(f"batch_size={sgd_cfg.batch_size} not divisible by "
                         f"data axis size {d_shards}")
    state, pcfg = SD.init_sharded_state(cfg, mesh, generator)
    step_fn = SD.make_sharded_train_step(pcfg, sgd_cfg, mesh)
    score_fn = SD.make_sharded_score(pcfg, mesh)
    fill = pcfg.fm.num_features - 1
    plan_cap = E.auto_budget(sgd_cfg.batch_size * train.max_nnz)
    stacked_budget = E.auto_budget(
        (sgd_cfg.batch_size // d_shards) * train.max_nnz)
    rung = [1]

    def lift(batch):
        ids = np.asarray(batch.ids)
        if sgd_cfg.host_plan and mode == "global":
            hp = E.host_dedup(ids, plan_cap, fill)
            rung[0] = max(rung[0], E.ladder_budget(int(hp.count),
                                                   cap=plan_cap))
            plan = hp._replace(uids=hp.uids[:rung[0]], order=None,
                               seg=None, svals=None, sex=None)
            return MH.global_batch(mesh, batch, False, plan, "global")
        if sgd_cfg.host_plan:
            plan = E.stack_plans(ids, d_shards, stacked_budget, fill)
            return MH.global_batch(mesh, batch, False, plan, "stacked")
        return MH.global_batch(mesh, batch)

    def eval_metrics(state):
        outs = []
        for b in batch_iterator(eval_ds, sgd_cfg.batch_size, device="cpu"):
            gb = MH.global_batch(mesh, b)
            s = MH.collect(score_fn(state, gb.ids, gb.vals), mesh,
                           Mesh.DATA_AXIS)
            outs.append(torch.from_numpy(s[:int(b.mask.sum())]))
        return _metrics_of(torch.cat(outs), eval_ds.y, cfg.fm.task)

    def run_epoch(state, epoch, dispatch):
        batches = batch_iterator(train, sgd_cfg.batch_size, device="cpu",
                                 shuffle=sgd_cfg.shuffle_each_epoch,
                                 seed=cfg.fm.seed, epoch=epoch)
        return step_loop(state, step_fn, map(lift, batches), dispatch)

    state, history, eps = run_epochs(
        state, sgd_cfg, train.num_examples, run_epoch,
        path=f"sharded deepfm {mode}",
        evaluate_state=None if eval_ds is None else eval_metrics,
        eval_every=eval_every,
        checkpoint_dir=_rank_dir(checkpoint_dir, mesh),
        checkpoint_every=checkpoint_every, resume=resume,
        record_overflows=False,
        stop_together=lambda stop: Mesh.any_rank(stop, mesh))
    return TrainResult(
        params=SD.trimmed_params(state, mesh, cfg.fm.num_features),
        history=history, examples_per_sec=eps)
