"""Fused-record SGD: all per-feature state in one row.

Port of ``sparkfm_tpu/solvers/sgd_fused.py``: the state the hybrid, fused
and sorted paths of the port share, and the fused train step (FM and FFM)
that trains on it:

    record[f] = [ v[f] (vk) | slot_v[f] (vk) | w[f] (1) | slot_w[f] (1) | pad ]

with vk = K for plain FM and num_fields * K for FFM (V's flat row),

one (F+1, W) float32 table, so a train step does ONE unique-row gather and
ONE row write-back for parameters and optimizer state together. Row F is
the dedup plan's fill row, garbage by contract.

Record width: the JAX package pads 2vk+2 up to a multiple of 128 floats,
the TPU's lane tile. The port pads it to a multiple of 4 floats only (68
for K = 32, against 128; 356 for 22 fields at K = 8, against 384), so
every row is 16-byte aligned for the row kernels' float4 accesses
(``csrc/rowio.cu``), the table takes about half the bytes (4.6 GB against
8.6 GB at 2^24 rows) and each gather and write-back moves about half as
many. Tests compare ``table[:F, :2vk+2]``.

The train step (:func:`make_fused_train_step`):

1. one gather of the batch's unique records (kernel B1,
   ``ops/rowio.py::gather_rows``), rows past the plan's count zeroed;
2. the spread of ``[v | w]`` to the slots by the plan's ranks, and
   ``torch.autograd.grad`` of the batch loss
   (``solvers/sgd.py::_batch_loss_from_rows``) with respect to the bias
   and the per-slot rows;
3. the per-unique reduce of ``[g_v | g_w | g_v² | g_w²]`` (adagrad_row:
   ``[g_v | mean g_v² | g_w | g_w²]``): under ``accumulate="segsum"``, and
   under ``"auto"`` for CUDA tensors, the gradients permuted into id-sorted
   order and summed over runs in a fixed order, under adagrad and sgd by
   kernel B6 (``ops/segsum.py::segment_rowsum_sq``: ``[g_v | g_w]`` in,
   the squares formed in the kernel, so the pack never exists), under
   adagrad_row by kernel B5 (``segment_rowsum``) on the pack; under
   ``"scatter"``, and under ``"auto"`` for CPU tensors (the JAX package's
   choice, from a TPU measurement), ``index_add_`` of the pack by the
   ranks, whose atomic adds on the card do not repeat bit for bit;
4. the adagrad / adagrad_row / sgd update and one write-back of the
   records (kernel B2, ``ops/rowio.py::scatter_set_rows``), IN PLACE on
   ``state.table``;
5. the bias update.

It takes the batch's host plan when it has one, else builds a plan on the
device (``ops/embedding.py::dedup_ids``) with no host round trip.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sparkfm_tpu_torch.config import FMConfig, SGDConfig
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.ops import segsum
from sparkfm_tpu_torch.solvers import sgd as sgd_solver
from sparkfm_tpu_torch.utils import graphs

_INIT_CHUNK_BYTES = 1 << 28        # V drawn 256 MiB at a time


@dataclasses.dataclass
class FusedState:
    """Fused sparse state + dense scalars, all tensors on one device.
    ``table`` rows: see the module doc; row F is the fill row."""

    table: torch.Tensor         # (F+1, W) float32
    w0: torch.Tensor            # () float32
    slot_w0: torch.Tensor       # () float32
    step: torch.Tensor          # () int32


def v_lanes(cfg: FMConfig) -> int:
    """Width of one row's factor block: K for plain FM, num_fields*K for
    FFM."""
    return cfg.num_factors * max(1, cfg.num_fields)


def record_width(num_factors: int, num_fields: int = 0) -> int:
    """2*vk + 2 floats rounded up to a multiple of 4 (see module doc)."""
    need = 2 * num_factors * max(1, num_fields) + 2
    return (need + 3) // 4 * 4


def _scalars(device, w0=0.0, slot_w0=0.0, step=0):
    return dict(w0=torch.tensor(w0, dtype=torch.float32, device=device),
                slot_w0=torch.tensor(slot_w0, dtype=torch.float32,
                                     device=device),
                step=torch.tensor(step, dtype=torch.int32, device=device))


def init_fused_state(cfg: FMConfig,
                     generator: Optional[torch.Generator] = None, *,
                     device) -> FusedState:
    """V ~ N(init_mean, init_stdev) drawn straight into a zero record
    table on ``device``, w = 0, w0 = 0, all slots 0. V is drawn in chunks
    of rows, so the peak stays near the table alone (one 2^24 x 32 draw
    at once would add 2 GiB). Without a generator one is seeded from
    ``cfg.seed`` on the device; torch's numbers differ from jax.random's
    for the same seed."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    vk = v_lanes(cfg)
    f = cfg.num_features
    table = torch.zeros((f + 1, record_width(cfg.num_factors,
                                             cfg.num_fields)),
                        dtype=torch.float32, device=device)
    rows = max(1, _INIT_CHUNK_BYTES // (vk * 4))
    for off in range(0, f, rows):
        n = min(rows, f - off)
        chunk = torch.randn((n, vk), generator=generator, device=device)
        table[off:off + n, :vk] = cfg.init_mean + cfg.init_stdev * chunk
    return FusedState(table=table, **_scalars(device))


def fused_from_params(params: FMParams, cfg: FMConfig, *,
                      device) -> FusedState:
    """A fresh fused state (zero slots) on ``device`` holding a copy of
    ``params`` (F rows): the trainer's warm start."""
    vk = v_lanes(cfg)
    f = cfg.num_features
    table = torch.zeros((f + 1, record_width(cfg.num_factors,
                                             cfg.num_fields)),
                        dtype=torch.float32, device=device)
    table[:f, :vk] = params.v.detach().reshape(f, vk)
    table[:f, 2 * vk] = params.w.detach()
    state = FusedState(table=table, **_scalars(device))
    state.w0 = params.w0.detach().to(device=device, dtype=torch.float32,
                                     copy=True)
    return state


def params_from_fused(state: FusedState, cfg: FMConfig) -> FMParams:
    """FMParams copied out of the record table (F rows, contiguous, so the
    row kernels can read them)."""
    vk = v_lanes(cfg)
    f = cfg.num_features
    return FMParams(w0=state.w0.clone(),
                    w=state.table[:f, 2 * vk].contiguous(),
                    v=state.table[:f, :vk].contiguous())


def fused_state_from_numpy(table, w0, slot_w0, step, cfg: FMConfig, *,
                           device) -> FusedState:
    """A JAX FusedState carried into the port, from its arrays as numpy
    (``np.asarray(state.table)`` etc.): the record's 2*vk+2 used columns
    are kept and the JAX package's lane padding is dropped."""
    vk = v_lanes(cfg)
    need = 2 * vk + 2
    table = np.asarray(table, np.float32)
    if table.ndim != 2 or table.shape[0] != cfg.num_features + 1 or (
            table.shape[1] < need):
        raise ValueError(f"table {table.shape} is no record table for "
                         f"{cfg.num_features} features and vk={vk}")
    out = torch.zeros((table.shape[0], record_width(cfg.num_factors,
                                                    cfg.num_fields)),
                      dtype=torch.float32, device=device)
    out[:, :need] = torch.as_tensor(np.array(table[:, :need]), device=device)
    return FusedState(table=out, **_scalars(
        device, float(np.asarray(w0)), float(np.asarray(slot_w0)),
        int(np.asarray(step))))


def valid_slots(count, budget: int, device) -> torch.Tensor:
    """(budget,) bool: the plan's slots that hold a unique id. ``count``
    is a host number (host plans) or a 0-d tensor on the device (device
    plans), which is compared there, without a host round trip."""
    limit = (count.clamp(max=budget) if torch.is_tensor(count)
             else min(int(count), budget))
    return torch.arange(budget, device=device) < limit


def update_records(opt: str, sgd_cfg: SGDConfig, rec_u: torch.Tensor,
                   acc: torch.Tensor, k: int) -> torch.Tensor:
    """The optimizer update of the unique records ``rec_u`` (U, W) from
    the reduced ``acc``: ``[Σg_v | Σg_w | Σg_v² | Σg_w²]`` (U, 2k+2), the
    order in which kernels B6 (``ops/segsum.py::segment_rowsum_sq`` of
    ``[g_v | g_w]``) and B3 (``fm_grad_segsum_factored``) return it; under
    adagrad_row ``[Σg_v | Σ mean g_v² | Σg_w | Σg_w²]`` (U, k+3). Returns
    the new (U, W) records, padding zero."""
    lr, eps = sgd_cfg.learning_rate, sgd_cfg.adagrad_eps
    v_u, slot_v_u = rec_u[:, :k], rec_u[:, k:2 * k]
    w_u, slot_w_u = rec_u[:, 2 * k], rec_u[:, 2 * k + 1]
    if opt == "adagrad_row":
        g_v_u, sq_row_u = acc[:, :k], acc[:, k]
        g_w_u, sq_w_u = acc[:, k + 1], acc[:, k + 2]
        slot_row_new = slot_v_u[:, 0] + sq_row_u
        v_new = v_u - lr * g_v_u * torch.rsqrt(slot_row_new + eps)[:, None]
        slot_v_new = torch.cat([slot_row_new[:, None],
                                torch.zeros_like(slot_v_u[:, 1:])], dim=1)
        slot_w_new = slot_w_u + sq_w_u
        w_new = w_u - lr * g_w_u * torch.rsqrt(slot_w_new + eps)
    else:
        g_v_u, g_w_u = acc[:, :k], acc[:, k]
        sq_v_u, sq_w_u = acc[:, k + 1:2 * k + 1], acc[:, 2 * k + 1]
        if opt == "adagrad":
            slot_v_new = slot_v_u + sq_v_u
            v_new = v_u - lr * g_v_u * torch.rsqrt(slot_v_new + eps)
            slot_w_new = slot_w_u + sq_w_u
            w_new = w_u - lr * g_w_u * torch.rsqrt(slot_w_new + eps)
        else:
            slot_v_new, slot_w_new = slot_v_u, slot_w_u
            v_new = v_u - lr * g_v_u
            w_new = w_u - lr * g_w_u
    pad = rec_u.shape[1] - (2 * k + 2)
    return torch.cat([v_new, slot_v_new, w_new[:, None], slot_w_new[:, None],
                      rec_u.new_zeros((rec_u.shape[0], pad))], dim=1)


def segsum_accumulate(accumulate: str, device: torch.device) -> bool:
    """Whether the fused step sums per unique row over sorted runs by
    kernel B6 or B5 (True) or by ``index_add_`` (False): "segsum" always,
    "auto" for CUDA tensors, where the sorted sums are ~25x faster than
    ``index_add_`` at the main path's shape and repeat; "scatter", and
    "auto" for CPU tensors, as the JAX package's "auto" does."""
    return accumulate == "segsum" or (accumulate == "auto"
                                      and device.type == "cuda")


def make_fused_train_step(cfg: FMConfig, sgd_cfg: SGDConfig):
    """(FusedState, SparseBatch) -> (FusedState, aux), with aux holding
    ``loss`` and ``scores`` (tensors on the device) and the plan's
    ``unique_count`` and ``unique_overflow`` (host numbers for host plans,
    0-d device tensors for device plans). The returned state holds the
    same table tensor, updated in place.

    Optimizers: "adagrad" (element-wise accumulators), "adagrad_row" (one
    accumulator per row, the mean of the squared gradient over the k
    lanes, kept in slot lane 0) and plain "sgd". The module doc lists the
    steps; the kernels are looked up through their modules at each call.
    """
    if sgd_cfg.optimizer not in ("adagrad", "adagrad_row", "sgd"):
        raise ValueError("fused path supports adagrad/adagrad_row/sgd; use "
                         "update_path='dedup' for adam/momentum")
    if sgd_cfg.momentum > 0 and sgd_cfg.optimizer == "sgd":
        raise ValueError("fused path: momentum not supported")
    if sgd_cfg.accumulate not in ("auto", "scatter", "segsum"):
        raise ValueError(
            f"unknown accumulate={sgd_cfg.accumulate!r}; expected "
            "'auto', 'scatter' or 'segsum'")
    k = v_lanes(cfg)
    opt = sgd_cfg.optimizer
    reg_cpu = sgd_solver.reg_vectors(cfg)
    reg_on = {}                         # device -> the reg vectors there

    def train_step(state: FusedState, batch):
        device = state.table.device
        plan = batch.plan
        if plan is not None:
            budget = plan.uids.shape[0]
        else:
            budget = sgd_cfg.unique_budget or E.auto_budget(batch.ids.numel())
            plan = E.dedup_ids(batch.ids, budget,
                               fill=state.table.shape[0] - 1)
        use_segsum = segsum_accumulate(sgd_cfg.accumulate, device)
        if use_segsum and plan.order is None:
            raise ValueError(
                f"accumulate={sgd_cfg.accumulate!r} on {device} sums by "
                "sorted runs and requires a plan with the id-sort "
                "permutation (plan.order/plan.seg); both dedup_ids and "
                "host_dedup emit it - this plan was built without it")
        if reg_cpu is not None and device not in reg_on:
            reg_on[device] = tuple(r.to(device) for r in reg_cpu)

        with torch.no_grad():
            rec_u = E.gather_unique(state.table, plan)          # (U, W)
            rec_u = torch.where(
                valid_slots(plan.count, budget, device)[:, None], rec_u, 0.0)
            vw_u = torch.cat([rec_u[:, :k], rec_u[:, 2 * k:2 * k + 1]], 1)
            vw_rows = E.spread(vw_u, plan)                      # (B, L, k+1)
        w0 = state.w0.detach().requires_grad_()
        w_rows = vw_rows[..., k].detach().requires_grad_()
        v_rows = vw_rows[..., :k].detach().requires_grad_()
        with torch.enable_grad():
            total, (scores, data_loss) = sgd_solver._batch_loss_from_rows(
                w0, w_rows, v_rows, batch, cfg, reg_on.get(device))
            g_w0, g_wrows, g_vrows = torch.autograd.grad(
                total, (w0, w_rows, v_rows))

        with torch.no_grad():
            gv_s = g_vrows.reshape(-1, k)
            gw_s = g_wrows.reshape(-1, 1)
            if use_segsum:
                gvw_s = torch.cat([gv_s, gw_s], 1).index_select(
                    0, plan.order.long())
                gv_s, gw_s = gvw_s[:, :k], gvw_s[:, k:]
            if use_segsum and opt != "adagrad_row":
                # B6 forms the squares, so the (N, 2k+2) pack is never built
                acc = segsum.segment_rowsum_sq(gvw_s, plan.seg, budget)
            else:
                if opt == "adagrad_row":
                    parts = [gv_s, gv_s.square().mean(dim=-1, keepdim=True),
                             gw_s, gw_s.square()]               # (N, k+3)
                else:                                 # B6's column order
                    parts = [gv_s, gw_s, gv_s.square(), gw_s.square()]
                packed = torch.cat(parts, dim=1)
                if use_segsum:
                    acc = segsum.segment_rowsum(packed, plan.seg, budget)
                else:
                    acc = E.accumulate_to_unique(
                        packed.view(*plan.ranks.shape, -1), plan, budget)
            E.scatter_set_unique(state.table, plan,
                                 update_records(opt, sgd_cfg, rec_u, acc, k))
            if cfg.use_bias:
                w0_new, slot_w0, _ = sgd_solver._dense_scalar_update(
                    opt, sgd_cfg.learning_rate, sgd_cfg, state.w0,
                    state.slot_w0, None, g_w0, state.step)
            else:
                w0_new, slot_w0 = state.w0, state.slot_w0

        new_state = dataclasses.replace(state, w0=w0_new, slot_w0=slot_w0,
                                        step=state.step + 1)
        return new_state, {"loss": data_loss.detach(),
                           "scores": scores.detach(),
                           "unique_count": plan.count,
                           "unique_overflow": plan.overflow}

    return train_step


def make_fused_multi_step(cfg: FMConfig,
                          sgd_cfg: SGDConfig) -> graphs.MultiStep:
    """G fused steps per call, the fused twin of
    ``sgd_hybrid.make_hybrid_multi_step``: ``multi(state, stacked) ->
    (state, aux)`` over batches stacked by ``sgd_hybrid.stack_batches``
    (one plan shape: a ladder rung, or batches without plans, whose
    device plans have a fixed budget), exactly the sequence of G single
    steps. On the card one CUDA graph per input shape and G, captured
    with ``torch.autograd.grad`` inside it after the shape's first group
    ran eagerly (which also fills the step's per-device cache of the
    group L2 vectors); on the CPU the steps one after another. As in the
    JAX package, the trainer does not call it."""
    return graphs.MultiStep(make_fused_train_step(cfg, sgd_cfg))
