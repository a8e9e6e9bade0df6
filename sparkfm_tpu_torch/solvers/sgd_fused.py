"""Fused-record training state: all per-feature state in one row.

Port of the state half of ``sparkfm_tpu/solvers/sgd_fused.py`` (the fused
train step itself comes with ROADMAP A9):

    record[f] = [ v[f] (K) | slot_v[f] (K) | w[f] (1) | slot_w[f] (1) | pad ]

one (F+1, W) float32 table, so a train step does ONE unique-row gather and
ONE row write-back for parameters and optimizer state together. Row F is
the dedup plan's fill row, garbage by contract.

Record width: the JAX package pads 2K+2 up to a multiple of 128 floats,
the TPU's lane tile. The port pads it to a multiple of 4 floats only (68
for K = 32, against 128), so every row is 16-byte aligned for the row
kernels' float4 accesses (``csrc/rowio.cu``), the table takes about half
the bytes (4.6 GB against 8.6 GB at 2^24 rows) and each gather and
write-back moves about half as many. Tests compare ``table[:F, :2K+2]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sparkfm_tpu_torch.config import FMConfig
from sparkfm_tpu_torch.models.fm import FMParams

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
