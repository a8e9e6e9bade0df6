"""Second-order FM interaction (plain FM), as torch ops.

Port of the plain-FM forms of ``sparkfm_tpu/ops/interaction.py``. Rendle's
O(k * nnz) identity, batched over padded CSR batches (ids (B, L) int32,
vals (B, L); padding slots have val == 0, an exact no-op):

    y2(x) = 1/2 * sum_f [ (sum_i v_{f,i} x_i)^2 - sum_i v_{f,i}^2 x_i^2 ]

The math stays plain torch, as the JAX package left it to XLA: it is a
small share of a call next to the table reads. The field-aware forms are
not ported yet.
"""

from __future__ import annotations

import torch

from sparkfm_tpu_torch.ops import rowio


def interaction_from_rows(vx: torch.Tensor) -> torch.Tensor:
    """(B,) interaction from (B, L, K) rows already scaled by their values
    (padded slots exactly zero)."""
    s = vx.sum(dim=1)                                  # (B, K)
    sq = vx.square().sum(dim=(1, 2))                   # (B,)
    return 0.5 * (s.square().sum(dim=-1) - sq)


def fm_scores_from_gathered(w0: torch.Tensor, w_rows: torch.Tensor,
                            v_rows: torch.Tensor, vals: torch.Tensor,
                            use_bias: bool = True, use_linear: bool = True,
                            compute_dtype=torch.float32) -> torch.Tensor:
    """(B,) float32 raw scores from gathered rows: w0 scalar, w_rows
    (B, L), v_rows (B, L, K), vals (B, L)."""
    vals_c = vals.to(compute_dtype)
    out = interaction_from_rows(v_rows.to(compute_dtype) * vals_c[..., None])
    if use_linear:
        out = out + (w_rows.to(compute_dtype) * vals_c).sum(dim=-1)
    if use_bias:
        out = out + w0.to(compute_dtype)
    return out.to(torch.float32)


def fm_scores(w0: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
              ids: torch.Tensor, vals: torch.Tensor,
              use_bias: bool = True, use_linear: bool = True,
              compute_dtype=torch.float32) -> torch.Tensor:
    """(B,) raw scores w0 + <w, x> + interaction, reading each slot's rows
    of w (F,) and v (F, K) straight from the tables with the row-gather
    kernel."""
    flat = ids.reshape(-1).to(torch.int32)
    v_rows = rowio.gather_rows(v, flat).view(*ids.shape, v.shape[1])
    w_rows = rowio.gather_rows(w.view(-1, 1), flat).view(ids.shape)
    return fm_scores_from_gathered(w0, w_rows, v_rows, vals,
                                   use_bias=use_bias, use_linear=use_linear,
                                   compute_dtype=compute_dtype)
