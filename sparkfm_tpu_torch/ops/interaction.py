"""Second-order FM and field-aware FM (FFM) interactions, as torch ops.

Port of ``sparkfm_tpu/ops/interaction.py``. Rendle's O(k * nnz) identity,
batched over padded CSR batches (ids (B, L) int32, vals (B, L); padding
slots have val == 0, an exact no-op):

    y2(x) = 1/2 * sum_f [ (sum_i v_{f,i} x_i)^2 - sum_i v_{f,i}^2 x_i^2 ]

FFM gives each feature one K-vector per field, stored flat as a
(num_fields * K) row; the pair (a, b) contributes
<v_a[field(b)], v_b[field(a)]> x_a x_b. Three forms compute it: the
field-aggregated one (:func:`ffm_interaction_from_rows`), the slot-major
one for batches whose slot l holds a feature of field l
(:func:`ffm_interaction_slot_major`), and the per-pair oracle
(:func:`ffm_scores_pairwise`).

The math stays plain torch, as the JAX package left it to XLA. For the
plain FM it is a small share of a call next to the table reads; FFM at
Criteo's 39 fields (741 pairs an example, (B, 39, 39, K) tensors) makes
it most of a fused training step (``PERF.md``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from sparkfm_tpu_torch.ops import rowio


def interaction_from_rows(vx: torch.Tensor) -> torch.Tensor:
    """(B,) interaction from (B, L, K) rows already scaled by their values
    (padded slots exactly zero)."""
    s = vx.sum(dim=1)                                  # (B, K)
    sq = vx.square().sum(dim=(1, 2))                   # (B,)
    return 0.5 * (s.square().sum(dim=-1) - sq)


def _linear_and_bias(out, w0, w_rows, vals_c, use_bias, use_linear,
                     compute_dtype):
    """The interaction ``out`` plus <w, x> and w0, as float32."""
    if use_linear:
        out = out + (w_rows.to(compute_dtype) * vals_c).sum(dim=-1)
    if use_bias:
        out = out + w0.to(compute_dtype)
    return out.to(torch.float32)


def fm_scores_from_gathered(w0: torch.Tensor, w_rows: torch.Tensor,
                            v_rows: torch.Tensor, vals: torch.Tensor,
                            use_bias: bool = True, use_linear: bool = True,
                            compute_dtype=torch.float32) -> torch.Tensor:
    """(B,) float32 raw scores from gathered rows: w0 scalar, w_rows
    (B, L), v_rows (B, L, K), vals (B, L)."""
    vals_c = vals.to(compute_dtype)
    out = interaction_from_rows(v_rows.to(compute_dtype) * vals_c[..., None])
    return _linear_and_bias(out, w0, w_rows, vals_c, use_bias, use_linear,
                            compute_dtype)


def fm_scores(w0: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
              ids: torch.Tensor, vals: torch.Tensor,
              use_bias: bool = True, use_linear: bool = True,
              compute_dtype=torch.float32) -> torch.Tensor:
    """(B,) raw scores w0 + <w, x> + interaction, reading each slot's rows
    of v (F, K) and w (F,) straight from the tables with the two-table
    gather kernel."""
    flat = ids.reshape(-1).to(torch.int32)
    k = v.shape[1]
    vw_rows = rowio.gather_vw_rows(v, w, flat).view(*ids.shape, k + 1)
    w_rows, v_rows = vw_rows[..., k], vw_rows[..., :k]
    return fm_scores_from_gathered(w0, w_rows, v_rows, vals,
                                   use_bias=use_bias, use_linear=use_linear,
                                   compute_dtype=compute_dtype)


def _field_rows(vr: torch.Tensor, num_fields: int) -> torch.Tensor:
    """(B, L, num_fields, K) view of flat (B, L, num_fields * K) rows."""
    if vr.dim() == 3:
        vr = vr.reshape(vr.shape[0], vr.shape[1], num_fields, -1)
    return vr


def ffm_interaction_from_rows(vr: torch.Tensor, vals_c: torch.Tensor,
                              field_ids: torch.Tensor,
                              num_fields: int) -> torch.Tensor:
    """(B,) FFM interaction, aggregated by source field: with
    S[b, u, t] = sum over slots a of field u of x_a v_a[t], the ordered
    pairs sum to T = sum_{t,u} <S[u, t], S[t, u]>, and the interaction is
    (T - D) / 2, D = sum_a x_a^2 |v_a[field(a)]|^2 removing the self
    pairs. O(B F^2 K) memory instead of the pairwise form's O(B L^2 K).

    vr: (B, L, F, K) or flat (B, L, F*K) rows; vals_c: (B, L), padding 0;
    field_ids: (B, L) int field of each slot."""
    vr = _field_rows(vr, num_fields)
    f_oh = nnf.one_hot(field_ids.long(), num_fields).to(vr.dtype)
    xv = vr * vals_c[..., None, None]                        # (B, L, F, K)
    s = torch.einsum("bau,batk->butk", f_oh, xv)             # (B, F, F, K)
    total = torch.einsum("butk,btuk->b", s, s)
    vaa = torch.einsum("batk,bat->bak", xv, f_oh)            # (B, L, K)
    return 0.5 * (total - vaa.square().sum(dim=(1, 2)))


def ffm_interaction_slot_major(vr: torch.Tensor,
                               vals_c: torch.Tensor) -> torch.Tensor:
    """(B,) FFM interaction when slot a is field a (L == num_fields, the
    fixed-column hashed-CTR layout): the field aggregation is the
    identity, so T = sum_{t,u} <xv[u, t], xv[t, u]> and the self pairs are
    |xv[a, a]|^2, with no one-hot. vr: (B, L, L, K)."""
    _, l, fq, _ = vr.shape
    if l != fq:
        raise ValueError(
            f"slot-major FFM requires one slot per field (L == num_fields),"
            f" got L={l}, num_fields={fq}")
    xv = vr * vals_c[..., None, None]                        # (B, L, F, K)
    total = (xv * xv.transpose(1, 2)).sum(dim=(1, 2, 3))
    # xv[:, a, a, :] as a view: its gradient is a strided copy, where
    # advanced indexing's would be an accumulating index_put_
    diag = torch.diagonal(xv, dim1=1, dim2=2).square().sum(dim=(1, 2))
    return 0.5 * (total - diag)


def ffm_scores_from_gathered(w0: torch.Tensor, w_rows: torch.Tensor,
                             v_rows: torch.Tensor, vals: torch.Tensor,
                             field_ids, num_fields: int,
                             use_bias: bool = True, use_linear: bool = True,
                             compute_dtype=torch.float32,
                             slot_major: bool = False) -> torch.Tensor:
    """(B,) float32 FFM raw scores from gathered rows: v_rows (B, L, F, K)
    or flat (B, L, F*K), w_rows (B, L), vals (B, L), field_ids (B, L).
    With ``slot_major`` (``FMConfig.slot_major_fields``) field_ids are not
    read (may be None) and the slot-major form runs; otherwise the
    field-aggregated form."""
    vals_c = vals.to(compute_dtype)
    vr = _field_rows(v_rows.to(compute_dtype), num_fields)
    if slot_major:
        out = ffm_interaction_slot_major(vr, vals_c)
    else:
        out = ffm_interaction_from_rows(vr, vals_c, field_ids, num_fields)
    return _linear_and_bias(out, w0, w_rows, vals_c, use_bias, use_linear,
                            compute_dtype)


def ffm_scores_pairwise(w0: torch.Tensor, w_rows: torch.Tensor,
                        v_rows: torch.Tensor, vals: torch.Tensor,
                        field_ids: torch.Tensor, num_fields: int,
                        use_bias: bool = True, use_linear: bool = True,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """The per-pair FFM form, O(B L^2 K) memory: <v_a[field(c)],
    v_c[field(a)]> x_a x_c over the slot pairs a < c. The oracle of the
    other two forms."""
    l = vals.shape[1]
    vals_c = vals.to(compute_dtype)
    vr = _field_rows(v_rows.to(compute_dtype), num_fields)
    f_oh = nnf.one_hot(field_ids.long(), num_fields).to(compute_dtype)
    v_toward = torch.einsum("batk,bct->back", vr, f_oh)       # (B, L, L, K)
    pair_dot = torch.einsum("back,bcak->bac", v_toward, v_toward)
    xx = vals_c[:, :, None] * vals_c[:, None, :]
    upper = torch.triu(torch.ones((l, l), dtype=torch.bool,
                                  device=vals.device), diagonal=1)
    out = torch.where(upper, pair_dot * xx, 0.0).sum(dim=(1, 2))
    return _linear_and_bias(out, w0, w_rows, vals_c, use_bias, use_linear,
                            compute_dtype)
