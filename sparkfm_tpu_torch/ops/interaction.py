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
(:func:`ffm_scores_pairwise`). The Compressed Interaction Network of
xDeepFM (:func:`cin_forward`, :func:`cin_backward`) forms explicit
interactions of every order up to its depth from the field embeddings.

The math stays plain torch, as the JAX package left it to XLA, with one
exception: the slot-major FFM's loss and row gradients in a training
step (:func:`ffm_slot_major_loss_grad`), which at Criteo's 39 fields (741
pairs an example, (B, 39, 39, K) tensors) took most of a fused step as
autograd over those forms (``PERF.md``). On CUDA tensors it runs one
hand-written kernel (``csrc/interaction.cu``) that reads each slot's
``[v | w]`` row once and writes its ``[g_v | g_w]`` row once; on CPU
tensors its plain version, the autograd route.
"""

from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as nnf

from sparkfm_tpu_torch.config import Task
from sparkfm_tpu_torch.ops import losses as L
from sparkfm_tpu_torch.ops import rowio
from sparkfm_tpu_torch.utils.build import PACKAGE_DIR, CudaKernel

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "interaction.cu")
MAX_FIELDS = 64                 # the largest F the step sends the kernel
FACTORS = (1, 2, 4, 8, 16)      # the kernel's K (its template cases)
MAX_SMEM = 227 * 1024           # a block's shared memory on the H100
FFM_SLOT_MAJOR = CudaKernel(
    "interaction", SOURCE, "sfm_ffm_slot_major",
    [ctypes.c_void_p] * 8 + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 3
    + [ctypes.c_int64] + [ctypes.c_int] * 5)


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


def fm_linear_from_gathered(w0: torch.Tensor, w_rows: torch.Tensor,
                            vals: torch.Tensor, use_bias: bool = True,
                            use_linear: bool = True) -> torch.Tensor:
    """(B,) float32 first-order scores w0 + <w, x> from gathered rows:
    xDeepFM's linear head, beside its CIN."""
    vals_c = vals.to(torch.float32)
    out = torch.zeros(vals.shape[:1], dtype=torch.float32,
                      device=vals.device)
    return _linear_and_bias(out, w0, w_rows, vals_c, use_bias, use_linear,
                            torch.float32)


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


def slot_major_tile_floats(fields: int, k: int) -> int:
    """Floats of the slot-major kernel's tile in shared memory: the
    example's F (F K + 1) floats at their offset past a 16-byte bound (0
    to 3 floats) and their copy rounded out to 16 bytes. The kernel takes
    it, and :func:`slot_major_smem_bytes`, from the launch."""
    n = fields * (fields * k + 1)
    return (n + 6) // 4 * 4


def slot_major_smem_bytes(fields: int, k: int) -> int:
    """Shared memory of one block of the slot-major kernel: the tile, then
    three floats a slot (its value and two L2 coefficients)."""
    return (slot_major_tile_floats(fields, k) + 3 * fields) * 4


def slot_major_kernel_takes(fields: int, k: int) -> bool:
    """Whether :func:`ffm_slot_major_loss_grad` takes F = ``fields``
    slots of K = ``k`` factors a field: F <= MAX_FIELDS, K in FACTORS and
    an example's rows in a block's shared memory."""
    return (1 <= fields <= MAX_FIELDS and k in FACTORS
            and slot_major_smem_bytes(fields, k) <= MAX_SMEM)


def ffm_slot_major_loss_grad_reference(w0, vw_rows, vals, y, mask,
                                       task: Task, *, use_bias: bool,
                                       use_linear: bool, reg0, reg_w,
                                       reg_v):
    """Plain version of :func:`ffm_slot_major_loss_grad`: the slot-major
    scores, the task's loss and the per-appearance L2 term
    (``losses.appearance_l2``), differentiated by ``torch.autograd.grad``
    in the rows' dtype, as the fused step ran them before the kernel."""
    b, l, width = vw_rows.shape
    vk = width - 1
    w0 = w0.detach().requires_grad_()
    w_rows = vw_rows[..., vk].detach().requires_grad_()
    v_rows = vw_rows[..., :vk].detach().requires_grad_()
    weights = None if mask is None else mask.to(torch.float32)
    with torch.enable_grad():
        vals_c = vals.to(vw_rows.dtype)
        s = ffm_interaction_slot_major(_field_rows(v_rows, l), vals_c)
        if use_linear:
            s = s + (w_rows * vals_c).sum(dim=-1)
        if use_bias:
            s = s + w0
        data_loss = L.loss_for_task(task)(s, y, weights)
        reg = L.appearance_l2(w0, w_rows, v_rows, vals, weights, reg0, reg_w,
                              reg_v)
        g_w0, g_w, g_v = torch.autograd.grad(data_loss + reg,
                                             (w0, w_rows, v_rows))
    g = torch.cat([g_v.reshape(b * l, vk), g_w.reshape(b * l, 1)], 1)
    return s.detach(), data_loss.detach(), g_w0, g


def _check_loss_grad(w0, vw_rows, vals, y, mask, reg_w, reg_v) -> int:
    """Raises on what :func:`ffm_slot_major_loss_grad` does not take;
    returns K."""
    if vw_rows.dim() != 3:
        raise ValueError(f"ffm_slot_major_loss_grad takes (B, F, F K + 1) "
                         f"rows, got {tuple(vw_rows.shape)}")
    b, l, width = vw_rows.shape
    k = (width - 1) // l if l else 0
    if k * l + 1 != width or not slot_major_kernel_takes(l, k):
        raise ValueError(f"ffm_slot_major_loss_grad takes F in [1, "
                         f"{MAX_FIELDS}] slots of F K + 1 floats with K in "
                         f"{FACTORS}, the F rows within {MAX_SMEM} bytes, "
                         f"got rows {tuple(vw_rows.shape)}")
    dtype = vw_rows.dtype
    if vw_rows.device.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"ffm_slot_major_loss_grad's kernel takes float32 "
                         f"rows, got {dtype}")
    if vw_rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ffm_slot_major_loss_grad has no kernel for "
                         f"{vw_rows.device}")
    want = {"vw_rows": (vw_rows, (b, l, width)), "vals": (vals, (b, l)),
            "y": (y, (b,)), "w0": (w0, ())}
    for name, t in (("reg_w", reg_w), ("reg_v", reg_v)):
        if torch.is_tensor(t):
            want[name] = (t, (b, l))
    for name, (t, shape) in want.items():
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"ffm_slot_major_loss_grad takes a contiguous "
                             f"{dtype} {name} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}"
                             f"{'' if t.is_contiguous() else ', strided'}")
    if mask is not None and (tuple(mask.shape) != (b,)
                             or not mask.is_contiguous()):
        raise ValueError(f"ffm_slot_major_loss_grad takes a contiguous (B,) "
                         f"mask, got {tuple(mask.shape)}")
    tensors = [t for t, _ in want.values()] + ([mask] if mask is not None
                                                else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    return k


def ffm_slot_major_loss_grad(w0: torch.Tensor, vw_rows: torch.Tensor,
                             vals: torch.Tensor, y: torch.Tensor, mask,
                             task: Task, *, use_bias: bool, use_linear: bool,
                             reg0: float, reg_w, reg_v):
    """The slot-major FFM's scores, data loss and gradients of data loss +
    per-appearance L2 (``losses.appearance_l2``) for one batch, from the
    per-slot rows ``vw_rows`` (B, F, F K + 1), each ``[v | w]`` with v's F
    K-vectors toward each field (slot a holds field a): returns
    ``(scores (B,), data loss (), g_w0 (), g (B F, F K + 1))``, g the
    rows' ``[g_v | g_w]`` in their own layout. ``vals`` (B, F), ``y``
    (B,), ``mask`` None or (B,) (False = padding), ``w0`` 0-d; ``reg_w``
    and ``reg_v`` floats or per-slot (B, F) tensors. F <= 64, K in
    {1, 2, 4, 8, 16}.

    CUDA tensors (float32) run the kernel ``csrc/interaction.cu``, one
    launch counted on ``FFM_SLOT_MAJOR``, then a few (B,)-sized torch ops
    for the loss and g_w0; CPU tensors run the plain version, the
    autograd route (:func:`ffm_slot_major_loss_grad_reference`)."""
    k = _check_loss_grad(w0, vw_rows, vals, y, mask, reg_w, reg_v)
    if vw_rows.device.type == "cpu":
        return ffm_slot_major_loss_grad_reference(
            w0, vw_rows, vals, y, mask, task, use_bias=use_bias,
            use_linear=use_linear, reg0=reg0, reg_w=reg_w, reg_v=reg_v)
    b, l, width = vw_rows.shape
    weights = None if mask is None else mask.to(torch.float32)
    wsum = None if weights is None else weights.sum()
    g = torch.empty((b * l, width), dtype=torch.float32,
                    device=vw_rows.device)
    out = torch.empty((2, b), dtype=torch.float32, device=vw_rows.device)
    if b:
        flags = ((1 if task != Task.REGRESSION else 0)
                 | (2 if use_bias else 0) | (4 if use_linear else 0))

        def ptr(t):
            return t.data_ptr() if torch.is_tensor(t) else None

        def scalar(t):
            return 0.0 if torch.is_tensor(t) else float(t)
        FFM_SLOT_MAJOR.launch(
            vw_rows.device, vw_rows.data_ptr(), vals.data_ptr(), y.data_ptr(),
            ptr(weights), ptr(wsum), w0.data_ptr(), ptr(reg_v), ptr(reg_w),
            scalar(reg_v), scalar(reg_w), 1.0 / b, 2.0 / b, g.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), b, l, k,
            slot_major_tile_floats(l, k), slot_major_smem_bytes(l, k), flags)
    scores, dlds = out[0], out[1]
    data_loss = L.loss_for_task(task)(scores, y, weights)
    g_w0 = w0 * (2.0 * reg0)
    if use_bias:
        g_w0 = g_w0 + dlds.sum()
    return scores, data_loss, g_w0, g


# ---------------------------------------------------------------------------
# Compressed Interaction Network (xDeepFM)

def cin_forward(e: torch.Tensor, weights):
    """The Compressed Interaction Network of xDeepFM (Lian et al. 2018,
    eqs. (6)-(8)) over the m field embeddings ``e`` (B, m, D):

        X^k_{h,*} = sum_{i <= H_{k-1}} sum_{j <= m} W^k_{h,(i,j)}
                    (X^{k-1}_{i,*} o X^0_{j,*}),   X^0 = e,

    no bias, the identity activation, every layer's H_k maps sum-pooled
    over D into p+ = [p^1 | ... | p^K]. ``weights``: W^k (H_k, H_{k-1} m),
    column i m + j. Works on D-major rows, N = B D: row b D + d of x_k
    (N, H_k) holds coordinate d of example b's maps, so each layer is the
    outer product z_k = x_{k-1} o x_0 (N, H_{k-1} m) and one GEMM
    z_k W^k^T; in float32 its products follow
    ``torch.backends.cuda.matmul.allow_tf32``, which the port leaves False.

    Returns (p+ (B, sum H_k), saved): ``saved`` = (xs, zs), the layers'
    maps x_0..x_{K-1} and products z_1..z_K that :func:`cin_backward`
    reads."""
    b, m, d = e.shape
    x = e.transpose(1, 2).reshape(b * d, m)
    xs, zs, pools = [x], [], []
    for w in weights:
        z = (x[:, :, None] * xs[0][:, None, :]).view(b * d, -1)
        x = torch.mm(z, w.t())
        pools.append(x.view(b, d, -1).sum(1))
        zs.append(z)
        xs.append(x)
    return torch.cat(pools, 1), (xs[:-1], zs)


def cin_backward(e: torch.Tensor, weights, saved, g_p: torch.Tensor):
    """Gradients of :func:`cin_forward` from g_p = dL/dp+ (B, sum H_k):
    returns (dL/de (B, m, D), [dL/dW^k]). Per layer, last first: dL/dx_k
    is g_p's block p^k spread over D plus what layer k + 1 passed down;
    dW^k = dx_k^T z_k and dz_k = dx_k W^k (N, H_{k-1}, m), whose
    contractions with x_0 and x_{k-1} give dL/dx_{k-1} and layer k's part
    of dL/dx_0."""
    b, m, d = e.shape
    xs, zs = saved
    x0 = xs[0]
    widths = [w.shape[0] for w in weights]
    g_x0 = torch.zeros_like(x0)
    down, g_w = None, [None] * len(weights)
    for k in reversed(range(len(weights))):
        g = g_p[:, sum(widths[:k]):sum(widths[:k + 1])]
        g_x = g[:, None, :].expand(b, d, widths[k]).reshape(b * d, -1)
        if down is not None:
            g_x = g_x + down
        g_w[k] = torch.mm(g_x.t(), zs[k])
        g_z = torch.mm(g_x, weights[k]).view(b * d, -1, m)
        g_x0 += torch.bmm(xs[k][:, None, :], g_z)[:, 0]
        down = torch.bmm(g_z, x0[:, :, None])[:, :, 0]
    g_x0 += down
    return g_x0.view(b, d, m).transpose(1, 2), g_w
