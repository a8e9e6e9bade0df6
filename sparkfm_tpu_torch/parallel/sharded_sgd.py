"""Sharded SGD: examples split over the ``data`` axis, the w/V tables'
rows over the ``model`` axis. Port of ``sparkfm_tpu/parallel/
sharded_sgd.py`` onto ``torch.distributed``: each rank runs the step on
its own rows of the batch and its own rows of the tables, and the
collectives of ``parallel/mesh.py`` move what the JAX ``shard_map`` moves.

The forward reads every row a rank needs by a masked local lookup (the
two-table gather, kernel B1, with local row ids; rows of other shards
zeroed) and one ``psum`` over ``model``. Three exchanges carry the
backward (``make_sharded_train_step(..., exchange=...)``):

- ``"unique"``: each data shard dedups its ids (a stacked host plan or a
  plan built on the device), sums its per-slot gradients per unique id,
  ``[Σg | Σg²]``, and ``all_gather``s them with the uids over ``data``;
  each model shard applies the rows it owns.
- ``"global"``: one host plan over the whole global batch puts every
  shard's per-unique sums in the same rank space, so the exchange is one
  ``psum`` over ``data``. With per-shard sorted extras in the plan
  (``ops/embedding.py::stack_hybrid_extras``) the local sums are the
  hybrid step's analytic sorted backward, kernel B3
  (``ops/segsum.py::fm_grad_segsum_factored``), added into the shared
  rank space through the extras' gmap.
- ``"dense"``: the per-slot gradients themselves are gathered over
  ``data``; the only exchange for adam and momentum, whose slot updates
  do not decompose into per-shard sums, and the oracle of the others.
  Each model shard keeps only the slots it owns and applies them as the
  one-device direct step does (``solvers/sgd.py::update_plan_rows``: one
  plan over their local ids, the rows written back by kernel B2, which
  their distinct ids allow). The JAX step applies every slot, the others
  masked to local row 0 with zero gradients, which under adam and
  momentum sets row 0's moments and adds their step to it
  (``sparkfm_tpu/parallel/sharded_sgd.py:669-681``); the port updates as
  one device does.

The unique and global exchanges' owner update adds: an id appears once
per data shard after the unique exchange's gather, and ids a shard does
not own are masked to its local row 0 with zero sums, so the update is
``index_add_`` and never a row write (kernel B2 keeps the first row of a
run of equal ids). The loss
is exact across uneven shards: per-shard sums over the global count of
valid examples (a ``psum``).

The steps update the rank's tables in place, as the single-device steps
do, and return the state with its new bias and step count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.models import fm as fm_model
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import embedding as E
from sparkfm_tpu_torch.ops import interaction as I
from sparkfm_tpu_torch.ops import rowio, segsum
from sparkfm_tpu_torch.parallel import mesh as M
from sparkfm_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from sparkfm_tpu_torch.solvers import sgd as sgd_solver
from sparkfm_tpu_torch.solvers.sgd import SGDState
from sparkfm_tpu_torch.solvers.sgd_fused import segsum_accumulate, valid_slots

EXCHANGES = ("unique", "global", "dense")


def padded_config(cfg: FMConfig, model_size: int) -> FMConfig:
    """``cfg`` with num_features + 1 padded up to a multiple of the model
    axis. The padding rows are never referenced by an example; the last
    is the dedup fill row (F_pad - 1, on the last model shard), which
    receives only exact-zero adds. With ``feature_groups`` the padding
    rows join one extra group of zero L2, so ``reg_vectors`` stays
    consistent and the fill row is never pulled."""
    f_pad = M.pad_to_multiple(cfg.num_features + 1, model_size)
    pcfg = cfg.replace(num_features=f_pad)
    if cfg.feature_groups is not None:
        g_pad = cfg.num_groups
        groups = tuple(cfg.feature_groups) + (g_pad,) * (
            f_pad - cfg.num_features)

        def extend(per_group, scalar):
            base = (tuple(float(x) for x in per_group)
                    if per_group is not None else (float(scalar),) * g_pad)
            return base + (0.0,)
        pcfg = pcfg.replace(feature_groups=groups,
                            group_reg_w=extend(cfg.group_reg_w, cfg.reg_w),
                            group_reg_v=extend(cfg.group_reg_v, cfg.reg_v))
    return pcfg


def _shard_state(full: SGDState, mesh) -> SGDState:
    """This rank's rows of a state over the padded tables (copies)."""
    def rows(x):
        return x if x.dim() == 0 else M.row_shard(x, mesh).clone()
    p = full.params
    return SGDState(params=FMParams(w0=p.w0.clone(), w=rows(p.w),
                                    v=rows(p.v)),
                    slot_w0=full.slot_w0.clone(), slot_w=rows(full.slot_w),
                    slot_v=rows(full.slot_v),
                    slot2_w0=full.slot2_w0.clone(),
                    slot2_w=rows(full.slot2_w), slot2_v=rows(full.slot2_v),
                    step=full.step.clone())


def init_sharded_state(cfg: FMConfig, mesh,
                       generator: Optional[torch.Generator] = None,
                       optimizer: Optional[str] = None) -> tuple:
    """(this rank's SGDState, padded cfg). Every rank draws the whole init
    from ``generator`` (default: seeded from ``cfg.seed``), so all agree,
    and keeps its rows: first the F true rows, as the one-device
    ``init_params`` draws them, then the padding rows, so that the true
    rows are the same on every mesh shape and on one device.
    ``optimizer`` as ``solvers/sgd.py::init_state``: not "adam" keeps 0-d
    slot2 placeholders."""
    pcfg = padded_config(cfg, M.size(mesh, MODEL_AXIS))
    device = M.device_of(mesh)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    true = fm_model.init_params(cfg, generator, device=device)
    pad = fm_model.init_params(
        cfg.replace(num_features=pcfg.num_features - cfg.num_features),
        generator, device=device)
    params = FMParams(w0=true.w0, w=torch.cat([true.w, pad.w]),
                      v=torch.cat([true.v, pad.v]))
    full = sgd_solver.init_state(params, optimizer=optimizer)
    return _shard_state(full, mesh), pcfg


def sharded_state_from_numpy(w0, w, v, slot_w0, slot_w, slot_v, slot2_w0,
                             slot2_w, slot2_v, step, mesh) -> SGDState:
    """This rank's shard of a JAX ``SGDState`` over padded tables (from
    ``init_sharded_state`` there), given as whole numpy arrays."""
    full = sgd_solver.state_from_numpy(
        w0, w, v, slot_w0, slot_w, slot_v, slot2_w0, slot2_w, slot2_v, step,
        device=M.device_of(mesh))
    return _shard_state(full, mesh)


def collect_state(state: SGDState, mesh) -> dict:
    """The whole state as host numpy arrays by field name (``w0``, ``w``,
    ``v``, ``slot_w``, ...), the tables gathered over ``model``; the same
    on every rank."""
    from sparkfm_tpu_torch.parallel.multihost import collect
    out = {}
    for name, t in (("w0", state.params.w0), ("w", state.params.w),
                    ("v", state.params.v), ("slot_w0", state.slot_w0),
                    ("slot_w", state.slot_w), ("slot_v", state.slot_v),
                    ("slot2_w0", state.slot2_w0), ("slot2_w", state.slot2_w),
                    ("slot2_v", state.slot2_v), ("step", state.step)):
        out[name] = (t.cpu().numpy() if t.dim() == 0
                     else collect(t, mesh, MODEL_AXIS))
    return out


# ---------------------------------------------------------------------------
# The pieces every exchange shares

def _own_mask_and_lid(ids: torch.Tensor, rows_per_shard: int, mesh):
    """(mine, local row ids): ids the rank's model shard owns, and their
    local rows, 0 elsewhere."""
    owner = torch.div(ids, rows_per_shard, rounding_mode="floor")
    mine = owner == M.axis_index(MODEL_AXIS, mesh)
    lid = (ids - owner * rows_per_shard).to(torch.int32)
    return mine, torch.where(mine, lid, torch.zeros_like(lid))


def gather_vw(v: torch.Tensor, w: torch.Tensor, ids: torch.Tensor,
              mesh) -> torch.Tensor:
    """ids.shape + (kf+1,) rows ``[v | w]`` of global ``ids`` from the
    row-sharded tables: the masked local lookup (kernel B1's two-table
    gather with local ids, the rows of other shards zeroed) and one
    ``psum`` over ``model`` give the exact gather."""
    flat = ids.reshape(-1)
    mine, lid = _own_mask_and_lid(flat, w.shape[0], mesh)
    rows = rowio.gather_vw_rows(v, w, lid)
    rows = torch.where(mine[:, None], rows, 0.0)
    return M.psum(rows, MODEL_AXIS, mesh).view(*ids.shape, -1)


def _loss_sums(w0, w_rows, v_rows, batch, cfg: FMConfig, reg_vecs):
    """(data loss sum, L2 sum, valid count, scores) over the rank's rows:
    sums, not means, so that a psum over ``data`` and one global
    normalizer give the global objective whatever each shard's count."""
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.num_fields > 0:
        s = I.ffm_scores_from_gathered(
            w0, w_rows, v_rows, batch.vals, batch.field_ids, cfg.num_fields,
            use_bias=cfg.use_bias, use_linear=cfg.use_linear,
            compute_dtype=cdt, slot_major=cfg.slot_major_fields)
    else:
        s = I.fm_scores_from_gathered(
            w0, w_rows, v_rows, batch.vals, use_bias=cfg.use_bias,
            use_linear=cfg.use_linear, compute_dtype=cdt)
    wts = (batch.mask.to(torch.float32) if batch.mask is not None
           else torch.ones_like(batch.y))
    if cfg.task == Task.REGRESSION:
        per_ex = (s - batch.y).square()
    else:
        per_ex = F.softplus(-torch.where(batch.y > 0, 1.0, -1.0) * s)
    count = wts.sum()
    active = (batch.vals != 0).to(torch.float32) * wts[:, None]
    if reg_vecs is not None:
        flat = batch.ids.reshape(-1).long()
        rw, rv = (r.index_select(0, flat).view(batch.ids.shape)
                  for r in reg_vecs)
    else:
        rw, rv = cfg.reg_w, cfg.reg_v
    reg = (cfg.reg0 * w0.square() * count
           + (rw * w_rows.square() * active).sum()
           + ((rv * active)[..., None] * v_rows.square()).sum())
    return (per_ex * wts).sum(), reg, count, s


def _global_count(batch, mesh) -> torch.Tensor:
    """Σmask over the whole global batch (a psum over ``data``)."""
    wts = (batch.mask.to(torch.float32) if batch.mask is not None
           else torch.ones_like(batch.y))
    return M.psum(wts.sum().reshape(1), DATA_AXIS, mesh)[0]


def _grads(cfg, batch, w0_t, vw_rows, kf, reg_vecs, total):
    """The local objective (dsum + rsum) / max(total, 1) and its
    gradients with respect to w0 and the slots' w and v rows. Returns
    (g_w0, g_w_rows, g_v_rows, dsum); v rows are (B, L, kf)."""
    w0 = w0_t.detach().requires_grad_()
    w_rows = vw_rows[..., kf].detach().requires_grad_()
    v_rows = vw_rows[..., :kf].detach().requires_grad_()
    with torch.enable_grad():
        dsum, rsum, _, _ = _loss_sums(w0, w_rows, v_rows, batch, cfg,
                                      reg_vecs)
        obj = (dsum + rsum) * (1.0 / total.clamp(min=1.0))
        g_w0, g_w, g_v = torch.autograd.grad(obj, (w0, w_rows, v_rows),
                                             materialize_grads=True)
    return g_w0, g_w, g_v, dsum.detach()


def _local_acc(g_v: torch.Tensor, g_w: torch.Tensor, ranks: torch.Tensor,
               budget: int, plan=None) -> torch.Tensor:
    """(U, 2kf+2) ``[Σg_v | Σg_w | Σg_v² | Σg_w²]`` per rank of the
    per-slot gradients. On the card by kernel B6 over sorted runs, with no
    atomic adds: over the device plan's own sort when it has one, else
    over a sort of the ranks on the device (a host plan's rows of a
    global batch), whose runs are then placed at their ranks. On the CPU
    by ``index_add_`` by rank, as the JAX step's scatter-add."""
    g = torch.cat([g_v.reshape(ranks.numel(), -1),
                   g_w.reshape(-1, 1)], dim=1)
    if not segsum_accumulate("auto", g.device):
        packed = torch.cat([g, g.square()], dim=1)
        return packed.new_zeros((budget, packed.shape[1])).index_add_(
            0, ranks.reshape(-1).long(), packed)
    if plan is not None and plan.order is not None and plan.seg is not None:
        return E.accumulate_sq_to_unique_sorted(g, plan, budget)
    runs = E.dedup_ids(ranks, min(ranks.numel(), budget), fill=0)
    sums = E.accumulate_sq_to_unique_sorted(g, runs, runs.uids.shape[0])
    # each rank once; the unused budget slots' rows are zeros, added at 0
    return sums.new_zeros((budget, sums.shape[1])).index_add_(
        0, runs.uids.long(), sums)


def unique_row_update(opt: str, sgd_cfg: SGDConfig, table: torch.Tensor,
                      slot: torch.Tensor, lids: torch.Tensor,
                      g_u: torch.Tensor, sq_u: torch.Tensor) -> None:
    """The owner's update from exchanged per-unique sums, IN PLACE: the
    same id may come once per data shard and masked ids add zeros at row
    0, so both the accumulator and the table are added to, the adagrad
    scale read after every add (the direct path's semantics with the
    per-slot sums pre-reduced)."""
    lids = lids.long()
    lr = sgd_cfg.learning_rate
    if opt == "adagrad":
        slot.index_add_(0, lids, sq_u)
        scale = torch.rsqrt(slot.index_select(0, lids) + sgd_cfg.adagrad_eps)
        table.index_add_(0, lids, -lr * g_u * scale)
    else:  # plain sgd (the routers refuse momentum)
        table.index_add_(0, lids, -lr * g_u)


def _bias_update(cfg, sgd_cfg, state: SGDState, g_w0) -> tuple:
    if not cfg.use_bias:
        return state.params.w0, state.slot_w0, state.slot2_w0
    return sgd_solver._dense_scalar_update(
        sgd_cfg.optimizer, sgd_cfg.learning_rate, sgd_cfg, state.params.w0,
        state.slot_w0, state.slot2_w0, g_w0, state.step)


def _with_bias(state: SGDState, w0, sw0, s2w0) -> SGDState:
    p = state.params
    return dataclasses.replace(state, params=FMParams(w0=w0, w=p.w, v=p.v),
                               slot_w0=sw0, slot2_w0=s2w0,
                               step=state.step + 1)


def _apply_unique_acc(cfg, sgd_cfg, state: SGDState, acc, uids, mesh,
                      zero_linear: bool) -> None:
    """Mask the exchanged (n, 2kf+2) per-unique sums to the rows this
    model shard owns and apply them (:func:`unique_row_update`)."""
    kf = state.params.v.shape[1]
    p = state.params
    mine, lids = _own_mask_and_lid(uids, p.w.shape[0], mesh)
    acc = torch.where(mine[:, None], acc, 0.0)
    g_w, sq_w = acc[:, kf], acc[:, 2 * kf + 1]
    if zero_linear:
        g_w, sq_w = torch.zeros_like(g_w), torch.zeros_like(sq_w)
    opt = sgd_cfg.optimizer
    unique_row_update(opt, sgd_cfg, p.w, state.slot_w, lids, g_w, sq_w)
    unique_row_update(opt, sgd_cfg, p.v, state.slot_v, lids, acc[:, :kf],
                      acc[:, kf + 1:2 * kf + 1])


def _reg_on(cfg: FMConfig, device, cache: dict):
    """The per-feature L2 vectors on ``device`` (None without groups)."""
    if cfg.feature_groups is None:
        return None
    if device not in cache:
        cache[device] = tuple(r.to(device)
                              for r in sgd_solver.reg_vectors(cfg))
    return cache[device]


# ---------------------------------------------------------------------------
# The steps

def resolve_exchange(sgd_cfg: SGDConfig, exchange: str = "auto") -> str:
    """"auto": "unique" for adagrad and plain sgd, else "dense". The
    unique and global exchanges refuse momentum and optimizers other
    than adagrad and sgd, whose updates do not split into per-shard
    sums."""
    if exchange == "auto":
        exchange = ("unique" if sgd_cfg.optimizer in ("adagrad", "sgd")
                    and sgd_cfg.momentum == 0 else "dense")
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown exchange={exchange!r}")
    if exchange in ("unique", "global") and (
            sgd_cfg.optimizer not in ("adagrad", "sgd")
            or sgd_cfg.momentum > 0):
        raise ValueError(f"{exchange} exchange supports adagrad/plain sgd; "
                         "use exchange='dense' for adam/momentum")
    return exchange


def hybrid_eligible(cfg: FMConfig, sgd_cfg: SGDConfig) -> bool:
    """Whether the global exchange may take the analytic sorted backward:
    plain FM, float32, adagrad or sgd, no feature_groups."""
    return (cfg.num_fields == 0 and cfg.feature_groups is None
            and getattr(torch, cfg.compute_dtype, None) == torch.float32
            and sgd_cfg.optimizer in ("adagrad", "sgd"))


def make_sharded_train_step(cfg: FMConfig, sgd_cfg: SGDConfig, mesh,
                            exchange: str = "auto"):
    """``step(state, batch) -> (state, aux)`` on this rank's shard of the
    state (``init_sharded_state``) and of the batch
    (``multihost.global_batch``); ``cfg.num_features`` must be padded.
    aux holds ``loss`` (the global batch's, the same on every rank) and,
    on the unique and global exchanges, ``unique_count`` and
    ``unique_overflow`` (the largest over the data shards on "unique").

    The unique step takes the rank's row of a stacked host plan (uids of
    shape (1, U)) or builds a plan on the device; the global step needs a
    global host plan (uids (U_g,)), and runs the hybrid backward when the
    plan carries ``stack_hybrid_extras``' rows (order = gmap, seg, svals,
    sex, each (1, ...)); the dense step ignores any plan."""
    exchange = resolve_exchange(sgd_cfg, exchange)
    if exchange == "unique":
        return _make_unique_step(cfg, sgd_cfg, mesh)
    if exchange == "global":
        return _make_global_step(cfg, sgd_cfg, mesh)
    return _make_dense_step(cfg, sgd_cfg, mesh)


def _kf(cfg: FMConfig) -> int:
    return cfg.num_factors * max(1, cfg.num_fields)


def _make_unique_step(cfg, sgd_cfg, mesh):
    kf = _kf(cfg)
    fill = cfg.num_features - 1          # the padding row
    regs = {}

    def step(state: SGDState, batch):
        p = state.params
        device = p.v.device
        ids = batch.ids
        plan = batch.plan
        if plan is not None:
            if plan.uids.dim() != 2:
                raise ValueError(
                    "exchange='unique' takes the rank's row of stacked "
                    "per-shard plans (ops.embedding.stack_plans, lifted "
                    "by multihost.global_batch), uids of shape (1, U)")
            uids, ranks = plan.uids[0], plan.ranks
            count = torch.as_tensor(plan.count, device=device).reshape(())
            overflow = torch.as_tensor(plan.overflow,
                                       device=device).reshape(())
            local_plan = None
        else:
            budget = sgd_cfg.unique_budget or E.auto_budget(ids.numel())
            local_plan = E.dedup_ids(ids, budget, fill=fill)
            uids, ranks = local_plan.uids, local_plan.ranks
            count, overflow = local_plan.count, local_plan.overflow
        budget = uids.shape[0]
        valid = valid_slots(count, budget, device)

        vw_u = torch.where(valid[:, None], gather_vw(p.v, p.w, uids, mesh),
                           0.0)
        vw_rows = vw_u.index_select(0, ranks.reshape(-1).long()).view(
            *ids.shape, kf + 1)
        total = _global_count(batch, mesh)
        g_w0, g_w, g_v, dsum = _grads(cfg, batch, p.w0, vw_rows, kf,
                                      _reg_on(cfg, device, regs), total)
        with torch.no_grad():
            acc = _local_acc(g_v, g_w, ranks, budget, local_plan)
            uids_all = M.all_gather(uids, DATA_AXIS, mesh)
            acc_all = M.all_gather(acc, DATA_AXIS, mesh)
            _apply_unique_acc(cfg, sgd_cfg, state, acc_all, uids_all, mesh,
                              zero_linear=False)
            w0, sw0, s2w0 = _bias_update(
                cfg, sgd_cfg, state, M.psum(g_w0.clone(), DATA_AXIS, mesh))
            loss = M.psum(dsum.clone(), DATA_AXIS, mesh) / total.clamp(
                min=1.0)
            aux = {"loss": loss,
                   "unique_count": M.pmax(count.to(torch.int64).clone(),
                                          DATA_AXIS, mesh),
                   "unique_overflow": M.pmax(
                       overflow.to(torch.int32).clone(), DATA_AXIS,
                       mesh) > 0}
        return _with_bias(state, w0, sw0, s2w0), aux

    return step


def _make_global_step(cfg, sgd_cfg, mesh):
    kf = _kf(cfg)
    k = cfg.num_factors
    hybrid_ok = hybrid_eligible(cfg, sgd_cfg)
    classification = cfg.task == Task.CLASSIFICATION
    regs = {}

    def forward_rows(state, batch):
        p = state.params
        plan = batch.plan
        budget = plan.uids.shape[0]
        valid = valid_slots(plan.count, budget, p.v.device)
        vw_u = torch.where(valid[:, None],
                           gather_vw(p.v, p.w, plan.uids, mesh), 0.0)
        vw_rows = vw_u.index_select(0, plan.ranks.reshape(-1).long()).view(
            *batch.ids.shape, kf + 1)
        return vw_u, vw_rows

    def aux_of(plan, loss):
        return {"loss": loss, "unique_count": plan.count,
                "unique_overflow": plan.overflow}

    def step_plain(state: SGDState, batch):
        p = state.params
        plan = batch.plan
        budget = plan.uids.shape[0]
        _, vw_rows = forward_rows(state, batch)
        total = _global_count(batch, mesh)
        g_w0, g_w, g_v, dsum = _grads(cfg, batch, p.w0, vw_rows, kf,
                                      _reg_on(cfg, p.v.device, regs), total)
        with torch.no_grad():
            acc = M.psum(_local_acc(g_v, g_w, plan.ranks, budget),
                         DATA_AXIS, mesh)
            _apply_unique_acc(cfg, sgd_cfg, state, acc, plan.uids, mesh,
                              zero_linear=not cfg.use_linear)
            w0, sw0, s2w0 = _bias_update(
                cfg, sgd_cfg, state, M.psum(g_w0.clone(), DATA_AXIS, mesh))
            loss = M.psum(dsum.clone(), DATA_AXIS, mesh) / total.clamp(
                min=1.0)
        return _with_bias(state, w0, sw0, s2w0), aux_of(plan, loss)

    def step_hybrid(state: SGDState, batch):
        """The single-device hybrid step's analytic backward per shard:
        the closed-form FM gradient in the shard's id-sorted order, each
        run summed by kernel B3 against the run's row, the (U_cap, 2k+2)
        local sums added into the shared global rank space through gmap,
        one psum over ``data``. No autograd, no per-slot scatter."""
        p = state.params
        plan = batch.plan
        budget = plan.uids.shape[0]
        seg, svals, sex = plan.seg[0], plan.svals[0], plan.sex[0]
        gmap = plan.order[0]
        vw_u, vw_rows = forward_rows(state, batch)
        with torch.no_grad():
            vals = batch.vals
            vx = vw_rows[..., :k] * vals[..., None]
            s = vx.sum(dim=1)                                   # (B/D, k)
            score = 0.5 * (s.square().sum(dim=-1)
                           - vx.square().sum(dim=(1, 2)))
            if cfg.use_linear:
                score = score + (vw_rows[..., k] * vals).sum(dim=-1)
            if cfg.use_bias:
                score = score + p.w0
            wt = (batch.mask.to(torch.float32) if batch.mask is not None
                  else torch.ones_like(batch.y))
            total = M.psum(wt.sum().reshape(1), DATA_AXIS, mesh)[0]
            denom_data = total.clamp(min=1e-12)
            denom_reg = total.clamp(min=1.0)
            if classification:
                y_pm = torch.where(batch.y > 0, 1.0, -1.0)
                z = -y_pm * score
                dsum = (F.softplus(z) * wt).sum()
                ds = -y_pm * torch.sigmoid(z) * wt / denom_data
            else:
                err = score - batch.y
                dsum = (err.square() * wt).sum()
                ds = 2.0 * err * wt / denom_data
            vw_loc = vw_u.index_select(0, gmap.long())          # (U_cap,k+1)
            ex_srt = torch.cat([s, ds[:, None], wt[:, None]],
                               dim=1).index_select(0, sex.long())
            acc_loc = segsum.fm_grad_segsum_factored(
                vw_loc, ex_srt, svals, seg, gmap.shape[0],
                2.0 * cfg.reg_v / denom_reg, 2.0 * cfg.reg_w / denom_reg)
            acc = acc_loc.new_zeros((budget, 2 * k + 2)).index_add_(
                0, gmap.long(), acc_loc)
            M.psum(acc, DATA_AXIS, mesh)
            _apply_unique_acc(cfg, sgd_cfg, state, acc, plan.uids, mesh,
                              zero_linear=not cfg.use_linear)
            g_w0 = (M.psum(ds.sum().reshape(1), DATA_AXIS, mesh)[0]
                    + 2.0 * cfg.reg0 * p.w0)
            w0, sw0, s2w0 = _bias_update(cfg, sgd_cfg, state, g_w0)
            loss = M.psum(dsum.reshape(1), DATA_AXIS, mesh)[0] / denom_data
        return _with_bias(state, w0, sw0, s2w0), aux_of(plan, loss)

    def step(state: SGDState, batch):
        plan = batch.plan
        if plan is None or plan.uids.dim() != 1:
            raise ValueError(
                "exchange='global' requires ONE host dedup plan over the "
                "whole global batch (uids shape (U_g,)); build it with "
                "ops.embedding.host_dedup on the full id block, or use "
                "exchange='unique' for stacked per-shard plans")
        if plan.seg is None:
            return step_plain(state, batch)
        if not hybrid_ok:
            raise ValueError(
                "global-exchange hybrid extras need plain FM, float32, "
                "adagrad/sgd, no feature_groups - drop the extras "
                "(stack_hybrid_extras) for this config")
        return step_hybrid(state, batch)

    return step


def _make_dense_step(cfg, sgd_cfg, mesh):
    kf = _kf(cfg)
    opt = sgd_cfg.optimizer
    sgd_solver._check_row_optimizer(opt)
    per_slot = opt == "adam" or (opt == "sgd" and sgd_cfg.momentum > 0)
    regs = {}

    def step(state: SGDState, batch):
        p = state.params
        ids = batch.ids
        vw_rows = gather_vw(p.v, p.w, ids, mesh)               # (B/D, L, kf+1)
        total = _global_count(batch, mesh)
        g_w0, g_w, g_v, dsum = _grads(cfg, batch, p.w0, vw_rows, kf,
                                      _reg_on(cfg, p.v.device, regs), total)
        with torch.no_grad():
            ids_all = M.all_gather(ids, DATA_AXIS, mesh).reshape(-1)
            g_w_all = M.all_gather(g_w, DATA_AXIS, mesh).reshape(-1)
            g_v_all = M.all_gather(g_v, DATA_AXIS, mesh).reshape(-1, kf)
            rows = p.w.shape[0]
            mine, lid = _own_mask_and_lid(ids_all, rows, mesh)
            # only the slots this shard owns (a slot masked to row 0 would
            # set row 0's adam/momentum moments and add its step there),
            # then the one-device direct step's update on their local ids
            keep = torch.nonzero(mine).squeeze(1)
            if keep.numel():
                g = torch.cat([g_v_all, g_w_all[:, None]],
                              dim=1).index_select(0, keep)
                budget = min(keep.numel(), rows)
                plan = E.dedup_ids(lid.index_select(0, keep), budget,
                                   fill=rows - 1)
                valid = valid_slots(plan.count, budget, g.device)[:, None]
                rows_u = (rowio.gather_vw_rows(p.v, p.w, plan.uids),
                          rowio.gather_vw_rows(state.slot_v, state.slot_w,
                                               plan.uids),
                          rowio.gather_vw_rows(state.slot2_v, state.slot2_w,
                                               plan.uids)
                          if opt == "adam" else None)
                sgd_solver.update_plan_rows(sgd_cfg, state, plan, budget, g,
                                            rows_u, valid, per_slot)
            w0, sw0, s2w0 = _bias_update(
                cfg, sgd_cfg, state, M.psum(g_w0.clone(), DATA_AXIS, mesh))
            loss = M.psum(dsum.clone(), DATA_AXIS, mesh) / total.clamp(
                min=1.0)
        return _with_bias(state, w0, sw0, s2w0), {"loss": loss}

    return step


def make_sharded_score_fn(cfg: FMConfig, mesh):
    """``score(params, ids, vals, field_ids=None) -> (B/D,)`` raw scores
    of the rank's rows from its row-sharded params: per-slot rows by the
    masked lookup and a psum over ``model``, then the FM or FFM math."""
    kf = _kf(cfg)
    cdt = getattr(torch, cfg.compute_dtype)

    @torch.no_grad()
    def score(params: FMParams, ids, vals, field_ids=None):
        vw = gather_vw(params.v, params.w, ids, mesh)
        w_rows, v_rows = vw[..., kf], vw[..., :kf]
        if cfg.num_fields > 0:
            return I.ffm_scores_from_gathered(
                params.w0, w_rows, v_rows, vals, field_ids, cfg.num_fields,
                use_bias=cfg.use_bias, use_linear=cfg.use_linear,
                compute_dtype=cdt, slot_major=cfg.slot_major_fields)
        return I.fm_scores_from_gathered(
            params.w0, w_rows, v_rows, vals, use_bias=cfg.use_bias,
            use_linear=cfg.use_linear, compute_dtype=cdt)

    return score


def trimmed_params(state: SGDState, mesh, num_features: int) -> FMParams:
    """The whole parameters on the rank's device, gathered over ``model``
    and trimmed to the true feature count: a model that scores anywhere."""
    from sparkfm_tpu_torch.parallel.multihost import collect
    p = state.params
    device = p.v.device
    w = torch.as_tensor(collect(p.w, mesh)[:num_features], device=device)
    v = torch.as_tensor(collect(p.v, mesh)[:num_features], device=device)
    return FMParams(w0=p.w0.detach().clone(), w=w, v=v)

