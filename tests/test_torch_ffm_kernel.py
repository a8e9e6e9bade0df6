"""The slot-major FFM's one-pass loss and row gradients
(``ops/interaction.py::ffm_slot_major_loss_grad``) on the CPU, where it
runs its plain version, the autograd route; the kernel itself is held to
that plain version on the card (``tests/test_torch_cuda.py``).

Each case is held three ways:

- in float32, to ``solvers/sgd.py::_batch_loss_from_rows`` +
  ``torch.autograd.grad`` as the fused step ran them before, bit for bit:
  the CPU route of the step is unchanged;
- in float64, to the same route at 1e-6 of each entry or of the
  output's scale (its largest entry; for g_w0 the sum of the terms it
  adds): that route rounds its scores to float32
  (``ops/interaction.py::_linear_and_bias``), so its dloss/ds, and every
  gradient it scales, carries a float32 rounding (g_w0 sums B of them);
- in float64, to the kernel's formulas written out per pair and per lane
  below (``_by_formula``), at rtol 1e-10: float64 sums in two orders.

Then the wrapper's refusals and which models the fused step sends
through it.
"""

import numpy as np
import pytest
import torch

from sparkfm_tpu_torch.config import FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.data import batching as PB
from sparkfm_tpu_torch.ops import interaction as I
from sparkfm_tpu_torch.solvers import sgd as sgd_solver
from sparkfm_tpu_torch.solvers import sgd_fused

B, FEATURES, REG0 = 12, 500, 0.01


def _case(fields, k, task, masked, groups, dtype, seed=0):
    """Rows, values (about a quarter of the slots zero: padding), labels,
    mask, ids and the per-feature L2 vectors of one small batch."""
    rng = np.random.default_rng(seed + 100 * fields + k)
    vk = fields * k
    rows = rng.normal(0, 0.4, (B, fields, vk + 1))
    vals = rng.uniform(0.2, 1.5, (B, fields)) * (rng.random((B, fields))
                                                  > 0.25)
    y = (rng.integers(0, 2, B).astype(np.float64)
         if task == Task.CLASSIFICATION else rng.normal(0, 1, B))
    mask = rng.random(B) > 0.3 if masked else None
    ids = rng.integers(0, FEATURES, (B, fields)).astype(np.int32)
    regs = (tuple(torch.as_tensor(rng.uniform(0, 0.05, FEATURES), dtype=dtype)
                  for _ in range(2)) if groups else None)
    t = dict(rows=torch.as_tensor(rows, dtype=dtype),
             vals=torch.as_tensor(vals, dtype=dtype),
             y=torch.as_tensor(y, dtype=dtype),
             mask=None if mask is None else torch.as_tensor(mask),
             ids=torch.as_tensor(ids),
             w0=torch.tensor(0.3, dtype=dtype))
    return t, regs


def _cfg(fields, k, task, bias, linear, dtype):
    return FMConfig(num_features=FEATURES, num_factors=k, num_fields=fields,
                    slot_major_fields=True, use_bias=bias, use_linear=linear,
                    task=task, reg0=REG0, reg_w=0.02, reg_v=0.03,
                    compute_dtype=str(dtype).split(".")[-1])


def _plain(t, regs, cfg):
    rw, rv = sgd_solver.slot_reg_strengths(t["ids"], cfg, regs)
    return I.ffm_slot_major_loss_grad(
        t["w0"], t["rows"], t["vals"], t["y"], t["mask"], cfg.task,
        use_bias=cfg.use_bias, use_linear=cfg.use_linear, reg0=cfg.reg0,
        reg_w=rw, reg_v=rv)


def _autograd_route(t, regs, cfg):
    """The fused step's former lines: _batch_loss_from_rows and
    torch.autograd.grad of it, the gradients laid out as [g_v | g_w]."""
    vk = cfg.num_fields * cfg.num_factors
    batch = PB.SparseBatch(ids=t["ids"], vals=t["vals"], y=t["y"],
                           mask=t["mask"])
    w0 = t["w0"].detach().requires_grad_()
    w_rows = t["rows"][..., vk].detach().requires_grad_()
    v_rows = t["rows"][..., :vk].detach().requires_grad_()
    with torch.enable_grad():
        total, (s, loss) = sgd_solver._batch_loss_from_rows(
            w0, w_rows, v_rows, batch, cfg, regs)
        g_w0, g_w, g_v = torch.autograd.grad(total, (w0, w_rows, v_rows))
    g = torch.cat([g_v.reshape(-1, vk), g_w.reshape(-1, 1)], 1)
    return s, loss, g_w0, g


def _by_formula(t, regs, cfg):
    """The kernel's arithmetic (csrc/interaction.cu's note) in float64
    numpy: the score over the pairs a < c, dloss/ds, then each lane of
    each slot's gradient row."""
    f, k = cfg.num_fields, cfg.num_factors
    vk = f * k
    rows = t["rows"].double().numpy()
    x = t["vals"].double().numpy()
    y = t["y"].double().numpy()
    v = rows[..., :vk].reshape(B, f, f, k)          # v[b, a, c] = v_a[c]
    w = rows[..., vk]
    wt = (np.ones(B) if t["mask"] is None
          else t["mask"].double().numpy())
    s = np.zeros(B)
    for a in range(f):
        for c in range(a + 1, f):
            s += x[:, a] * x[:, c] * (v[:, a, c] * v[:, c, a]).sum(-1)
    if cfg.use_linear:
        s += (w * x).sum(-1)
    if cfg.use_bias:
        s += float(t["w0"])
    denom = wt.sum() if t["mask"] is not None else B
    if cfg.task == Task.CLASSIFICATION:
        ypm = np.where(y > 0, 1.0, -1.0)
        loss = (np.logaddexp(0, -ypm * s) * wt).sum() / max(denom, 1e-12)
        d = -ypm / (1 + np.exp(ypm * s))
    else:
        loss = ((s - y) ** 2 * wt).sum() / max(denom, 1e-12)
        d = 2 * (s - y)
    d = d * wt / max(denom, 1e-12)
    if regs is None:        # reg_v scales the float32 activity first
        rw = np.full((B, f), cfg.reg_w)
        rv = np.full((B, f), np.float32(cfg.reg_v), np.float64)
    else:
        ids = t["ids"].long().numpy()
        rw, rv = (r.double().numpy()[ids] for r in regs)
    act = (x != 0) * wt[:, None]
    l2 = 2 / max(denom, 1.0)
    pair = (d[:, None, None, None] * x[:, :, None, None]
            * x[:, None, :, None] * v.transpose(0, 2, 1, 3))
    pair[:, np.arange(f), np.arange(f)] = 0.0       # the diagonal block
    g_v = pair + (l2 * rv * act)[..., None, None] * v
    g_w = l2 * rw * act * w
    if cfg.use_linear:
        g_w = g_w + d[:, None] * x
    g = np.concatenate([g_v.reshape(B, f, vk), g_w[..., None]], -1)
    g_w0 = 2 * cfg.reg0 * float(t["w0"]) + (d.sum() if cfg.use_bias
                                            else 0.0)
    # each output's scale: its largest entry; g_w0's, the sum of the
    # terms it adds up
    scales = (np.abs(s).max(), abs(loss), abs(2 * cfg.reg0 * float(t["w0"]))
              + np.abs(d).sum(), np.abs(g).max())
    return (s, loss, g_w0, g.reshape(B * f, vk + 1)), scales


@pytest.mark.parametrize("groups", [False, True], ids=["scalar", "groups"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
@pytest.mark.parametrize("linear", [False, True], ids=["nolin", "lin"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("task", [Task.CLASSIFICATION, Task.REGRESSION],
                         ids=["logistic", "squared"])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("fields", [3, 22, 39])
def test_plain_loss_grad_holds_to_the_autograd_route(fields, k, task, bias,
                                                     linear, masked, groups):
    # float32: the plain version is the former route, bit for bit
    t, regs = _case(fields, k, task, masked, groups, torch.float32)
    cfg = _cfg(fields, k, task, bias, linear, torch.float32)
    for got, want in zip(_plain(t, regs, cfg), _autograd_route(t, regs, cfg)):
        assert got.dtype == want.dtype and torch.equal(got, want)

    # float64: the former route (scores rounded to float32), the formulas
    t, regs = _case(fields, k, task, masked, groups, torch.float64)
    cfg = _cfg(fields, k, task, bias, linear, torch.float64)
    got = [z.detach().double().numpy() for z in _plain(t, regs, cfg)]
    route = [z.detach().double().numpy()
             for z in _autograd_route(t, regs, cfg)]
    want, scales = _by_formula(t, regs, cfg)
    for name, a, b, scale in zip(("scores", "loss", "g_w0", "g"), got,
                                 route, scales):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * scale,
                                   err_msg=name)
    for name, a, b in zip(("scores", "loss", "g_w0", "g"), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14,
                                   err_msg=name)
    g = got[3].reshape(B, fields, fields * k + 1)
    x = t["vals"].numpy()
    # padding slots (value 0) get zero rows; the rows moved elsewhere
    assert not g[x == 0].any() and np.abs(g).max() > 1e-3


@pytest.mark.parametrize("fault", ["strided rows", "float64 values",
                                   "65 fields", "k = 3", "wide rows",
                                   "strided mask"])
def test_the_wrapper_refuses_what_the_kernel_cannot_take(fault):
    fields, k = {"65 fields": (65, 1), "k = 3": (4, 3),
                 "wide rows": (64, 16)}.get(fault, (5, 4))
    t, _ = _case(fields, k, Task.CLASSIFICATION, fault == "strided mask",
                 False, torch.float32)
    rows, vals, mask = t["rows"], t["vals"], t["mask"]
    if fault == "strided rows":
        rows = torch.cat([rows, rows], 2)[..., ::2]
    elif fault == "float64 values":
        vals = vals.double()
    elif fault == "strided mask":
        mask = torch.stack([mask, mask], 1)[:, 0]
    with pytest.raises(ValueError, match="ffm_slot_major_loss_grad"):
        I.ffm_slot_major_loss_grad(
            t["w0"], rows, vals, t["y"], mask, Task.CLASSIFICATION,
            use_bias=False, use_linear=False, reg0=0.0, reg_w=0.0,
            reg_v=1e-5)
    # the shape faults are the ones the fused step's choice sees
    assert I.slot_major_kernel_takes(fields, k) == (fault not in (
        "65 fields", "k = 3", "wide rows"))


@pytest.mark.parametrize("model,calls", [
    ("plain FM", 0), ("field-aggregated FFM", 0), ("slot-major FFM", 2),
    ("slot-major FFM in float64", 0), ("slot-major FFM at k = 3", 0)])
def test_the_fused_step_runs_it_for_slot_major_ffm_only(monkeypatch, model,
                                                        calls):
    fields, k = 6, 3 if model.endswith("k = 3") else 4
    kw = dict(num_features=1 << 12, num_factors=k, task=Task.CLASSIFICATION,
              reg_v=1e-4)
    if model != "plain FM":
        kw.update(num_fields=fields, slot_major_fields="slot-major" in model)
    if model.endswith("float64"):
        kw.update(compute_dtype="float64")
    cfg = FMConfig(**kw)
    rng = np.random.default_rng(3)
    n = 64
    ids = (rng.integers(0, 600, (n, fields))
           + 600 * np.arange(fields)).astype(np.int32)
    ds = PB.SparseDataset(
        ids=ids, vals=np.ones((n, fields), np.float32),
        y=rng.integers(0, 2, n).astype(np.float32), num_features=1 << 12,
        field_ids=np.broadcast_to(np.arange(fields, dtype=np.int32),
                                  (n, fields)).copy())
    seen = []
    real = I.ffm_slot_major_loss_grad

    def counted(*a, **kw):
        seen.append(a[1].shape)
        return real(*a, **kw)
    monkeypatch.setattr(I, "ffm_slot_major_loss_grad", counted)
    sgd = SGDConfig(batch_size=32, update_path="fused", host_plan=False)
    state = sgd_fused.init_fused_state(cfg, device="cpu")
    step = sgd_fused.make_fused_train_step(cfg, sgd)
    losses = []
    for batch in PB.batch_iterator(ds, 32, device="cpu"):
        state, aux = step(state, batch)
        losses.append(float(aux["loss"]))
    assert len(seen) == calls and len(losses) == 2
    assert all(np.isfinite(losses))
