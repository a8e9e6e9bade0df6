"""The port on a CUDA card: the row gathers (one table and two), row
write, factored backward, per-slot backward, row-sum and per-rank
stream-sum kernels against their plain versions, and the scoring, SGD
(hybrid, fused and sorted) and ALS training paths on the card against the
CPU.

These tests skip without a card. This file imports no jax, so it also
runs on a GPU machine without it, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparkfm_tpu_torch import (ALSConfig, FMConfig, MicroBatcher,
                               SGDConfig, Task, train_als, train_sgd)
from sparkfm_tpu_torch.data import synth as psynth
from sparkfm_tpu_torch.models import fm as pfm
from sparkfm_tpu_torch.ops import embedding as PE
from sparkfm_tpu_torch.ops import rowio, segsum
from sparkfm_tpu_torch.solvers import als as pals

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows,width,n", [
    (1000, 1, 777), (1000, 4, 1), (100003, 32, 40960), (5000, 33, 333),
    (5000, 128, 1025), (20001, 356, 8192)])
def test_gather_kernel_equals_plain(dev, rows, width, n):
    g = torch.Generator(device=dev).manual_seed(rows + width)
    table = torch.randn((rows, width), generator=g, device=dev)
    ids = torch.randint(0, rows, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    before = rowio.GATHER.launches
    got = rowio.gather_rows(table, ids)
    assert rowio.GATHER.launches == before + 1
    assert torch.equal(got, rowio.gather_rows_reference(table, ids))


def test_gather_kernel_misaligned_table(dev):
    table = torch.randn(600 * 4 + 1, device=dev)[1:].view(600, 4)
    ids = torch.arange(599, -1, -2, dtype=torch.int32, device=dev)
    assert torch.equal(rowio.gather_rows(table, ids),
                       rowio.gather_rows_reference(table, ids))


@pytest.mark.parametrize("width", [1, 32, 33, 68])
def test_gather_tiles_on_a_device_plan(dev, width):
    """The tile gather at the widths the paths give it (w, V, [v | w],
    the fused record) on a plan dedup_ids builds on the card: a 2^18-slot
    budget whose ~253k-slot fill tail names one row, exact on every row;
    then on a table off a 16-byte bound (scalar route)."""
    g = torch.Generator(device=dev).manual_seed(width)
    num_rows = 1 << 20
    table = torch.randn((num_rows, width), generator=g, device=dev)
    ids = torch.randint(0, num_rows - 1, (1024, 9), generator=g, device=dev,
                        dtype=torch.int32)
    plan = PE.dedup_ids(ids, 1 << 18, fill=num_rows - 1)
    before = rowio.GATHER.launches
    got = rowio.gather_rows(table, plan.uids)
    assert rowio.GATHER.launches == before + 1
    assert torch.equal(got, rowio.gather_rows_reference(table, plan.uids))
    flat = torch.randn(4097 * width + 1, generator=g, device=dev)
    off = flat[1:].view(4097, width)
    sub = plan.uids[:5000] % 4097
    assert torch.equal(rowio.gather_rows(off, sub),
                       rowio.gather_rows_reference(off, sub))


@pytest.mark.parametrize("rows,k,n", [(100003, 32, 40960), (5000, 5, 333),
                                      (1000, 1, 1), (3000, 128, 1025),
                                      (1 << 20, 32, 1 << 18),
                                      (20001, 176, 8192 * 22)])
def test_gather_vw_rows_kernel_equals_plain(dev, rows, k, n):
    """The two-table gather [v[ids] | w[ids]] (serving's one launch per
    chunk) against two index_selects and a cat: exact, a fill tail
    included."""
    g = torch.Generator(device=dev).manual_seed(rows + k)
    v = torch.randn((rows, k), generator=g, device=dev)
    w = torch.randn((rows,), generator=g, device=dev)
    ids = torch.randint(0, rows, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    ids[n - n // 5:] = rows - 1
    before = rowio.GATHER_VW.launches
    got = rowio.gather_vw_rows(v, w, ids)
    assert rowio.GATHER_VW.launches == before + 1
    assert torch.equal(got, rowio.gather_vw_rows_reference(v, w, ids))


@pytest.mark.parametrize("feats,plan", [(100, "none"), (1 << 17, "none"),
                                        (1 << 17, "host")])
def test_scores_on_card_match_cpu(dev, feats, plan):
    rng = np.random.default_rng(feats)
    cfg = FMConfig(num_features=feats, num_factors=8,
                   task=Task.CLASSIFICATION)
    arrays = (np.float32(0.1), rng.normal(0, 0.5, feats).astype(np.float32),
              rng.normal(0, 0.3, (feats, 8)).astype(np.float32))
    ids = rng.integers(0, feats, (64, 10)).astype(np.int32)
    vals = rng.normal(size=(64, 10)).astype(np.float32)
    outs = []
    for device in ("cpu", dev):
        hp = (PE.plan_to_device(PE.host_dedup(ids, 1024, feats - 1), device)
              if plan == "host" else None)
        outs.append(pfm.predict(
            pfm.params_from_numpy(*arrays, device=device), cfg,
            torch.as_tensor(ids, device=device),
            torch.as_tensor(vals, device=device), plan=hp).cpu().numpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("slot_major", [False, True])
def test_ffm_scores_on_card_match_cpu(dev, slot_major):
    """FFM scoring (one two-table gather of the per-slot [v | w] rows) on
    the card against the CPU, in the aggregated and slot-major forms."""
    rng = np.random.default_rng(3)
    nf, k, feats = 6, 4, 5000
    cfg = FMConfig(num_features=feats, num_factors=k, num_fields=nf,
                   slot_major_fields=slot_major, task=Task.CLASSIFICATION)
    arrays = (np.float32(0.1), rng.normal(0, 0.5, feats).astype(np.float32),
              rng.normal(0, 0.3, (feats, nf * k)).astype(np.float32))
    ids = rng.integers(0, feats, (64, nf)).astype(np.int32)
    vals = rng.normal(size=(64, nf)).astype(np.float32)
    fids = (np.broadcast_to(np.arange(nf, dtype=np.int32), (64, nf))
            if slot_major else rng.integers(0, nf, (64, nf)).astype(np.int32))
    outs = []
    for device in ("cpu", dev):
        before = rowio.GATHER_VW.launches
        outs.append(pfm.predict(
            pfm.params_from_numpy(*arrays, device=device), cfg,
            torch.as_tensor(ids, device=device),
            torch.as_tensor(vals, device=device),
            torch.as_tensor(np.array(fids), device=device)).cpu().numpy())
        assert rowio.GATHER_VW.launches - before == (device != "cpu")
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)


def test_microbatcher_on_card_runs_the_kernel(dev):
    cfg = FMConfig(num_features=1 << 17, num_factors=8,
                   task=Task.CLASSIFICATION)
    params = pfm.init_params(cfg, device=dev)
    rng = np.random.default_rng(0)
    mb = MicroBatcher(params, cfg, max_batch=256)
    for n in (1, 300, 17):
        mb.submit(rng.integers(0, 1 << 17, (n, 39)).astype(np.int32),
                  np.ones((n, 39), np.float32))
    before = rowio.GATHER_VW.launches
    out = mb.flush()
    assert rowio.GATHER_VW.launches - before == 2      # one per chunk
    assert [o.shape for o in out] == [(1,), (300,), (17,)]
    assert all(np.all((o > 0) & (o < 1)) for o in out)


@pytest.mark.parametrize("rows,width,n", [
    (1000, 1, 777), (1000, 4, 1), (100003, 68, 40960), (5000, 33, 333),
    (5000, 128, 1025), (20001, 356, 8192)])
def test_scatter_kernel_equals_plain(dev, rows, width, n):
    """Unique ids plus a repeated fill row (the last): every row, the fill
    row included (its first slot's row), must equal the plain version's."""
    g = torch.Generator(device=dev).manual_seed(rows + width)
    table = torch.randn((rows, width), generator=g, device=dev)
    ids = torch.randperm(rows - 1, generator=g, device=dev)[:n].to(
        torch.int32)
    ids[n - n // 10:] = rows - 1
    new = torch.randn((n, width), generator=g, device=dev)
    want = rowio.scatter_set_rows_reference(table.clone(), ids, new)
    before = rowio.SCATTER.launches
    got = rowio.scatter_set_rows(table, ids, new)
    assert got is table and rowio.SCATTER.launches == before + 1
    assert torch.equal(got, want)


def test_scatter_kernel_misaligned_table(dev):
    table = torch.randn(600 * 4 + 1, device=dev)[1:].view(600, 4)
    ids = torch.arange(599, -1, -2, dtype=torch.int32, device=dev)
    new = torch.randn((300, 4), device=dev)
    want = rowio.scatter_set_rows_reference(table.clone(), ids, new)
    assert torch.equal(rowio.scatter_set_rows(table, ids, new), want)


@pytest.mark.parametrize("width", [68, 32, 33, 1])
def test_scatter_kernel_on_a_device_plan(dev, width):
    """B2 on a plan that dedup_ids builds on the card, with a long fill tail
    (a 2^14-slot budget for <= 3000 uniques, as a device plan's 2^18 slots
    hold ~40k): every row, the fill row included, equals the plain
    version's."""
    g = torch.Generator(device=dev).manual_seed(width)
    num_rows = 100003
    ids = torch.randint(0, 3000, (64, 39), generator=g, device=dev,
                        dtype=torch.int32) * 31
    plan = PE.dedup_ids(ids, 1 << 14, fill=num_rows - 1)
    assert int(plan.count) < (1 << 13)
    table = torch.randn((num_rows, width), generator=g, device=dev)
    new = torch.randn((1 << 14, width), generator=g, device=dev)
    want = rowio.scatter_set_rows_reference(table.clone(), plan.uids, new)
    before = rowio.SCATTER.launches
    got = rowio.scatter_set_rows(table, plan.uids, new)
    assert rowio.SCATTER.launches == before + 1
    assert got is table and torch.equal(got, want)
    assert torch.equal(got[-1], new[int(plan.count)])


def _sorted_case(dev, n, k, long_run, seed):
    rng = np.random.default_rng(seed)
    incr = (rng.random(n) < 0.3).astype(np.int64)
    incr[0] = 0
    if long_run:
        incr[n // 3 + 1:n // 3 + long_run] = 0
    seg = np.cumsum(incr).astype(np.int32)
    u = int(seg[-1]) + 5
    t = lambda a: torch.as_tensor(a, device=dev)
    return (t(rng.normal(size=(u, k + 1)).astype(np.float32)),
            t(rng.normal(size=(n, k + 2)).astype(np.float32)),
            t(np.where(rng.random(n) < 0.2, 0.0,
                       rng.normal(size=n)).astype(np.float32)),
            t(seg), u)


@pytest.mark.parametrize("n,k,long_run", [
    (1, 4, 0), (255, 4, 0), (257, 32, 0), (5000, 33, 0), (20000, 32, 9000),
    (3000, 128, 2999), (700, 1, 0)])
def test_factored_kernel_equals_plain(dev, n, k, long_run):
    """Chunks of every kind: runs inside one chunk, runs crossing one and
    many chunk boundaries, ranks beyond the last run. Held to the plain
    version in float64 at max |a - b| / (1 + |b|) < 1e-4: the f32 plain
    version sums by atomics on the card, in an order that changes from run
    to run, and is itself ~1e-4 off at the 2,999-slot run."""
    vw_u, ex, x, seg, u = _sorted_case(dev, n, k, long_run, seed=n + k)
    cv = torch.tensor(3e-3, device=dev)
    want = segsum.fm_grad_segsum_factored_reference(
        vw_u.double(), ex.double(), x.double(), seg, u, cv.double(), 7e-3)
    before = segsum.FACTORED.launches
    got = segsum.fm_grad_segsum_factored(vw_u, ex, x, seg, u, cv, 7e-3)
    assert segsum.FACTORED.launches == before + 1
    assert float(((got.double() - want).abs() / (1 + want.abs())).max()) \
        < 1e-4
    again = segsum.fm_grad_segsum_factored(vw_u, ex, x, seg, u, cv, 7e-3)
    assert torch.equal(got, again)                 # no atomics


def _b3_case(dev, k, kind, seed):
    """Sorted ranks of a kind, with (U, k+1) rows, an example pack and
    values on the card: runs of one slot; short runs and runs of 3,000
    slots (across one span or a few); one run of 60% of the slots (across
    hundreds of spans); the main path's plan (a bench-recipe batch:
    16384 x 39 zipf(1.3) ids hashed into 2^24, ~40k uniques, a ~162k-slot
    head run); or ranks with gaps of up to 9 and 3 empty ranks first,
    whose zero rows the kernel writes."""
    rng = np.random.default_rng(seed)
    if kind == "bench":
        ids = ((rng.zipf(1.3, (16384, 39)).astype(np.int64) * 2654435761)
               % (1 << 24)).astype(np.int32)
        seg = PE.host_dedup(ids, 1 << 18, fill=1 << 24).seg
    elif kind == "ones":
        seg = np.arange(100003)
    elif kind == "cross":
        seg = np.repeat(np.arange(100), rng.integers(1, 3000, 100))
        seg = np.concatenate([seg, seg[-1] + 1 + np.arange(5000)])
    elif kind == "gaps":
        seg = 3 + np.cumsum(rng.choice([0, 0, 0, 1, 2, 9], 200003))
    else:                            # "long"
        incr = (rng.random(300001) < 0.5).astype(np.int64)
        incr[60000:240000] = 0
        seg = np.cumsum(incr)
    seg = seg.astype(np.int32)
    n, u = seg.shape[0], int(seg[-1]) + 3
    t = lambda a: torch.as_tensor(a, device=dev)
    ex = rng.normal(size=(n, k + 2)).astype(np.float32)
    ex[:, k + 1] = rng.random(n) < 0.9
    return (t(0.1 * rng.normal(size=(u, k + 1)).astype(np.float32)), t(ex),
            t(np.where(rng.random(n) < 0.2, 0.0,
                       rng.normal(size=n)).astype(np.float32)), t(seg), u)


def _magnitudes(vw_u, ex, x, seg, u, cv, cw):
    """Per rank, in float64, the sums of |g_v|, |g_w|, g_v² and g_w²: the
    scale of each output sum's float32 rounding."""
    k = vw_u.shape[1] - 1
    vw = vw_u.double().index_select(0, seg.long())
    e, xx = ex.double(), x.double()
    a = torch.where(xx != 0, e[:, k + 1], 0.0)
    dsx = e[:, k] * xx
    g = torch.cat([dsx[:, None] * (e[:, :k] - vw[:, :k] * xx[:, None])
                   + (cv * a)[:, None] * vw[:, :k],
                   (dsx + cw * vw[:, k] * a)[:, None]], dim=1)
    return torch.zeros((u, 2 * k + 2), dtype=torch.float64,
                       device=ex.device).index_add_(
        0, seg.long(), torch.cat([g.abs(), g.square()], dim=1))


@pytest.mark.parametrize("kind", ["ones", "cross", "long", "bench", "gaps"])
@pytest.mark.parametrize("k", [4, 32, 33, 128])
def test_factored_kernel_holds_to_float64(dev, k, kind):
    """B3 on runs of one slot, runs across one span or a few, a run across
    hundreds of spans (pass 2's block), the main path's plan and ranks
    with gaps (the kernel writes the rows of ranks without slots): held to
    the plain version in float64 at |a - b| <= 1e-4 (1 + |b|) + 1e-6 S,
    with S the float64 sum of the terms' magnitudes. The second term is
    the rounding a cancelling float32 sum may carry (~16 ulp of S): at k
    = 128 a Σg_v of ~4 over 180k slots whose terms sum to ~1e5 in
    magnitude is 1.9e-4 off in the plain version's sequential float32 sum
    and 1.3e-4 in the kernel's order (tests/test_torch_segsum.py's
    emulation of that order gives the same). Repeated calls are bitwise
    equal (no atomics)."""
    vw_u, ex, x, seg, u = _b3_case(dev, k, kind, seed=k)
    cv = torch.tensor(3e-3, device=dev)
    want = segsum.fm_grad_segsum_factored_reference(
        vw_u.double(), ex.double(), x.double(), seg, u, 3e-3, 7e-3)
    before = segsum.FACTORED.launches
    got = segsum.fm_grad_segsum_factored(vw_u, ex, x, seg, u, cv, 7e-3)
    assert segsum.FACTORED.launches == before + 1
    bound = 1e-4 * (1 + want.abs()) + 1e-6 * _magnitudes(vw_u, ex, x, seg,
                                                         u, 3e-3, 7e-3)
    assert bool(((got.double() - want).abs() <= bound).all())
    assert torch.equal(got, segsum.fm_grad_segsum_factored(
        vw_u, ex, x, seg, u, cv, 7e-3))
    empty = torch.ones(u, dtype=torch.bool, device=dev)
    empty[seg.long()] = False
    assert not got[empty].any()


def test_train_sgd_on_card_matches_cpu(dev):
    """A few epochs on the card through the three kernels, against the
    same run on the CPU's plain versions."""
    ds = psynth.synth_ctr(num_examples=2000, num_fields=8,
                          num_buckets=1 << 17, seed=1)
    cfg = FMConfig(num_features=1 << 17, num_factors=8,
                   task=Task.CLASSIFICATION, reg_v=1e-4, seed=1)
    sgd = SGDConfig(batch_size=256, learning_rate=0.1, epochs=2)
    init = pfm.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    counts = [k.launches for k in (rowio.GATHER, rowio.SCATTER,
                                   segsum.FACTORED)]
    on_card = train_sgd(cfg, sgd, ds, init_params=init, device=dev)
    steps = 2 * 8
    assert [k.launches - c for k, c in zip(
        (rowio.GATHER, rowio.SCATTER, segsum.FACTORED), counts)] == [
            steps, steps, steps]
    on_cpu = train_sgd(cfg, sgd, ds, init_params=init, device="cpu")
    np.testing.assert_allclose(
        [h["train_loss"] for h in on_card.history],
        [h["train_loss"] for h in on_cpu.history], rtol=1e-4)
    np.testing.assert_allclose(on_card.params.v.cpu().numpy(),
                               on_cpu.params.v.numpy(), rtol=1e-4,
                               atol=1e-6)


def _colsums_case(dev, n, s, kind, seed):
    rng = np.random.default_rng(seed)
    if kind in ("runs", "offset"):   # short runs, seg[0] > 0, gaps
        seg = 3 + np.cumsum(rng.integers(0, 3, n) * (rng.random(n) < 0.4))
    elif kind == "one_run":
        seg = np.full(n, 2)
    elif kind == "unique":
        seg = np.arange(n)
    elif kind == "cross_one":        # runs of 3000 and 5000 slots
        seg = np.repeat(np.arange(n), np.where(np.arange(n) % 2, 3000,
                                               5000))[:n]
    elif kind == "rows33":           # chunk 9's last 5 slots to chunk 41's
        incr = (rng.random(n) < 0.3).astype(np.int64)  # end: 33 partial
        a, b = 10 * 4096 - 5, 42 * 4096                # rows
        incr[a], incr[a + 1:b], incr[b] = 1, 0, 1
        seg = np.cumsum(incr)
    else:                            # "long": one run of 60% of the slots
        incr = (rng.random(n) < 0.5).astype(np.int64)
        incr[n // 5 + 1:n // 5 + 3 * n // 5] = 0
        seg = np.cumsum(incr)
    seg = seg.astype(np.int32)
    u = int(seg[-1]) + 4
    xs = [rng.normal(size=n).astype(np.float32) for _ in range(s)]
    if kind != "offset":
        return ([torch.as_tensor(x, device=dev) for x in xs],
                torch.as_tensor(seg, device=dev), u)
    # views 4 bytes (seg) and 8 or 0 bytes (streams) past 16-byte bounds,
    # as the ALS sweep's slice col_rank[b*N:(b+1)*N] is when N % 4 != 0
    seg_t = torch.as_tensor(np.r_[np.int32(0), seg], device=dev)[1:]
    streams = [torch.as_tensor(np.r_[np.zeros(2 * (j % 2), np.float32), x],
                               device=dev)[2 * (j % 2):]
               for j, x in enumerate(xs)]
    assert seg_t.data_ptr() % 16 == 4
    return streams, seg_t, u


@pytest.mark.parametrize("n,s,kind", [
    (1, 1, "runs"), (1000, 5, "runs"), (3073, 16, "runs"),
    (5000, 5, "one_run"), (4097, 3, "unique"), (300001, 5, "long"),
    (300001, 1, "long"), (300001, 16, "long"), (100003, 5, "cross_one"),
    (100003, 1, "cross_one"), (200003, 5, "rows33"), (150001, 5, "offset"),
    (150001, 1, "offset"), (150001, 16, "offset")])
def test_colsums_kernel_equals_plain_in_float64(dev, n, s, kind):
    """Chunks of every kind: N not a multiple of the 4096-slot chunk or of
    pass 1's tile, seg[0] > 0, gaps, one run over all of N, all slots
    unique, runs that cross one or two chunk boundaries, a run over 33
    partial rows (the most a warp of pass 2 sums), a run across ~44 chunks
    (summed by a block), and seg and streams as views off 16-byte bounds.
    Against the plain version in float64: max |a - b| / (1 + |b|) < 1e-4;
    repeated calls are bitwise equal (no atomics); ranks without slots are
    zero."""
    streams, seg, u = _colsums_case(dev, n, s, kind, seed=n + s)
    want = segsum.segment_colsums_reference(
        [x.double() for x in streams], seg, u)
    before = segsum.COLSUMS.launches
    got = segsum.segment_colsums(streams, seg, u)
    assert segsum.COLSUMS.launches == before + 1
    assert got.shape == (u, s)
    assert float(((got.double() - want).abs() / (1 + want.abs())).max()) \
        < 1e-4
    assert torch.equal(got, segsum.segment_colsums(streams, seg, u))
    empty = torch.ones(u, dtype=torch.bool, device=dev)
    empty[seg.long()] = False
    assert not got[empty].any()


def test_train_als_on_card_matches_cpu(dev):
    """A few sweeps on the card through B7 (one call per w block and per
    (factor, block)), against the same run on the CPU's plain version."""
    ds = psynth.synth_movielens(300, 400, 20000, rank=3, seed=1)
    cfg = FMConfig(num_features=ds.num_features, num_factors=8, reg_w=0.1,
                   reg_v=0.5, seed=1)
    als_cfg = ALSConfig(epochs=3, feature_blocks=pals.slot_blocks(ds))
    init = pfm.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    before = segsum.COLSUMS.launches
    on_card = train_als(cfg, als_cfg, ds, eval_ds=ds, params=init,
                        device=dev)
    assert segsum.COLSUMS.launches - before == 3 * (8 + 1) * 2
    on_cpu = train_als(cfg, als_cfg, ds, eval_ds=ds, params=init,
                       device="cpu")
    np.testing.assert_allclose(
        [h["eval_rmse"] for h in on_card.history],
        [h["eval_rmse"] for h in on_cpu.history], rtol=1e-4)
    # f32 sums in another order, compounded over 3 sweeps of exact
    # coordinate steps
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(on_card.params, name).cpu(),
                                   getattr(on_cpu.params, name),
                                   rtol=1e-3, atol=1e-4, err_msg=name)


def _rows_case(dev, n, w, kind, seed):
    """Sorted ranks of a kind and (N, W) normal rows on the card."""
    rng = np.random.default_rng(seed)
    if kind == "runs":               # short runs, seg[0] > 0, gaps
        seg = 3 + np.cumsum(rng.integers(0, 3, n) * (rng.random(n) < 0.4))
    elif kind == "dense":            # step <= 1, what the plans emit
        seg = np.cumsum(rng.random(n) < 0.3)
    else:                            # "long": one run of 60% of the slots
        incr = (rng.random(n) < 0.5).astype(np.int64)
        incr[n // 5 + 1:n // 5 + 3 * n // 5] = 0
        seg = np.cumsum(incr)
    seg = torch.as_tensor(seg.astype(np.int32), device=dev)
    g = torch.as_tensor(rng.normal(size=(n, w)).astype(np.float32),
                        device=dev)
    return g, seg, int(seg[-1]) + 4


ROWS_CASES = [  # (n, W, kind): N not a multiple of the 256-slot chunk
    (1, 1, "runs"), (1000, 3, "runs"), (3073, 66, "dense"),
    (20000, 35, "long"), (5000, 130, "runs"), (4097, 354, "dense"),
    (300001, 66, "long"), (8192, 9, "dense"), (200003, 33, "long"),
    (90001, 354, "long"), (3001, 700, "runs"),
    # B6's shapes on the paths: BASELINE config 1's direct step (above,
    # N = 8,192, W = 9), the dedup, fused and sorted payloads at config 3
    # and config 4's fused FFM step
    (638976, 33, "long"), (180224, 177, "dense")]


@pytest.mark.parametrize("squares", [False, True])
@pytest.mark.parametrize("n,w,kind", ROWS_CASES)
def test_rowsum_kernels_equal_plain_in_float64(dev, n, w, kind, squares):
    """B5 (and B6 with the squares) against the plain version in float64:
    max |a - b| / (1 + |b|) < 1e-4; repeated calls bitwise equal; ranks
    without slots zero."""
    g, seg, u = _rows_case(dev, n, w, kind, seed=n + w)
    if squares:
        fn, kernel = segsum.segment_rowsum_sq, segsum.ROWSUM_SQ
        want = segsum.segment_rowsum_sq_reference(g.double(), seg, u)
    else:
        fn, kernel = segsum.segment_rowsum, segsum.ROWSUM
        want = segsum.segment_rowsum_reference(g.double(), seg, u)
    before = kernel.launches
    got = fn(g, seg, u)
    assert kernel.launches == before + 1
    assert got.shape == want.shape
    assert float(((got.double() - want).abs() / (1 + want.abs())).max()) \
        < 1e-4
    assert torch.equal(got, fn(g, seg, u))             # no atomics
    empty = torch.ones(u, dtype=torch.bool, device=dev)
    empty[seg.long()] = False
    assert not got[empty].any()


def test_rowsum_kernel_refuses_what_it_cannot_take(dev):
    seg = torch.zeros((4,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="W"):
        segsum.segment_rowsum(torch.zeros((4, 0), device=dev), seg, 2)
    with pytest.raises(ValueError, match="W <= 32768"):
        segsum.segment_rowsum_sq(torch.zeros((4, 32769), device=dev), seg, 2)


def test_rowsum_sq_kernel_on_no_slots_gives_zeros(dev):
    before = segsum.ROWSUM_SQ.launches
    got = segsum.segment_rowsum_sq(torch.zeros((0, 9), device=dev),
                                   torch.zeros((0,), dtype=torch.int32,
                                               device=dev), 5)
    assert got.shape == (5, 18) and not got.any()
    assert segsum.ROWSUM_SQ.launches == before


def test_rowsum_sq_kernel_traps_on_a_rank_out_of_range(dev):
    """A rank outside [0, U) traps B6 where the chunk's ranks are loaded.
    In a child process: a trap leaves its CUDA context unusable."""
    code = ("import torch\n"
            "from sparkfm_tpu_torch.ops import segsum\n"
            "seg = torch.tensor([0, 1, 1, 5], dtype=torch.int32, "
            "device='cuda')\n"
            "segsum.segment_rowsum_sq(torch.ones((4, 3), device='cuda'), "
            "seg, 5)\n"
            "torch.cuda.synchronize()\n")
    child = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300, cwd=REPO)
    assert child.returncode != 0
    assert "unspecified launch failure" in child.stderr, child.stderr[-2000:]


@pytest.mark.parametrize("n,k,long_run", [
    (1, 4, 0), (257, 32, 0), (5000, 33, 0), (20000, 32, 9000),
    (3000, 128, 2999), (700, 1, 0)])
def test_fm_grad_kernel_equals_plain_and_factored(dev, n, k, long_run):
    """B4 from per-slot rows against its plain version in float64 (max
    |a - b| / (1 + |b|) < 1e-4), bitwise repeatable, and within 1e-6 of
    B3 on the unique rows those per-slot rows expand (both sum in the same
    order from the same row values)."""
    vw_u, ex, x, seg, u = _sorted_case(dev, n, k, long_run, seed=n + k + 1)
    vw_srt = vw_u.index_select(0, seg.long())
    want = segsum.fm_grad_segsum_reference(
        vw_srt.double(), ex.double(), x.double(), seg, u, 3e-3, 7e-3)
    before = segsum.FM_GRAD.launches
    got = segsum.fm_grad_segsum(vw_srt, ex, x, seg, u, 3e-3, 7e-3)
    assert segsum.FM_GRAD.launches == before + 1
    assert float(((got.double() - want).abs() / (1 + want.abs())).max()) \
        < 1e-4
    assert torch.equal(got, segsum.fm_grad_segsum(vw_srt, ex, x, seg, u,
                                                  3e-3, 7e-3))
    factored = segsum.fm_grad_segsum_factored(vw_u, ex, x, seg, u, 3e-3,
                                              7e-3)
    assert float(((got - factored).abs() / (1 + factored.abs())).max()) \
        < 1e-6


@pytest.mark.parametrize("sgd_kw,kernels,idle", [
    (dict(update_path="fused", accumulate="segsum"),
     (rowio.GATHER, rowio.SCATTER, segsum.ROWSUM_SQ), segsum.ROWSUM),
    (dict(update_path="fused", host_plan=False),
     (rowio.GATHER, rowio.SCATTER, segsum.ROWSUM_SQ), segsum.ROWSUM),
    (dict(update_path="fused", optimizer="adagrad_row"),
     (rowio.GATHER, rowio.SCATTER, segsum.ROWSUM), segsum.ROWSUM_SQ),
    (dict(update_path="sorted"),
     (rowio.GATHER, rowio.SCATTER, segsum.ROWSUM_SQ), segsum.ROWSUM),
])
def test_fused_and_sorted_train_sgd_on_card_match_cpu(dev, sgd_kw, kernels,
                                                      idle):
    """train_sgd on the fused and sorted paths on the card, one launch of
    each kernel of the path per step ("auto" on the card sums by sorted
    runs: adagrad's [g_v | g_w] by B6, which forms the squares, and
    adagrad_row's pack by B5; the other of the two is not launched), run
    twice: the two card runs are equal bit for bit (no atomics on either
    path), and they hold to the same run on the CPU, which sums by
    index_add_ in slot order. Tolerance from float32 against float64:
    each step's per-unique and per-example sums have up to 2,048 terms
    (256 rows x 8 slots), so two float32 orders of one sum differ by up
    to ~2,048 x 2^-24 ~ 1.2e-4 of its terms' magnitude; through 16
    adagrad steps of lr 0.1 that stays within rtol 1e-4, atol 1e-5 on V
    (card runs have read 1.18e-6 beside an entry near 0)."""
    ds = psynth.synth_ctr(num_examples=2000, num_fields=8,
                          num_buckets=1 << 17, seed=2)
    cfg = FMConfig(num_features=1 << 17, num_factors=8,
                   task=Task.CLASSIFICATION, reg_v=1e-4, seed=2)
    sgd = SGDConfig(batch_size=256, learning_rate=0.1, epochs=2, **sgd_kw)
    init = pfm.init_params(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
    counts = [k.launches for k in kernels]
    idle_count = idle.launches
    on_card = train_sgd(cfg, sgd, ds, init_params=init, device=dev)
    assert [k.launches - c for k, c in zip(kernels, counts)] == [16] * len(
        kernels)
    assert idle.launches == idle_count
    again = train_sgd(cfg, sgd, ds, init_params=init, device=dev)
    assert [h["train_loss"] for h in again.history] == [
        h["train_loss"] for h in on_card.history]
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(again.params, name),
                           getattr(on_card.params, name)), name
    on_cpu = train_sgd(cfg, sgd, ds, init_params=init, device="cpu")
    np.testing.assert_allclose(
        [h["train_loss"] for h in on_card.history],
        [h["train_loss"] for h in on_cpu.history], rtol=1e-4)
    np.testing.assert_allclose(on_card.params.v.cpu().numpy(),
                               on_cpu.params.v.numpy(), rtol=1e-4,
                               atol=1e-5)


def _movielens_like():
    return psynth.synth_movielens(num_users=300, num_items=400,
                                  num_examples=6000, seed=3)


def _big_ctr():
    return psynth.synth_ctr(num_examples=2000, num_fields=8,
                            num_buckets=1 << 17, seed=4)


PATH_RUNS = {  # name: (data, FMConfig extras, SGDConfig extras, launches/step)
    "direct adagrad": (_movielens_like, dict(num_factors=8, reg_v=0.02),
                       dict(learning_rate=0.1),
                       {"GATHER_VW": 2, "SCATTER": 4, "ROWSUM_SQ": 1}),
    "direct adam": (_movielens_like, dict(num_factors=8, reg_v=0.02),
                    dict(learning_rate=0.001, optimizer="adam"),
                    {"GATHER_VW": 3, "SCATTER": 6, "ROWSUM": 1}),
    "direct momentum": (_movielens_like, dict(num_factors=8, reg_v=0.02),
                        dict(learning_rate=0.01, optimizer="sgd",
                             momentum=0.9),
                        {"GATHER_VW": 2, "SCATTER": 4, "ROWSUM": 1}),
    "dedup adam": (_big_ctr, dict(num_factors=8, reg_v=1e-4,
                                  task=Task.CLASSIFICATION),
                   dict(learning_rate=0.01, optimizer="adam"),
                   {"GATHER_VW": 3, "SCATTER": 6, "ROWSUM_SQ": 1}),
    "dedup momentum, device plans": (
        _big_ctr, dict(num_factors=8, reg_v=1e-4, task=Task.CLASSIFICATION),
        dict(learning_rate=0.01, optimizer="sgd", momentum=0.9,
             host_plan=False),
        {"GATHER_VW": 2, "SCATTER": 4, "ROWSUM_SQ": 1}),
    "fused FFM": (_big_ctr, dict(num_factors=4, num_fields=8, reg_v=1e-4,
                                 slot_major_fields=True,
                                 task=Task.CLASSIFICATION),
                  dict(learning_rate=0.05),
                  {"GATHER": 1, "SCATTER": 1, "ROWSUM_SQ": 1}),
}


@pytest.mark.parametrize("name", list(PATH_RUNS))
def test_direct_dedup_and_ffm_train_sgd_on_card_match_cpu(dev, name):
    """train_sgd on the direct path (BASELINE config 1's shape, tables
    below 2^16 rows), the dedup path (adam, momentum) and FFM on the
    fused path, on the card: the kernels' launches per step as the path
    runs them (B1's two-table gather for [v | w], the slots and adam's
    second moments; B2 once a table; B6 for [Σg | Σg²], the fused FFM
    step's [g_v | g_w] included, or B5 for the direct step's per-slot
    momentum and adam terms), two card runs equal bit for bit (no
    atomics), and the
    card run against the CPU's at the fused test's tolerance (rtol 1e-4;
    V at rtol 1e-4, atol 1e-5)."""
    from sparkfm_tpu_torch.solvers import sgd as psgd
    make, fm_kw, sgd_kw, per_step = PATH_RUNS[name]
    ds = make()
    cfg = FMConfig(num_features=ds.num_features, seed=3, **fm_kw)
    sgd = SGDConfig(batch_size=512, epochs=2, **sgd_kw)
    path = psgd.resolve_update_path(cfg, sgd)
    assert path == name.split()[0]
    init = pfm.init_params(cfg, torch.Generator().manual_seed(3),
                           device="cpu")
    kernels = {"GATHER": rowio.GATHER, "GATHER_VW": rowio.GATHER_VW,
               "SCATTER": rowio.SCATTER, "ROWSUM": segsum.ROWSUM,
               "ROWSUM_SQ": segsum.ROWSUM_SQ}
    counts = {k: kern.launches for k, kern in kernels.items()}
    on_card = train_sgd(cfg, sgd, ds, init_params=init, device=dev)
    steps = 2 * -(-ds.num_examples // 512)
    assert {k: kern.launches - counts[k] for k, kern in kernels.items()} == {
        k: steps * per_step.get(k, 0) for k in kernels}
    again = train_sgd(cfg, sgd, ds, init_params=init, device=dev)
    assert [h["train_loss"] for h in again.history] == [
        h["train_loss"] for h in on_card.history]
    for pname in ("w0", "w", "v"):
        assert torch.equal(getattr(again.params, pname),
                           getattr(on_card.params, pname)), pname
    on_cpu = train_sgd(cfg, sgd, ds, init_params=init, device="cpu")
    np.testing.assert_allclose(
        [h["train_loss"] for h in on_card.history],
        [h["train_loss"] for h in on_cpu.history], rtol=1e-4)
    np.testing.assert_allclose(on_card.params.v.cpu().numpy(),
                               on_cpu.params.v.numpy(), rtol=1e-4,
                               atol=1e-5)
