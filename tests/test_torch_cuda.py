"""The port on a CUDA card: the row gathers (one table and two), row
write, factored backward, per-slot backward, row-sum and per-rank
stream-sum kernels against their plain versions, the scoring, SGD
(hybrid, fused and sorted), ALS, MCMC, relational SGD and BS-ALS
training paths on the card against the CPU, the CUDA graphs of several steps (``utils/graphs.py``) and
checkpointed training against eager steps and uninterrupted runs, and
the sharded paths (``parallel/``) on a one-rank NCCL mesh against the
one-device paths.

These tests skip without a card. This file imports no jax, so it also
runs on a GPU machine without it, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparkfm_tpu_torch import (ALSConfig, FMConfig, MicroBatcher,
                               SGDConfig, Task, train_als, train_sgd)
from sparkfm_tpu_torch.data import synth as psynth
from sparkfm_tpu_torch.data.batching import SparseDataset, batch_iterator
from sparkfm_tpu_torch.models import fm as pfm
from sparkfm_tpu_torch.ops import embedding as PE
from sparkfm_tpu_torch.ops import interaction as PI
from sparkfm_tpu_torch.ops import rowio, segsum
from sparkfm_tpu_torch.solvers import als as pals
from sparkfm_tpu_torch.solvers import sgd_fused, sgd_hybrid

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
    """A few sweeps on the card through B7 (one call per w block) and the
    ALS stream sums (one per (factor, block)), against the same run on the
    CPU's plain versions."""
    ds = psynth.synth_movielens(300, 400, 20000, rank=3, seed=1)
    cfg = FMConfig(num_features=ds.num_features, num_factors=8, reg_w=0.1,
                   reg_v=0.5, seed=1)
    als_cfg = ALSConfig(epochs=3, feature_blocks=pals.slot_blocks(ds))
    init = pfm.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    before = segsum.COLSUMS.launches, segsum.STREAM_SUMS.launches
    on_card = train_als(cfg, als_cfg, ds, eval_ds=ds, params=init,
                        device=dev)
    assert segsum.COLSUMS.launches - before[0] == 3 * 2
    assert segsum.STREAM_SUMS.launches - before[1] == 3 * 8 * 2
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



def _torch_streams(eq, x, row, seg, u):
    """B7 over the five streams as torch forms them on the card from e and
    q, eq's columns (the compact sweep's former form): the ALS stream
    sums' bit-exact oracle."""
    e, q = eq[:, 0], eq[:, 1]
    e_c = e if row is None else e.index_select(0, row)
    q_c = q if row is None else q.index_select(0, row)
    x2 = x * x
    return segsum.segment_colsums(
        [e_c * x * q_c, e_c * x2, x2 * q_c * q_c, x2 * x * q_c, x2 * x2],
        seg, u)


def _stream_sums_case(dev, n, kind, gather, offset, seed):
    """A block as the compact sweep hands it over: seg of the given kind
    (``_colsums_case``), x, and the (e, q) pairs eq with the rows into
    them (or none: eq in seg's order). With ``offset`` x, the rows and seg
    are the second half of arrays of 2N, N odd: views off 16-byte bounds,
    as ``col_rank[b*N:(b+1)*N]`` is at config 2, and eq a view 8 bytes
    past a 16-byte bound."""
    rng = np.random.default_rng(seed)
    (x,), seg, u = _colsums_case(dev, n, 1, kind, seed)
    rows = max(1, n // 3) if gather else n
    eq = torch.as_tensor(rng.normal(size=(rows, 2)).astype(np.float32),
                         device=dev)
    row = (torch.as_tensor(rng.integers(0, rows, n).astype(np.int32),
                           device=dev) if gather else None)
    if offset:
        x = torch.cat([x.flip(0), x])[n:]
        seg = torch.cat([seg.flip(0), seg])[n:]
        row = None if row is None else torch.cat([row, row])[n:]
        eq = torch.cat([eq[:1], eq])[1:]
        assert seg.data_ptr() % 16 == 4 * (n % 4)
        assert eq.data_ptr() % 16 == 8
    return eq, x, row, seg, u


STREAM_CASES = [  # (n, kind, gather)
    (1, "runs", False), (1001, "runs", True), (5001, "one_run", True),
    (4097, "unique", False), (300001, "long", True), (300001, "long", False),
    (100003, "cross_one", True), (200003, "rows33", True),
    (150001, "runs", False)]


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("n,kind,gather", STREAM_CASES)
def test_stream_sums_kernel_equals_b7_on_torch_streams(dev, n, kind, gather,
                                                       offset):
    """The ALS stream sums on the card equal B7 over the streams torch
    forms from e and q, bit for bit: without and with rows, at N not a
    multiple of the chunk or tile, gapped ranks, one run, unique ranks,
    runs crossing one or two chunk boundaries, a run over 33 partial rows
    and a run across ~44 chunks (pass 2's block-wide case), inputs at odd
    offsets (eq staged from 8 bytes past a 16-byte bound). A second
    call repeats the first bit for bit; the sums hold to the plain version
    in float64 at B7's tolerance; ranks without slots are zero."""
    eq, x, row, seg, u = _stream_sums_case(dev, n, kind, gather, offset,
                                           seed=n + 2 * gather + offset)
    before = segsum.STREAM_SUMS.launches, segsum.COLSUMS.launches
    got = segsum.als_stream_sums(eq, x, row, seg, u)
    assert (segsum.STREAM_SUMS.launches, segsum.COLSUMS.launches) == (
        before[0] + 1, before[1])
    assert got.shape == (u, 5)
    assert torch.equal(got, _torch_streams(eq, x, row, seg, u))
    assert torch.equal(got, segsum.als_stream_sums(eq, x, row, seg, u))
    want = segsum.als_stream_sums_reference(eq.double(), x.double(), row,
                                            seg, u)
    assert float(((got.double() - want).abs() / (1 + want.abs())).max()) \
        < 1e-4
    empty = torch.ones(u, dtype=torch.bool, device=dev)
    empty[seg.long()] = False
    assert not got[empty].any()


def test_stream_sums_kernel_on_no_slots_gives_zeros(dev):
    before = segsum.STREAM_SUMS.launches
    got = segsum.als_stream_sums(torch.zeros((0, 2), device=dev),
                                 torch.zeros((0,), device=dev), None,
                                 torch.zeros((0,), dtype=torch.int32,
                                             device=dev), 7)
    assert got.shape == (7, 5) and not got.any()
    assert segsum.STREAM_SUMS.launches == before


def test_stream_sums_kernel_traps_on_a_row_out_of_range(dev):
    """A row outside [0, len(eq)) traps the kernel before its pair is
    read. In a child process: a trap leaves its CUDA context unusable."""
    code = ("import torch\n"
            "from sparkfm_tpu_torch.ops import segsum\n"
            "eq = torch.ones((4, 2), device='cuda')\n"
            "x = torch.ones(4, device='cuda')\n"
            "i = lambda v: torch.tensor(v, dtype=torch.int32, "
            "device='cuda')\n"
            "segsum.als_stream_sums(eq, x, i([0, 1, 4, 2]), i([0, 0, 1, 2]),"
            " 3)\n"
            "torch.cuda.synchronize()\n")
    child = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300, cwd=REPO)
    assert child.returncode != 0
    assert "unspecified launch failure" in child.stderr, child.stderr[-2000:]


@pytest.mark.parametrize("blocks", ["slots", "contiguous"])
def test_train_als_stream_sums_equal_torch_streams(dev, monkeypatch, blocks):
    """train_als on the card with the ALS stream sums equals, parameter for
    parameter, the same run with them replaced by the streams torch forms
    and B7: on slot blocks (block 0 without rows, block 1 with) and on
    contiguous blocks of 100 features (neither column-pure nor CSC-uniform:
    every block gathers over all entries)."""
    ds = psynth.synth_movielens(300, 400, 20000, rank=3, seed=2)
    cfg = FMConfig(num_features=ds.num_features, num_factors=4, reg_w=0.1,
                   reg_v=0.5, seed=2)
    als_cfg = (ALSConfig(epochs=2, feature_blocks=pals.slot_blocks(ds))
               if blocks == "slots" else ALSConfig(epochs=2, block_size=100))
    init = pfm.init_params(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
    before = segsum.STREAM_SUMS.launches
    fused = train_als(cfg, als_cfg, ds, params=init, device=dev)
    assert segsum.STREAM_SUMS.launches > before
    monkeypatch.setattr(segsum, "als_stream_sums", _torch_streams)
    before = segsum.STREAM_SUMS.launches
    formed = train_als(cfg, als_cfg, ds, params=init, device=dev)
    assert segsum.STREAM_SUMS.launches == before
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(fused.params, name),
                           getattr(formed.params, name)), name


CELL_N, CELL_USERS, CELL_RANKS = 25_000_095, 162_541, 221_588


def _patch_case(dev, n, u, users):
    """The compact sweep's patch inputs at a block's shapes: the (e, q)
    pairs eq (n, 2), the (u, 2) table [delta | dsq] with zero rows off the
    block, the (2, n) rows of ranks (slot 0 sorted users, slot 1 random
    movies) and values, and a next factor's q (n,)."""
    gen = torch.Generator(device=dev).manual_seed(n)
    eq = torch.randn((n, 2), generator=gen, device=dev)
    table = torch.randn((u, 2), generator=gen, device=dev)
    table[torch.rand(u, generator=gen, device=dev) < 0.3] = 0.0
    rank = torch.stack([
        torch.sort(torch.randint(0, users, (n,), generator=gen,
                                 device=dev))[0],
        torch.randint(users, u, (n,), generator=gen, device=dev)]).int()
    vals = torch.randn((2, n), generator=gen, device=dev)
    q_next = torch.randn(n, generator=gen, device=dev)
    return eq, table, rank, vals, q_next


@pytest.mark.parametrize("b", [0, 1])
@pytest.mark.parametrize("n", [1, 2049, CELL_N])
def test_patch_kernel_equals_the_torch_lines(dev, n, b):
    """The ALS patch kernel patches the (e, q) pairs in place to what its
    plain version, the compact sweep's torch lines run on the card on eq's
    columns, gives, bit for bit, with and without the next factor's q: at
    the ml25m-als-sweep cell's N and U (block 1's rank and vals rows 12
    bytes past a 16-byte bound, its q_next row 4 bytes past one) and at N
    not a multiple of the kernel's tile; a second call from the same
    inputs repeats the first."""
    u, users = (CELL_RANKS, CELL_USERS) if n == CELL_N else (300, 100)
    eq, table, rank, vals, q_next = _patch_case(dev, n, u, users)
    if n == CELL_N:
        assert rank[b].data_ptr() % 16 == vals[b].data_ptr() % 16 == 12 * b
    for nxt in (None, torch.cat([q_next[:1], q_next])[1:]):
        want = eq.clone()
        segsum.als_patch_reference(want, table, rank[b], vals[b], nxt)
        for _ in range(2):
            got = eq.clone()
            before = segsum.ALS_PATCH.launches
            segsum.als_patch(got, table, rank[b], vals[b], nxt)
            assert segsum.ALS_PATCH.launches == before + 1
            assert torch.equal(got, want)


def test_patch_kernel_traps_on_a_rank_out_of_range(dev):
    """A rank outside [0, U) traps the kernel before its table row is
    read. In a child process: a trap leaves its CUDA context unusable."""
    code = ("import torch\n"
            "from sparkfm_tpu_torch.ops import segsum\n"
            "eq, t = (torch.ones((4, 2), device='cuda') for _ in range(2))\n"
            "v = torch.ones(4, device='cuda')\n"
            "r = torch.tensor([0, 1, 4, 2], dtype=torch.int32, "
            "device='cuda')\n"
            "segsum.als_patch(eq, t, r, v)\n"
            "torch.cuda.synchronize()\n")
    child = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300, cwd=REPO)
    assert child.returncode != 0
    assert "unspecified launch failure" in child.stderr, child.stderr[-2000:]


@pytest.mark.parametrize("blocks", ["slots", "contiguous"])
def test_train_als_patch_kernel_equals_the_torch_lines(dev, monkeypatch,
                                                       blocks):
    """train_als on the card patches q and e by the kernel once a (factor,
    block) when the blocks are column-pure (slot blocks), and gives the
    parameters of the same run with the plain version's torch lines bit
    for bit; contiguous blocks of 100 features (not column-pure) and MCMC
    keep the torch lines and launch it not at all."""
    from sparkfm_tpu_torch import MCMCConfig
    from sparkfm_tpu_torch.solvers.mcmc import train_mcmc
    ds = psynth.synth_movielens(300, 400, 20000, rank=3, seed=3)
    k, sweeps = 4, 2
    cfg = FMConfig(num_features=ds.num_features, num_factors=k, reg_w=0.1,
                   reg_v=0.5, seed=3)
    fb = pals.slot_blocks(ds)
    als_cfg = (ALSConfig(epochs=sweeps, feature_blocks=fb)
               if blocks == "slots"
               else ALSConfig(epochs=sweeps, block_size=100))
    init = pfm.init_params(cfg, torch.Generator().manual_seed(3),
                           device="cpu")
    before = segsum.ALS_PATCH.launches
    kernel = train_als(cfg, als_cfg, ds, params=init, device=dev)
    assert segsum.ALS_PATCH.launches - before == (
        sweeps * k * 2 if blocks == "slots" else 0)
    before = segsum.ALS_PATCH.launches
    train_mcmc(cfg, MCMCConfig(epochs=2, burn_in=1, feature_blocks=fb), ds,
               params=init, device=dev)
    assert segsum.ALS_PATCH.launches == before
    monkeypatch.setattr(segsum, "als_patch", segsum.als_patch_reference)
    plain = train_als(cfg, als_cfg, ds, params=init, device=dev)
    assert segsum.ALS_PATCH.launches == before
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(kernel.params, name),
                           getattr(plain.params, name)), name

def test_compact_sweeps_on_pairs_equal_plain_sums_and_patch(dev,
                                                            monkeypatch):
    """Three compact sweeps on a config-2-shaped dataset (slot 0 users in
    example order, slot 1 movies scattered over the examples, so block 1
    gathers its (e, q) pairs by its rows) give, bit for bit, the
    parameters of the same sweeps with the stream sums formed by torch
    from e and q and summed by B7 and the patch's torch lines; the
    counters read one gathered slot an example a factor and K - 1
    patches with the next factor's q a sweep."""
    from torch.profiler import profile
    from sparkfm_tpu_torch.utils import profiling
    rng = np.random.default_rng(8)
    n, users, movies, k, sweeps = 200_003, 5_000, 2_000, 4, 3
    ids = np.stack([rng.integers(0, users, n),
                    users + (rng.zipf(1.3, n) % movies)], axis=1)
    ds = SparseDataset(ids=ids.astype(np.int32),
                       vals=np.ones((n, 2), np.float32),
                       y=rng.normal(size=n).astype(np.float32),
                       num_features=users + movies)
    cfg = FMConfig(num_features=ds.num_features, num_factors=k, reg_w=0.1,
                   reg_v=0.5, seed=8)
    als_cfg = ALSConfig(epochs=sweeps, feature_blocks=pals.slot_blocks(ds))
    init = pfm.init_params(cfg, torch.Generator().manual_seed(8),
                           device="cpu")
    profiling.clear()
    try:
        with profile():
            kernels = train_als(cfg, als_cfg, ds, params=init, device=dev)
        counters = profiling.recorded()["counters"]
    finally:
        profiling.clear()
    assert counters["als.paired_gather_slots"] == sweeps * k * n
    assert counters["als.q_next_patches"] == sweeps * (k - 1)
    monkeypatch.setattr(segsum, "als_stream_sums", _torch_streams)
    monkeypatch.setattr(segsum, "als_patch", segsum.als_patch_reference)
    before = segsum.STREAM_SUMS.launches, segsum.ALS_PATCH.launches
    plain = train_als(cfg, als_cfg, ds, params=init, device=dev)
    assert (segsum.STREAM_SUMS.launches, segsum.ALS_PATCH.launches) == before
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(kernels.params, name),
                           getattr(plain.params, name)), name


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


def _zipf_ids(rng, rows, slots, buckets):
    """bench.py's id recipe: zipf(1.3) draws hashed into the buckets; at
    16,384 x 39 one id takes ~162k slots."""
    raw = rng.zipf(1.3, size=(rows, slots)).astype(np.int64)
    return ((raw * 2654435761) % buckets).astype(np.int32)


def _field_ids(rng, rows, slots, buckets):
    """BASELINE config 5's ids: each slot's zipf(1.3) draw hashed into its
    own field's range of the buckets."""
    per = buckets // slots
    raw = rng.zipf(1.3, size=(rows, slots)).astype(np.int64)
    return (((raw * 2654435761) % buckets) % per
            + per * np.arange(slots)[None, :]).astype(np.int32)


def _b5_path_plan(dev, shape):
    """(seg, U, W) of one shape a path gives B5: the fused adagrad_row
    pack (W = k + 3 = 35) over a bench-recipe ladder plan; the direct
    step's per-slot terms over a ``dedup_ids`` plan of budget N at rank 32
    (W = 33) and at BASELINE config 5 (W = 17); config 1's direct step
    (W = 9, 4,096 user-item pairs of 2,625 features, budget F)."""
    rng = np.random.default_rng(13)
    if shape == "adagrad_row":
        ids = _zipf_ids(rng, 16384, 39, 1 << 24)
        cap = PE.auto_budget(ids.size)
        plan = PE.host_dedup(ids, cap, fill=1 << 24)
        return (torch.as_tensor(plan.seg, device=dev),
                PE.ladder_budget(int(plan.count), cap=cap), 35)
    if shape == "config 1":
        ids = np.stack([rng.integers(0, 943, 4096),
                        943 + rng.integers(0, 1682, 4096)], 1)
        rows, w = 2625, 9
    elif shape == "direct":
        ids, rows, w = _zipf_ids(rng, 16384, 39, 1 << 24), 1 << 24, 33
    else:                                          # "config 5"
        ids, rows, w = _field_ids(rng, 8192, 39, 1 << 20), 1 << 20, 17
    budget = min(ids.size, rows)
    plan = PE.dedup_ids(torch.as_tensor(ids.astype(np.int32), device=dev),
                        budget, fill=rows - 1)
    return plan.seg, budget, w


@pytest.mark.parametrize("layout", ["tiles", "chunks"])
@pytest.mark.parametrize("shape", ["adagrad_row", "direct", "config 5",
                                   "config 1"])
def test_rowsum_kernel_on_each_layout_at_path_shapes(dev, monkeypatch, shape,
                                                     layout):
    """B5 at each shape its paths give it, on both of its layouts (the
    wrapper's rule, ``segsum.rowsum_layout``, pinned to one): against the
    plain version in float64 at max |a - b| / (1 + |b|) < 1e-4, bit for
    bit on a second call, zero rows for the ranks no slot has (at U = N
    nearly all of them), one launch a call. The bench-recipe plans have a
    ~162k-slot head run; there the chunked layout, which adds the run's
    ~630 chunk sums in pass 2, is held to 2.5e-4, the bound chip_smoke.py
    set for it on that run (B5_WIDE_TOL: it read up to 1.87e-4, the f32
    plain version 3.26e-4 and more), and read 1.29e-4 at W = 33 on an
    H100; the tiles' groups and chunk sums keep 1e-4."""
    seg, u, w = _b5_path_plan(dev, shape)
    n = seg.shape[0]
    tol = 1e-4
    if shape in ("adagrad_row", "direct"):
        assert int(torch.bincount(seg).max()) > 100_000
        tol = 2.5e-4 if layout == "chunks" else 1e-4
    if layout == "tiles":
        monkeypatch.setattr(segsum, "rowsum_layout", lambda n, w, s: (
            "tiles", *segsum.tile_layout(n, w, s)))
    else:
        monkeypatch.setattr(segsum, "rowsum_layout", lambda n, w, s: (
            "chunks", 2 * -(-n // segsum.ROWSUM_CHUNK)))
    g = torch.randn((n, w), generator=torch.Generator(dev).manual_seed(5),
                    device=dev)
    want = segsum.segment_rowsum_reference(g.double(), seg, u)
    before = segsum.ROWSUM.launches
    got = segsum.segment_rowsum(g, seg, u)
    assert segsum.ROWSUM.launches == before + 1
    assert got.shape == (u, w)
    assert float(((got.double() - want).abs() / (1 + want.abs())).max()) \
        < tol
    assert torch.equal(got, segsum.segment_rowsum(g, seg, u))
    empty = torch.ones(u, dtype=torch.bool, device=dev)
    empty[seg.long()] = False
    assert not got[empty].any()


@pytest.mark.parametrize("w", [1, 64, 65, 65536])
def test_rowsum_kernel_takes_every_width(dev, w):
    """B5 takes 1 <= W <= 65536 on the card: the tiles up to
    ROWSUM_TILE_WIDTH, the chunked kernel past it, held to float64 with a
    run across chunks and a gap."""
    assert segsum.rowsum_layout(2000, w, 132)[0] == (
        "tiles" if w <= segsum.ROWSUM_TILE_WIDTH else "chunks")
    n = 2000 if w < 65536 else 40
    ranks = np.arange(n)
    ranks[:n // 2] = 0                     # one run of half the slots
    seg = torch.as_tensor(2 * ranks.astype(np.int32), device=dev)
    u = int(seg[-1]) + 3
    g = torch.randn((n, w), generator=torch.Generator(dev).manual_seed(w),
                    device=dev)
    got = segsum.segment_rowsum(g, seg, u)
    want = segsum.segment_rowsum_reference(g.double(), seg, u)
    assert float(((got.double() - want).abs() / (1 + want.abs())).max()) \
        < 1e-4
    assert not got[1::2].any()


@pytest.mark.parametrize("w", [3, 100])
def test_rowsum_kernel_traps_on_a_rank_out_of_range(dev, w):
    """A rank outside [0, U) traps B5 on either layout (W = 3 on the tiles,
    100 on the chunked kernel), in a child process."""
    code = ("import torch\n"
            "from sparkfm_tpu_torch.ops import segsum\n"
            "seg = torch.tensor([0, 1, 1, 5], dtype=torch.int32, "
            "device='cuda')\n"
            f"segsum.segment_rowsum(torch.ones((4, {w}), device='cuda'), "
            "seg, 5)\n"
            "torch.cuda.synchronize()\n")
    child = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300, cwd=REPO)
    assert child.returncode != 0
    assert "unspecified launch failure" in child.stderr, child.stderr[-2000:]


def _plain_rows64(g, seg, num_segments):
    """B5's plain version in float64, rounded to float32."""
    return segsum.segment_rowsum_reference(g.double(), seg,
                                           num_segments).float()


def _close_on_card(a, b, what, rtol=1e-4, atol=1e-6):
    bad = (a - b).abs() > atol + rtol * b.abs()
    assert not bool(bad.any()), f"{what}: {int(bad.sum())} entries differ"


@pytest.mark.parametrize("path", ["fused adagrad_row", "direct adam"])
def test_b5_steps_on_card_equal_plain_steps(dev, monkeypatch, path):
    """The two steps that sum by B5 on the card at rank 32 (4,096 x 39
    synth_ctr slots in 2^20 rows): the fused step under adagrad_row (its
    (N, k+3) pack over ladder plans, U = 8,192) and the direct step under
    adam (per-slot terms, budget U = N = 159,744). Each of 5 steps runs
    twice from one state, with the kernels and with the plain versions
    (B5 in float64, B1 and B2 as ``index_select``/``index_copy_``), and the
    run goes on from the kernels' result: losses at rtol 1e-5, every table
    at rtol 1e-4, atol 1e-6 (PERF.md section 2)."""
    from sparkfm_tpu_torch.solvers import sgd as psgd
    f = 1 << 20
    cfg = FMConfig(num_features=f, num_factors=32, task=Task.CLASSIFICATION,
                   reg_v=1e-6, seed=4)
    _, batches = _ctr_batches(dev, 5, seed=13, f=f, rows=4096, slots=39)
    init = pfm.init_params(cfg, torch.Generator().manual_seed(4),
                           device="cpu")
    if path == "fused adagrad_row":
        sgd = SGDConfig(batch_size=4096, learning_rate=0.05,
                        optimizer="adagrad_row", update_path="fused")
        step = sgd_fused.make_fused_train_step(cfg, sgd)
        state = _fused_state(cfg, dev, 4)

        def tables(st):
            return [st.table[:f], st.w0]

        def clone(st):
            return dataclasses.replace(st, table=st.table.clone(),
                                       w0=st.w0.clone(),
                                       slot_w0=st.slot_w0.clone(),
                                       step=st.step.clone())
    else:
        sgd = SGDConfig(batch_size=4096, learning_rate=1e-4,
                        optimizer="adam", update_path="direct")
        step = psgd.make_train_step(cfg, sgd)
        state = psgd.init_state(pfm.FMParams(*(t.to(dev) for t in (
            init.w0, init.w, init.v))), "adam")
        names = ("slot_w0", "slot_w", "slot_v", "slot2_w0", "slot2_w",
                 "slot2_v", "step")

        def tables(st):
            return [st.params.w0, st.params.w, st.params.v] + [
                getattr(st, n) for n in names[:-1]]

        def clone(st):
            return dataclasses.replace(
                st, params=pfm.FMParams(*(t.clone() for t in (
                    st.params.w0, st.params.w, st.params.v))),
                **{n: getattr(st, n).clone() for n in names})
    swaps = {(segsum, "segment_rowsum"): _plain_rows64,
             (rowio, "gather_rows"): rowio.gather_rows_reference,
             (rowio, "gather_vw_rows"): rowio.gather_vw_rows_reference,
             (rowio, "scatter_set_rows"): rowio.scatter_set_rows_reference}
    for i, b in enumerate(batches):
        plain_in = clone(state)
        before = segsum.ROWSUM.launches
        state, aux = step(state, b)
        assert segsum.ROWSUM.launches == before + 1
        with monkeypatch.context() as m:
            for (mod, name), fn in swaps.items():
                m.setattr(mod, name, fn)
            plain_out, plain_aux = step(plain_in, b)
        assert segsum.ROWSUM.launches == before + 1
        np.testing.assert_allclose(float(aux["loss"]),
                                   float(plain_aux["loss"]), rtol=1e-5)
        for j, (a, p) in enumerate(zip(tables(state), tables(plain_out))):
            _close_on_card(a, p, f"{path} step {i} table {j}")


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
                  {"GATHER": 1, "SCATTER": 1, "ROWSUM_SQ": 1,
                   "FFM_SLOT_MAJOR": 1}),
}


@pytest.mark.parametrize("name", list(PATH_RUNS))
def test_direct_dedup_and_ffm_train_sgd_on_card_match_cpu(dev, name):
    """train_sgd on the direct path (BASELINE config 1's shape, tables
    below 2^16 rows), the dedup path (adam, momentum) and FFM on the
    fused path, on the card: the kernels' launches per step as the path
    runs them (B1's two-table gather for [v | w], the slots and adam's
    second moments; B2 once a table; B6 for [Σg | Σg²], the fused FFM
    step's [g_v | g_w] included, or B5 for the direct step's per-slot
    momentum and adam terms; the slot-major FFM's one-pass kernel once a
    fused FFM step), two card runs equal bit for bit (no atomics), and the
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
               "ROWSUM_SQ": segsum.ROWSUM_SQ,
               "FFM_SLOT_MAJOR": PI.FFM_SLOT_MAJOR}
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


def _ctr_batches(dev, n, seed, budget=None, f=1 << 16, rows=256, slots=8):
    """n synth_ctr batches with host plans on ``dev``: ladder plans of one
    rung (the largest of the n), or of ``budget`` slots; None drops the
    plans (the fused step then builds them on the card)."""
    ds = psynth.synth_ctr(num_examples=n * rows, num_fields=slots,
                          num_buckets=f, seed=seed)
    if budget is None:
        ladder = list(batch_iterator(ds, rows, device="cpu",
                                     dedup_budget="ladder", dedup_fill=f))
        budget = max(int(b.plan.uids.shape[0]) for b in ladder)
    out = list(batch_iterator(ds, rows, device=dev, dedup_budget=budget,
                              dedup_fill=f))
    return ds, out


def _fused_state(cfg, dev, seed):
    init = pfm.init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
    return sgd_fused.fused_from_params(init, cfg, device=dev)


def _same_state(a, b):
    for name in ("table", "w0", "slot_w0", "step"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("kind", ["hybrid", "fused host plans",
                                  "fused device plans",
                                  "fused FFM device plans"])
def test_multi_step_graph_equals_eager_steps(dev, kind):
    """make_hybrid_multi_step / make_fused_multi_step on the card: three
    groups of G = 4 (the first runs eagerly and is captured, the next two
    replay the graph) give the state of 12 eager steps bit for bit, with
    the same losses; one graph is captured; each kernel of the path counts
    one launch per step, replays included (a slot-major FFM's one-pass
    kernel too)."""
    f = 1 << 16
    ffm = dict(num_fields=8, slot_major_fields=True) if "FFM" in kind else {}
    cfg = FMConfig(num_features=f, num_factors=4 if ffm else 8,
                   task=Task.CLASSIFICATION, reg_v=1e-4, seed=3, **ffm)
    sgd = SGDConfig(batch_size=256, learning_rate=0.1, unique_budget=0)
    if kind == "hybrid":
        make = sgd_hybrid.make_hybrid_multi_step
        step = sgd_hybrid.make_hybrid_train_step(cfg, sgd)
        kernels = (rowio.GATHER, segsum.FACTORED, rowio.SCATTER)
    else:
        make = sgd_fused.make_fused_multi_step
        step = sgd_fused.make_fused_train_step(cfg, sgd)
        kernels = (rowio.GATHER, segsum.ROWSUM_SQ, rowio.SCATTER) + (
            (PI.FFM_SLOT_MAJOR,) if ffm else ())
    _, batches = _ctr_batches(dev, 12, seed=4)
    if kind.endswith("device plans"):
        batches = [dataclasses.replace(b, plan=None) for b in batches]
    eager = _fused_state(cfg, dev, 5)
    eager_losses = []
    for b in batches:
        eager, aux = step(eager, b)
        eager_losses.append(aux["loss"])
    state = _fused_state(cfg, dev, 5)
    multi = make(cfg, sgd)
    counts = [k.launches for k in kernels]
    losses = []
    for g in range(3):
        out, aux = multi(state, sgd_hybrid.stack_batches(
            batches[4 * g:4 * g + 4]))
        assert out is state
        losses.append(aux["loss_mean"])
        assert torch.equal(aux["loss"], eager_losses[4 * g + 3])
    torch.cuda.synchronize()
    assert multi.captures == 1
    assert [k.launches - c for k, c in zip(kernels, counts)] == [12] * len(
        kernels)
    _same_state(state, eager)
    want = torch.stack(eager_losses).double().view(3, 4).mean(1)
    assert torch.equal(torch.stack(losses), want)


def test_graph_replay_adds_captured_launches(dev):
    """A capture counts nothing (it runs nothing); every replay adds the
    launches the graph captured."""
    cfg = FMConfig(num_features=1 << 16, num_factors=8, seed=3)
    sgd = SGDConfig(batch_size=256, learning_rate=0.1)
    _, batches = _ctr_batches(dev, 4, seed=6)
    multi = sgd_hybrid.make_hybrid_multi_step(cfg, sgd)
    state = _fused_state(cfg, dev, 6)
    stacked = sgd_hybrid.stack_batches(batches[:2])
    seen = []
    for _ in range(3):
        before = rowio.GATHER.launches
        multi(state, stacked)
        seen.append(rowio.GATHER.launches - before)
    assert seen == [2, 2, 2]
    (entry,) = multi.graphs.entries.values()
    ((_, launches),) = entry.graphs
    assert launches == {rowio.GATHER: 2, rowio.SCATTER: 2,
                        segsum.FACTORED: 2}


@pytest.mark.parametrize("spd", [2, 4])
def test_grouped_train_sgd_on_card_equals_single_steps(dev, spd):
    """train_sgd(steps_per_dispatch=G) on the hybrid path on the card:
    graphs per rung, the same tables and histories as G = 1 bit for bit,
    one launch of B1, B2 and B3 per step."""
    ds = psynth.synth_ctr(num_examples=2000, num_fields=8,
                          num_buckets=1 << 17, seed=2)
    cfg = FMConfig(num_features=1 << 17, num_factors=8,
                   task=Task.CLASSIFICATION, reg_v=1e-4, seed=2)
    init = pfm.init_params(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
    runs = []
    kernels = (rowio.GATHER, rowio.SCATTER, segsum.FACTORED)
    for g in (1, spd):
        sgd = SGDConfig(batch_size=256, learning_rate=0.1, epochs=2,
                        update_path="hybrid", steps_per_dispatch=g)
        counts = [k.launches for k in kernels]
        runs.append(train_sgd(cfg, sgd, ds, init_params=init, device=dev))
        assert [k.launches - c for k, c in zip(kernels, counts)] == [16] * 3
    one, grouped = runs
    assert one.history == grouped.history
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(one.params, name),
                           getattr(grouped.params, name)), name


def test_resume_on_card_equals_uninterrupted_run(dev, tmp_path):
    """Grouped hybrid training into a checkpoint_dir, resumed by a second
    call: the same parameters and history as the straight run, bit for
    bit."""
    ds = psynth.synth_ctr(num_examples=1500, num_fields=8,
                          num_buckets=1 << 17, seed=3)
    cfg = FMConfig(num_features=1 << 17, num_factors=8,
                   task=Task.CLASSIFICATION, reg_v=1e-4, seed=3)

    def run(epochs, **kw):
        sgd = SGDConfig(batch_size=256, learning_rate=0.1, epochs=epochs,
                        update_path="hybrid", steps_per_dispatch=2)
        return train_sgd(cfg, sgd, ds, generator=torch.Generator(
            device=dev).manual_seed(3), device=dev, **kw)
    straight = run(4)
    ckdir = str(tmp_path / "ck")
    run(2, checkpoint_dir=ckdir)
    resumed = run(4, checkpoint_dir=ckdir)
    assert resumed.history == straight.history
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(resumed.params, name),
                           getattr(straight.params, name)), name


# -- DeepFM, its serving and the CLI on the card ---------------------------

def _deepfm_weights(cfg, seed=0):
    rng = np.random.default_rng(seed)
    f, k = cfg.fm.num_features, cfg.fm.num_factors
    dims = (cfg.tower_in,) + tuple(cfg.hidden) + (1,)
    return (np.float32(0.05), rng.normal(0, 0.1, f).astype(np.float32),
            rng.normal(0, 0.05, (f, k)).astype(np.float32),
            [rng.normal(0, np.sqrt(2 / a), (a, b)).astype(np.float32)
             for a, b in zip(dims[:-1], dims[1:])],
            [rng.normal(0, 0.05, b).astype(np.float32) for b in dims[1:]])


def _deepfm_state(path, cfg, wts, device):
    from sparkfm_tpu_torch.models import deepfm as PDF
    params = PDF.deepfm_params_from_numpy(*wts, device=device)
    if path == "fused":
        fused = sgd_fused.fused_from_params(
            params.fm, cfg.fm.replace(num_fields=0), device=device)
        return PDF._tower_state(fused, params.mlp_w, params.mlp_b)
    state = PDF.init_state(params)
    return PDF.pad_deepfm_state_for_dedup(state) if path == "dedup" else state


DEEPFM_RUNS = {  # path, SGDConfig extras, launches a step
    "fused": ({}, {"GATHER": 1, "SCATTER": 1, "ROWSUM_SQ": 1}),
    "dedup": ({}, {"GATHER_VW": 2, "SCATTER": 4, "ROWSUM_SQ": 1}),
    "direct": ({}, {"GATHER_VW": 2, "SCATTER": 4, "ROWSUM_SQ": 1}),
    "direct momentum": (dict(optimizer="sgd", momentum=0.9),
                        {"GATHER_VW": 2, "SCATTER": 4, "ROWSUM": 1}),
}


@pytest.mark.parametrize("name", list(DEEPFM_RUNS))
def test_deepfm_steps_on_card_match_cpu(dev, name):
    """3 DeepFM steps of each path on the card from one state: the
    kernels' launches per step (B1 the record or two-table gathers, B2 a
    write per table, B6 the [g_v | g_w] sums, B5 the direct momentum
    terms), two card runs equal bit for bit, and the card against the CPU
    (losses rtol 1e-5; tables, slots and the tower, whose matmuls stay in
    full float32 on the card, rtol 1e-4, atol 1e-6)."""
    from sparkfm_tpu_torch.models import deepfm as PDF
    from sparkfm_tpu_torch.utils.checkpoint import state_tensors
    assert not torch.backends.cuda.matmul.allow_tf32
    path = name.split()[0]
    sgd_kw, per_step = DEEPFM_RUNS[name]
    feats = 1 << 17 if path == "fused" else 5000
    cfg = PDF.DeepFMConfig(fm=FMConfig(
        num_features=feats, num_factors=16, num_fields=8, reg_v=1e-4,
        task=Task.CLASSIFICATION), hidden=(64, 32))
    sgd = SGDConfig(batch_size=256, learning_rate=0.02, update_path=path,
                    **sgd_kw)
    ds = psynth.synth_ctr(num_examples=3 * 256, num_fields=8,
                          num_buckets=feats, seed=5)
    wts = _deepfm_weights(cfg)
    kernels = {"GATHER": rowio.GATHER, "GATHER_VW": rowio.GATHER_VW,
               "SCATTER": rowio.SCATTER, "ROWSUM": segsum.ROWSUM,
               "ROWSUM_SQ": segsum.ROWSUM_SQ}
    plan_kw = ({} if path == "direct"
               else dict(dedup_budget="ladder", dedup_fill=feats))
    runs = []
    for device in (dev, dev, "cpu"):
        state = _deepfm_state(path, cfg, wts, device)
        step = PDF.make_train_step(cfg, sgd)
        counts = {k: kern.launches for k, kern in kernels.items()}
        losses = [float(step(state, b)[1]["loss"]) for b in batch_iterator(
            ds, 256, device=device, **plan_kw)]
        if device != "cpu":
            assert {k: kern.launches - counts[k]
                    for k, kern in kernels.items()} == {
                k: 3 * per_step.get(k, 0) for k in kernels}
        runs.append((losses, {k: t.cpu() for k, t in
                              state_tensors(state).items()}))
    (l1, t1), (l2, t2), (lc, tc) = runs
    assert l1 == l2
    for k in t1:
        assert torch.equal(t1[k], t2[k]), k
    np.testing.assert_allclose(l1, lc, rtol=1e-5)
    for k in t1:
        a, b = t1[k], tc[k]
        if k == "fm.table":
            a, b = a[:feats, :34], b[:feats, :34]
        elif a.dim() and a.shape[0] == feats + 1:
            a, b = a[:feats], b[:feats]
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("path", ["dedup", "direct"])
def test_deepfm_adam_dropout_on_card_matches_the_reference(dev, path):
    """3 DeepFM steps under adam with dropout 0.5 on the card: B1 three
    two-table gathers and B2 six writes a step (adam's second moments
    too), B6 once; two card runs equal bit for bit (the masks redrawn
    from the same seeds); against the benchmark's float64 reference on
    the card, drawing the same masks there (losses rtol 1e-5; per leaf the
    change after 3 steps within 1e-3 of the reference's norm, as
    tests/test_torch_deepfm_reference.py holds it on the CPU)."""
    from portbench.reference import deepfm as R
    from sparkfm_tpu_torch.models import deepfm as PDF
    feats, b = 1 << 16, 256
    cfg = PDF.DeepFMConfig(fm=FMConfig(
        num_features=feats, num_factors=10, num_fields=8, reg_w=1e-3,
        reg_v=1e-3, task=Task.CLASSIFICATION, seed=21), hidden=(64, 64, 64),
        dropout=0.5)
    sgd = SGDConfig(batch_size=b, optimizer="adam", learning_rate=1e-2,
                    update_path=path)
    ds = psynth.synth_ctr(num_examples=3 * b, num_fields=8,
                          num_buckets=feats, seed=6)
    wts = _deepfm_weights(cfg, seed=3)
    kernels = {"GATHER_VW": rowio.GATHER_VW, "SCATTER": rowio.SCATTER,
               "ROWSUM_SQ": segsum.ROWSUM_SQ}
    runs = []
    for _ in range(2):
        state = PDF.initial_state(cfg, sgd, start=PDF.
                                  deepfm_params_from_numpy(*wts, device=dev),
                                  device=dev)
        step = PDF.make_train_step(cfg, sgd)
        counts = {k: kern.launches for k, kern in kernels.items()}
        losses = [float(step(state, x)[1]["loss"])
                  for x in batch_iterator(ds, b, device=dev)]
        assert {k: kern.launches - counts[k] for k, kern in
                kernels.items()} == {"GATHER_VW": 9, "SCATTER": 18,
                                     "ROWSUM_SQ": 3}
        runs.append((losses, PDF.params_of(state, cfg)))
    (l1, p1), (l2, p2) = runs
    assert l1 == l2
    assert all(torch.equal(x, y) for x, y in zip(p1.parameters(),
                                                 p2.parameters()))
    t = [torch.as_tensor(x, device=dev) for x in wts[:3]]
    tw = [[torch.as_tensor(x, device=dev) for x in xs] for xs in wts[3:]]
    batches = [{"idx": torch.as_tensor(ds.ids[i * b:(i + 1) * b],
                                       device=dev),
                "vals": torch.as_tensor(ds.vals[i * b:(i + 1) * b],
                                        device=dev),
                "y": torch.as_tensor(ds.y[i * b:(i + 1) * b], device=dev),
                "step": i} for i in range(3)]
    ref = R.train_steps(*t, *tw, batches, lr=1e-2, reg_w=1e-3, reg_v=1e-3,
                        dropout=0.5, seed=21)
    np.testing.assert_allclose(l1, ref["losses"], rtol=1e-5)
    got = R.leaves(p1.fm.w0, p1.fm.w, p1.fm.v, p1.mlp_w, p1.mlp_b)
    for name, x in got.items():
        want = ref["params"][-1][name] - ref["init"][name]
        gap = float((x.double() - ref["init"][name] - want).norm())
        assert gap <= 1e-3 * float(want.norm()) + 1e-7, name


def test_ffm_juan16_fused_step_on_card_matches_the_reference(dev):
    """One step of the field-aware FM at Juan et al.'s (2016) Criteo
    settings (39 fields, k = 4, no bias or linear term, adagrad with eps
    1, V ~ U(0, 1/sqrt(k)), values 1/sqrt(39)) at B = 4,096 on the card,
    by "auto" on the fused path with a device plan: B1, B6 and B2 once;
    inside a profiler session, whose record holds the step's three spans
    with CUDA-event device times and B * 39 slots on ``fused.slot_rows``.
    Against the benchmark's float64 per-pair reference on the card, with
    tests/test_torch_ffm_juan16.py's tolerances: the loss rtol 1e-6, the
    slots rtol 1e-4 (atol 1e-15), V atol 2e-7 (a few float32 ulps at
    |v| <= 0.5)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.gen import ffm as gen_ffm
    from portbench.reference import ffm as R
    from sparkfm_tpu_torch.solvers import sgd as psgd
    from sparkfm_tpu_torch.utils import profiling
    fields, k, b, feats = 39, 4, 4096, 1 << 20
    cfg = FMConfig(num_features=feats, num_factors=k, num_fields=fields,
                   slot_major_fields=True, use_bias=False, use_linear=False,
                   task=Task.CLASSIFICATION, reg_w=0.0, reg_v=1e-5)
    sgd = SGDConfig(batch_size=b, optimizer="adagrad", learning_rate=0.2,
                    adagrad_eps=1.0, host_plan=False)
    assert psgd.resolve_update_path(cfg, sgd) == "fused"
    rng = np.random.default_rng(3)
    per = feats // fields
    ids = ((rng.zipf(1.3, (b, fields)) - 1) % per
           + per * np.arange(fields)).astype(np.int32)
    vals = np.full((b, fields), 1 / np.sqrt(fields), np.float32)
    y = rng.integers(0, 2, b).astype(np.float32)
    ds = SparseDataset(ids=ids, vals=vals, y=y, num_features=feats)
    w0, w, v = gen_ffm.ffm_weights(feats, fields, k, 7, dev)
    state = sgd_fused.fused_from_params(pfm.FMParams(w0, w, v), cfg,
                                        device=dev)
    step = sgd_fused.make_fused_train_step(cfg, sgd)
    batch = next(batch_iterator(ds, b, device=dev))
    kernels = (rowio.GATHER, segsum.ROWSUM_SQ, rowio.SCATTER)
    counts = [kern.launches for kern in kernels]
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            with profiling.annotate("train.dispatch"):
                state, aux = step(state, batch)
            torch.cuda.synchronize()
        got = profiling.recorded()
    finally:
        profiling.clear()
    assert [kern.launches - c for kern, c in zip(kernels, counts)] == [1] * 3
    for name in ("fused.rows", "fused.interaction", "fused.update"):
        span = got["spans"][name]
        assert span["calls"] == 1 and span["device_s"] > 0, name
    assert got["counters"]["fused.slot_rows"] == b * fields
    rows = np.unique(ids)
    r = torch.as_tensor(rows, dtype=torch.long, device=dev)
    ref = R.sgd_steps(v[r], [{
        "idx": torch.as_tensor(np.searchsorted(rows, ids), device=dev),
        "vals": torch.as_tensor(vals, device=dev),
        "y": torch.as_tensor(y, device=dev),
        "field_ids": torch.arange(fields, device=dev).expand(b, -1)}],
        fields=fields, lr=0.2, eps=1.0, reg_v=1e-5)
    np.testing.assert_allclose(float(aux["loss"]), ref["losses"][0],
                               rtol=1e-6)
    vk = fields * k
    table = state.table[r]
    np.testing.assert_allclose(table[:, vk:2 * vk].double().cpu().numpy(),
                               ref["slot1"].cpu().numpy(), rtol=1e-4,
                               atol=1e-15)
    np.testing.assert_allclose(table[:, :vk].double().cpu().numpy(),
                               ref["params"][0].cpu().numpy(), rtol=0,
                               atol=2e-7)
    assert not table[:, 2 * vk:].any()


@pytest.mark.parametrize("path,opt", [("dedup", "adam"), ("direct", "adam"),
                                      ("fused", "adagrad")])
def test_deepfm_graphed_steps_equal_eager_steps(dev, path, opt):
    """The card's DeepFM step as four CUDA graphs a batch shape (the
    default) against its phases run eagerly (cuda_graphs=False), with
    dropout 0.5 over 6 steps of two batch shapes: a shape's first step
    runs eagerly, the others replay, and every loss, score and tensor of
    the state equals the eager run's bit for bit; aux holds fresh tensors
    (step 2's loss survives step 3), and the row kernels' launch counts
    are the eager step's."""
    from sparkfm_tpu_torch.models import deepfm as PDF
    from sparkfm_tpu_torch.utils.checkpoint import state_tensors
    feats, b = 1 << 16, 256
    cfg = PDF.DeepFMConfig(fm=FMConfig(
        num_features=feats, num_factors=10, num_fields=8, reg_w=1e-3,
        reg_v=1e-3, task=Task.CLASSIFICATION, seed=21), hidden=(64, 64, 64),
        dropout=0.5)
    ds = psynth.synth_ctr(num_examples=4 * b, num_fields=8,
                          num_buckets=feats, seed=6)
    wts = _deepfm_weights(cfg, seed=3)
    kernels = (rowio.GATHER, rowio.GATHER_VW, rowio.SCATTER,
               segsum.ROWSUM_SQ)
    runs = []
    for graphed in (False, True):
        sgd = SGDConfig(batch_size=b, optimizer=opt, learning_rate=1e-2,
                        update_path=path)
        state = PDF.initial_state(cfg, sgd, start=PDF.
                                  deepfm_params_from_numpy(*wts, device=dev),
                                  device=dev)
        step = PDF.make_train_step(cfg, sgd, cuda_graphs=graphed)
        before = [kern.launches for kern in kernels]
        auxes = []
        for size in (b, b // 2):
            for x in batch_iterator(ds, size, device=dev):
                auxes.append(step(state, x)[1])
                if len(auxes) in (3, 6):
                    break
        launches = [kern.launches - n for kern, n in zip(kernels, before)]
        runs.append((auxes, {k: t.clone() for k, t in
                             state_tensors(state).items()}, launches))
    (a1, s1, n1), (a2, s2, n2) = runs
    assert n1 == n2 and sum(n1) > 0
    for x, y in zip(a1, a2):
        assert set(x) == set(y)
        for key in x:
            assert torch.equal(x[key], y[key]), key
    assert set(s1) == set(s2)
    for key in s1:
        assert torch.equal(s1[key], s2[key]), key


def _xdeepfm_setup(dev, cin=(32, 32, 16)):
    """A small xDeepFM on the card (8 fields, k = 10, tower (64, 64)),
    its adam SGDConfig, data and seeded numpy weights (CIN ~ N(0, 0.1))."""
    from sparkfm_tpu_torch.models import deepfm as PDF
    feats, b = 1 << 16, 256
    cfg = PDF.DeepFMConfig(fm=FMConfig(
        num_features=feats, num_factors=10, num_fields=8, reg_w=1e-3,
        reg_v=1e-3, task=Task.CLASSIFICATION, seed=21), hidden=(64, 64),
        cin=cin, reg_dense=1e-3)
    ds = psynth.synth_ctr(num_examples=4 * b, num_fields=8,
                          num_buckets=feats, seed=6)
    rng = np.random.default_rng(9)
    shapes = PDF.cin_shapes(cfg)[0]
    wts = _deepfm_weights(cfg, seed=3) + (
        [rng.normal(0, 0.1, s).astype(np.float32) for s in shapes],)
    return cfg, ds, b, wts


def _graph_records(monkeypatch):
    """A list that grows by one for every CUDA graph captured."""
    from sparkfm_tpu_torch.utils import graphs
    captured, record = [], graphs.record

    def counted(body, pool):
        captured.append(1)
        return record(body, pool)
    monkeypatch.setattr(graphs, "record", counted)
    return captured


def test_xdeepfm_graphed_steps_equal_eager_steps(dev, monkeypatch):
    """xDeepFM's step as six CUDA graphs a batch shape (gather, CIN
    forward, dense, CIN backward, update, tower update) against its phases
    run eagerly, over 6 steps of two batch shapes: every loss, score and
    tensor of the state (the CIN's and its moments among them) equal bit
    for bit, and TF32 stays off."""
    from sparkfm_tpu_torch.models import deepfm as PDF
    from sparkfm_tpu_torch.utils.checkpoint import state_tensors
    cfg, ds, b, wts = _xdeepfm_setup(dev)
    captured = _graph_records(monkeypatch)
    runs = []
    for graphed in (False, True):
        sgd = SGDConfig(batch_size=b, optimizer="adam", learning_rate=1e-2,
                        update_path="dedup")
        state = PDF.initial_state(cfg, sgd, start=PDF.
                                  deepfm_params_from_numpy(*wts, device=dev),
                                  device=dev)
        step = PDF.make_train_step(cfg, sgd, cuda_graphs=graphed)
        auxes = []
        for size in (b, b // 2):
            for x in batch_iterator(ds, size, device=dev):
                auxes.append(step(state, x)[1])
                if len(auxes) in (3, 6):
                    break
        runs.append((auxes, {k: t.clone() for k, t in
                             state_tensors(state).items()}))
    assert len(captured) == 2 * 6
    (a1, s1), (a2, s2) = runs
    for x, y in zip(a1, a2):
        for key in x:
            assert torch.equal(x[key], y[key]), key
    assert set(s1) == set(s2)
    assert {"cin.0", "cin.3", "smc.3", "smc2.3"} <= set(s1)
    for key in s1:
        assert torch.equal(s1[key], s2[key]), key
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_deepfm_graphed_step_still_captures_four_graphs(dev, monkeypatch):
    from sparkfm_tpu_torch.models import deepfm as PDF
    cfg, ds, b, wts = _xdeepfm_setup(dev, cin=())
    captured = _graph_records(monkeypatch)
    sgd = SGDConfig(batch_size=b, optimizer="adam", learning_rate=1e-2,
                    update_path="dedup")
    state = PDF.initial_state(cfg, sgd, start=PDF.deepfm_params_from_numpy(
        *wts[:5], device=dev), device=dev)
    step = PDF.make_train_step(cfg, sgd)
    for x in batch_iterator(ds, b, device=dev):
        step(state, x)
    assert len(captured) == 4


def test_xdeepfm_on_card_matches_the_reference(dev):
    """3 graphed xDeepFM steps on the card against the benchmark's float64
    reference on the card (losses rtol 1e-5; per leaf the change after 3
    steps within 1e-3 of the reference's norm, as
    tests/test_torch_xdeepfm.py holds it on the CPU)."""
    from portbench.reference import xdeepfm as R
    from sparkfm_tpu_torch.models import deepfm as PDF
    cfg, ds, b, wts = _xdeepfm_setup(dev)
    sgd = SGDConfig(batch_size=b, optimizer="adam", learning_rate=1e-2,
                    update_path="dedup")
    state = PDF.initial_state(cfg, sgd, start=PDF.deepfm_params_from_numpy(
        *wts, device=dev), device=dev)
    step = PDF.make_train_step(cfg, sgd)
    batches = list(batch_iterator(ds, b, device=dev))[:3]
    losses = [float(step(state, x)[1]["loss"]) for x in batches]
    p = PDF.params_of(state, cfg)
    t = [torch.as_tensor(x, device=dev) for x in wts[:3]]
    tw = [[torch.as_tensor(x, device=dev) for x in xs] for xs in wts[3:]]
    ref = R.train_steps(*t, *tw, [
        {"idx": torch.as_tensor(ds.ids[i * b:(i + 1) * b], device=dev),
         "vals": torch.as_tensor(ds.vals[i * b:(i + 1) * b], device=dev),
         "y": torch.as_tensor(ds.y[i * b:(i + 1) * b], device=dev),
         "step": i} for i in range(3)], lr=1e-2, reg_w=1e-3, reg_v=1e-3,
        reg_dense=1e-3)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    got = R.leaves(p.fm.w0, p.fm.w, p.fm.v, p.mlp_w, p.mlp_b, p.cin)
    for name, x in got.items():
        want = ref["params"][-1][name] - ref["init"][name]
        gap = float((x.double() - ref["init"][name] - want).norm())
        assert gap <= 1e-3 * float(want.norm()) + 1e-7, name


def test_xdeepfm_records_its_cin_span_and_counter_on_card(dev):
    """On the card, replayed steps record ``deepfm.cin`` twice a step with
    device time, and ``deepfm.cin_rows`` B a step; a DeepFM step records
    neither."""
    from torch.profiler import profile

    from sparkfm_tpu_torch.models import deepfm as PDF
    from sparkfm_tpu_torch.utils import profiling
    recs = []
    for cin in ((32, 32, 16), ()):
        cfg, ds, b, wts = _xdeepfm_setup(dev, cin=cin)
        sgd = SGDConfig(batch_size=b, optimizer="adam", learning_rate=1e-2,
                        update_path="dedup")
        state = PDF.initial_state(cfg, sgd, start=PDF.
                                  deepfm_params_from_numpy(
                                      *(wts if cin else wts[:5]),
                                      device=dev), device=dev)
        step = PDF.make_train_step(cfg, sgd)
        batches = list(batch_iterator(ds, b, device=dev))
        step(state, batches[0])                 # eager, then captured
        profiling.clear()
        try:
            with profile():
                for x in batches[1:]:
                    step(state, x)
            recs.append(profiling.recorded())
        finally:
            profiling.clear()
    cin, plain = recs
    assert cin["spans"]["deepfm.cin"]["calls"] == 2 * 3
    assert cin["spans"]["deepfm.cin"]["device_s"] > 0
    assert cin["counters"]["deepfm.cin_rows"] == 3 * 256
    assert "deepfm.cin" not in plain["spans"]
    assert "deepfm.cin_rows" not in plain["counters"]
    assert plain["spans"]["deepfm.dense"]["calls"] == 3


@pytest.mark.parametrize("budget", [None, "ladder"])
def test_pinned_batches_equal_pageable_ones(dev, budget):
    """batch_iterator(pinned=True) on the card gives the batches and host
    plans of the pageable copies, tail included, counts every copy as
    pinned, and leaves each plan's count a pinned 0-d host tensor."""
    from torch.profiler import profile

    from sparkfm_tpu_torch.utils import profiling
    ds = psynth.synth_ctr(num_examples=1000, num_fields=8,
                          num_buckets=1 << 10, seed=4)
    kw = dict(shuffle=True, seed=3, epoch=1, dedup_budget=budget,
              dedup_fill=1 << 10)
    profiling.clear()
    with profile():
        got = list(batch_iterator(ds, 256, device=dev, pinned=True, **kw))
    counters = profiling.recorded()["counters"]
    want = list(batch_iterator(ds, 256, device=dev, **kw))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for name in ("ids", "vals", "y", "mask"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        if budget is None:
            assert a.plan is None and b.plan is None
            continue
        for name in ("uids", "ranks", "order", "seg", "svals", "sex"):
            x, y = getattr(a.plan, name), getattr(b.plan, name)
            assert x.device == y.device == dev, name
            assert torch.equal(x, y), name
        assert a.plan.count.is_pinned() and a.plan.count.ndim == 0
        assert int(a.plan.count) == int(b.plan.count)
        assert bool(a.plan.overflow) == bool(b.plan.overflow)
    assert counters["copy.h2d_pinned_bytes"] > 0
    assert "copy.h2d_pageable_bytes" not in counters


def test_deepfm_serving_on_card(dev):
    """MicroBatcher(model="deepfm") on the card: one two-table gather per
    chunk, of its unique rows with use_plans and of its slots' rows by
    default; both equal DeepFMModel.predict on the CPU (rtol 1e-5, atol
    1e-6)."""
    from sparkfm_tpu_torch.api import DeepFMModel
    from sparkfm_tpu_torch.models import deepfm as PDF
    cfg = PDF.DeepFMConfig(fm=FMConfig(
        num_features=1 << 17, num_factors=16, num_fields=8,
        task=Task.CLASSIFICATION), hidden=(64, 32))
    wts = _deepfm_weights(cfg, seed=2)
    ds = psynth.synth_ctr(num_examples=700, num_fields=8,
                          num_buckets=1 << 17, seed=2)
    want = DeepFMModel(PDF.deepfm_params_from_numpy(*wts, device="cpu"),
                       cfg).predict(ds.ids, ds.vals)
    params = PDF.deepfm_params_from_numpy(*wts, device=dev)
    for use_plans in (True, None):
        mb = MicroBatcher(params, cfg, max_batch=256, use_plans=use_plans,
                          model="deepfm")
        for a, b in ((0, 1), (1, 300), (300, 700)):
            mb.submit(ds.ids[a:b], ds.vals[a:b])
        before = rowio.GATHER_VW.launches
        out = np.concatenate(mb.flush())
        assert rowio.GATHER_VW.launches - before == 3      # one a chunk
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("argv,kernels", [
    (["--solver", "sgd", "--synth", "ctr"], ("GATHER", "SCATTER")),
    (["--solver", "sgd", "--synth", "ctr", "--model", "deepfm",
      "--fields", "16", "--task", "classification"],
     ("GATHER", "SCATTER", "ROWSUM_SQ")),
    (["--solver", "als", "--synth", "movielens"], ("COLSUMS",)),
])
def test_cli_train_on_card(dev, capsys, argv, kernels):
    """cli.main train with no --device runs on the card: its kernels
    launch and it prints its JSON."""
    import json

    from sparkfm_tpu_torch import cli as pcli
    kerns = {"GATHER": rowio.GATHER, "SCATTER": rowio.SCATTER,
             "ROWSUM_SQ": segsum.ROWSUM_SQ, "COLSUMS": segsum.COLSUMS}
    before = {k: kerns[k].launches for k in kernels}
    assert pcli.main(["train", "--synth-examples", "4000", "--iters", "2",
                      "--batch-size", "1024", "--split", "0.8,0.2",
                      *argv]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["train_examples"] == 3200 and out["examples_per_sec"] > 0
    assert all(kerns[k].launches > before[k] for k in kernels)


def _users_relation(n=20000, users=300, movies=400, seed=3):
    """(user, movie) ratings with a users side table of three one-hot
    columns (2, 7 and 21 values), keyed by user, in block-structure form."""
    from sparkfm_tpu_torch.data import relational as PR
    rng = np.random.default_rng(seed)
    uid = rng.integers(0, users, n)
    demo = np.stack([rng.integers(0, 2, users), 2 + rng.integers(0, 7, users),
                     9 + rng.integers(0, 21, users)], axis=1)
    off = users + movies
    table = np.concatenate([demo, np.zeros((1, 3), np.int64)]).astype(
        np.int32)
    vals = np.concatenate([np.ones((users, 3)), np.zeros((1, 3))]).astype(
        np.float32)
    main = np.stack([uid, users + rng.integers(0, movies, n)], axis=1)
    y = (3 + 0.5 * (demo[uid, 0] - 0.5) + 0.3 * rng.normal(size=n)).astype(
        np.float32)
    return PR.RelationalDataset(
        main_ids=main.astype(np.int32), main_vals=np.ones((n, 2), np.float32),
        y=y, keys=uid[:, None].astype(np.int32),
        tables=(PR.RelationTable(ids=table, vals=vals, offset=off),),
        num_features=off + 30)


def test_mcmc_sweep_on_card_matches_cpu(dev):
    """One MCMC sweep on the card through B7 ((K + 1) x blocks launches),
    against the same sweep on the CPU under one draw source's values, and
    two card sweeps from one seed bit for bit."""
    from sparkfm_tpu_torch.solvers import mcmc as pmcmc
    ds = psynth.synth_movielens(300, 400, 20000, rank=3, seed=1)
    cfg = FMConfig(num_features=ds.num_features, num_factors=8, seed=1)
    acfg = ALSConfig(feature_blocks=pals.slot_blocks(ds))
    init = pfm.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")

    class Recorded:
        """The card generator's draws, replayed on the CPU."""

        def __init__(self, draws, device):
            self.draws, self.device, self.log = draws, device, []

        def normal(self, shape):
            return self._keep(self.draws.normal(shape))

        def gamma(self, shape_param):
            return self._keep(self.draws.gamma(
                shape_param.to(self.draws.generator.device)))

        def _keep(self, x):
            self.log.append(x.cpu())
            return x.to(self.device)

    def sweep(device, draws):
        ws, nb = pals.build_workspace(ds, cfg, acfg, device=device)
        state = pmcmc.init_mcmc_state(pfm.FMParams(
            *(t.to(device) for t in (init.w0, init.w, init.v))))
        return pmcmc.mcmc_sweep(state, ws, draws, nb, cfg.num_features,
                                column_pure=True, csc_uniform=True,
                                slice_identity=pals.csc_slice_identity(
                                    ws, nb, ds.num_examples))

    def card_draws():
        return pmcmc.TorchDraws(torch.Generator(device=dev).manual_seed(5))

    before = segsum.COLSUMS.launches
    rec = Recorded(card_draws(), dev)
    on_card = sweep(dev, rec)
    assert segsum.COLSUMS.launches - before == (8 + 1) * 2
    replay = iter(rec.log)

    class Replay:
        def normal(self, shape):
            return next(replay)

        def gamma(self, shape_param):
            return next(replay)

    on_cpu = sweep(torch.device("cpu"), Replay())
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(on_card.params, name).cpu(),
                                   getattr(on_cpu.params, name),
                                   rtol=1e-3, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(on_card.alpha), float(on_cpu.alpha),
                               rtol=1e-5)
    again = sweep(dev, card_draws())
    for name in ("w0", "w", "v"):
        assert torch.equal(getattr(again.params, name),
                           getattr(on_card.params, name)), name


@pytest.mark.parametrize("update_path,launches", [
    ("direct", dict(gather_vw=2, scatter=4, rowsum_sq=1)),
    ("dedup", dict(gather_vw=2, scatter=4, rowsum_sq=1))])
def test_relational_sgd_on_card_matches_cpu(dev, update_path, launches,
                                           monkeypatch):
    """train_sgd_relational on the card (B1's two-table gathers, B6, B2 per
    step) against the CPU run from the same initial weights, and twice
    bit for bit."""
    from sparkfm_tpu_torch.training import trainer as ptrainer
    rel = _users_relation()
    init = pfm.init_params(FMConfig(num_features=rel.num_features,
                                    num_factors=8),
                           torch.Generator().manual_seed(2), device="cpu")
    monkeypatch.setattr(pfm, "init_params", lambda cfg, generator=None, *,
                        device: pfm.FMParams(*(t.to(device, copy=True)
                                               for t in (init.w0, init.w,
                                                         init.v))))
    cfg = FMConfig(num_features=rel.num_features, num_factors=8,
                   reg_v=0.01, seed=2)
    sgd_cfg = SGDConfig(batch_size=2048, epochs=2, learning_rate=0.05,
                        update_path=update_path)
    kernels = dict(gather_vw=rowio.GATHER_VW, scatter=rowio.SCATTER,
                   rowsum_sq=segsum.ROWSUM_SQ)
    before = {k: v.launches for k, v in kernels.items()}
    on_card = ptrainer.train_sgd_relational(cfg, sgd_cfg, rel, eval_ds=rel,
                                            device=dev)
    steps = 2 * -(-rel.num_examples // 2048)
    evals = steps          # an eval each epoch: one gather a batch
    for k, per_step in launches.items():
        got = kernels[k].launches - before[k]
        assert got == per_step * steps + (evals if k == "gather_vw" else 0), k
    on_cpu = ptrainer.train_sgd_relational(cfg, sgd_cfg, rel, eval_ds=rel,
                                           device="cpu")
    np.testing.assert_allclose([h["train_loss"] for h in on_card.history],
                               [h["train_loss"] for h in on_cpu.history],
                               rtol=1e-4)
    for name in ("w", "v"):
        np.testing.assert_allclose(getattr(on_card.params, name).cpu(),
                                   getattr(on_cpu.params, name),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    again = ptrainer.train_sgd_relational(cfg, sgd_cfg, rel, device=dev)
    assert torch.equal(again.params.v, on_card.params.v)


def test_bs_als_on_card_matches_cpu(dev):
    """train_als_relational on the card (B7 at S = 1, 2 and 4) against the
    CPU run."""
    from sparkfm_tpu_torch.solvers import als_bs as pbs
    rel = _users_relation()
    cfg = FMConfig(num_features=rel.num_features, num_factors=8, reg_w=0.1,
                   reg_v=0.5, seed=1)
    init = pfm.init_params(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    flat = rel.materialize()
    before = segsum.COLSUMS.launches
    on_card = pbs.train_als_relational(cfg, ALSConfig(epochs=3), rel,
                                       eval_ds=flat, params=init, device=dev)
    # 2 main blocks, 3 relation columns: w 2 + 3 x 2, a factor 2 + 3 x 2
    assert segsum.COLSUMS.launches - before == 3 * (8 + 8 * 8)
    on_cpu = pbs.train_als_relational(cfg, ALSConfig(epochs=3), rel,
                                      eval_ds=flat, params=init,
                                      device="cpu")
    np.testing.assert_allclose(
        [h["eval_rmse"] for h in on_card.history],
        [h["eval_rmse"] for h in on_cpu.history], rtol=1e-4)
    for name in ("w0", "w", "v"):
        np.testing.assert_allclose(getattr(on_card.params, name).cpu(),
                                   getattr(on_cpu.params, name),
                                   rtol=1e-3, atol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# The sharded paths on a one-rank NCCL mesh (parallel/)

@pytest.fixture(scope="module")
def mesh1():
    """A (1, 1) mesh on one real NCCL rank, in this process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sparkfm_tpu_torch.parallel import mesh as PM
    return PM.make_mesh(1, 1, device="cuda")


def _sharded_batches(ds, n, bs=512):
    return [b for _, b in zip(range(n), batch_iterator(ds, bs,
                                                       device="cpu"))]


@pytest.mark.parametrize("exchange,plan,opt", [
    ("global", "hybrid", "adagrad"), ("global", "global", "adagrad"),
    ("unique", None, "adagrad"), ("dense", None, "adam")])
def test_sharded_sgd_one_rank_nccl_matches_direct_step(dev, mesh1, exchange,
                                                       plan, opt):
    """Each exchange on a one-rank NCCL mesh against the one-device direct
    step on the card, step by step from a copy of the sharded state; the
    hybrid exchange launches B3 once a step, the global and unique ones B6
    (their local sums), all B1 (the masked lookup; the dense exchange also
    reads its [v | w], m and v rows by it, and runs the direct step's
    update). Tables and slots at rtol 1e-4, atol 1e-6; under adam, whose
    entries move by about lr a slot, on each step's change (rtol 1e-4 of
    it, plus an ulp and 1e-6 of the largest change), where up to 64
    entries of w and V may differ by 2 lr: a slot whose gradient is at
    rounding level flips the sign of its step when the two steps'
    gradients round apart."""
    from sparkfm_tpu_torch.parallel import multihost as MH
    from sparkfm_tpu_torch.parallel import sharded_sgd as S
    from sparkfm_tpu_torch.solvers import sgd as psgd
    ds = psynth.synth_ctr(4096, num_fields=8, num_buckets=1 << 12, seed=3)
    cfg = FMConfig(num_features=ds.num_features, num_factors=8,
                   task=Task.CLASSIFICATION, reg_w=1e-4, reg_v=1e-4)
    sgd_cfg = SGDConfig(batch_size=512, optimizer=opt, unique_budget=4096,
                        learning_rate=1e-5 if opt == "adam" else 1e-2)
    state, pcfg = S.init_sharded_state(cfg, mesh1,
                                       torch.Generator(dev).manual_seed(2),
                                       opt)
    step = S.make_sharded_train_step(pcfg, sgd_cfg, mesh1, exchange)
    ref_step = psgd.make_train_step(pcfg, dataclasses.replace(
        sgd_cfg, update_path="direct"))
    fill = pcfg.num_features - 1
    kernels = (segsum.FACTORED, segsum.ROWSUM_SQ, rowio.GATHER_VW)
    launches = [0, 0, 0]
    f = cfg.num_features
    for b in _sharded_batches(ds, 4):
        p = None
        if plan is not None:
            p = PE.host_dedup(np.asarray(b.ids), 4096, fill,
                              vals=np.asarray(b.vals))
            if plan == "hybrid":
                seg, sv, sex, gmap, _ = PE.stack_hybrid_extras(
                    p.ranks, np.asarray(b.vals), 1)
                p = p._replace(order=gmap, seg=seg, svals=sv, sex=sex)
            else:
                p = p._replace(order=None, seg=None, svals=None, sex=None)
        ref = dataclasses.replace(state, params=pfm.FMParams(*(
            t.clone() for t in (state.params.w0, state.params.w,
                                state.params.v))),
            slot_w=state.slot_w.clone(), slot_v=state.slot_v.clone(),
            slot2_w=state.slot2_w.clone(), slot2_v=state.slot2_v.clone())
        start = {n: t.cpu()[:f].double().numpy()
                 for n, t in _sgd_tables(state).items()}
        before = [k.launches for k in kernels]
        state, aux = step(state, MH.global_batch(
            mesh1, b, plan=p, plan_mode="global_hybrid"
            if plan == "hybrid" else "global"))
        launches = [n + k.launches - b0
                    for n, k, b0 in zip(launches, kernels, before)]
        ref, ref_aux = ref_step(ref, dataclasses.replace(
            b, ids=b.ids.to(dev), vals=b.vals.to(dev), y=b.y.to(dev),
            mask=b.mask.to(dev), field_ids=None))
        np.testing.assert_allclose(float(aux["loss"]),
                                   float(ref_aux["loss"]), rtol=1e-5)
        refs = _sgd_tables(ref)
        for name, t in _sgd_tables(state).items():
            a = t.cpu()[:f].numpy()
            w = refs[name].cpu()[:f].numpy()
            if opt != "adam":
                np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-6,
                                           err_msg=name)
                continue
            change = np.abs(w - start[name])
            diff = np.abs(a.astype(np.float64) - w)
            bad = diff > (1e-4 * change + np.spacing(np.abs(w))
                          + 1e-6 * change.max())
            flips = name in ("w", "v")
            assert bad.sum() <= (64 if flips else 0), (name, bad.sum())
            assert (diff[bad] <= 2 * sgd_cfg.learning_rate).all(), name
    assert launches == [4 if plan == "hybrid" else 0,
                        4 if exchange in ("unique", "global")
                        and plan != "hybrid" else 0,
                        16 if exchange == "dense" else 4]


def _sgd_tables(state):
    """An SGDState's tables and slots by name (0-d slot2 placeholders
    left out)."""
    out = {"w": state.params.w, "v": state.params.v}
    for n in ("slot_w", "slot_v", "slot2_w", "slot2_v"):
        if getattr(state, n).dim():
            out[n] = getattr(state, n)
    return out


def test_sharded_als_and_mcmc_one_rank_nccl(dev, mesh1):
    """The sharded sweep on one NCCL rank against the one-device
    reference sweep and the compact sweep on the card; B7 launches
    (K + 1) x blocks a sweep, with S = 1 for w and S = 2 for V."""
    from sparkfm_tpu_torch.parallel import sharded_als as SA
    ds = psynth.synth_movielens(300, 400, 20000, rank=3, seed=1)
    cfg = FMConfig(num_features=ds.num_features, num_factors=8, reg_v=0.5)
    acfg = ALSConfig(feature_blocks=pals.slot_blocks(ds))
    init = pfm.init_params(cfg, torch.Generator(dev).manual_seed(1),
                           device=dev)
    ws, nb = SA.build_sharded_workspace(ds, cfg, acfg, mesh1)
    before = segsum.COLSUMS.launches
    got = SA.make_sharded_sweep(cfg, nb, mesh1)(init, ws)
    assert segsum.COLSUMS.launches - before == (8 + 1) * nb
    one_ws, _ = pals.build_workspace(ds, cfg, acfg, device=dev)
    for want in (pals.als_sweep(init, one_ws, nb, cfg.num_features, 0.0,
                                0.0, 0.5),
                 pals.als_sweep_compact(init, one_ws, nb,
                                        one_ws.present.shape[0], 0.0, 0.0,
                                        0.5)):
        for name in ("w0", "w", "v"):
            np.testing.assert_allclose(getattr(got, name).cpu(),
                                       getattr(want, name).cpu(),
                                       rtol=1e-3, atol=1e-4, err_msg=name)
    from sparkfm_tpu_torch import MCMCConfig
    res = SA.train_mcmc_sharded(
        cfg, MCMCConfig(epochs=2, burn_in=1,
                        feature_blocks=acfg.feature_blocks),
        ds, mesh1, eval_ds=ds)
    assert np.isfinite(res.history[-1]["eval_rmse_avg"])


def test_sharded_deepfm_one_rank_nccl_matches_dedup_step(dev, mesh1):
    from sparkfm_tpu_torch.models import deepfm as DF
    from sparkfm_tpu_torch.parallel import multihost as MH
    from sparkfm_tpu_torch.parallel import sharded_deepfm as SD
    ds = psynth.synth_ctr(4096, num_fields=8, num_buckets=1 << 12, seed=4)
    cfg = DF.DeepFMConfig(fm=FMConfig(num_features=ds.num_features,
                                      num_factors=8, num_fields=8,
                                      task=Task.CLASSIFICATION),
                          hidden=(32, 16))
    sgd_cfg = SGDConfig(batch_size=512, learning_rate=0.05,
                        update_path="dedup", unique_budget=4096)
    state, pcfg = SD.init_sharded_state(cfg, mesh1,
                                        torch.Generator(dev).manual_seed(3))
    p = state.fm.params
    ref_cfg = DF.DeepFMConfig(fm=pcfg.fm.replace(
        num_features=pcfg.fm.num_features - 1), hidden=cfg.hidden)
    ref = DF.pad_deepfm_state_for_dedup(DF.init_state(DF.DeepFMParams(
        pfm.FMParams(p.w0.clone(), p.w[:-1].clone(), p.v[:-1].clone()),
        [w.clone() for w in state.mlp_w], [b.clone() for b in state.mlp_b])))
    step = SD.make_sharded_train_step(pcfg, sgd_cfg, mesh1)
    ref_step = DF.make_train_step(ref_cfg, sgd_cfg)
    for b in _sharded_batches(ds, 3):
        state, aux = step(state, MH.global_batch(mesh1, b))
        ref, ref_aux = ref_step(ref, dataclasses.replace(
            b, ids=b.ids.to(dev), vals=b.vals.to(dev), y=b.y.to(dev),
            mask=b.mask.to(dev)))
        np.testing.assert_allclose(float(aux["loss"]),
                                   float(ref_aux["loss"]), rtol=1e-5)
    f = cfg.fm.num_features
    np.testing.assert_allclose(state.fm.params.v.cpu()[:f],
                               ref.fm.params.v.cpu()[:f], rtol=1e-4,
                               atol=1e-6)
    for a, b in zip(state.mlp_w, ref.mlp_w):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-6)


def test_b3_and_b7_at_sharded_shapes_equal_plain(dev):
    """B3 on one data shard's id-sorted block (local dense ranks from
    stack_hybrid_extras, U_cap rows) and B7 on one shard's CSC view (the
    feature ids as ranks, with gaps; S = 1 and 2), each against its plain
    version in float64."""
    rng = np.random.default_rng(7)
    ids = (rng.zipf(1.3, (8192, 39)) % (1 << 20)).astype(np.int32)
    vals = np.ones(ids.shape, np.float32)
    hp = PE.host_dedup(ids, 1 << 18, (1 << 20) - 1, vals=vals)
    seg, sv, sex, gmap, u_cap = PE.stack_hybrid_extras(hp.ranks, vals, 2)
    g = torch.Generator(dev).manual_seed(7)
    k = 32
    vw = torch.randn((u_cap, k + 1), generator=g, device=dev) * 0.1
    ex = torch.randn((4096, k + 2), generator=g, device=dev)
    seg_t = torch.as_tensor(seg[0], device=dev)
    x = torch.as_tensor(sv[0], device=dev)
    ex_srt = ex.index_select(0, torch.as_tensor(sex[0], device=dev).long())
    got = segsum.fm_grad_segsum_factored(vw, ex_srt, x, seg_t, u_cap,
                                         1e-4, 1e-4)
    want = segsum.fm_grad_segsum_factored_reference(
        vw.double(), ex_srt.double(), x.double(), seg_t, u_cap, 1e-4, 1e-4)
    np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=1e-4, atol=1e-4)

    feat = np.sort(rng.integers(0, 200_000, 2_000_000).astype(np.int32))
    seg7 = torch.as_tensor(feat, device=dev)
    for s in (1, 2):
        streams = [torch.randn(feat.shape[0], generator=g, device=dev)
                   for _ in range(s)]
        got = segsum.segment_colsums(streams, seg7, 200_000)
        want = segsum.segment_colsums_reference(
            [t.double() for t in streams], seg7, 200_000)
        np.testing.assert_allclose(got.cpu(), want.cpu(), rtol=1e-4,
                                   atol=1e-4)


def _slot_major_case(dev, b, f, k, variant, seed):
    """One batch of per-slot [v | w] rows (B, F, F K + 1) on the card, as
    the fused step spreads them, with its values, labels and L2
    arguments. "cell": ffm-train-criteo's model (logistic, no bias or
    linear term, values 1/sqrt(F), scalar L2); "all terms": the bias,
    the linear term, a mask, zero-valued padding slots and per-slot L2
    strengths; "squared": regression with bias and linear term; "offset":
    the cell's model on rows 4 bytes past a 16-byte bound, so the first
    and last examples' copies would leave the tensor."""
    g = torch.Generator(device=dev).manual_seed(seed)
    width = f * k + 1
    n = b * f * width
    if variant == "offset":
        rows = torch.rand(n + 1, generator=g, device=dev)[1:].view(
            b, f, width)
    else:
        rows = torch.rand((b, f, width), generator=g, device=dev)
    rows.mul_(0.5)
    vals = torch.full((b, f), f ** -0.5, device=dev)
    y = torch.randint(0, 2, (b,), generator=g, device=dev).float()
    kw = dict(use_bias=False, use_linear=False, reg0=0.0, reg_w=0.0,
              reg_v=1e-5)
    task, mask = Task.CLASSIFICATION, None
    if variant == "all terms":
        vals = vals * (torch.rand((b, f), generator=g, device=dev) > 0.2)
        mask = torch.rand(b, generator=g, device=dev) > 0.1
        kw.update(use_bias=True, use_linear=True, reg0=1e-3,
                  reg_w=torch.rand((b, f), generator=g, device=dev) * 1e-3,
                  reg_v=torch.rand((b, f), generator=g, device=dev) * 1e-3)
    elif variant == "squared":
        task = Task.REGRESSION
        y = torch.randn(b, generator=g, device=dev)
        kw.update(use_bias=True, use_linear=True, reg0=1e-3, reg_w=1e-4)
    w0 = torch.tensor(0.1, device=dev)
    return (w0, rows, vals, y, mask, task), kw


SLOT_MAJOR_SHAPES = {"config 4": (8192, 22, 8), "cell": (4096, 39, 4)}


@pytest.mark.parametrize("variant", ["cell", "all terms", "squared",
                                     "offset"])
@pytest.mark.parametrize("shape", list(SLOT_MAJOR_SHAPES))
def test_slot_major_kernel_holds_to_float64(dev, shape, variant):
    """The one-pass kernel against its plain version (autograd) on the
    same inputs in float64, at config 4's shape (B = 8,192, F = 22, K =
    8) and the cell's F = 39, K = 4 (B = 4,096): scores, loss, g_w0 and
    every lane of [g_v | g_w]; one launch a call, and two calls equal bit
    for bit. Tolerances: a score is a float32 sum of up to 741 pair dots
    in another order than the float64 one, ~1e-7 of the sum of the
    terms' sizes, so 1e-5 of the largest score; the gradients scale
    dloss/ds, whose error follows the score's, by one or two float32
    products, so 1e-5 relative and 1e-6 of the largest entry; g_w0 sums
    B of those, so 1e-5 of the sum of |dloss/ds|; the loss, a float32
    mean of B terms, 1e-6."""
    b, f, k = SLOT_MAJOR_SHAPES[shape]
    args, kw = _slot_major_case(dev, b, f, k, variant, seed=b + f)
    before = PI.FFM_SLOT_MAJOR.launches
    got = PI.ffm_slot_major_loss_grad(*args, **kw)
    assert PI.FFM_SLOT_MAJOR.launches == before + 1
    again = PI.ffm_slot_major_loss_grad(*args, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, again))

    def dbl(t):
        return t.double() if torch.is_tensor(t) and t.is_floating_point() \
            else t
    want = PI.ffm_slot_major_loss_grad_reference(
        *(dbl(a) for a in args), **{n: dbl(v) for n, v in kw.items()})
    s, loss, g_w0, g = (t.double().cpu().numpy() for t in got)
    ws, wloss, wg_w0, wg = (t.detach().cpu().numpy() for t in want)
    np.testing.assert_allclose(s, ws, rtol=1e-5, atol=1e-5 * abs(ws).max())
    np.testing.assert_allclose(loss, wloss, rtol=1e-6)
    np.testing.assert_allclose(g, wg, rtol=1e-5, atol=1e-6 * abs(wg).max())
    # g_w0's scale: 2 reg0 w0 and, with the bias, the sum of |dloss/ds|
    yv = args[3].double().cpu().numpy()
    wt = (np.ones(b) if args[4] is None
          else args[4].double().cpu().numpy())
    if args[5] == Task.REGRESSION:
        d = 2 * np.abs(ws - yv)
    else:
        ypm = np.where(yv > 0, 1.0, -1.0)
        d = 1 / (1 + np.exp(ypm * ws))
    scale = abs(wg_w0) + (float((d * wt).sum() / max(wt.sum(), 1e-12))
                          if kw["use_bias"] else 0.0)
    np.testing.assert_allclose(g_w0, wg_w0, rtol=1e-5, atol=1e-5 * scale)
    assert np.count_nonzero(wg) > wg.size // 2


def test_slot_major_kernel_counts_one_launch_a_fused_ffm_step(dev):
    """The fused step launches the one-pass kernel once a step on a
    slot-major FFM and never on plain FM (the same batches)."""
    ds = _big_ctr()
    for fields, want in ((8, 1), (0, 0)):
        kw = dict(num_fields=fields, slot_major_fields=True) if fields \
            else {}
        cfg = FMConfig(num_features=ds.num_features, num_factors=4,
                       task=Task.CLASSIFICATION, reg_v=1e-4, seed=3, **kw)
        sgd = SGDConfig(batch_size=512, learning_rate=0.05,
                        update_path="fused", host_plan=False)
        state = _fused_state(cfg, dev, 3)
        step = sgd_fused.make_fused_train_step(cfg, sgd)
        before = PI.FFM_SLOT_MAJOR.launches
        steps = 0
        for batch in batch_iterator(ds, 512, device=dev):
            state, _ = step(state, batch)
            steps += 1
        torch.cuda.synchronize()
        assert PI.FFM_SLOT_MAJOR.launches - before == want * steps


@pytest.mark.parametrize("fault", ["strided rows", "float64 rows",
                                   "65 fields", "k = 3", "wide rows"])
def test_slot_major_kernel_refuses_what_it_cannot_take(dev, fault):
    f, k = {"65 fields": (65, 1), "k = 3": (4, 3),
            "wide rows": (64, 16)}.get(fault, (5, 4))
    (w0, rows, vals, y, mask, task), kw = _slot_major_case(
        dev, 16, f, k, "cell", seed=1)
    if fault == "strided rows":
        rows = torch.cat([rows, rows], 2)[..., ::2]
    elif fault == "float64 rows":
        w0, rows, vals, y = (t.double() for t in (w0, rows, vals, y))
    before = PI.FFM_SLOT_MAJOR.launches
    with pytest.raises(ValueError, match="ffm_slot_major_loss_grad"):
        PI.ffm_slot_major_loss_grad(w0, rows, vals, y, mask, task, **kw)
    assert PI.FFM_SLOT_MAJOR.launches == before
