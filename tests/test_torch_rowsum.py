"""The port's per-run row sums against the JAX package's:

- ``segment_rowsum`` (kernel B5) against JAX ``segment_rowsum``;
- ``segment_rowsum_sq`` (kernel B6) against JAX ``segment_rowsum_sq``
  (``bf16x2=False``: the split is a TPU matrix-unit device, not a parity
  target);
- ``fm_grad_segsum`` (kernel B4) against JAX ``fm_grad_segsum``;
- ``accumulate_to_unique_sorted`` against JAX's, and against the scatter
  form ``accumulate_to_unique``.

On the CPU the wrappers run their plain versions (``index_add_``). They
are held to the JAX XLA branch (``force="xla"``, exact f32
``segment_sum``) at rtol 1e-5, atol 1e-6, and to the Pallas kernels in
interpret mode at small tiles at rtol 1e-5, atol 1e-5, the JAX segsum
tests' own tolerance (a one-hot matrix product sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.ops import embedding as JE
from sparkfm_tpu.ops import pallas_segsum as S
from sparkfm_tpu_torch.ops import embedding as PE
from sparkfm_tpu_torch.ops import segsum

torch.set_num_threads(1)
CV, CW = 3e-3, 7e-3
TOL = {"xla": dict(rtol=1e-5, atol=1e-6), "interpret": dict(rtol=1e-5,
                                                            atol=1e-5)}


def _seg(rng, n, kind):
    """Sorted dense ranks (step <= 1, what the plans emit) of a kind."""
    incr = rng.integers(0, 2, n)
    incr[0] = 0
    if kind == "long":                     # one run of 60% of the slots
        incr[n // 5 + 1:n // 5 + 3 * n // 5] = 0
    elif kind == "one_run":
        incr[:] = 0
    seg = np.cumsum(incr)
    if kind == "offset":                   # seg[0] > 0
        seg = seg + 5
    return seg.astype(np.int32)


def _segments(seg, n, kind):
    """U for a case: N for "budget" (the direct step's plan, budget N, so
    most ranks have no slot), else a few ranks past the last."""
    return n if kind == "budget" else int(seg[-1]) + 4


CASES = [  # (n, W, kind)
    (96, 66, "dense"), (90, 35, "offset"), (77, 1, "dense"),
    (64, 130, "dense"), (1500, 66, "long"), (40, 3, "one_run"),
    # B5's widths on its paths, at a budget of N: config 1's direct step
    # (W = 9), config 5's (17), the direct step at rank 32 (33) and the
    # fused adagrad_row pack (35)
    (300, 9, "budget"), (200, 17, "budget"), (257, 33, "budget"),
    (130, 35, "budget")]


def _outside(seg, u):
    """The ranks no slot has."""
    mask = np.ones(u, bool)
    mask[seg] = False
    return mask


@pytest.mark.parametrize("force", ["xla", "interpret"])
@pytest.mark.parametrize("n,w,kind", CASES)
def test_segment_rowsum_matches_jax(n, w, kind, force):
    rng = np.random.default_rng(n + w)
    seg = _seg(rng, n, kind)
    u = _segments(seg, n, kind)
    g = rng.normal(size=(n, w)).astype(np.float32)
    want = np.asarray(S.segment_rowsum(jnp.asarray(g), jnp.asarray(seg), u,
                                       tile=16, force=force))
    before = segsum.ROWSUM.launches
    got = segsum.segment_rowsum(torch.from_numpy(g), torch.from_numpy(seg), u)
    assert segsum.ROWSUM.launches == before         # CPU: plain version
    assert got.shape == (u, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL[force])
    assert not got.numpy()[_outside(seg, u)].any()  # rank-zeroing contract


@pytest.mark.parametrize("w", [9, 17, 33, 35])
def test_segment_rowsum_with_gaps_matches_jax(w):
    """B5's path widths at a budget of N over ranks with gaps (steps up to
    2) from seg[0] = 2: the zero rows before the first rank, between
    gapped ranks and past the last, against the JAX XLA branch (the
    Pallas kernel's interpret mode needs dense ranks)."""
    rng = np.random.default_rng(40 + w)
    n = 240
    incr = rng.choice([0, 0, 1, 2], n)
    incr[0] = 0
    seg = (2 + np.cumsum(incr)).astype(np.int32)
    assert seg[-1] < n and (np.diff(seg) > 1).any()
    g = rng.normal(size=(n, w)).astype(np.float32)
    want = np.asarray(S.segment_rowsum(jnp.asarray(g), jnp.asarray(seg), n,
                                       force="xla"))
    got = segsum.segment_rowsum(torch.from_numpy(g), torch.from_numpy(seg), n)
    assert got.shape == (n, w)
    np.testing.assert_allclose(got.numpy(), want, **TOL["xla"])
    assert not got.numpy()[_outside(seg, n)].any()


@pytest.mark.parametrize("force", ["xla", "interpret"])
@pytest.mark.parametrize("n,w,kind", CASES)
def test_segment_rowsum_sq_matches_jax(n, w, kind, force):
    rng = np.random.default_rng(n + w + 1)
    seg = _seg(rng, n, kind)
    u = _segments(seg, n, kind)
    g = rng.normal(size=(n, w)).astype(np.float32)
    want = np.asarray(S.segment_rowsum_sq(
        jnp.asarray(g), jnp.asarray(seg), u, tile=16, subtile=8,
        bf16x2=False, force=force))
    before = segsum.ROWSUM_SQ.launches
    got = segsum.segment_rowsum_sq(torch.from_numpy(g),
                                   torch.from_numpy(seg), u, bf16x2=True)
    assert segsum.ROWSUM_SQ.launches == before
    assert got.shape == (u, 2 * w)
    np.testing.assert_allclose(got.numpy(), want, **TOL[force])
    assert not got.numpy()[_outside(seg, u)].any()


@pytest.mark.parametrize("force", ["xla", "interpret"])
@pytest.mark.parametrize("n,k,kind", [(96, 4, "dense"), (90, 32, "offset"),
                                      (70, 33, "dense"), (1500, 4, "long")])
def test_fm_grad_segsum_matches_jax(n, k, kind, force):
    rng = np.random.default_rng(n + k)
    seg = _seg(rng, n, kind)
    u = int(seg[-1]) + 3
    vw = rng.normal(size=(n, k + 1)).astype(np.float32)
    ex = rng.normal(size=(n, k + 2)).astype(np.float32)
    ex[:, k + 1] = rng.integers(0, 2, n)
    x = np.where(rng.random(n) < 0.2, 0.0,
                 rng.normal(size=n)).astype(np.float32)
    j = jnp.asarray
    want = np.asarray(S.fm_grad_segsum(j(vw), j(ex), j(x), j(seg), u, CV, CW,
                                       tile=16, subtile=8, bf16x2=False,
                                       force=force))
    t = torch.from_numpy
    before = segsum.FM_GRAD.launches
    got = segsum.fm_grad_segsum(t(vw), t(ex), t(x), t(seg), u, CV, CW)
    assert segsum.FM_GRAD.launches == before
    assert got.shape == (u, 2 * k + 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL[force])
    assert not got.numpy()[_outside(seg, u)].any()


def test_fm_grad_segsum_equals_the_factored_form_on_expanded_rows():
    """B4 on the rows vw_u[seg] is B3 on vw_u: the same plain sums."""
    rng = np.random.default_rng(3)
    seg = _seg(rng, 200, "long")
    u = int(seg[-1]) + 2
    t = torch.from_numpy
    vw_u = t(rng.normal(size=(u, 9)).astype(np.float32))
    ex = t(rng.normal(size=(200, 10)).astype(np.float32))
    x = t(rng.normal(size=200).astype(np.float32))
    seg_t = t(seg)
    assert torch.equal(
        segsum.fm_grad_segsum(vw_u.index_select(0, seg_t.long()), ex, x,
                              seg_t, u, CV, CW),
        segsum.fm_grad_segsum_factored(vw_u, ex, x, seg_t, u, CV, CW))


def test_plain_versions_keep_float64():
    """The card's checks evaluate the plain versions in float64."""
    rng = np.random.default_rng(4)
    seg = torch.from_numpy(_seg(rng, 50, "dense"))
    g = torch.from_numpy(rng.normal(size=(50, 3)))
    u = int(seg[-1]) + 1
    want = np.zeros((u, 3))
    np.add.at(want, seg.numpy(), g.numpy())
    got = segsum.segment_rowsum_reference(g, seg, u)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    sq = segsum.segment_rowsum_sq_reference(g, seg, u)
    np.testing.assert_allclose(sq[:, :3].numpy(), want, rtol=1e-12)
    assert sq.dtype == torch.float64 and (sq[:, 3:] >= 0).all()


@pytest.mark.parametrize("payload", ["rows", "scalar"])
def test_accumulate_to_unique_sorted_matches_jax_and_scatter(payload):
    rng = np.random.default_rng(5)
    ids = (rng.zipf(1.5, (12, 5)) % 40).astype(np.int32)
    shape = (12, 5, 7) if payload == "rows" else (12, 5)
    g = rng.normal(size=shape).astype(np.float32)
    budget = 64
    jplan = JE.dedup_ids(jnp.asarray(ids), budget, fill=40)
    want = np.asarray(JE.accumulate_to_unique_sorted(
        jnp.asarray(g), jplan, budget, force="xla"))
    pplan = PE.dedup_ids(torch.from_numpy(ids), budget, fill=40)
    got = PE.accumulate_to_unique_sorted(torch.from_numpy(g), pplan, budget)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        PE.accumulate_to_unique(torch.from_numpy(g), pplan, budget).numpy(),
        want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,w,num_sms,want", [
    (8192, 9, 132, (16, 16, 1024)),       # BASELINE config 1: 512 chunks
    (638976, 33, 132, (480, 15, 2664)),   # config 3's [g_v | g_w]: 64 KB
    (180224, 177, 132, (92, 2, 3918)),    # config 4's FFM [g_v | g_w]
    (3000, 700, 4, (23, 1, 262)),         # wide rows: one group a block
    (4, 3, 132, (1, 1, 8)),
])
def test_tile_layout_rule(n, w, num_sms, want):
    """B6's layout (kernel rowsum_tiles_kernel): a chunk of rows and
    ranks within TILE_BYTES, at most N over CHUNKS_PER_SM chunks an SM (so
    config 1's 8,192 slots give ~4 blocks an SM, not 32 warps in all), a
    multiple of its row groups, which fill at most TILE_THREADS threads;
    the wrapper allocates two partial rows a chunk."""
    chunk, groups, rows = segsum.tile_layout(n, w, num_sms)
    assert (chunk, groups, rows) == want
    assert rows == 2 * -(-n // chunk)
    assert chunk == 1 or 4 * chunk * (w + 1) <= segsum.TILE_BYTES
    assert chunk <= -(-n // (segsum.CHUNKS_PER_SM * num_sms))
    assert chunk % groups == 0
    assert groups * min(w, segsum.TILE_THREADS) <= segsum.TILE_THREADS


@pytest.mark.parametrize("n,w,num_sms,want", [
    (638976, 35, 132, ("tiles", 448, 14, 2854)),   # fused adagrad_row pack
    (638976, 33, 132, ("tiles", 480, 15, 2664)),   # direct step, rank 32
    (319488, 17, 132, ("tiles", 600, 30, 1066)),   # config 5's direct step
    (8192, 9, 132, ("tiles", 16, 16, 1024)),       # config 1: 512 chunks
    (638976, 64, 132, ("tiles", 248, 8, 5154)),    # the widest on tiles
    (638976, 66, 132, ("chunks", 4992)),           # the chunked kernel's
    (180224, 354, 132, ("chunks", 1408)),          # an FFM record's pack
    (4, 65536, 132, ("chunks", 2)),                # the widest B5 takes
])
def test_rowsum_layout_rule(n, w, num_sms, want):
    """B5's layout: rows of at most ROWSUM_TILE_WIDTH floats (every
    path's: 9, 17, 33, 35) on B6's staged tiles at B6's own layout, wider
    rows on the chunked kernel, ROWSUM_CHUNK slots a warp; two partial
    rows a chunk either way. The crossover lies between the widths the
    tiles won at on an H100 (9 to 35) and 66, where the chunked kernel
    did (PERF.md)."""
    layout = segsum.rowsum_layout(n, w, num_sms)
    assert layout == want
    if layout[0] == "tiles":
        assert w <= segsum.ROWSUM_TILE_WIDTH
        assert layout[1:] == segsum.tile_layout(n, w, num_sms)
    else:
        assert w > segsum.ROWSUM_TILE_WIDTH
        assert layout[1] == 2 * -(-n // segsum.ROWSUM_CHUNK)


def test_empty_streams_give_zeros():
    seg = torch.zeros((0,), dtype=torch.int32)
    assert not segsum.segment_rowsum(torch.zeros((0, 3)), seg, 4).any()
    assert segsum.segment_rowsum_sq(torch.zeros((0, 3)), seg, 4).shape == (
        4, 6)
    got = segsum.fm_grad_segsum(torch.zeros((0, 3)), torch.zeros((0, 4)),
                                torch.zeros((0,)), seg, 5, CV, CW)
    assert got.shape == (5, 6) and not got.any()


@pytest.mark.parametrize("g,seg,match", [
    (torch.zeros((4, 3), dtype=torch.float64),
     torch.zeros((4,), dtype=torch.int32), "float32"),
    (torch.zeros((4,)), torch.zeros((4,), dtype=torch.int32), "2-D"),
    (torch.zeros((4, 6))[:, ::2], torch.zeros((4,), dtype=torch.int32),
     "contiguous"),
    (torch.zeros((4, 3)), torch.zeros((4,), dtype=torch.int64), "int32"),
    (torch.zeros((4, 3)), torch.zeros((5,), dtype=torch.int32), "rows"),
    (torch.zeros((4, 3), device="meta"), torch.zeros((4,), dtype=torch.int32),
     "devices"),
])
def test_rowsum_rejects_what_the_kernel_does_not_take(g, seg, match):
    for fn in (segsum.segment_rowsum, segsum.segment_rowsum_sq):
        with pytest.raises(ValueError, match=match):
            fn(g, seg, 5)


def test_fm_grad_segsum_checks_per_slot_rows():
    args = dict(ex=torch.zeros((4, 4)), x=torch.zeros((4,)),
                seg=torch.zeros((4,), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"vw_srt must be \(N=4"):
        segsum.fm_grad_segsum(torch.zeros((5, 3)), args["ex"], args["x"],
                              args["seg"], 5, CV, CW)
