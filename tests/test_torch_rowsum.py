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


CASES = [  # (n, W, kind)
    (96, 66, "dense"), (90, 35, "offset"), (77, 1, "dense"),
    (64, 130, "dense"), (1500, 66, "long"), (40, 3, "one_run")]


def _outside(seg, u):
    mask = np.ones(u, bool)
    mask[seg[0]:seg[-1] + 1] = False
    return mask


@pytest.mark.parametrize("force", ["xla", "interpret"])
@pytest.mark.parametrize("n,w,kind", CASES)
def test_segment_rowsum_matches_jax(n, w, kind, force):
    rng = np.random.default_rng(n + w)
    seg = _seg(rng, n, kind)
    u = int(seg[-1]) + 4
    g = rng.normal(size=(n, w)).astype(np.float32)
    want = np.asarray(S.segment_rowsum(jnp.asarray(g), jnp.asarray(seg), u,
                                       tile=16, force=force))
    before = segsum.ROWSUM.launches
    got = segsum.segment_rowsum(torch.from_numpy(g), torch.from_numpy(seg), u)
    assert segsum.ROWSUM.launches == before         # CPU: plain version
    assert got.shape == (u, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL[force])
    assert not got.numpy()[_outside(seg, u)].any()  # rank-zeroing contract


@pytest.mark.parametrize("force", ["xla", "interpret"])
@pytest.mark.parametrize("n,w,kind", CASES)
def test_segment_rowsum_sq_matches_jax(n, w, kind, force):
    rng = np.random.default_rng(n + w + 1)
    seg = _seg(rng, n, kind)
    u = int(seg[-1]) + 4
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
    """B6's layout (kernel rowsum_sq_tiles_kernel): a chunk of rows and
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
