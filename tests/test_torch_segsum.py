"""The port's factored FM backward (kernel B3) against the JAX package's
``fm_grad_segsum_factored``:

- in interpret mode (the Pallas kernel itself, ``bf16x2=False``) at
  rtol/atol 1e-4, the JAX test's own tolerance for that kernel: it factors
  V_u out of the squared sums, which loses precision under cancellation;
- against the XLA branch (the same direct formula, summed in another
  order) at rtol 1e-5, atol 1e-6.

The plain version of B4, ``fm_grad_segsum_reference``, is held against
the JAX ``fm_grad_segsum(force="xla")`` at the same tolerance.

The plain version of B7, ``segment_colsums_reference`` (what
``segment_colsums`` runs for CPU tensors), is held against the JAX
``segment_colsums`` in its XLA branch and in interpret mode (tile 16,
subtile 8) at 1e-5, the JAX test's tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkfm_tpu.ops import pallas_segsum as S
from sparkfm_tpu_torch.ops import segsum
from sparkfm_tpu_torch.utils.build import BuildError, CudaKernel

torch.set_num_threads(1)
CV, CW = 3e-3, 7e-3


def _factored_case(rng, n, k, u_extra=3, long_run=0):
    """Sorted dense ranks with unique rows consistent per run (the
    factored contract), 0/1 example weights and ~20% zero values; with
    ``long_run`` one run of that many slots (a zipf head id)."""
    incr = rng.integers(0, 2, n)
    incr[0] = 0
    if long_run:
        start = n // 3
        incr[start + 1:start + long_run] = 0
    seg = np.cumsum(incr).astype(np.int32)
    u = int(seg[-1]) + u_extra
    vw_u = rng.normal(size=(u, k + 1)).astype(np.float32)
    ex = rng.normal(size=(n, k + 2)).astype(np.float32)
    ex[:, k + 1] = rng.integers(0, 2, n)
    x = np.where(rng.random(n) < 0.2, 0.0,
                 rng.normal(size=n)).astype(np.float32)
    return vw_u, ex, x, seg, u


def _port(vw_u, ex, x, seg, u, cv=CV, cw=CW):
    t = torch.from_numpy
    before = segsum.FACTORED.launches
    out = segsum.fm_grad_segsum_factored(t(vw_u), t(ex), t(x), t(seg), u,
                                         cv, cw)
    assert segsum.FACTORED.launches == before   # CPU: plain version
    assert out.shape == (u, vw_u.shape[1] * 2) and out.dtype == torch.float32
    return out.numpy()


def _jax(vw_u, ex, x, seg, u, force, cv=CV, cw=CW, **kw):
    j = jnp.asarray
    return np.asarray(S.fm_grad_segsum_factored(
        j(vw_u), j(ex), j(x), j(seg), u, cv, cw, force=force, **kw))


CASES = [  # (n, k, u_extra, long_run, cv, cw)
    (96, 4, 3, 0, CV, CW),
    (96, 32, 3, 0, CV, CW),
    (70, 8, 9, 0, CV, 0.0),          # ranks beyond seg[-1]; cw = 0
    (40, 4, 1, 0, 0.0, 0.0),
    (6000, 4, 2, 5000, CV, CW),      # one run of 5,000 slots
]


@pytest.mark.parametrize("n,k,u_extra,long_run,cv,cw", CASES)
def test_factored_matches_pallas_interpret(n, k, u_extra, long_run, cv, cw):
    rng = np.random.default_rng(n + k)
    case = _factored_case(rng, n, k, u_extra, long_run)
    want = _jax(*case, force="interpret", cv=cv, cw=cw, bf16x2=False,
                tile=8 if n < 1000 else 1024, subtile=4 if n < 1000 else 256)
    np.testing.assert_allclose(_port(*case, cv=cv, cw=cw), want,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,k,u_extra,long_run,cv,cw", CASES)
def test_factored_matches_xla(n, k, u_extra, long_run, cv, cw):
    rng = np.random.default_rng(n + k + 1)
    case = _factored_case(rng, n, k, u_extra, long_run)
    got = _port(*case, cv=cv, cw=cw)
    np.testing.assert_allclose(got, _jax(*case, force="xla", cv=cv, cw=cw),
                               rtol=1e-5, atol=1e-6)
    seg, u = case[3], case[4]
    outside = np.ones(u, bool)
    outside[seg[0]:seg[-1] + 1] = False
    assert not got[outside].any()          # ranks outside the runs: zero


def test_zero_values_and_weights_give_no_gradient():
    """A slot with x = 0 or weight 0 adds nothing: its ds·x term and its
    L2 term both vanish."""
    rng = np.random.default_rng(5)
    vw_u, ex, x, seg, u = _factored_case(rng, 64, 4)
    x[:] = 0.0
    assert not _port(vw_u, ex, x, seg, u).any()
    vw_u, ex, x, seg, u = _factored_case(rng, 64, 4)
    ex[:, 4] = 0.0               # ds
    ex[:, 5] = 0.0               # wt
    assert not _port(vw_u, ex, x, seg, u).any()


def test_tensor_coefficients_match_floats():
    """The step passes cv/cw as 0-d tensors (they depend on the batch's
    weights); they give the same sums as Python floats."""
    rng = np.random.default_rng(6)
    case = _factored_case(rng, 80, 4)
    np.testing.assert_array_equal(
        _port(*case, cv=torch.tensor(CV), cw=torch.tensor(CW)),
        _port(*case))


def test_segsum_reference_matches_jax_xla():
    rng = np.random.default_rng(12)
    n, k = 50, 8
    incr = rng.integers(0, 2, n)
    incr[0] = 0
    seg = np.cumsum(incr).astype(np.int32)
    u = int(seg[-1]) + 2
    vw = rng.normal(size=(n, k + 1)).astype(np.float32)
    ex = rng.normal(size=(n, k + 2)).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    want = np.asarray(S.fm_grad_segsum(
        jnp.asarray(vw), jnp.asarray(ex), jnp.asarray(x), jnp.asarray(seg),
        u, 1e-2, 2e-2, force="xla"))
    t = torch.from_numpy
    got = segsum.fm_grad_segsum_reference(t(vw), t(ex), t(x), t(seg), u,
                                          1e-2, 2e-2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_empty_stream_gives_zeros():
    got = segsum.fm_grad_segsum_factored(
        torch.ones((5, 3)), torch.zeros((0, 4)), torch.zeros((0,)),
        torch.zeros((0,), dtype=torch.int32), 5, CV, CW)
    assert got.shape == (5, 6) and not got.any()


@pytest.mark.parametrize("change,match", [
    (dict(seg=torch.zeros((4,), dtype=torch.int64)), "int32"),
    (dict(ex=torch.zeros((4, 4), dtype=torch.float64)), "float32"),
    (dict(ex=torch.zeros((4, 3))), "shapes"),
    (dict(vw=torch.zeros((6, 3))), "num_segments"),
    (dict(x=torch.zeros((8,))[::2]), "contiguous"),
    (dict(x=torch.zeros((4,), device="meta")), "devices"),
])
def test_rejects_what_the_kernel_does_not_take(change, match):
    args = dict(vw=torch.zeros((5, 3)), ex=torch.zeros((4, 4)),
                x=torch.zeros((4,)), seg=torch.zeros((4,), dtype=torch.int32))
    args.update(change)
    with pytest.raises(ValueError, match=match):
        segsum.fm_grad_segsum_factored(args["vw"], args["ex"], args["x"],
                                       args["seg"], 5, CV, CW)


def test_segsum_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    k = segsum.FACTORED
    kernel = CudaKernel(k.library, k.source, k.symbol, k.argtypes)
    with pytest.raises(BuildError, match="nvcc"):
        kernel.build()
    assert kernel.launches == 0 and kernel.path is None


def _factored_card_order(vw_u, ex, x, seg, u, cv, cw, span):
    """The card's B3 sums in its own float32 order (csrc/segsum.cu): pass
    1 per span of ``span`` slots adds each run's slot gradients in slot
    order and writes a run that crosses a span boundary as partial rows
    (the span where it begins: its last run's; each later span it
    reaches: its first run's); pass 2 adds a crossing run's partial rows
    in order when there are at most 33, else 32 warps take rows w, w + 32,
    ... in order and the warps' sums are added in warp order."""
    f32 = np.float32
    k = vw_u.shape[1] - 1
    n = seg.shape[0]
    v, w = vw_u[seg, :k], vw_u[seg, k]
    a = np.where(x != 0, ex[:, k + 1], f32(0))
    dsx = ex[:, k] * x
    g = np.concatenate([dsx[:, None] * (ex[:, :k] - v * x[:, None])
                        + (f32(cv) * a)[:, None] * v,
                        (dsx + f32(cw) * w * a)[:, None]], axis=1)
    terms = np.concatenate([g, g * g], axis=1).astype(f32)   # [g | g²]
    out = np.zeros((u, 2 * k + 2), f32)
    num = -(-n // span)
    partials = np.zeros((2 * num, 2 * k + 2), f32)
    for c in range(num):
        s0, s1 = c * span, min(n, (c + 1) * span)
        before = seg[s0 - 1] if s0 > 0 else -1
        after = seg[s1] if s1 < n else -1
        cuts = [s0, *(np.flatnonzero(seg[s0 + 1:s1] != seg[s0:s1 - 1])
                      + s0 + 1), s1]
        for i in range(len(cuts) - 1):
            acc = np.zeros(2 * k + 2, f32)
            for j in range(cuts[i], cuts[i + 1]):
                acc = acc + terms[j]
            r = seg[cuts[i]]
            if i == 0 and r == before:
                partials[2 * c] = acc
            elif i == len(cuts) - 2 and r == after:
                partials[2 * c + 1] = acc
            else:
                out[r] = acc
    for c in range(num - 1):
        end = (c + 1) * span
        r = seg[end - 1]
        if seg[end] != r or (c > 0 and seg[c * span - 1] == r):
            continue
        last = c + 1
        while last + 1 < num and seg[(last + 1) * span] == r:
            last += 1
        rows = [partials[2 * c + 1]] + [partials[2 * j]
                                        for j in range(c + 1, last + 1)]
        warps = 1 if len(rows) <= 33 else 32
        acc = [np.zeros(2 * k + 2, f32) for _ in range(warps)]
        for j, row in enumerate(rows):
            acc[j % warps] = acc[j % warps] + row
        total = np.zeros(2 * k + 2, f32)
        for part in acc:
            total = total + part
        out[r] = total
    return out


@pytest.mark.parametrize("k", [4, 32])
def test_factored_card_order_holds_to_float64_and_jax(k):
    """B3's summation order on the card (spans, then pass 2's order),
    emulated in float32 with 16-slot spans so that every path of pass 2
    runs at a small N: a 9,000-slot run across ~560 spans (the block's
    path), runs across a few spans (the warp's) and a run over exactly 33
    partial rows. This checks the design's order, not the port's code (the
    kernel is held to float64 on the card, ``tests/test_torch_cuda.py``,
    ``chip_smoke.py``). Held to the float64 sums at max |a - b| / (1 +
    |b|) < 1e-4, the card check's bound, and to JAX
    ``fm_grad_segsum_factored(force="xla")`` at rtol = atol = 1e-4: both
    are float32 sums of up to 9,000 terms in different orders."""
    span = 16
    rng = np.random.default_rng(50 + k)
    vw_u, ex, x, seg, u = _factored_case(rng, 20_000, k, long_run=9000)
    seg = seg.copy()
    start = 18_000 - 5                  # a run over exactly 33 partial rows
    seg[start:] += 1
    seg[start + 32 * span + 5:] += 1
    u = int(seg[-1]) + 3
    vw_u = rng.normal(size=(u, k + 1)).astype(np.float32)
    got = _factored_card_order(vw_u, ex, x, seg, u, CV, CW, span)
    exact = segsum.fm_grad_segsum_factored_reference(
        *(torch.from_numpy(a).double() for a in (vw_u, ex, x)),
        torch.from_numpy(seg), u, CV, CW).numpy()
    assert float((np.abs(got - exact) / (1 + np.abs(exact))).max()) < 1e-4
    np.testing.assert_allclose(got, _jax(vw_u, ex, x, seg, u, force="xla"),
                               rtol=1e-4, atol=1e-4)


def _colsums_case(rng, n, s, kind):
    """Sorted ranks of the given kind and ``s`` normal streams; the JAX
    Pallas kernel (interpret mode) needs dense ranks, step <= 1."""
    if kind == "jax_test":                 # tests/test_pallas_segsum.py
        incr = rng.integers(0, 2, n)
        incr[0] = 0
        seg = np.cumsum(incr)
    elif kind == "offset":                 # seg[0] > 0
        incr = rng.integers(0, 2, n)
        incr[0] = 0
        seg = 7 + np.cumsum(incr)
    elif kind == "one_run":
        seg = np.full(n, 4)
    elif kind == "unique":
        seg = np.arange(n)
    else:                                  # "gaps": step up to 3
        incr = rng.integers(0, 4, n)
        incr[0] = 0
        seg = np.cumsum(incr)
    seg = seg.astype(np.int32)
    u = int(seg[-1]) + 3
    return [rng.normal(size=n).astype(np.float32) for _ in range(s)], seg, u


COLSUMS_CASES = [  # (n, s, kind)
    (90, 5, "jax_test"), (90, 1, "jax_test"), (77, 16, "jax_test"),
    (53, 5, "offset"), (45, 5, "one_run"), (61, 3, "unique"),
    (2100, 5, "jax_test")]


def _colsums_port(streams, seg, u):
    before = segsum.COLSUMS.launches
    out = segsum.segment_colsums([torch.from_numpy(s) for s in streams],
                                 torch.from_numpy(seg), u)
    assert segsum.COLSUMS.launches == before      # CPU: plain version
    assert out.shape == (u, len(streams)) and out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("force", ["xla", "interpret"])
@pytest.mark.parametrize("n,s,kind", COLSUMS_CASES)
def test_colsums_matches_jax(n, s, kind, force):
    rng = np.random.default_rng(31 + n + s)
    streams, seg, u = _colsums_case(rng, n, s, kind)
    want = np.asarray(S.segment_colsums(
        [jnp.asarray(x) for x in streams], jnp.asarray(seg), u, tile=16,
        subtile=8, force=force))
    got = _colsums_port(streams, seg, u)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    outside = np.ones(u, bool)
    outside[np.unique(seg)] = False
    assert not got[outside].any()          # ranks without slots: zero


def test_colsums_gapped_ranks_match_jax_xla():
    """A block's slice of the CSC view holds only that block's ranks: gaps
    in seg (the XLA branch sums any sorted seg)."""
    streams, seg, u = _colsums_case(np.random.default_rng(8), 300, 5,
                                    "gaps")
    want = np.asarray(S.segment_colsums([jnp.asarray(x) for x in streams],
                                        jnp.asarray(seg), u, force="xla"))
    np.testing.assert_allclose(_colsums_port(streams, seg, u), want,
                               rtol=1e-5, atol=1e-5)


def test_colsums_reference_keeps_float64():
    """The card's checks evaluate the plain version in float64."""
    streams, seg, u = _colsums_case(np.random.default_rng(9), 50, 2,
                                    "jax_test")
    got = segsum.segment_colsums_reference(
        [torch.from_numpy(x.astype(np.float64)) for x in streams],
        torch.from_numpy(seg), u)
    want = np.zeros((u, 2))
    for j, x in enumerate(streams):
        np.add.at(want[:, j], seg, x.astype(np.float64))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


def test_colsums_empty_stream_gives_zeros():
    got = segsum.segment_colsums([torch.zeros((0,))] * 2,
                                 torch.zeros((0,), dtype=torch.int32), 4)
    assert got.shape == (4, 2) and not got.any()


@pytest.mark.parametrize("streams,seg,match", [
    ([], torch.zeros((4,), dtype=torch.int32), "streams"),
    ([torch.zeros((4,))] * 17, torch.zeros((4,), dtype=torch.int32),
     "streams"),
    ([torch.zeros((4,))], torch.zeros((4,), dtype=torch.int64), "int32"),
    ([torch.zeros((4,), dtype=torch.float64)],
     torch.zeros((4,), dtype=torch.int32), "float32"),
    ([torch.zeros((5,))], torch.zeros((4,), dtype=torch.int32), "shape"),
    ([torch.zeros((8,))[::2]], torch.zeros((4,), dtype=torch.int32),
     "contiguous"),
    ([torch.zeros((4,), device="meta")],
     torch.zeros((4,), dtype=torch.int32), "devices"),
])
def test_colsums_rejects_what_the_kernel_does_not_take(streams, seg, match):
    with pytest.raises(ValueError, match=match):
        segsum.segment_colsums(streams, seg, 5)


# ---- B7's summation order on the card, emulated in float32 numpy

def _colsums_card_order(streams, seg, u, chunk=4096):
    """The card kernel's sums in its own float32 order (csrc/segsum.cu, B7):
    pass 1 per chunk of ``chunk`` slots, steps of 32 lanes x V consecutive
    slots (V = 16 for S <= 5, 8 for S <= 8, else 4); each lane sums its
    runs in slot order (the run carried from the previous step joins once,
    where it ends or goes on), a segmented
    Hillis-Steele scan keyed on each lane's last rank joins the lanes' open
    runs, a lane's first run that ends inside it takes the previous lane's
    scan value, a run that ends at a lane's last slot is written from that
    lane's scan value, the run open after a step is carried on; pass 2
    sums a crossing run's partial rows over 32 lanes and a butterfly when
    it spans at most 33 rows, else over 256 threads and a halving tree."""
    x = np.stack(streams, axis=1).astype(np.float32)
    n, s = x.shape
    lane_slots = 16 if s <= 5 else 8 if s <= 8 else 4
    zero = np.zeros(s, np.float32)
    out = np.zeros((u, s), np.float32)
    num_chunks = -(-n // chunk)
    partials = np.zeros((2 * num_chunks, s), np.float32)
    step = 32 * lane_slots
    for c in range(num_chunks):
        s0, s1 = c * chunk, min(n, (c + 1) * chunk)
        before = seg[s0 - 1] if s0 > 0 else -1
        after = seg[s1] if s1 < n else -1

        def write(rank, vals, may_go_on, c=c, before=before, after=after):
            if rank == before:
                partials[2 * c] = vals
            elif may_go_on and rank == after:
                partials[2 * c + 1] = vals
            else:
                out[rank] = vals
        carry_rank, carry = -1, zero
        for b0 in range(s0, s1, step):
            cnt = min(step, s1 - b0)
            if carry_rank >= 0 and seg[b0] != carry_rank:
                write(carry_rank, carry, False)
                carry_rank = -1
            keys, open_, closed, heads, firsts = [], [], [], [], []
            for lane in range(32):
                lc = min(max(cnt - lane * lane_slots, 0), lane_slots)
                if lc == 0:
                    keys.append(-1), open_.append(zero), closed.append(False)
                    heads.append(zero), firsts.append(-1)
                    continue
                i0 = b0 + lane * lane_slots
                r, v = seg[i0:i0 + lc], x[i0:i0 + lc]
                head, acc, cl = v[0], zero, False
                for i in range(1, lc):
                    if r[i] != r[i - 1]:
                        if cl:
                            out[r[i - 1]] = acc
                        cl, acc = True, v[i]
                    elif cl:
                        acc = acc + v[i]
                    else:
                        head = head + v[i]
                keys.append(r[lc - 1]), open_.append(acc if cl else head)
                closed.append(cl), heads.append(head), firsts.append(r[0])
            sc = list(open_)
            d = 1
            while d < 32:
                sc = [sc[l] + sc[l - d] if l >= d and keys[l - d] == keys[l]
                      else sc[l] for l in range(32)]
                d *= 2
            for lane in range(32):
                if closed[lane]:
                    head = heads[lane]
                    if lane > 0 and keys[lane - 1] == firsts[lane]:
                        head = sc[lane - 1] + head
                    if firsts[lane] == carry_rank:
                        head = carry + head
                    write(firsts[lane], head, False)
            last = (cnt - 1) // lane_slots
            for lane in range(last):       # a run ends at the lane's end
                if keys[lane] != firsts[lane + 1]:
                    write(keys[lane], carry + sc[lane]
                          if keys[lane] == carry_rank else sc[lane], False)
            carry = carry + sc[last] if keys[last] == carry_rank else sc[last]
            carry_rank = keys[last]
        write(carry_rank, carry, True)
    for c in range(num_chunks - 1):
        end = (c + 1) * chunk
        r = seg[end - 1]
        if seg[end] != r or (c > 0 and seg[c * chunk - 1] == r):
            continue
        last = c + 1
        while last + 1 < num_chunks and seg[(last + 1) * chunk] == r:
            last += 1
        rows = [partials[2 * c + 1]] + [partials[2 * j]
                                        for j in range(c + 1, last + 1)]
        threads = 32 if len(rows) <= 33 else 256
        acc = [zero] * threads
        for j, row in enumerate(rows):
            acc[j % threads] = acc[j % threads] + row
        if threads == 32:
            d = 16
            while d:
                acc = [acc[l] + acc[l ^ d] for l in range(32)]
                d //= 2
        else:
            half = 128
            while half:
                acc = [acc[t] + acc[t + half] for t in range(half)] + \
                    acc[half:]
                half //= 2
        out[r] = acc[0]
    return out


def _long_run_case(rng, n, s, head_share, chunk):
    """Sorted ranks with gaps and one head run of ``head_share`` of the
    slots (the ALS movie block's shape), runs that cross one chunk
    boundary, and a run spanning exactly 33 partial rows."""
    incr = rng.integers(0, 3, n) * (rng.random(n) < 0.05)
    incr[0] = 0
    start = n // 7
    incr[start + 1:start + int(head_share * n)] = 0
    seg = 2 + np.cumsum(incr)
    c0 = -(-(start + int(head_share * n) + 5 * chunk) // chunk)
    seg[c0 * chunk - 5:] = seg[c0 * chunk - 6] + 1     # begins before c0
    seg[(c0 + 32) * chunk:] = seg[(c0 + 32) * chunk - 1] + 2
    seg[(c0 + 32) * chunk + 3:] += 1
    seg = seg.astype(np.int32)
    return ([rng.normal(size=n).astype(np.float32) for _ in range(s)], seg,
            int(seg[-1]) + 3)


@pytest.mark.parametrize("s", [1, 5, 16])
def test_colsums_card_order_holds_to_float64_and_jax(s):
    """The card's B7 summation order (V-slot lane sums, warp scan, pass-2
    order), emulated in float32 with a small chunk so the same code paths
    run at a small N: a head run across 300 chunks, a run over exactly 33
    partial rows (the warp's largest) and short crossing runs. This checks
    the design's order, not the port's code: the emulation lives in this
    file, and the kernel itself is held to float64 only on the card
    (``tests/test_torch_cuda.py``, ``chip_smoke.py``). Held to the
    float64 sums at max |a - b| / (1 + |b|) < 1e-4, the card check's bound
    (1e-6 to 8e-6 here), and to JAX ``segment_colsums(force="xla")`` at
    rtol = atol = 1e-4: both are float32 sums of up to ~27k terms, taken in
    different orders."""
    chunk = 512
    streams, seg, u = _long_run_case(np.random.default_rng(40 + s), 60_000,
                                     s, 0.45, chunk)
    got = _colsums_card_order(streams, seg, u, chunk=chunk)
    exact = np.zeros((u, s))
    for j, x in enumerate(streams):
        np.add.at(exact[:, j], seg, x.astype(np.float64))
    assert float((np.abs(got - exact) / (1 + np.abs(exact))).max()) < 1e-4
    want = np.asarray(S.segment_colsums([jnp.asarray(x) for x in streams],
                                        jnp.asarray(seg), u, force="xla"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_colsums_unaligned_seg_slice_on_cpu():
    """The ALS sweep passes seg as the slice col_rank[b*N:(b+1)*N], 16-byte
    aligned only when N % 4 == 0; on the CPU the wrapper takes seg (and
    streams) at any offset, and its sums hold to JAX
    ``segment_colsums(force="xla")`` on the same values at 1e-5."""
    streams, seg, u = _colsums_case(np.random.default_rng(10), 1001, 5,
                                    "gaps")
    view = torch.from_numpy(np.concatenate([seg[:3], seg]))[3:]
    ts = [torch.from_numpy(np.concatenate([x[:1], x]))[1:] for x in streams]
    assert view.storage_offset() % 4 != 0
    assert all(t.storage_offset() % 4 != 0 for t in ts)
    before = segsum.COLSUMS.launches
    got = segsum.segment_colsums(ts, view, u)
    assert segsum.COLSUMS.launches == before      # CPU: plain version
    want = np.asarray(S.segment_colsums([jnp.asarray(x) for x in streams],
                                        jnp.asarray(seg), u, force="xla"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
