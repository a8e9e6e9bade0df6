"""The least work of one ALS sweep (Rendle's coordinate descent, float32)
and the bytes of one call of the stream-sum kernel B7.

A sweep updates w0, then for each of the 1 + K coordinates (w, then each
factor) every block. For each coordinate each entry's id, value and
residual are read once (and, for a factor, its cached sum q), and the
residual (and q) written once, since the update changes them; each
parameter row is read and written once a coordinate; w0 reads and writes
the residual. FLOPs: about 12 per entry and coordinate (the sums of e x q,
x² q², the patches of e and q).
"""

from __future__ import annotations

F32 = 4


def sweep_work(entries: int, examples: int, features: int, k: int) -> dict:
    """``{"flops", "bytes"}`` of one sweep over ``entries`` (example, slot)
    pairs of ``examples`` examples and ``features`` features present."""
    w_bytes = entries * 3 * F32 + entries * F32        # id, val, e; e
    v_bytes = entries * 4 * F32 + entries * 2 * F32    # id, val, e, q; e, q
    param_bytes = (1 + k) * features * 2 * F32
    w0_bytes = 2 * examples * F32
    nbytes = w0_bytes + w_bytes + k * v_bytes + param_bytes
    flops = 12.0 * entries * (1 + k) + 2 * examples
    return {"flops": float(flops), "bytes": float(nbytes)}


def b7_bytes(streams: int, n: int, segments: int) -> int:
    """One B7 call (``segment_colsums``): S float32 streams and the int32
    ranks of n entries read once, the (U, S) sums written once (the count
    ``PERF.md`` §6 uses: 604.4 MB at S = 5, N = 25M, U = 221,588)."""
    return (streams + 1) * n * F32 + segments * streams * F32
