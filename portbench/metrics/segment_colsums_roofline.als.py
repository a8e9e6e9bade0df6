"""Kernel B7's (``ops/segsum.py::segment_colsums``) share of its byte
bound in the ALS sweeps of the traced window, in %: the bytes of every
call, counted from its shapes by ``counts/als.py::b7_bytes``, at the HBM
peak, over the device time of B7's kernels (``colsums`` in their names)."""


def read(rec):
    nbytes = rec.notes.get("b7_bytes")
    if not nbytes or rec.trace is None:
        return None
    secs = sum(t for name, (t, _) in rec.trace.kernels.items()
               if "colsums" in name)
    if secs <= 0:
        return None
    return 100.0 * nbytes / rec.peaks["hbm_bytes_per_s"] / secs
