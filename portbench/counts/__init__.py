"""Frozen counts of the work a cell's steps need, from its shapes and its
batches' own distinct ids, whatever kernel or path does it; and the
published peaks of the card (``peaks.json``). A share of a peak is the
least time of the counted work at the peaks over the measured time, so it
cannot pass 100% unless the count is too high or the time leaves out
work."""


def least_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The larger of the two bounds: FLOPs at float32's rate outside the
    tensor cores, bytes at HBM's."""
    return max(flops / peaks["fp32_flops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])
