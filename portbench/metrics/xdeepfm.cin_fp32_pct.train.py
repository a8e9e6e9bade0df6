"""The xDeepFM step's Compressed Interaction Network's share of its
roofline, in %: the FLOPs of one example's CIN forward and backward
(``counts/xdeepfm.py::cin_flops`` of the fields, k and widths in the
entry's note ``xdeepfm_cin``) times the examples that the port's counter
``deepfm.cin_rows`` counted in the traced window, at the float32 peak of
``counts/peaks.json``, over the CUDA-event device time of the port's span
``deepfm.cin`` (``xdeepfm.cin_ms.train``'s). At ~100 FLOP a byte of its
largest intermediate, above the card's ridge, the CIN's roofline is the
compute peak. A port without the span or the counter reads None."""

from portbench.counts import xdeepfm


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    shape = rec.notes.get("xdeepfm_cin")
    if recorded is None or not shape:
        return None
    got = recorded()
    span = got["spans"].get("deepfm.cin")
    rows = got["counters"].get("deepfm.cin_rows")
    if not span or not span["device_s"] or span["device_s"] <= 0 or not rows:
        return None
    flops = rows * xdeepfm.cin_flops(shape["fields"], shape["k"],
                                     shape["widths"])
    return 100.0 * flops / rec.peaks["fp32_flops_per_s"] / span["device_s"]
