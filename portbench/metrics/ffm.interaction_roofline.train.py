"""The field-aware FM interaction's share of its roofline, in %: the
least bytes of its forward and backward (``counts/ffm_sgd.py::
interaction_bytes``) over the slots that the port's counter
``fused.slot_rows`` counted in the traced window, at the HBM rate of
``counts/peaks.json``, over the CUDA-event device time of the port's span
``fused.interaction`` (``solvers/sgd_fused.py::make_fused_train_step``).
The entry's notes give the fields and k. A port without the span or the
counter reads None."""

from portbench.counts import ffm_sgd


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    fields, k = rec.notes.get("ffm_fields"), rec.notes.get("ffm_k")
    if recorded is None or not fields or not k:
        return None
    got = recorded()
    span = got["spans"].get("fused.interaction")
    slots = got["counters"].get("fused.slot_rows")
    if not span or not span["device_s"] or span["device_s"] <= 0 or not slots:
        return None
    return (100.0 * ffm_sgd.interaction_bytes(slots, fields, k)
            / rec.peaks["hbm_bytes_per_s"] / span["device_s"])
