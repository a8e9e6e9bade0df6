"""The DeepFM step's dense part's share of its roofline, in %: the FLOPs
of both heads' and the tower's forward and backward that
``counts/deepfm.py::dense_flops`` counts for one step (the entry's note
``deepfm_dense_flops``), times the calls of the port's span
``deepfm.dense``, at the float32 peak of ``counts/peaks.json``, over the
span's CUDA-event device time (``deepfm.dense_ms.train``'s: the masks'
draws and the replay of the phase's CUDA graph on the card). A port
without the span reads None."""


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    flops = rec.notes.get("deepfm_dense_flops")
    if recorded is None or not flops:
        return None
    span = recorded()["spans"].get("deepfm.dense")
    if not span or not span["device_s"] or span["device_s"] <= 0:
        return None
    return (100.0 * flops * span["calls"] / rec.peaks["fp32_flops_per_s"]
            / span["device_s"])
