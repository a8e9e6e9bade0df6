"""Device milliseconds a DeepFM step spends on its table rows: the plan,
the unique gathers and the spread (span ``deepfm.gather``), and the
per-unique sums, the rows' update and their writes (span
``deepfm.update``), the CUDA-event times of the port's spans
(``models/deepfm.py::make_train_step``, recorded by
``sparkfm_tpu_torch/utils/profiling.py``) over the traced window's
steps. On the card each span holds the replay of its phase's CUDA graph,
so its events bracket the phase's kernels on the device. A port without
both spans reads None."""


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    if recorded is None:
        return None
    spans = recorded()["spans"]
    parts = [spans.get("deepfm.gather"), spans.get("deepfm.update")]
    if (not all(parts) or any(s["device_s"] is None for s in parts)
            or not rec.steps):
        return None
    return 1e3 * sum(s["device_s"] for s in parts) / rec.steps
