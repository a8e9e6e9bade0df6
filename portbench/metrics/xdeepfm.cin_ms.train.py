"""Device milliseconds an xDeepFM step spends in its Compressed
Interaction Network: the CUDA-event time of the port's span
``deepfm.cin`` (``models/deepfm.py::make_train_step``, recorded by
``sparkfm_tpu_torch/utils/profiling.py``), which brackets the CIN's
forward and its backward, each the replay of its phase's CUDA graph on
the card, summed over the traced window's steps and taken a step. A port
without the span reads None."""


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    if recorded is None:
        return None
    span = recorded()["spans"].get("deepfm.cin")
    if not span or span["device_s"] is None or not rec.steps:
        return None
    return 1e3 * span["device_s"] / rec.steps
