"""Device milliseconds a DeepFM step spends updating the tower and w0 by
the dense rule (Adam in the DeepFM cell): the CUDA-event time of the
port's span ``deepfm.tower_update`` (``models/deepfm.py::
make_train_step``, recorded by ``sparkfm_tpu_torch/utils/profiling.py``)
over the traced window's steps. On the card the span holds the replay of
the phase's CUDA graph, so its events bracket the phase's kernels on the
device. A port without the span reads None."""


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    if recorded is None:
        return None
    span = recorded()["spans"].get("deepfm.tower_update")
    if not span or span["device_s"] is None or not rec.steps:
        return None
    return 1e3 * span["device_s"] / rec.steps
