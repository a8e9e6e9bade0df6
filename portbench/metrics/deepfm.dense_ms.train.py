"""Device milliseconds a DeepFM step spends on its dense part: the dropout
masks, both heads, the loss and ``torch.autograd.grad``, the CUDA-event
time of the port's span ``deepfm.dense`` (``models/deepfm.py::
make_train_step``, recorded by ``sparkfm_tpu_torch/utils/profiling.py``)
over the traced window's steps. On the card the span holds the masks'
three draws and the replay of the phase's CUDA graph, so its events
bracket that work on the device rather than the host's enqueue of the
phase's kernels. A port without the span reads None."""


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    if recorded is None:
        return None
    span = recorded()["spans"].get("deepfm.dense")
    if not span or span["device_s"] is None or not rec.steps:
        return None
    return 1e3 * span["device_s"] / rec.steps
