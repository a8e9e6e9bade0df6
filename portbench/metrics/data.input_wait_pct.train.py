"""Share of the traced window in which the training loop waited on its
prefetch thread for the next batch, in %: the host time of the port's span
``data.prefetch_wait`` (``data/batching.py::prefetch``, recorded by
``sparkfm_tpu_torch/utils/profiling.py``) over the window."""


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    if recorded is None:
        return None
    span = recorded()["spans"].get("data.prefetch_wait")
    if not span or not rec.window_s or rec.window_s <= 0:
        return None
    return 100.0 * span["host_s"] / rec.window_s
