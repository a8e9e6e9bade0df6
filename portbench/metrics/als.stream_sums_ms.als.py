"""Device milliseconds a sweep spends on the five per-rank sums of its
(factor, block) steps, e and q gathered and the streams formed inside the
kernel: the CUDA-event time of the port's span ``als.stream_sums``
(``solvers/als.py::als_sweep_compact``, recorded by
``sparkfm_tpu_torch/utils/profiling.py``) over the traced window's
sweeps. A port without the span reads None."""


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    if recorded is None:
        return None
    span = recorded()["spans"].get("als.stream_sums")
    if not span or span["device_s"] is None or not rec.steps:
        return None
    return 1e3 * span["device_s"] / rec.steps
