"""Device milliseconds a sweep spends gathering e and q into CSC order,
once a (factor, block): the CUDA-event time of the port's span
``als.gather`` (``solvers/als.py::als_sweep_compact``, recorded by
``sparkfm_tpu_torch/utils/profiling.py``) over the traced window's
sweeps."""


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    if recorded is None:
        return None
    span = recorded()["spans"].get("als.gather")
    if not span or span["device_s"] is None or not rec.steps:
        return None
    return 1e3 * span["device_s"] / rec.steps
