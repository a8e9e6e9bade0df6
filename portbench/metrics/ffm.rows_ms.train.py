"""Device milliseconds a field-aware FM step spends on its rows: the
device plan (``ops/embedding.py::dedup_ids``), the unique records'
gather (kernel B1), the ``[v | w]`` cat and the spread to the slots: the
CUDA-event time of the port's span ``fused.rows``
(``solvers/sgd_fused.py::make_fused_train_step``, recorded by
``sparkfm_tpu_torch/utils/profiling.py``) over the traced window's
steps. A port without the span reads None."""


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    if recorded is None:
        return None
    span = recorded()["spans"].get("fused.rows")
    if not span or span["device_s"] is None or not rec.steps:
        return None
    return 1e3 * span["device_s"] / rec.steps
