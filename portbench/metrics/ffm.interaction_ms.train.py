"""Device milliseconds a field-aware FM step spends on its interaction:
the batch loss (``solvers/sgd.py::_batch_loss_from_rows``, the
slot-major FFM form of ``ops/interaction.py``) and
``torch.autograd.grad``: the CUDA-event time of the port's span
``fused.interaction`` (``solvers/sgd_fused.py::make_fused_train_step``,
recorded by ``sparkfm_tpu_torch/utils/profiling.py``) over the traced
window's steps. A port without the span reads None."""


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    if recorded is None:
        return None
    span = recorded()["spans"].get("fused.interaction")
    if not span or span["device_s"] is None or not rec.steps:
        return None
    return 1e3 * span["device_s"] / rec.steps
