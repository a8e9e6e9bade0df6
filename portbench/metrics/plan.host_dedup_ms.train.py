"""Host milliseconds a host dedup plan takes in the traced window: the
host time of the port's span ``plan.host_dedup``
(``ops/embedding.py::host_dedup``, run in the trainer's prefetch thread)
over its calls."""


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    if recorded is None:
        return None
    span = recorded()["spans"].get("plan.host_dedup")
    if not span or not span["calls"]:
        return None
    return 1e3 * span["host_s"] / span["calls"]
