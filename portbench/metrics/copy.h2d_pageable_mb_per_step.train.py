"""Megabytes (1e6 bytes) copied to the card from pageable host memory per
training step in the traced window: the port's counter
``copy.h2d_pageable_bytes`` (``utils/profiling.py::count_h2d``, counted by
``data/batching.py::batch_iterator`` and ``ops/embedding.py::
plan_to_device``) over the window's steps."""


def read(rec):
    from sparkfm_tpu_torch.utils import profiling
    recorded = getattr(profiling, "recorded", None)   # a port without spans
    if recorded is None:
        return None
    nbytes = recorded()["counters"].get("copy.h2d_pageable_bytes")
    if not nbytes or not rec.steps:
        return None
    return nbytes / rec.steps / 1e6
