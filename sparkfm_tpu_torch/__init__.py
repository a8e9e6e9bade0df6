"""sparkfm_tpu_torch — the factorization-machine framework on PyTorch and
CUDA, for NVIDIA Hopper (H100).

A port of ``sparkfm_tpu`` (JAX on a TPU), which stays beside it as the
reference every module here is tested against. This package imports
torch and numpy, never jax, and nothing from ``sparkfm_tpu``. It covers
the FM serving path: dedup plans, the row-gather kernel
(``csrc/rowio.cu``), FM scoring, ``MicroBatcher`` and ``FMModel``.
"""

from sparkfm_tpu_torch.api import FMModel
from sparkfm_tpu_torch.config import FMConfig, Task
from sparkfm_tpu_torch.models.fm import (FMParams, init_params,
                                         params_from_numpy, predict, scores)
from sparkfm_tpu_torch.serving import MicroBatcher

__all__ = [
    "FMModel", "FMConfig", "Task", "FMParams", "init_params",
    "params_from_numpy", "predict", "scores", "MicroBatcher",
]
