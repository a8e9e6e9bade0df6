"""sparkfm_tpu_torch — the factorization-machine framework on PyTorch and
CUDA, for NVIDIA Hopper (H100).

A port of ``sparkfm_tpu`` (JAX on a TPU), which stays beside it as the
reference every module here is tested against. This package imports
torch and numpy, never jax, and nothing from ``sparkfm_tpu``. It covers
FM and field-aware FM (FFM) serving (dedup plans, the row-gather kernel,
scoring, ``MicroBatcher``, ``FMModel``), single-device SGD training on
every update path (direct, dedup, hybrid, fused and sorted; adagrad,
adagrad_row, sgd with momentum and adam where the path has them;
``SGDConfig``, ``train_sgd``, ``evaluate``) with the row-write, backward
and row-sum kernels, single-device ALS training (``ALSConfig``,
``train_als``) with the per-rank stream-sum kernel, and the ``FM`` facade
over both solvers. The kernels are CUDA C++ under ``csrc/``.
"""

from sparkfm_tpu_torch.api import FM, FMModel
from sparkfm_tpu_torch.config import ALSConfig, FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.models.fm import (FMParams, init_params,
                                         params_from_numpy, predict, scores)
from sparkfm_tpu_torch.serving import MicroBatcher
from sparkfm_tpu_torch.solvers.als import train_als
from sparkfm_tpu_torch.training.trainer import (TrainResult, evaluate,
                                                train_sgd)

__all__ = [
    "FM", "FMModel", "ALSConfig", "FMConfig", "SGDConfig", "Task",
    "FMParams", "init_params", "params_from_numpy", "predict", "scores",
    "MicroBatcher", "TrainResult", "evaluate", "train_als", "train_sgd",
]
