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
``train_als``) with the per-rank stream-sum kernel, DeepFM training and
serving (``models/deepfm.py``, ``DeepFMModel``), the ``FM`` facade over
them, the data pipeline (``data/``: libFM files, the Vectorizer, the
public datasets' loaders) and the command line (``python -m
sparkfm_tpu_torch``), and sharded training over a (data, model) mesh
of ranks on ``torch.distributed`` (``parallel/``: SGD, DeepFM, ALS and
MCMC; ``FM(mesh=...)``, ``--mesh``). The kernels are CUDA C++ under
``csrc/``. Entry points run on the card unless asked for the CPU
(``utils/device.py``).
"""

from sparkfm_tpu_torch.api import FM, DeepFMModel, FMModel, load_model
from sparkfm_tpu_torch.config import (ALSConfig, FMConfig, MCMCConfig,
                                      MeshConfig, SGDConfig, Solver, Task,
                                      TrainConfig)
from sparkfm_tpu_torch.models.fm import (FMParams, init_params,
                                         params_from_numpy, predict, scores)
from sparkfm_tpu_torch.serving import MicroBatcher
from sparkfm_tpu_torch.solvers.als import train_als
from sparkfm_tpu_torch.training.trainer import (TrainResult, evaluate,
                                                train_sgd)

__all__ = [
    "FM", "FMModel", "DeepFMModel", "load_model", "ALSConfig", "FMConfig",
    "MCMCConfig", "MeshConfig", "SGDConfig", "Solver", "Task", "TrainConfig",
    "FMParams", "init_params", "params_from_numpy", "predict", "scores",
    "MicroBatcher", "TrainResult", "evaluate", "train_als", "train_sgd",
]
