"""Model and solver configuration.

A copy of ``Task``, ``FMConfig``, ``SGDConfig`` and ``ALSConfig`` from
``sparkfm_tpu/config.py``, so the port imports without jax and one set of
keyword arguments builds the same config in both packages. The other
solvers' configs come with those solvers.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class Task(enum.Enum):
    """Learning task; selects the head: squared loss and raw scores for
    REGRESSION, logistic loss and P(y=1) for CLASSIFICATION."""

    REGRESSION = "regression"
    CLASSIFICATION = "classification"


@dataclasses.dataclass(frozen=True)
class FMConfig:
    """Model shape + initialization + regularization.

    ``use_bias`` / ``use_linear`` switch the w0 and <w, x> terms;
    ``init_mean`` / ``init_stdev`` / ``seed`` set the N(mean, stdev) init
    of V; ``reg0`` / ``reg_w`` / ``reg_v`` are per-group L2 strengths.
    ``num_fields > 0`` selects the field-aware model (FFM), and
    ``slot_major_fields`` promises that slot l holds a feature of field l
    (the training steps then take the slot-major interaction and do not
    read field_ids). ``feature_groups`` with
    ``group_reg_w`` / ``group_reg_v`` give per-attribute-group L2.
    """

    num_features: int
    num_factors: int = 8
    task: Task = Task.REGRESSION
    use_bias: bool = True
    use_linear: bool = True
    init_mean: float = 0.0
    init_stdev: float = 0.01
    seed: int = 0
    reg0: float = 0.0
    reg_w: float = 0.0
    reg_v: float = 10.0
    dtype: str = "float32"          # parameter dtype
    compute_dtype: str = "float32"  # dtype of the interaction math
    num_fields: int = 0
    slot_major_fields: bool = False
    feature_groups: Optional[tuple] = None
    group_reg_w: Optional[tuple] = None
    group_reg_v: Optional[tuple] = None

    def replace(self, **kw) -> "FMConfig":
        return dataclasses.replace(self, **kw)

    @property
    def num_groups(self) -> int:
        if self.feature_groups is None:
            return 1
        return int(max(self.feature_groups)) + 1

    def reg_vectors(self):
        """(reg_w_vec, reg_v_vec): per-feature L2 strengths as numpy (F,)
        f32 arrays — per-group values spread to features when groups are
        configured, else the scalars broadcast."""
        if self.feature_groups is None:
            return (np.full((self.num_features,), self.reg_w, np.float32),
                    np.full((self.num_features,), self.reg_v, np.float32))
        groups = np.asarray(self.feature_groups, np.int64)
        if groups.shape != (self.num_features,):
            raise ValueError(
                f"feature_groups must have length num_features="
                f"{self.num_features}, got {groups.shape}")
        gw = (np.asarray(self.group_reg_w, np.float32)
              if self.group_reg_w is not None
              else np.full((self.num_groups,), self.reg_w, np.float32))
        gv = (np.asarray(self.group_reg_v, np.float32)
              if self.group_reg_v is not None
              else np.full((self.num_groups,), self.reg_v, np.float32))
        for name, arr in (("group_reg_w", gw), ("group_reg_v", gv)):
            if arr.shape != (self.num_groups,):
                raise ValueError(
                    f"{name} must have length num_groups={self.num_groups}"
                    f" (= max(feature_groups)+1), got {arr.shape}")
        return gw[groups], gv[groups]

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["task"] = self.task.value
        return d

    @classmethod
    def from_json(cls, d: dict) -> "FMConfig":
        d = dict(d)
        d["task"] = Task(d["task"])
        for k in ("feature_groups", "group_reg_w", "group_reg_v"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    """SGD solver settings; same fields and defaults as the JAX package's.

    ``update_path``: "direct" and "dedup" (``solvers/sgd.py``, separate
    tables), "hybrid" (``solvers/sgd_hybrid.py``), "fused"
    (``solvers/sgd_fused.py``) and "sorted" (``solvers/sgd_sorted.py``) on
    the fused record table; "auto" picks among them as the JAX package
    does (``solvers/sgd.py::resolve_update_path``). Optimizers: adagrad /
    sgd (with ``momentum``) / adam on "direct" and "dedup"; adagrad /
    adagrad_row / sgd without momentum on "hybrid" and "fused"; adagrad /
    sgd on "sorted"; a path given an optimizer it lacks raises the JAX
    package's ``ValueError``. ``host_plan=False`` makes the dedup and
    fused steps build their plans on the device (the hybrid path needs
    host plans and raises ``ValueError``). ``steps_per_dispatch`` groups
    only hybrid steps, as in the JAX package; above 1 the hybrid path
    raises ``NotImplementedError`` (ROADMAP A3), and the other paths run
    their steps one by one.

    ``max_seconds``: wall-clock budget, checked at epoch boundaries (0 =
    none). ``unique_budget``: 0 sizes each batch's plan by the ladder
    (``ops/embedding.py::ladder_budget``), or by ``auto_budget`` where the
    step builds its own; a positive value pins one budget. ``accumulate``
    selects the fused step's per-unique reduce: "segsum" the row-sum
    kernel B5 over id-sorted runs, whose sums repeat bit for bit;
    "scatter" an ``index_add_`` by rank, whose atomic adds on the card do
    not; "auto" B5 for CUDA tensors and ``index_add_`` for CPU tensors
    (``solvers/sgd_fused.py::segsum_accumulate``). ``pallas_scatter`` and
    ``sparse_updates`` are TPU dispatch knobs of the JAX package; the port
    accepts them and they have no effect here (the write-back always runs
    the port's row-write kernel on the card).
    """

    learning_rate: float = 0.05
    max_seconds: float = 0.0
    optimizer: str = "adagrad"      # adagrad | adagrad_row | sgd | adam
    batch_size: int = 8192
    epochs: int = 10
    momentum: float = 0.0
    adagrad_eps: float = 1e-8
    sparse_updates: bool = True
    shuffle_each_epoch: bool = True
    update_path: str = "auto"
    unique_budget: int = 0
    pallas_scatter: str = "auto"
    host_plan: bool = True
    accumulate: str = "auto"
    steps_per_dispatch: int = 1


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    """Blocked coordinate-descent (Rendle ALS) settings; same fields and
    defaults as the JAX package's.

    Features are swept in blocks: Jacobi within a block, exact
    Gauss-Seidel across blocks (``solvers/als.py``). ``feature_blocks`` is
    an explicit feature -> block map (e.g. ``slot_blocks(ds)``); without
    it, contiguous blocks of ``block_size`` features. ``max_seconds``: a
    wall-clock budget checked between sweeps (0 = none).
    """

    epochs: int = 10
    block_size: int = 4096
    max_seconds: float = 0.0
    feature_blocks: Optional[tuple] = None
