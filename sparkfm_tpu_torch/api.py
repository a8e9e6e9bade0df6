"""The facade: ``FM``, configured once, whose ``fit`` runs a solver, and
the fitted ``FMModel`` (predict, metrics, save and load). Port of
``sparkfm_tpu/api.py`` for one device."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from sparkfm_tpu_torch.config import ALSConfig, FMConfig, SGDConfig, Task
from sparkfm_tpu_torch.data.batching import SparseDataset, batch_iterator
from sparkfm_tpu_torch.models import fm as fm_core
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import metrics as M
from sparkfm_tpu_torch.utils import checkpoint


@dataclasses.dataclass
class FMModel:
    """Parameters + config + metric helpers, and the training run's
    per-epoch ``history`` and ``examples_per_sec`` when ``FM.fit`` made
    it. Everything runs on the parameters' device."""

    params: FMParams
    cfg: FMConfig
    history: list = dataclasses.field(default_factory=list)
    examples_per_sec: float = 0.0

    @property
    def device(self) -> torch.device:
        return self.params.device

    def predict(self, ids, vals, field_ids=None) -> np.ndarray:
        """Predictions in output space: raw score (regression) or P(y=1)."""
        dev = self.device
        return fm_core.predict(
            self.params, self.cfg, torch.as_tensor(ids, device=dev),
            torch.as_tensor(vals, device=dev),
            None if field_ids is None
            else torch.as_tensor(field_ids, device=dev)).cpu().numpy()

    def _scores(self, ds: SparseDataset, batch_size: int) -> np.ndarray:
        """Raw scores of every example. Big plain-FM tables score through
        host ladder dedup plans: one unique-row gather per batch."""
        dedup_budget = dedup_fill = None
        if (self.cfg.num_fields == 0
                and self.cfg.num_features >= fm_core.BIG_TABLE):
            # fill with the last row id, so fill entries sort after every
            # real unique id
            dedup_budget, dedup_fill = "ladder", self.cfg.num_features - 1
        outs = []
        for b in batch_iterator(ds, batch_size, device=self.device,
                                dedup_budget=dedup_budget,
                                dedup_fill=dedup_fill):
            plan = b.plan
            if plan is not None and plan.overflow:
                # a capped ladder plan overflowed: its aliased rows would
                # score wrong, so this batch scores exactly without one
                plan = None
            s = fm_core.scores(self.params, self.cfg, b.ids, b.vals,
                               b.field_ids, plan=plan)
            outs.append(s[b.mask].cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    def predict_dataset(self, ds: SparseDataset,
                        batch_size: int = 8192) -> np.ndarray:
        s = self._scores(ds, batch_size)
        if self.cfg.task == Task.CLASSIFICATION:
            return torch.sigmoid(torch.from_numpy(s)).numpy()
        return s

    def evaluate(self, ds: SparseDataset,
                 batch_size: int = 8192) -> Dict[str, float]:
        """Regression: rmse, mae. Classification: logloss, accuracy, auc."""
        scores = self._scores(ds, batch_size)
        y = ds.y[:len(scores)]
        if self.cfg.task == Task.REGRESSION:
            return {"rmse": float(np.sqrt(np.mean(np.square(scores - y)))),
                    "mae": float(np.mean(np.abs(scores - y)))}
        prob = torch.sigmoid(torch.from_numpy(scores).double()).numpy()
        y01 = (y > 0).astype(np.float64)
        p = np.clip(prob, 1e-7, 1 - 1e-7)
        return {
            "logloss": float(-np.mean(y01 * np.log(p)
                                      + (1 - y01) * np.log1p(-p))),
            "accuracy": float(np.mean((prob >= 0.5) == (y01 > 0.5))),
            "auc": float(M.auc(torch.from_numpy(scores),
                               torch.from_numpy(y))),
        }

    def compute_rmse(self, ds: SparseDataset) -> float:
        p = self.predict_dataset(ds)
        return float(np.sqrt(np.mean(np.square(p - ds.y[:len(p)]))))

    def compute_mae(self, ds: SparseDataset) -> float:
        """True mean |error|."""
        p = self.predict_dataset(ds)
        return float(np.mean(np.abs(p - ds.y[:len(p)])))

    def compute_accuracy(self, ds: SparseDataset) -> float:
        p = self.predict_dataset(ds)
        if self.cfg.task == Task.CLASSIFICATION:
            pred_pos = p >= 0.5
        else:
            pred_pos = p > 0
        return float(np.mean(pred_pos == (ds.y[:len(p)] > 0)))

    def save(self, directory: str) -> None:
        checkpoint.save(directory, self.params.state_dict(),
                        {"cfg": self.cfg.to_json()})

    @classmethod
    def load(cls, directory: str, *, device) -> "FMModel":
        state, meta = checkpoint.restore(directory, device)
        return cls(params=FMParams(w0=state["w0"], w=state["w"],
                                   v=state["v"]),
                   cfg=FMConfig.from_json(meta["cfg"]))


def _detect_slot_major(train, num_fields: int) -> bool:
    """True iff every example's slot l holds a field-l feature
    (field_ids == arange(num_fields) in every row: the fixed-column
    hashed-CTR layout of ``synth_ctr`` and the Avazu/Criteo loaders). One
    host pass at fit time; when true the FFM interaction takes the
    slot-major form (``ops/interaction.py::ffm_interaction_slot_major``),
    the same math without the one-hot. Scoring checks given field_ids
    again (``models/fm.py::scores``)."""
    if num_fields <= 0:
        return False
    fids = getattr(train, "field_ids", None)
    if fids is None:
        return False
    fids = np.asarray(fids)
    if fids.ndim != 2 or fids.shape[1] != num_fields:
        return False
    return bool((fids == np.arange(num_fields,
                                   dtype=fids.dtype)[None, :]).all())


class FM:
    """The facade: configure once, then ``fit``. Port of
    ``sparkfm_tpu/api.py::FM`` for one device and a ``SparseDataset``::

        model = FM(num_factors=8, max_iter=20, solver="als",
                   reg_v=0.5).fit(train, eval_ds=test, device="cuda")
        rmse = model.compute_rmse(test)

    ``solver`` is "als" (slot-aligned blocks, ``solvers/als.py``), "sgd"
    (``train_sgd``, on the update path ``update_path`` names or "auto"
    picks, with ``optimizer`` "adagrad", "adagrad_row", "sgd" or "adam")
    or a callable ``(cfg, train, eval_ds, eval_every, generator) ->
    TrainResult``, where ``generator`` is a ``torch.Generator`` on the
    fit's device seeded with ``seed``. ``num_fields > 0`` fits a
    field-aware FM on data with ``field_ids``; when every row's field_ids
    are ``arange(num_fields)`` the config gets ``slot_major_fields``, as
    the JAX facade's does. ``timeout`` is a wall-clock budget in seconds,
    checked between epochs (0 = none). The arguments are the JAX
    facade's.

    Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP
    item: ``solver="mcmc"`` (A11), a ``mesh`` (A15), ``model="deepfm"``
    (A12), relational input (A10: BS-ALS and relational SGD), a
    ``checkpoint_dir`` (A5) and a fitted Vectorizer as ``feature_groups``
    (A14).
    """

    def __init__(self, num_factors: int = 8,
                 task: Task = Task.REGRESSION,
                 max_iter: int = 100,
                 solver: Union[str, Callable] = "als",
                 timeout: float = 0.0,
                 num_features: Optional[int] = None,
                 reg0: float = 0.0, reg_w: float = 0.0, reg_v: float = 10.0,
                 init_stdev: float = 0.01, init_mean: float = 0.0,
                 seed: int = 0,
                 learning_rate: float = 0.05, batch_size: int = 8192,
                 optimizer: str = "adagrad", num_fields: int = 0,
                 block_size: int = 4096,
                 eval_every: int = 1,
                 update_path: str = "auto",
                 steps_per_dispatch: int = 1,
                 mesh=None,
                 exchange: str = "auto",
                 model: str = "fm",
                 hidden: tuple = (128, 64),
                 feature_groups=None,
                 group_reg_w: Optional[tuple] = None,
                 group_reg_v: Optional[tuple] = None):
        if model not in ("fm", "deepfm"):
            raise ValueError(f"unknown model {model!r}")
        self.num_factors = num_factors
        self.task = Task(task)
        self.max_iter = max_iter
        self.solver = solver
        self.timeout = float(timeout)
        self.num_features = num_features
        self.reg0, self.reg_w, self.reg_v = reg0, reg_w, reg_v
        self.init_stdev = init_stdev
        self.init_mean = init_mean
        self.seed = seed
        self.learning_rate = learning_rate
        self.batch_size = batch_size
        self.optimizer = optimizer
        self.num_fields = num_fields
        self.block_size = block_size
        self.eval_every = eval_every
        self.update_path = update_path
        self.steps_per_dispatch = steps_per_dispatch
        self.mesh = mesh
        self.exchange = exchange
        self.model = model
        self.hidden = tuple(hidden)
        self.feature_groups = feature_groups
        self.group_reg_w = (None if group_reg_w is None
                            else tuple(float(x) for x in group_reg_w))
        self.group_reg_v = (None if group_reg_v is None
                            else tuple(float(x) for x in group_reg_v))

    def _resolved_groups(self) -> Optional[tuple]:
        fg = self.feature_groups
        if fg is None:
            return None
        if hasattr(fg, "offsets"):      # a fitted Vectorizer
            raise NotImplementedError(
                "feature groups from a Vectorizer need the data pipeline, "
                "not ported yet (ROADMAP A14); pass a tuple of group ids")
        if isinstance(fg, str):
            raise ValueError(
                "feature_groups='auto' needs the fitted Vectorizer itself: "
                "FM(feature_groups=vec) (one group per source column)")
        return tuple(int(g) for g in fg)

    def _cfg(self, train: SparseDataset) -> FMConfig:
        groups = self._resolved_groups()
        num_features = self.num_features or train.num_features
        if groups is not None:
            if len(groups) > num_features and self.num_features is None:
                num_features = len(groups)
            elif len(groups) != num_features:
                raise ValueError(
                    f"feature_groups length {len(groups)} != num_features "
                    f"{num_features}")
        return FMConfig(
            num_features=num_features,
            num_factors=self.num_factors, task=self.task,
            reg0=self.reg0, reg_w=self.reg_w, reg_v=self.reg_v,
            init_stdev=self.init_stdev, init_mean=self.init_mean,
            seed=self.seed, num_fields=self.num_fields,
            slot_major_fields=_detect_slot_major(train, self.num_fields),
            feature_groups=groups,
            group_reg_w=self.group_reg_w, group_reg_v=self.group_reg_v)

    def fit(self, train: SparseDataset,
            eval_ds: Optional[SparseDataset] = None,
            checkpoint_dir: Optional[str] = None,
            init_params=None, *, device) -> FMModel:
        """Train on ``device`` and return the fitted model.

        ``init_params`` (an FMParams or a fitted FMModel) warm-starts the
        "als" and "sgd" solvers. A callable solver takes neither
        ``init_params`` nor a ``timeout``: it is given no way to honour
        them, so ``fit`` raises ``ValueError`` where the JAX facade drops
        both silently.
        """
        # imported here: training.trainer (and so solvers.als) imports
        # this module
        from sparkfm_tpu_torch.solvers import als
        from sparkfm_tpu_torch.training import trainer

        if hasattr(train, "materialize"):
            raise NotImplementedError(
                "relational datasets are not ported yet (ROADMAP A10: "
                "BS-ALS and relational SGD)")
        if self.model == "deepfm":
            raise NotImplementedError("DeepFM is not ported yet (ROADMAP "
                                      "A12)")
        if self.mesh is not None:
            raise NotImplementedError("mesh training is not ported yet "
                                      "(ROADMAP A15)")
        if checkpoint_dir is not None:
            raise NotImplementedError("checkpointed training is not ported "
                                      "yet (ROADMAP A5)")
        if isinstance(init_params, FMModel):
            init_params = init_params.params
        device = torch.device(device)
        cfg = self._cfg(train)
        generator = torch.Generator(device=device).manual_seed(self.seed)
        if callable(self.solver):
            if init_params is not None or self.timeout:
                raise ValueError(
                    "a callable solver is called as (cfg, train, eval_ds, "
                    "eval_every, generator) and gets neither init_params "
                    "nor timeout; build them into the callable instead")
            res = self.solver(cfg, train, eval_ds, self.eval_every,
                              generator)
        elif self.solver == "sgd":
            sgd_cfg = SGDConfig(learning_rate=self.learning_rate,
                                optimizer=self.optimizer,
                                batch_size=self.batch_size,
                                epochs=self.max_iter,
                                update_path=self.update_path,
                                steps_per_dispatch=self.steps_per_dispatch,
                                max_seconds=self.timeout)
            res = trainer.train_sgd(cfg, sgd_cfg, train, eval_ds,
                                    self.eval_every, generator,
                                    init_params=init_params, device=device)
        elif self.solver == "als":
            als_cfg = ALSConfig(epochs=self.max_iter,
                                feature_blocks=als.slot_blocks(train),
                                max_seconds=self.timeout)
            res = als.train_als(cfg, als_cfg, train, eval_ds,
                                self.eval_every, generator,
                                params=init_params, device=device)
        elif self.solver == "mcmc":
            raise NotImplementedError("the MCMC solver is not ported yet "
                                      "(ROADMAP A11)")
        else:
            raise ValueError(f"unknown solver {self.solver!r}")
        return FMModel(params=res.params, cfg=cfg, history=res.history,
                       examples_per_sec=res.examples_per_sec)
