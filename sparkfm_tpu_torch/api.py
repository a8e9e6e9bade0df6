"""The facade: ``FM``, configured once, whose ``fit`` runs a solver, and
the fitted ``FMModel`` and ``DeepFMModel`` (predict, metrics, save and
load; :func:`load_model` loads either by the tag its directory carries).
Port of ``sparkfm_tpu/api.py`` for one device."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from sparkfm_tpu_torch.config import (ALSConfig, FMConfig, MCMCConfig,
                                      MeshConfig, SGDConfig, Task)
from sparkfm_tpu_torch.data.batching import SparseDataset, batch_iterator
from sparkfm_tpu_torch.models import deepfm as deepfm_core
from sparkfm_tpu_torch.models import fm as fm_core
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import metrics as M
from sparkfm_tpu_torch.utils import checkpoint
from sparkfm_tpu_torch.utils import device as device_util


def _metrics(scores: np.ndarray, y: np.ndarray,
             task: Task) -> Dict[str, float]:
    """Regression: rmse, mae. Classification: logloss, accuracy, auc;
    from raw scores (float32) and labels."""
    if task == Task.REGRESSION:
        return {"rmse": float(np.sqrt(np.mean(np.square(scores - y)))),
                "mae": float(np.mean(np.abs(scores - y)))}
    prob = torch.sigmoid(torch.from_numpy(scores).double()).numpy()
    y01 = (y > 0).astype(np.float64)
    p = np.clip(prob, 1e-7, 1 - 1e-7)
    return {
        "logloss": float(-np.mean(y01 * np.log(p)
                                  + (1 - y01) * np.log1p(-p))),
        "accuracy": float(np.mean((prob >= 0.5) == (y01 > 0.5))),
        "auc": float(M.auc(torch.from_numpy(scores), torch.from_numpy(y))),
    }


def _predictions(scores: np.ndarray, task: Task) -> np.ndarray:
    if task == Task.CLASSIFICATION:
        return torch.sigmoid(torch.from_numpy(scores)).numpy()
    return scores


class _Metrics:
    """The metric surface shared by :class:`FMModel` and
    :class:`DeepFMModel`: each has ``_scores(ds, batch_size)`` (raw
    scores of every example) and ``task``."""

    def predict_dataset(self, ds: SparseDataset,
                        batch_size: int = 8192) -> np.ndarray:
        return _predictions(self._scores(ds, batch_size), self.task)

    def evaluate(self, ds: SparseDataset,
                 batch_size: int = 8192) -> Dict[str, float]:
        """Regression: rmse, mae. Classification: logloss, accuracy,
        auc."""
        scores = self._scores(ds, batch_size)
        return _metrics(scores, ds.y[:len(scores)], self.task)

    def compute_rmse(self, ds: SparseDataset) -> float:
        p = self.predict_dataset(ds)
        return float(np.sqrt(np.mean(np.square(p - ds.y[:len(p)]))))

    def compute_mae(self, ds: SparseDataset) -> float:
        """True mean |error|."""
        p = self.predict_dataset(ds)
        return float(np.mean(np.abs(p - ds.y[:len(p)])))

    def compute_accuracy(self, ds: SparseDataset) -> float:
        p = self.predict_dataset(ds)
        if self.task == Task.CLASSIFICATION:
            pred_pos = p >= 0.5
        else:
            pred_pos = p > 0
        return float(np.mean(pred_pos == (ds.y[:len(p)] > 0)))


@dataclasses.dataclass
class FMModel(_Metrics):
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

    @property
    def task(self) -> Task:
        return self.cfg.task

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

    def save(self, directory: str) -> None:
        checkpoint.save(directory, self.params.state_dict(),
                        {"cfg": self.cfg.to_json()})

    @classmethod
    def load(cls, directory: str, *,
             device=device_util.DEFAULT) -> "FMModel":
        """The model :meth:`save` wrote, on ``device`` (default: the
        card; without one it raises). A DeepFM directory raises
        ``ValueError`` (:func:`load_model` takes either)."""
        state, meta = checkpoint.restore(directory,
                                         device_util.resolve(device))
        if meta.get("model", "fm") != "fm":
            raise ValueError(f"{directory} holds a {meta['model']!r} model; "
                             "load it with DeepFMModel.load or load_model")
        return cls(params=FMParams(w0=state["w0"], w=state["w"],
                                   v=state["v"]),
                   cfg=FMConfig.from_json(meta["cfg"]))


@dataclasses.dataclass
class DeepFMModel(_Metrics):
    """A fitted DeepFM (``models/deepfm.py``): FM tables + MLP tower, the
    same metric surface as :class:`FMModel`; predictions run both heads.
    Everything runs on the parameters' device."""

    params: deepfm_core.DeepFMParams
    cfg: deepfm_core.DeepFMConfig
    history: list = dataclasses.field(default_factory=list)
    examples_per_sec: float = 0.0

    @property
    def device(self) -> torch.device:
        return self.params.device

    @property
    def task(self) -> Task:
        return self.cfg.fm.task

    def predict(self, ids, vals, field_ids=None) -> np.ndarray:
        """Predictions in output space: raw score (regression) or P(y=1).
        ``field_ids`` are not read: DeepFM input is field-major."""
        dev = self.device
        return deepfm_core.predict(
            self.params, self.cfg,
            torch.as_tensor(ids, dtype=torch.int32, device=dev),
            torch.as_tensor(vals, dtype=torch.float32,
                            device=dev)).cpu().numpy()

    def _scores(self, ds: SparseDataset, batch_size: int) -> np.ndarray:
        outs = [deepfm_core.scores(self.params, self.cfg, b.ids,
                                   b.vals)[b.mask].cpu().numpy()
                for b in batch_iterator(ds, batch_size, device=self.device)]
        return np.concatenate(outs) if outs else np.zeros((0,), np.float32)

    def save(self, directory: str) -> None:
        """The tables and tower with the config, tagged ``"model":
        "deepfm"`` (the JAX package's tag), or ``"xdeepfm"`` with the
        CIN's widths and tensors beside them; ``reg_dense`` where set."""
        meta = {"cfg": self.cfg.fm.to_json(),
                "hidden": list(self.cfg.hidden),
                "dropout": self.cfg.dropout, "model": "deepfm"}
        if self.cfg.cin:
            meta.update(model="xdeepfm", cin=list(self.cfg.cin))
        if self.cfg.reg_dense:
            meta["reg_dense"] = self.cfg.reg_dense
        checkpoint.save(directory, self.params.state_dict(), meta)

    @classmethod
    def load(cls, directory: str, *,
             device=device_util.DEFAULT) -> "DeepFMModel":
        """The model :meth:`save` wrote, on ``device`` (default: the
        card; without one it raises)."""
        state, meta = checkpoint.restore(directory,
                                         device_util.resolve(device))
        if meta.get("model") not in _DEEP_MODELS:
            raise ValueError(f"{directory} holds no DeepFM model; load it "
                             "with FMModel.load or load_model")
        layers = len(meta["hidden"]) + 1
        cin = tuple(meta.get("cin", ()))
        params = deepfm_core.DeepFMParams(
            fm=FMParams(w0=state["fm.w0"], w=state["fm.w"],
                        v=state["fm.v"]),
            mlp_w=[state[f"mlp_w.{i}"] for i in range(layers)],
            mlp_b=[state[f"mlp_b.{i}"] for i in range(layers)],
            cin=[state[f"cin.{i}"] for i in range(len(cin) + bool(cin))])
        return cls(params=params, cfg=deepfm_core.DeepFMConfig(
            fm=FMConfig.from_json(meta["cfg"]),
            hidden=tuple(meta["hidden"]),
            dropout=float(meta.get("dropout", 0.0)), cin=cin,
            reg_dense=float(meta.get("reg_dense", 0.0))))


_DEEP_MODELS = ("deepfm", "xdeepfm")    # the tags DeepFMModel.save writes


def load_model(directory: str, *, device=device_util.DEFAULT):
    """An ``FMModel`` or ``DeepFMModel``, by the tag ``save`` wrote. The
    JAX CLI's ``predict`` and ``eval`` always call ``FMModel.load``,
    which fails on a DeepFM directory with a ``KeyError``; the port's
    CLI loads through this."""
    with open(os.path.join(directory, checkpoint.META_FILE)) as f:
        kind = json.load(f).get("model", "fm")
    return (DeepFMModel if kind in _DEEP_MODELS else FMModel).load(
        directory, device=device)


def _parse_mesh(mesh, exchange: str = "auto"):
    """None | DeviceMesh | MeshConfig | "DxM" -> None, a ``MeshConfig``
    (when one was given or an exchange must ride along: the trainers read
    ``MeshConfig.exchange``) or the ``DeviceMesh`` as it is."""
    if mesh is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        if exchange != "auto":
            raise ValueError(
                "exchange= with a DeviceMesh is ambiguous - pass a "
                "MeshConfig(data, model, exchange=...) or a 'DxM' string")
        return mesh
    if isinstance(mesh, MeshConfig):
        if exchange != "auto" and mesh.exchange != exchange:
            mesh = dataclasses.replace(mesh, exchange=exchange)
        return mesh
    if isinstance(mesh, str):
        d, m = (int(x) for x in mesh.lower().split("x"))
        return MeshConfig(data=d, model=m, exchange=exchange)
    raise ValueError(f"mesh must be None, DeviceMesh, MeshConfig or 'DxM' "
                     f"string; got {mesh!r}")


def _coordinate_mesh(mesh, device):
    """ALS and MCMC shard the examples over ``data`` with the parameters
    replicated: an exchange pin means nothing there, so it is refused."""
    from sparkfm_tpu_torch.parallel import mesh as M
    mesh, exchange = M.resolve_mesh(mesh, device=device)
    if exchange != "auto":
        raise ValueError(
            "exchange= applies to the sharded SGD/DeepFM paths; "
            "ALS/MCMC shard examples with replicated parameters "
            f"(got exchange={exchange!r})")
    return mesh


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
    ``sparkfm_tpu/api.py::FM`` for one device::

        model = FM(num_factors=8, max_iter=20, solver="als",
                   reg_v=0.5).fit(train, eval_ds=test)   # on the card
        rmse = model.compute_rmse(test)

    ``solver`` is "als" (slot-aligned blocks, ``solvers/als.py``), "sgd"
    (``train_sgd``, on the update path ``update_path`` names or "auto"
    picks, with ``optimizer`` "adagrad", "adagrad_row", "sgd" or "adam"),
    "mcmc" (``solvers/mcmc.py::train_mcmc``, slot-aligned blocks, burn-in
    ``max(1, max_iter // 10)``)
    or a callable ``(cfg, train, eval_ds, eval_every, generator) ->
    TrainResult``, where ``generator`` is a ``torch.Generator`` on the
    fit's device seeded with ``seed``. ``num_fields > 0`` fits a
    field-aware FM on data with ``field_ids``; when every row's field_ids
    are ``arange(num_fields)`` the config gets ``slot_major_fields``, as
    the JAX facade's does. ``model="deepfm"`` (with ``solver="sgd"`` and
    ``num_fields`` = slots per example) fits a DeepFM with tower widths
    ``hidden`` and tower ``dropout`` (the port's own; 0 = the JAX
    facade's) (``models/deepfm.py::train_deepfm``) and returns a
    ``DeepFMModel``; ``model="xdeepfm"`` fits xDeepFM, whose CIN has
    ``cin`` maps a layer (``DeepFMConfig.cin``; given with that model
    and no other), in its place. ``reg_dense`` is the L2 on a deep
    model's weight matrices (``DeepFMConfig.reg_dense``).
    ``feature_groups`` is a tuple of group ids or a
    fitted ``Vectorizer`` (one group per source column,
    ``data/vectorizer.py::feature_groups_of``). ``timeout`` is a
    wall-clock budget in seconds, checked between epochs (0 = none). The
    arguments are the JAX facade's.

    ``fit`` also takes a block-structure ``data/relational.py::
    RelationalDataset``: "sgd" trains on it as it is
    (``training/trainer.py::train_sgd_relational``), "als" by BS-ALS
    (``solvers/als_bs.py``), and every other solver, and DeepFM, on its
    ``materialize()``.

    ``mesh`` ("DxM", a ``MeshConfig`` or a ``DeviceMesh`` of
    ``parallel/mesh.py``) trains the "sgd" (FM or DeepFM), "als" and
    "mcmc" solvers sharded over a (data, model) mesh of ranks; every rank
    runs the same ``fit`` (under ``torchrun``, or
    ``parallel.multihost.spawn``). ``exchange`` pins the sharded SGD
    exchange; the coordinate solvers refuse one. A one-process run takes
    only a 1 x 1 mesh and raises naming the world size a larger one needs.
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
                 dropout: float = 0.0,
                 cin: tuple = (),
                 reg_dense: float = 0.0,
                 feature_groups=None,
                 group_reg_w: Optional[tuple] = None,
                 group_reg_v: Optional[tuple] = None):
        if model not in ("fm", *_DEEP_MODELS):
            raise ValueError(f"unknown model {model!r}")
        if bool(cin) != (model == "xdeepfm"):
            raise ValueError("cin (the CIN's map counts) is given with "
                             "model='xdeepfm' and no other model")
        if reg_dense and model not in _DEEP_MODELS:
            raise ValueError("reg_dense takes model='deepfm' or 'xdeepfm'")
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
        self.dropout = float(dropout)
        self.cin = tuple(int(h) for h in cin)
        self.reg_dense = float(reg_dense)
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
            from sparkfm_tpu_torch.data.vectorizer import feature_groups_of
            return feature_groups_of(fg)
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
            init_params=None, *, device=device_util.DEFAULT):
        """Train on ``device`` (default: the card; without one it raises)
        and return the fitted ``FMModel``, or ``DeepFMModel`` under
        ``model="deepfm"`` or ``"xdeepfm"``.

        ``init_params`` (an FMParams or a fitted FMModel) warm-starts the
        "als", "sgd" and "mcmc" solvers on a SparseDataset; DeepFM and
        relational input take none (``ValueError``, as in
        the JAX facade). ``checkpoint_dir`` checkpoints and
        resumes the "sgd" solver's training (``train_sgd``). A callable
        solver takes neither ``init_params`` nor a ``timeout``, and no
        solver but "sgd" on a SparseDataset takes a ``checkpoint_dir``:
        they are given no way
        to honour them, so ``fit`` raises ``ValueError`` where the JAX
        facade drops them silently. DeepFM honours ``update_path``, which
        the JAX facade does not pass to its DeepFM trainer.
        """
        # imported here: training.trainer (and so the solvers) imports
        # this module
        from sparkfm_tpu_torch.solvers import als, als_bs, mcmc
        from sparkfm_tpu_torch.training import trainer

        mesh = _parse_mesh(self.mesh, self.exchange)
        if mesh is not None and (self.solver not in ("sgd", "als", "mcmc")
                                 or hasattr(train, "materialize")):
            raise ValueError("mesh training supports solver='sgd' (FM or "
                             "DeepFM), 'als' or 'mcmc' on a SparseDataset "
                             "(materialize relational data first)")
        if mesh is not None and init_params is not None:
            raise ValueError("init_params warm start is single-device for "
                             "now")
        if checkpoint_dir is not None and self.solver != "sgd":
            raise ValueError("checkpoint_dir checkpoints the 'sgd' solver "
                             f"only, not {self.solver!r}")
        relational = hasattr(train, "materialize")
        if relational and (init_params is not None
                           or checkpoint_dir is not None):
            raise ValueError("init_params warm start and checkpoint_dir "
                             "take a SparseDataset, not a relational one")
        if relational and (self.model in _DEEP_MODELS
                           or self.solver not in ("sgd", "als")):
            train = train.materialize()
            relational = False
            if eval_ds is not None and hasattr(eval_ds, "materialize"):
                eval_ds = eval_ds.materialize()
        if isinstance(init_params, FMModel):
            init_params = init_params.params
        device = device_util.resolve(device)
        cfg = self._cfg(train)
        generator = torch.Generator(device=device).manual_seed(self.seed)
        if self.model in _DEEP_MODELS:
            if self.solver != "sgd":
                raise ValueError(f"model={self.model!r} requires "
                                 "solver='sgd'")
            if init_params is not None:
                raise ValueError("init_params warm start supports plain "
                                 "FM on a SparseDataset")
            dcfg = deepfm_core.DeepFMConfig(
                fm=cfg, hidden=self.hidden, dropout=self.dropout,
                cin=self.cin, reg_dense=self.reg_dense)
            sgd_cfg = SGDConfig(learning_rate=self.learning_rate,
                                optimizer=self.optimizer,
                                batch_size=self.batch_size,
                                epochs=self.max_iter,
                                update_path=self.update_path,
                                max_seconds=self.timeout)
            res = deepfm_core.train_deepfm(
                dcfg, sgd_cfg, train, eval_ds, self.eval_every, generator,
                mesh=mesh, checkpoint_dir=checkpoint_dir, device=device)
            return DeepFMModel(params=res.params, cfg=dcfg,
                               history=res.history,
                               examples_per_sec=res.examples_per_sec)
        if relational:
            if self.solver == "sgd":
                res = trainer.train_sgd_relational(
                    cfg, SGDConfig(learning_rate=self.learning_rate,
                                   optimizer=self.optimizer,
                                   batch_size=self.batch_size,
                                   epochs=self.max_iter,
                                   update_path=self.update_path,
                                   max_seconds=self.timeout),
                    train, eval_ds, self.eval_every, generator,
                    device=device)
            else:
                res = als_bs.train_als_relational(
                    cfg, ALSConfig(epochs=self.max_iter,
                                   max_seconds=self.timeout),
                    train, eval_ds, self.eval_every, generator,
                    device=device)
        elif callable(self.solver):
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
                                    checkpoint_dir=checkpoint_dir,
                                    mesh=mesh, init_params=init_params,
                                    device=device)
        elif self.solver == "als":
            als_cfg = ALSConfig(epochs=self.max_iter,
                                feature_blocks=als.slot_blocks(train),
                                max_seconds=self.timeout)
            if mesh is not None:
                from sparkfm_tpu_torch.parallel.sharded_als import (
                    train_als_sharded)
                res = train_als_sharded(
                    cfg, als_cfg, train, _coordinate_mesh(mesh, device),
                    eval_ds, self.eval_every, generator)
            else:
                res = als.train_als(cfg, als_cfg, train, eval_ds,
                                    self.eval_every, generator,
                                    params=init_params, device=device)
        elif self.solver == "mcmc":
            mcmc_cfg = MCMCConfig(epochs=self.max_iter,
                                  burn_in=max(1, self.max_iter // 10),
                                  feature_blocks=als.slot_blocks(train),
                                  max_seconds=self.timeout)
            if mesh is not None:
                from sparkfm_tpu_torch.parallel.sharded_als import (
                    train_mcmc_sharded)
                res = train_mcmc_sharded(cfg, mcmc_cfg, train,
                                         _coordinate_mesh(mesh, device),
                                         eval_ds, generator)
            else:
                res = mcmc.train_mcmc(cfg, mcmc_cfg, train, eval_ds,
                                      generator, params=init_params,
                                      device=device)
        else:
            raise ValueError(f"unknown solver {self.solver!r}")
        return FMModel(params=res.params, cfg=cfg, history=res.history,
                       examples_per_sec=res.examples_per_sec)
