"""The fitted-model facade: predict, metrics, save and load. Port of
``FMModel`` from ``sparkfm_tpu/api.py``; the ``FM`` builder and its
``fit`` come with the training path."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from sparkfm_tpu_torch.config import FMConfig, Task
from sparkfm_tpu_torch.data.batching import SparseDataset, batch_iterator
from sparkfm_tpu_torch.models import fm as fm_core
from sparkfm_tpu_torch.models.fm import FMParams
from sparkfm_tpu_torch.ops import metrics as M
from sparkfm_tpu_torch.utils import checkpoint


@dataclasses.dataclass
class FMModel:
    """Parameters + config + metric helpers. Everything runs on the
    parameters' device."""

    params: FMParams
    cfg: FMConfig

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
