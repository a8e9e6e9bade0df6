"""Serving: coalesce scoring requests into padded batches. Port of
``sparkfm_tpu/serving.py`` for ``model="fm"``, plain FM and FFM (whose
requests carry ``field_ids``).

A score call pays a fixed cost (launches, host-to-device copies, the copy
back) whatever its batch size, so a server queues requests and scores them
together. :class:`MicroBatcher` is the synchronous core a server loops
around: ``submit`` queues requests on the host; ``flush`` scores the queue
in chunks of at most ``max_batch`` examples, each padded to a power of two
(a bounded ladder of shapes), and maps the results back per request.

One deliberate difference from the JAX package: ``flush`` clears the queue
only after every chunk has scored, so an error leaves the queued requests
in place instead of dropping them.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from sparkfm_tpu_torch.models import fm as fm_model
from sparkfm_tpu_torch.ops import embedding as E


def _pad_batch_size(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


class MicroBatcher:
    """Coalesce scoring requests into padded ``predict`` calls. Outputs are
    in task space: raw score for regression, P(y=1) for classification.

    Args:
      params: FMParams, on the device that scores.
      cfg: the matching FMConfig.
      max_batch: largest chunk; a longer queue flushes in several chunks.
      use_plans: build a host dedup plan per chunk (default: for plain-FM
        tables of at least 2^16 rows).
      model: "fm"; "deepfm" is not ported yet.

    Usage::

        mb = MicroBatcher(model.params, model.cfg)
        i = mb.submit(ids_a, vals_a)      # (L,) or (n_a, L)
        j = mb.submit(ids_b, vals_b)
        out = mb.flush()
        out[i], out[j]                    # per-request score arrays
    """

    def __init__(self, params: fm_model.FMParams, cfg, max_batch: int = 4096,
                 use_plans: Optional[bool] = None, model: str = "fm"):
        if model == "deepfm":
            raise NotImplementedError("DeepFM serving is not ported yet "
                                      "(ROADMAP A7, with A12)")
        if model != "fm":
            raise ValueError(f"unknown model {model!r}")
        self.params = params
        self.cfg = cfg
        self.device = params.device
        self.max_batch = int(max_batch)
        if use_plans is None:
            use_plans = (cfg.num_fields == 0
                         and cfg.num_features >= fm_model.BIG_TABLE)
        self.use_plans = bool(use_plans)
        self._ids: List[np.ndarray] = []
        self._vals: List[np.ndarray] = []
        self._fids: List[Optional[np.ndarray]] = []
        self._sizes: List[int] = []

    def submit(self, ids, vals, field_ids=None) -> int:
        """Queue one request (a single example (L,) or a batch (n, L));
        returns its index in :meth:`flush`'s result list."""
        ids = np.atleast_2d(np.asarray(ids, np.int32))
        vals = np.atleast_2d(np.asarray(vals, np.float32))
        if ids.shape != vals.shape:
            raise ValueError(f"ids {ids.shape} != vals {vals.shape}")
        if field_ids is not None:
            field_ids = np.atleast_2d(np.asarray(field_ids, np.int32))
        # Refuse mixing at submit time: a mixed queue could only fail at
        # flush, and every retry would fail again on the same queue.
        if self._fids and (field_ids is None) != (self._fids[-1] is None):
            raise ValueError(
                "mixed submit: this request "
                + ("omits" if field_ids is None else "carries")
                + " field_ids while queued requests do the opposite — a "
                "queue must be all-FFM or all-plain")
        self._ids.append(ids)
        self._vals.append(vals)
        self._fids.append(field_ids)
        self._sizes.append(ids.shape[0])
        return len(self._sizes) - 1

    @property
    def pending(self) -> int:
        return int(sum(self._sizes))

    def _score_chunk(self, chunk: np.ndarray, vchunk: np.ndarray,
                     fchunk: Optional[np.ndarray]) -> np.ndarray:
        n = chunk.shape[0]
        b = _pad_batch_size(n, self.max_batch)
        if b > n:   # padded rows (val 0) score as no-ops and are cut off
            pad = ((0, b - n), (0, 0))
            chunk = np.pad(chunk, pad)
            vchunk = np.pad(vchunk, pad)
            if fchunk is not None:
                fchunk = np.pad(fchunk, pad)
        plan = None
        if self.use_plans:
            cap = E.auto_budget(chunk.size)
            # fill with the last row id, so the fill entries sort after
            # every real unique id
            hp = E.host_dedup(chunk, cap, fill=self.cfg.num_features - 1)
            if not hp.overflow:         # overflow -> exact scoring instead
                rung = E.ladder_budget(int(hp.count), cap=cap)
                plan = E.plan_to_device(
                    E.DedupBatch(uids=hp.uids[:rung], ranks=hp.ranks,
                                 count=hp.count, overflow=hp.overflow),
                    self.device)
        dev = self.device
        out = fm_model.predict(
            self.params, self.cfg, torch.as_tensor(chunk, device=dev),
            torch.as_tensor(vchunk, device=dev),
            None if fchunk is None else torch.as_tensor(fchunk, device=dev),
            plan=plan)
        return out[:n].cpu().numpy()

    def flush(self) -> List[np.ndarray]:
        """Score everything queued, one call per chunk of at most
        ``max_batch`` examples; returns one score array per submit(), in
        submit order. The queue is cleared only once every chunk has
        scored: if a chunk raises, every request stays queued."""
        if not self._sizes:
            return []
        ids = np.concatenate(self._ids, axis=0)
        vals = np.concatenate(self._vals, axis=0)
        fids = (np.concatenate(self._fids, axis=0)
                if self._fids[0] is not None else None)
        outs = []
        for s0 in range(0, ids.shape[0], self.max_batch):
            sl = slice(s0, s0 + self.max_batch)
            outs.append(self._score_chunk(
                ids[sl], vals[sl], None if fids is None else fids[sl]))
        flat = np.concatenate(outs)
        bounds = np.cumsum(self._sizes)[:-1]
        self._ids, self._vals, self._fids, self._sizes = [], [], [], []
        return np.split(flat, bounds)
