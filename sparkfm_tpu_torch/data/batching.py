"""Fixed-shape sparse batches and host-side batching. Port of
``sparkfm_tpu/data/batching.py``.

Examples are padded CSR: ids (B, L) int32, vals (B, L) float32, y (B,).
A padded slot has val == 0, an exact no-op for FM, so the forward needs
no mask; the tail batch is padded to the batch size and masked.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from sparkfm_tpu_torch.ops import embedding as E


@dataclasses.dataclass
class SparseBatch:
    """One batch of examples, as tensors on one device."""

    ids: torch.Tensor                        # (B, L) int32
    vals: torch.Tensor                       # (B, L) float32
    y: torch.Tensor                          # (B,) float32
    mask: Optional[torch.Tensor] = None      # (B,) bool, False = padding
    field_ids: Optional[torch.Tensor] = None  # (B, L) int32
    plan: Optional[E.DedupBatch] = None      # host dedup plan, on device


@dataclasses.dataclass
class SparseDataset:
    """A whole dataset as padded-CSR numpy arrays on the host."""

    ids: np.ndarray                  # (N, L) int32
    vals: np.ndarray                 # (N, L) float32
    y: np.ndarray                    # (N,) float32
    num_features: int
    field_ids: Optional[np.ndarray] = None  # (N, L) int32

    @property
    def num_examples(self) -> int:
        return self.ids.shape[0]

    @property
    def max_nnz(self) -> int:
        return self.ids.shape[1]

    def slice(self, idx: np.ndarray) -> "SparseDataset":
        return SparseDataset(
            ids=self.ids[idx], vals=self.vals[idx], y=self.y[idx],
            num_features=self.num_features,
            field_ids=None if self.field_ids is None else self.field_ids[idx])


def batch_iterator(ds: SparseDataset, batch_size: int, *, device,
                   shuffle: bool = False, seed: int = 0,
                   drop_remainder: bool = False, epoch: int = 0,
                   dedup_budget=None,
                   dedup_fill: Optional[int] = None) -> Iterator[SparseBatch]:
    """Yield fixed-shape SparseBatches on ``device``; the tail batch is
    padded and masked, or dropped with ``drop_remainder``.

    ``shuffle`` permutes the examples with a generator keyed by
    ``(seed, epoch)``, the same order as the JAX package's iterator.

    With ``dedup_budget`` and ``dedup_fill`` set, each batch carries a
    host dedup plan (``ops.embedding.host_dedup``): its unique ids, the
    slots' ranks, and the id-sorted ``order/seg/svals/sex`` that the
    hybrid train step's backward reads. An integer budget fixes the plan's
    size; ``"ladder"`` sizes it to the batch's unique count rounded up to
    a ladder rung (``ladder_budget``). Rungs only grow within one
    iterator, so the plan shapes settle on one or two.
    """
    ladder = dedup_budget == "ladder"
    if not (dedup_budget is None or ladder or (
            isinstance(dedup_budget, (int, np.integer))
            and not isinstance(dedup_budget, bool) and dedup_budget > 0)):
        raise ValueError("dedup_budget must be None, a positive int or "
                         f"'ladder', got {dedup_budget!r}")
    n = ds.num_examples
    order = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        rng.shuffle(order)
    plans = dedup_budget is not None and dedup_fill is not None
    ladder_cap = E.auto_budget(batch_size * ds.max_nnz)
    rung = 1
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        b = len(idx)
        if b < batch_size:
            if drop_remainder:
                return
            idx = np.concatenate([idx, np.zeros((batch_size - b,), np.int64)])
        mask = np.zeros((batch_size,), bool)
        mask[:b] = True
        ids_np = ds.ids[idx]
        vals_np = ds.vals[idx] * mask[:, None]
        plan = None
        if plans:
            hp = E.host_dedup(ids_np, ladder_cap if ladder else dedup_budget,
                              dedup_fill, vals=vals_np)
            if ladder:
                rung = max(rung, E.ladder_budget(int(hp.count),
                                                 cap=ladder_cap))
                hp = hp._replace(uids=hp.uids[:rung])
            plan = E.plan_to_device(hp, device)
        yield SparseBatch(
            ids=torch.as_tensor(ids_np, device=device),
            vals=torch.as_tensor(vals_np, device=device),
            y=torch.as_tensor(ds.y[idx] * mask, device=device),
            mask=torch.as_tensor(mask, device=device),
            field_ids=(None if ds.field_ids is None
                       else torch.as_tensor(ds.field_ids[idx],
                                            device=device)),
            plan=plan)


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded queue, so
    batch assembly, plan building and host-to-device copies overlap the
    consumer's work. An exception in the worker is raised in the
    consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:      # re-raised in the consumer below
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            t.join()
            if err:
                raise err[0]
            return
        yield item
