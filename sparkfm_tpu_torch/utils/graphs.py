"""Several train steps per dispatch: CUDA graphs of G steps, and the
pinned stage that feeds them.

Port of the JAX package's multi-steps
(``sparkfm_tpu/solvers/sgd_hybrid.py::make_hybrid_multi_step``,
``sgd_fused.py::make_fused_multi_step``), which scan G stacked batches in
one jitted dispatch. Here (:class:`MultiStep`):

- CPU tensors run the G steps one after another: the plain version;
- CUDA tensors run one ``torch.cuda.CUDAGraph`` of the G steps per input
  signature (the state's tensors, the batches' shapes and G: for ladder
  plans, one graph per rung and G), replayed for every later group of
  that signature. A signature's first group runs eagerly on a side
  stream before the capture. Those are that group's real steps, and they
  build the kernels, read the device's properties and fill the steps'
  lazy caches, so that nothing is built, looked up or copied from the
  host inside the capture. All graphs share one memory pool: they replay
  one after another on one stream, and no tensor allocated in a capture
  outlives it.

A graph reads its batches from static device buffers, one set per
signature, and writes each step's loss into a static (G,) buffer. The
trainer fills the batches from :class:`PinnedStage` by non-blocking
host-to-device copies; the API form (``MultiStep.__call__``) copies them
from a stacked batch already on the device. The steps update the table in
place (kernel B2). The bias, its slot and the step count, which an eager
step returns as new tensors, are copied into the state's own tensors at
the end of the group (:func:`run_steps`), so the graph's addresses stay
the state's. A graph records the kernel launches it captured and adds
them to the kernels' counts on every replay (``utils/build.py``), so a
count stays the number of times the kernel ran.
"""

from __future__ import annotations

import dataclasses
import math
import queue
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from sparkfm_tpu_torch.data.batching import SparseBatch
from sparkfm_tpu_torch.ops.embedding import DedupBatch
from sparkfm_tpu_torch.utils import profiling
from sparkfm_tpu_torch.utils.build import launch_counts

_BATCH = ("ids", "vals", "y", "mask", "field_ids")
_PLAN = ("uids", "ranks", "count", "order", "seg", "svals", "sex")
_SCALARS = ("w0", "slot_w0", "step")


def batch_fields(batch: SparseBatch) -> Dict[str, torch.Tensor]:
    """The batch's tensors by name, the plan's as ``plan.<field>``, its
    count as a tensor; the plan's overflow flag is left out (the host
    knows it before the dispatch)."""
    out = {name: getattr(batch, name) for name in _BATCH
           if getattr(batch, name) is not None}
    if batch.plan is not None:
        for name in _PLAN:
            x = getattr(batch.plan, name)
            if x is not None:
                out["plan." + name] = torch.as_tensor(x)
    return out


def batch_from_fields(fields: Dict[str, torch.Tensor],
                      overflow=None) -> SparseBatch:
    """The SparseBatch of :func:`batch_fields`' tensors."""
    plan = None
    if "plan.uids" in fields:
        plan = DedupBatch(**{name: fields.get("plan." + name)
                             for name in _PLAN}, overflow=overflow)
    return SparseBatch(**{name: fields.get(name) for name in _BATCH},
                       plan=plan)


def signature(fields: Dict[str, torch.Tensor]) -> tuple:
    """Names, shapes and dtypes: what a graph's static inputs fix."""
    return tuple((name, tuple(t.shape), t.dtype)
                 for name, t in fields.items())


def run_steps(step: Callable, state, batches: Iterable[SparseBatch]
              ) -> List[dict]:
    """Run ``step`` over ``batches`` one after another from the fused
    ``state``: the steps update its table in place, and the bias, its slot
    and the step count are copied into ``state``'s own tensors at the
    end. Returns each step's aux."""
    s, auxes = state, []
    for b in batches:
        s, aux = step(s, b)
        auxes.append(aux)
    for name in _SCALARS:
        getattr(state, name).copy_(getattr(s, name))
    return auxes


@dataclasses.dataclass
class _Group:
    """The static inputs and outputs of one signature's graph."""

    batches: List[Dict[str, torch.Tensor]]      # one dict of fields a step
    losses: torch.Tensor                        # (G,) float32
    graph: Optional[torch.cuda.CUDAGraph] = None
    launches: Optional[dict] = None             # kernel -> launches a replay


def capture(step: Callable, state, group: _Group, pool) -> None:
    """Run the group's steps eagerly on a side stream (they are the
    group's real steps and leave the state updated), then capture the same
    steps as ``group.graph``. The launches counted during the capture are
    taken back (it ran nothing) and kept in ``group.launches``, to be
    added on each replay."""
    device = state.table.device
    batches = [batch_from_fields(b) for b in group.batches]

    def body():
        for i, aux in enumerate(run_steps(step, state, batches)):
            group.losses[i].copy_(aux["loss"])

    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        body()
    current.wait_stream(side)
    group.graph, group.launches = record(body, pool)


def record(body: Callable, pool) -> tuple:
    """``body()`` captured as a ``torch.cuda.CUDAGraph`` in ``pool``:
    returns the graph and the kernel launches counted during the capture,
    which are taken back (it ran nothing), to be added on each
    :func:`replay`. The capture mode is thread-local, so that the
    prefetch thread goes on staging batches."""
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            body()
        after = launch_counts()
    finally:
        for kernel, n in before.items():
            kernel.launches = n
    return graph, {k: after[k] - n for k, n in before.items()
                   if after[k] != n}


def replay(graph: torch.cuda.CUDAGraph, launches: dict) -> None:
    """Replay ``graph`` and add its captured launches to the kernels'
    counts (:func:`record`)."""
    graph.replay()
    for kernel, n in launches.items():
        kernel.launches += n


class MultiStep:
    """G train steps per call, for a step ``(FusedState, SparseBatch) ->
    (FusedState, aux)`` (the hybrid or the fused step): the module doc
    says how. Call it as the JAX multi-step, ``multi(state, stacked)``, on
    a batch of :func:`stack_batches`; the trainer calls :meth:`run_staged`.
    Both update ``state``'s tensors in place and return aux with the last
    step's ``loss``, ``loss_mean`` (in float64, so that the group's mean
    logged once a step sums exactly to its steps' losses when G is a power
    of two) and ``unique_overflow`` (a host bool, ORed over the group).
    ``captures`` counts the graphs captured."""

    def __init__(self, step: Callable):
        self.step = step
        self.captures = 0
        self._groups: Dict[tuple, _Group] = {}
        self._pool = None

    def __call__(self, state, stacked: SparseBatch):
        fields = batch_fields(stacked)
        g = fields["ids"].shape[0]
        steps = [{name: t[i] for name, t in fields.items()}
                 for i in range(g)]

        def fill(static):
            for dst, src in zip(static, steps):
                for name, t in dst.items():
                    t.copy_(src[name])

        losses = self._run(state, signature(steps[0]), g, fill,
                           lambda: [batch_from_fields(s) for s in steps])
        overflow = (stacked.plan is not None
                    and bool(torch.as_tensor(stacked.plan.overflow).any()))
        return state, _aux(losses, overflow)

    def run_staged(self, state, stage: "PinnedStage",
                   staged: List["Staged"]) -> dict:
        """The steps of ``staged`` (batches of one signature from
        ``stage``), copied from their pinned buffers straight into the
        graph's static inputs. Returns the aux."""
        losses = self._run(
            state, staged[0].sig, len(staged),
            lambda static: [stage.load(s, dst)
                            for s, dst in zip(staged, static)],
            lambda: [stage.to_device(s) for s in staged])
        return _aux(losses, any(s.overflow for s in staged))

    def _run(self, state, sig: tuple, g: int, fill: Callable,
             eager: Callable) -> torch.Tensor:
        """The (G,) losses of G steps on ``state``: ``eager()`` gives the
        CPU path its batches; ``fill(static)`` writes a group's batches
        into a graph's static inputs."""
        device = state.table.device
        if device.type == "cpu":
            auxes = run_steps(self.step, state, eager())
            return torch.stack([a["loss"] for a in auxes])
        key = (tuple((t.data_ptr(), tuple(t.shape)) for t in (
            state.table, *(getattr(state, n) for n in _SCALARS))), sig, g)
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _Group(
                batches=[{name: torch.empty(shape, dtype=dtype,
                                            device=device)
                          for name, shape, dtype in sig}
                         for _ in range(g)],
                losses=torch.empty((g,), dtype=torch.float32,
                                   device=device))
        fill(group.batches)
        if group.graph is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            capture(self.step, state, group, self._pool)
            self.captures += 1
        else:
            replay(group.graph, group.launches)
        return group.losses.clone()


def _aux(losses: torch.Tensor, overflow: bool) -> dict:
    return {"loss": losses[-1], "loss_mean": losses.double().mean(),
            "unique_overflow": overflow}


def stack_batches(batches: List[SparseBatch]) -> SparseBatch:
    """Stack G batches of one shape (for ladder plans: one rung) into one
    with a leading (G,) dimension, on the first batch's device. The plans'
    counts become a (G,) tensor there and their overflow flags a (G,)
    numpy bool array (host plans know them)."""
    device = batches[0].ids.device
    fields = [batch_fields(b) for b in batches]
    stacked = {name: torch.stack([f[name].to(device) for f in fields])
               for name in fields[0]}
    overflow = None
    if batches[0].plan is not None:
        overflow = np.array([bool(b.plan.overflow) for b in batches])
    return batch_from_fields(stacked, overflow)


@dataclasses.dataclass
class Staged:
    """A host batch in a stage's buffer: its fields (views of the
    buffer), their signature, and the plan's overflow flag."""

    slot: "_Slot"
    fields: Dict[str, torch.Tensor]
    sig: tuple
    overflow: bool


class _Slot:
    """One batch's host buffers, one a field, grown as needed; ``done``
    is the event recorded behind the copies that last read them."""

    def __init__(self):
        self.buffers: Dict[str, torch.Tensor] = {}
        self.done: Optional[torch.cuda.Event] = None

    def view(self, name: str, shape, dtype, pin: bool) -> torch.Tensor:
        n = math.prod(shape)
        buf = self.buffers.get(name)
        if buf is None or buf.dtype != dtype or buf.numel() < n:
            buf = self.buffers[name] = torch.empty((max(n, 1),),
                                                   dtype=dtype,
                                                   pin_memory=pin)
        return buf[:n].view(shape)


class PinnedStage:
    """A ring of ``slots`` host buffers that batches pass through on their
    way to ``device``: pinned for a CUDA device, so that their copies run
    without the host, and plain host memory for the CPU. :meth:`fill`
    (run in the prefetch thread) writes each host batch into a free slot;
    :meth:`load` or :meth:`to_device` (run by the consumer) copies it to
    the device, records an event behind the copies on the current stream
    and frees the slot. A slot is written again only after that event has
    completed, so the producer never overwrites a buffer that a copy still
    reads. Slots in flight at once: those queued by the prefetch thread,
    those a consumer holds for a group and the one being written, so a
    ring of G + prefetch depth + 2 never starves."""

    def __init__(self, slots: int, device):
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        self._free: "queue.Queue[_Slot]" = queue.Queue()
        for _ in range(slots):
            self._free.put(_Slot())

    def fill(self, batches: Iterable[SparseBatch]) -> Iterator[Staged]:
        """Stage each batch of CPU tensors (with its host plan)."""
        for b in batches:
            slot = self._free.get()
            if slot.done is not None:
                slot.done.synchronize()
            fields = {name: slot.view(name, t.shape, t.dtype,
                                      self._pin).copy_(t)
                      for name, t in batch_fields(b).items()}
            yield Staged(slot=slot, fields=fields, sig=signature(fields),
                         overflow=(b.plan is not None
                                   and bool(b.plan.overflow)))

    def load(self, staged: Staged, dst: Dict[str, torch.Tensor]) -> None:
        """Copy the staged batch into the device tensors ``dst``."""
        for name, t in dst.items():
            src = staged.fields[name]
            profiling.count_h2d(src, t.device)
            t.copy_(src, non_blocking=True)
        self._release(staged.slot)

    def to_device(self, staged: Staged) -> SparseBatch:
        """The staged batch as a new SparseBatch on the device."""
        fields = {name: profiling.to_device(t, self.device,
                                            non_blocking=True, copy=True)
                  for name, t in staged.fields.items()}
        self._release(staged.slot)
        return batch_from_fields(fields, staged.overflow)

    def _release(self, slot: _Slot) -> None:
        if self._pin:
            if slot.done is None:
                slot.done = torch.cuda.Event()
            slot.done.record(torch.cuda.current_stream(self.device))
        self._free.put(slot)
