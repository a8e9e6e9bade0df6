"""CUDA graphs of train steps: the one cache that captures and replays
them (:class:`GraphCache`), and several steps per dispatch on it.

Port of the JAX package's multi-steps
(``sparkfm_tpu/solvers/sgd_hybrid.py::make_hybrid_multi_step``,
``sgd_fused.py::make_fused_multi_step``), which scan G stacked batches in
one jitted dispatch. Here (:class:`MultiStep`):

- CPU tensors run the G steps one after another: the plain version;
- CUDA tensors run one ``torch.cuda.CUDAGraph`` of the G steps per input
  signature (the state's tensors, the batches' shapes and G: for ladder
  plans, one graph per rung and G), replayed for every later group of
  that signature.

A :class:`GraphCache` holds the graphs of one step function, keyed by the
addresses of every tensor of the state (:func:`state_tensors`) and the
names, shapes and dtypes of the static inputs. A key's first call runs the
step eagerly on a side stream: those are that call's real steps, and they
build the kernels, read the device's properties and fill the steps' lazy
caches, so that nothing is built, looked up or copied from the host inside
the capture. Then its phases are captured, one graph each (DeepFM's step
has four, ``models/deepfm.py::make_train_step``; a multi-step one). Later
calls copy their inputs into the static ones and replay the phases. All
graphs of a cache share one memory pool: they replay one after another on
one stream, and only the static outputs, cloned after each replay,
outlive a capture. A graph records the kernel launches it captured and
adds them to the kernels' counts on every replay (``utils/build.py``), so
a count stays the number of times the kernel ran.

The multi-step's steps update the table in place (kernel B2). The bias,
its slot and the step count, which an eager step returns as new tensors,
are copied into the state's own tensors at the end of the group
(:func:`run_steps`), so the graph's addresses stay the state's.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence

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


def signature(fields: Dict) -> tuple:
    """Names, shapes and dtypes: what a graph's static inputs fix."""
    return tuple((name, tuple(t.shape), t.dtype)
                 for name, t in fields.items())


def state_tensors(state, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every tensor of a train state by its dotted path, in order: those
    of its dataclass fields, list or tuple items (by index) and module
    parameters (``FMParams``: ``w0``, ``w``, ``v``), so ``table`` of a
    ``FusedState``, ``params.v`` of an ``SGDState``, ``fm.step`` and
    ``mlp_w.0`` of a ``DeepFMState``. A captured step reads and writes
    them all (:class:`GraphCache` keys on their addresses);
    ``utils/checkpoint.py`` saves them under these names."""
    if isinstance(state, (list, tuple)):
        items = enumerate(state)
    elif isinstance(state, torch.nn.Module):
        items = state.named_parameters(recurse=False)
    elif dataclasses.is_dataclass(state):
        items = vars(state).items()         # its fields, in order
    else:
        return {}
    out = {}
    for name, x in items:
        if isinstance(x, torch.Tensor):
            out[prefix + str(name)] = x
        else:
            out.update(state_tensors(x, prefix + str(name) + "."))
    return out


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


def record(body: Callable, pool) -> tuple:
    """``body()`` captured as a ``torch.cuda.CUDAGraph`` in ``pool``:
    returns the graph and the kernel launches counted during the capture,
    which are taken back (it ran nothing), to be added on each
    :func:`replay`. The capture mode is thread-local, so that the
    prefetch thread goes on building batches."""
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


@dataclasses.dataclass
class Captured:
    """One key's static inputs, a ``(graph, launches)`` pair a phase, and
    the static outputs that the last phase yielded."""

    inputs: Dict[str, torch.Tensor]
    graphs: list
    outputs: object


class GraphCache:
    """The CUDA graphs of one step function, one set a key (the module doc
    says how). Call it as ``cache(state, inputs, phases)``:

    - ``inputs``: the call's tensors by name, copied into static tensors
      of the same names, shapes and dtypes without blocking (a host
      tensor, such as a host plan's count, from pinned memory);
    - ``drawn``: (name, shape, dtype) of more static inputs, which
      ``before(i, static)`` writes before phase i (DeepFM's dropout draws);
    - ``phases(static)``: a generator of the step over the static inputs
      and ``state``, yielding after each phase; the last yield gives the
      outputs, a tensor or a dict of tensors;
    - ``spans``: a name a phase, each phase run inside its span
      (``utils/profiling.py::annotate``, with device times); without
      them the step is one phase.

    Returns the outputs: a key's first call the eager run's, every later
    one the static outputs cloned. ``entries`` holds the captured keys."""

    def __init__(self):
        self.entries: Dict[tuple, Captured] = {}
        self._pool = None

    def __call__(self, state, inputs: Dict[str, torch.Tensor],
                 phases: Callable, *, drawn: Sequence[tuple] = (),
                 before: Optional[Callable] = None,
                 spans: Sequence[str] = ()):
        sig = signature(inputs) + tuple(drawn)
        key = (tuple((t.data_ptr(), t.shape)
                     for t in state_tensors(state).values()), sig)
        entry = self.entries.get(key)
        device = next(iter(inputs.values())).device
        static = entry.inputs if entry else {
            name: torch.empty(shape, dtype=dtype, device=device)
            for name, shape, dtype in sig}
        for name, x in inputs.items():
            profiling.count_h2d(x, device)
            static[name].copy_(x, non_blocking=True)
        steps = range(max(len(spans), 1))
        if entry is not None:
            for i, (graph, launches) in zip(steps, entry.graphs):
                with _span(spans, i):
                    if before is not None:
                        before(i, static)
                    replay(graph, launches)
            if isinstance(entry.outputs, dict):
                return {name: x.clone() for name, x in entry.outputs.items()}
            return entry.outputs.clone()
        # the first call: eagerly on a side stream, ordered after and
        # before the current stream's work; then each phase recorded
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        run = phases(static)
        with torch.cuda.stream(side):
            for i in steps:
                with _span(spans, i):
                    if before is not None:
                        before(i, static)
                    out = next(run)
        current.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        run, outs = phases(static), []
        recorded = [record(lambda: outs.append(next(run)), self._pool)
                    for _ in steps]
        self.entries[key] = Captured(static, recorded, outs[-1])
        return out


def _span(spans: Sequence[str], i: int):
    if not spans:
        return contextlib.nullcontext()
    return profiling.annotate(spans[i], device=True)


class MultiStep:
    """G train steps per call, for a step ``(FusedState, SparseBatch) ->
    (FusedState, aux)`` (the hybrid or the fused step): the module doc
    says how. Call it as the JAX multi-step, ``multi(state, stacked)``, on
    a batch of :func:`stack_batches`, or on the G batches themselves,
    ``multi.run(state, batches)``, which the trainer does: the cache
    copies them straight into the graph's static inputs. Both update
    ``state``'s tensors in place and return ``(state, aux)``, aux with the
    last step's ``loss``, ``loss_mean`` (in float64, so that the group's
    mean logged once a step sums exactly to its steps' losses when G is a
    power of two) and ``unique_overflow`` (a host bool, ORed over the
    group). ``captures`` counts the graphs captured; ``graphs`` is their
    cache."""

    def __init__(self, step: Callable):
        self.step = step
        self.graphs = GraphCache()

    @property
    def captures(self) -> int:
        return len(self.graphs.entries)

    def __call__(self, state, stacked: SparseBatch):
        fields = batch_fields(stacked)
        overflow = (stacked.plan is not None
                    and bool(torch.as_tensor(stacked.plan.overflow).any()))
        return self._run(state, [{name: t[i] for name, t in fields.items()}
                                 for i in range(fields["ids"].shape[0])],
                         overflow)

    def run(self, state, batches: List[SparseBatch]):
        """The steps of ``batches``, G batches of one signature."""
        overflow = (batches[0].plan is not None
                    and any(bool(b.plan.overflow) for b in batches))
        return self._run(state, [batch_fields(b) for b in batches], overflow)

    def _run(self, state, steps: List[Dict[str, torch.Tensor]],
             overflow: bool):
        g = len(steps)
        if state.table.device.type == "cpu":
            losses = self._losses(state, [batch_from_fields(f)
                                          for f in steps])
        else:
            # one static tensor a step and field, each aligned as the
            # kernels' vector loads need
            losses = self.graphs(
                state, {(i, name): t for i, f in enumerate(steps)
                        for name, t in f.items()},
                lambda static: self._phase(state, static, g))
        return state, {"loss": losses[-1],
                       "loss_mean": losses.double().mean(),
                       "unique_overflow": overflow}

    def _phase(self, state, static, g: int):
        yield self._losses(state, [
            batch_from_fields({name: t for (j, name), t in static.items()
                               if j == i}) for i in range(g)])

    def _losses(self, state, batches: List[SparseBatch]) -> torch.Tensor:
        return torch.stack([a["loss"]
                            for a in run_steps(self.step, state, batches)])


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
