"""The (data, model) process mesh and its collectives. Port of
``sparkfm_tpu/parallel/mesh.py`` onto ``torch.distributed``.

One process hosts one rank. The mesh is a ``DeviceMesh`` of shape
(data, model) over the ranks of the process group, with
``mesh_dim_names=("data", "model")``:

- ``data`` splits the examples of a batch (data parallelism);
- ``model`` splits the rows of the w/V tables: feature f lives on model
  shard f // rows_per_shard, so no rank holds a whole 2^24-row table.

The collectives below mirror the JAX names (``psum``, ``pmax``,
``all_gather``, ``axis_index``) and take the mesh and the axis, as a JAX
collective takes its axis name inside ``shard_map``. They are the only
calls of ``torch.distributed`` outside ``parallel/multihost.py``. The
backend is NCCL for tensors on the card and gloo on the CPU
(``multihost.initialize``); tensors live on :func:`device_of` the mesh.

In place of the JAX partition specs, the partition helpers slice one
rank's part of a host array: :func:`row_shard` its rows of a padded table,
:func:`data_slice` its rows of a batch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sparkfm_tpu_torch.config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"
Axes = Union[str, Sequence[str]]


def make_mesh(data: int = -1, model: int = 1, *, device="cuda",
              backend: Optional[str] = None) -> DeviceMesh:
    """The (data, model) mesh over every rank of the process group.

    ``data=-1`` takes all the ranks that ``model`` leaves. Without a
    process group, a 1 x 1 mesh starts a group of one rank (NCCL on the
    card, gloo on the CPU, or ``backend``); any larger mesh raises and
    names the world size it needs: a one-process run never shrinks the
    mesh it was asked for. With a group, data x model must equal its
    world size."""
    from sparkfm_tpu_torch.parallel import multihost
    if data == 0 or model < 1 or data < -1:
        raise ValueError(f"mesh ({data}x{model}): sizes must be positive")
    if not dist.is_initialized():
        if max(data, 1) * model != 1:
            raise ValueError(
                f"mesh ({data}x{model}) needs a world of "
                f"{max(data, 1) * model} processes (one rank each), but no "
                "process group is running: launch it under torchrun "
                "(--distributed on the command line) or through "
                "parallel.multihost.spawn")
        multihost.initialize(world_size=1, rank=0, device=device,
                             backend=backend)
    world = dist.get_world_size()
    if data == -1:
        if world % model:
            raise ValueError(f"{world} ranks not divisible by model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh ({data}x{model}) needs a world of "
                         f"{data * model} processes, this one has {world}")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(world).view(data, model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_from_config(cfg: MeshConfig, *, device="cuda") -> DeviceMesh:
    return make_mesh(cfg.data, cfg.model, device=device)


def resolve_mesh(mesh, *, device="cuda") -> tuple:
    """(DeviceMesh, exchange) for a trainer's ``mesh``: a ``DeviceMesh``
    as it is (exchange "auto"), a ``MeshConfig`` (its exchange) or a "DxM"
    string."""
    if isinstance(mesh, DeviceMesh):
        return mesh, "auto"
    if isinstance(mesh, MeshConfig):
        return mesh_from_config(mesh, device=device), mesh.exchange
    if isinstance(mesh, str):
        d, m = (int(x) for x in mesh.lower().split("x"))
        return make_mesh(d, m, device=device), "auto"
    raise ValueError(f"mesh must be a DeviceMesh, a MeshConfig or a 'DxM' "
                     f"string; got {mesh!r}")


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n (row-shard size alignment)."""
    return ((n + m - 1) // m) * m


def size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(axis: str, mesh: DeviceMesh) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def device_of(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on: its current card, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axes(axis: Axes):
    return (axis,) if isinstance(axis, str) else tuple(axis)


def psum(x: torch.Tensor, axis: Axes, mesh: DeviceMesh) -> torch.Tensor:
    """Sum ``x`` over the ranks along ``axis`` (a name or several), IN
    PLACE: ``x`` itself holds the sum and is returned."""
    for a in _axes(axis):
        dist.all_reduce(x, group=mesh.get_group(a))
    return x


def pmax(x: torch.Tensor, axis: Axes, mesh: DeviceMesh) -> torch.Tensor:
    """The largest ``x`` over the ranks along ``axis``, in place."""
    for a in _axes(axis):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    return x


def all_gather(x: torch.Tensor, axis: str, mesh: DeviceMesh,
               tiled: bool = True) -> torch.Tensor:
    """The ``x`` of every rank along ``axis``, in rank order: concatenated
    on the leading dimension (``tiled``) or stacked on a new one."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size(mesh, axis))]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts) if tiled else torch.stack(parts)


def any_rank(flag: bool, mesh: DeviceMesh) -> bool:
    """True on every rank iff ``flag`` is true on some rank: a decision
    (a time budget reached) that all ranks must take together."""
    t = torch.tensor([int(bool(flag))], device=device_of(mesh))
    return bool(pmax(t, (DATA_AXIS, MODEL_AXIS), mesh).item())


def rows_per_shard(num_rows: int, mesh: DeviceMesh) -> int:
    msize = size(mesh, MODEL_AXIS)
    if num_rows % msize:
        raise ValueError(f"{num_rows} table rows not divisible by the model "
                         f"axis ({msize}); pad with init_sharded_state")
    return num_rows // msize


def row_shard(x, mesh: DeviceMesh):
    """This rank's rows of a (padded) table: the ``model`` coordinate's
    contiguous block of rows_per_shard rows."""
    per = rows_per_shard(x.shape[0], mesh)
    m = axis_index(MODEL_AXIS, mesh)
    return x[m * per:(m + 1) * per]


def data_slice(n_global: int, mesh: DeviceMesh) -> slice:
    """This rank's contiguous rows of a global batch of ``n_global``: the
    ``data`` coordinate's block. Ranks that share it (the model shards)
    hold the same rows."""
    d = size(mesh, DATA_AXIS)
    if n_global % d:
        raise ValueError(f"batch of {n_global} rows not divisible by the "
                         f"data axis ({d})")
    per = n_global // d
    i = axis_index(DATA_AXIS, mesh)
    return slice(i * per, (i + 1) * per)
