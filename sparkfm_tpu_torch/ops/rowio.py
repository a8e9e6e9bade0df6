"""Row gather ``out[r] = table[ids[r]]`` and row write ``table[ids[r]] =
rows[r]``: the unique-row read and write-back of the serving and training
paths.

Port of ``sparkfm_tpu/ops/pallas_rowio.py``: ``gather_rows`` /
``gather_rows_pallas`` and ``scatter_set`` / ``scatter_set_rows``. Both
kernels are CUDA C++ for Hopper (``csrc/rowio.cu``), compiled with
``nvcc`` at first use and bound with ctypes. A CUDA tensor always goes to
the kernel; if the kernel cannot be built, the call raises. Only tensors
that lie on the CPU take the plain versions, :func:`gather_rows_reference`
and :func:`scatter_set_rows_reference`, which are also the oracles the
kernels are held against on the card.

Unlike the TPU kernels, any width W >= 1 and any number of ids U work: no
128-lane rows and no padding of U to a tile (the write takes W <= 2^24 on
the card).

The write keeps the first row of each run of equal ids: slot r writes only
if r == 0 or ids[r] != ids[r - 1]. The ids are unique except for the
plan's fill row, which the unused budget slots at the tail of the
ascending uids repeat, so the fill row is written once, with the first of
those slots' rows, on the card and on the CPU alike.
"""

from __future__ import annotations

import ctypes
import os

import torch

from sparkfm_tpu_torch.utils.build import PACKAGE_DIR, CudaKernel

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "rowio.cu")
MAX_WRITE_WIDTH = 1 << 24  # scatter_set_rows' largest W on the card
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
GATHER = CudaKernel("rowio", SOURCE, "sfm_gather_rows", _ARGS)
SCATTER = CudaKernel("rowio", SOURCE, "sfm_scatter_rows", _ARGS)


def gather_rows_reference(table: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """Plain version: ``table[ids]`` by ``index_select``."""
    return table.index_select(0, ids.long())


def scatter_set_rows_reference(table: torch.Tensor, ids: torch.Tensor,
                               rows: torch.Tensor) -> torch.Tensor:
    """Plain version: keep the first slot of each run of equal ids, then
    ``table[ids] = rows`` in place by ``index_copy_``."""
    keep = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    keep[1:] = ids[1:] != ids[:-1]
    return table.index_copy_(0, ids[keep].long(), rows[keep])


def _check(name: str, table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"{name} takes a 2-D float32 table, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"{name} takes 1-D int32 ids, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device}, ids on {ids.device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f"{name} takes contiguous table and ids")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no kernel for {table.device}")


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(U, W) rows ``table[ids]`` for a (R, W) float32 table and (U,)
    int32 ids in [0, R). CUDA tensors run the kernel (which traps on an id
    out of range); CPU tensors run the plain version."""
    _check("gather_rows", table, ids)
    if table.device.type == "cpu":
        return gather_rows_reference(table, ids)
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if ids.shape[0] == 0:
        return out
    GATHER.launch(table.device, table.data_ptr(), ids.data_ptr(),
                  out.data_ptr(), table.shape[0], table.shape[1],
                  ids.shape[0])
    return out


def scatter_set_rows(table: torch.Tensor, ids: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """Write ``rows[r]`` to ``table[ids[r]]`` IN PLACE and return
    ``table``: (R, W) float32 table, (U,) int32 ids in [0, R), (U, W)
    float32 rows. The JAX package donates the table and gets a new array;
    the port overwrites the rows of the one it has.

    Ids must be unique except for a repeated fill row (the dedup plan's
    unused budget slots, adjacent at the tail of the ascending uids). Slot
    r writes only if r == 0 or ``ids[r] != ids[r - 1]``, so the fill row
    gets the first of its slots' rows; the JAX package leaves it
    unspecified. CUDA tensors run the kernel (which traps on an id out of
    range); CPU tensors run the plain version.
    """
    _check("scatter_set_rows", table, ids)
    if rows.shape != (ids.shape[0], table.shape[1]) or (
            rows.dtype != torch.float32):
        raise ValueError("scatter_set_rows takes (U, W) float32 rows for "
                         f"U={ids.shape[0]} ids and W={table.shape[1]}, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    if rows.device != table.device or not rows.is_contiguous():
        raise ValueError("scatter_set_rows takes contiguous rows on the "
                         f"table's device {table.device}")
    if table.device.type == "cuda" and table.shape[1] > MAX_WRITE_WIDTH:
        raise ValueError(f"the write kernel takes W <= {MAX_WRITE_WIDTH}, "
                         f"got W={table.shape[1]}")
    if table.device.type == "cpu":
        return scatter_set_rows_reference(table, ids, rows)
    if ids.shape[0]:
        SCATTER.launch(table.device, table.data_ptr(), ids.data_ptr(),
                       rows.data_ptr(), table.shape[0], table.shape[1],
                       ids.shape[0])
    return table
