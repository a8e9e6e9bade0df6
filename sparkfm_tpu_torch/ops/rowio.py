"""Row gather ``out[r] = table[ids[r]]``: the unique-row read of the
serving path.

Port of ``sparkfm_tpu/ops/pallas_rowio.py::gather_rows`` /
``gather_rows_pallas``. The kernel is CUDA C++ for Hopper
(``csrc/rowio.cu``), compiled with ``nvcc`` at first use and bound with
ctypes. A CUDA tensor always goes to the kernel; if the kernel cannot be
built, the call raises. Only a tensor that lies on the CPU takes the plain
version, :func:`gather_rows_reference`, which is also the oracle the kernel
is held against on the card.

Unlike the TPU kernel, any width W >= 1 and any number of ids U work: no
128-lane rows and no padding of U to a tile.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from sparkfm_tpu_torch.utils.build import PACKAGE_DIR, build_shared_library

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "rowio.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


class CudaGather:
    """The gather kernel's library, built at first use, and the count of
    its launches (one per call of :meth:`launch`)."""

    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()
        self.path = None
        self.launches = 0

    def build(self) -> ctypes.CDLL:
        """Compile (or reuse) and load the library; raises
        ``BuildError`` when ``nvcc`` is missing or fails."""
        with self._lock:
            if self._lib is None:
                path = build_shared_library("rowio", [SOURCE], _nvcc(),
                                            NVCC_FLAGS)
                lib = ctypes.CDLL(path)
                lib.sfm_gather_rows.restype = ctypes.c_int
                lib.sfm_gather_rows.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_void_p]
                lib.sfm_error_string.restype = ctypes.c_char_p
                lib.sfm_error_string.argtypes = [ctypes.c_int]
                self.path, self._lib = path, lib
            return self._lib

    def launch(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Gather on ``table``'s card, on the current stream. Inputs must
        already have passed :func:`_check`."""
        lib = self.build()
        out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                          device=table.device)
        with torch.cuda.device(table.device):
            stream = torch.cuda.current_stream(table.device).cuda_stream
            err = lib.sfm_gather_rows(
                table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                table.shape[0], table.shape[1], ids.shape[0], stream)
        if err != 0:
            raise RuntimeError("gather_rows kernel launch failed: "
                               + lib.sfm_error_string(err).decode())
        self.launches += 1
        return out


GATHER = CudaGather()


def gather_rows_reference(table: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """Plain version: ``table[ids]`` by ``index_select``."""
    return table.index_select(0, ids.long())


def _check(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError("gather_rows takes a 2-D float32 table, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError("gather_rows takes 1-D int32 ids, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if table.device != ids.device:
        raise ValueError(f"table on {table.device}, ids on {ids.device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("gather_rows takes contiguous table and ids")


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(U, W) rows ``table[ids]`` for a (R, W) float32 table and (U,)
    int32 ids in [0, R). CUDA tensors run the kernel (which traps on an id
    out of range); CPU tensors run the plain version."""
    _check(table, ids)
    if table.device.type == "cpu":
        return gather_rows_reference(table, ids)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows has no kernel for {table.device}")
    if ids.shape[0] == 0:
        return table.new_empty((0, table.shape[1]))
    return GATHER.launch(table, ids)
