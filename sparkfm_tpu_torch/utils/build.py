"""Build a shared library from the repository's own sources at first use.

Used by the CUDA kernels (``nvcc``) and by the host dedup-plan builder
(``g++``). The library lands in ``sparkfm_tpu_torch/build/`` (git-ignored)
under a name that carries a hash of its sources and its command line, so
an edited source gets a fresh build and a stale binary is never loaded. A
file lock serialises processes that build at the same moment, and the
compiler writes to a temporary name that is renamed into place only when
it succeeds, so a reader never sees a half-written library. The
compiler's output (for ``nvcc -Xptxas -v``: registers, shared memory and
spills per kernel) is kept beside the library as ``<name>.log``.

:class:`CudaKernel` binds one ``extern "C"`` launcher of a CUDA source
under ``csrc/`` and counts its launches, those replayed in CUDA graphs
included (:func:`launch_counts`, ``utils/graphs.py``).
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Sequence

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildError(RuntimeError):
    """The compiler is missing or refused the source."""


def build_shared_library(name: str, sources: Sequence[str], compiler: str,
                         flags: Sequence[str], timeout: float = 600.0,
                         headers: Sequence[str] = ()) -> str:
    """Compile ``sources`` into ``BUILD_DIR/<name>-<hash>.so``; return the
    path. Reuses an existing build of the same sources, ``headers`` (files
    the sources include) and flags."""
    digest = hashlib.sha256(" ".join([compiler, *flags]).encode())
    for src in [*sources, *headers]:
        with open(src, "rb") as f:
            digest.update(f.read())
    stem = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}")
    path = stem + ".so"
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):        # another process built it meanwhile
            return path
        tmp = f"{stem}.{os.getpid()}.tmp.so"
        cmd = [compiler, *flags, "-o", tmp, *sources]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout)
        except FileNotFoundError as e:
            raise BuildError(f"cannot build {name}: compiler {compiler!r} "
                             "not found") from e
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise BuildError(f"cannot build {name}: {' '.join(cmd)} exited "
                             f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
        with open(stem + ".log", "w") as log:
            log.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        os.replace(tmp, path)
    return path


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on the PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


class CudaKernel:
    """One kernel launcher of a CUDA source under ``csrc/``.

    The source's library is compiled with ``nvcc`` at first use (sources
    sharing a library name share one build; the ``*.cuh`` headers beside
    the source count as part of it) and bound with ctypes. The launcher is
    an ``extern "C"`` function taking ``argtypes``, then the card's SM
    count (looked up once per device) and the stream, and returning a
    ``cudaError_t`` (0 on success).
    ``launches`` counts the calls of :meth:`launch`, one per launch of the
    kernel, and nowhere else; a CUDA graph that captured launches adds
    them back on each replay (``utils/graphs.py``), so the count stays
    the number of times the kernel ran. Neither the build nor the SM
    count lookup may happen while a stream captures: a step is run once
    eagerly before it is captured.
    """

    instances: list = []        # every kernel, for launch_counts()

    def __init__(self, library: str, source: str, symbol: str,
                 argtypes: Sequence):
        self.library, self.source, self.symbol = library, source, symbol
        self.argtypes = list(argtypes)
        self._lib = None
        self._lock = threading.Lock()
        self._num_sms = {}
        self.path = None
        self.launches = 0
        CudaKernel.instances.append(self)

    def build(self) -> ctypes.CDLL:
        """Compile (or reuse) and load the library; raises
        ``BuildError`` when ``nvcc`` is missing or fails."""
        with self._lock:
            if self._lib is None:
                if _capturing():
                    raise RuntimeError(
                        f"{self.symbol}: building inside a CUDA graph "
                        "capture; run the step once before capturing it")
                headers = sorted(glob.glob(os.path.join(
                    os.path.dirname(self.source), "*.cuh")))
                path = build_shared_library(self.library, [self.source],
                                            nvcc(), NVCC_FLAGS,
                                            headers=headers)
                lib = ctypes.CDLL(path)
                fn = getattr(lib, self.symbol)
                fn.restype = ctypes.c_int
                fn.argtypes = [*self.argtypes, ctypes.c_int,
                               ctypes.c_void_p]
                lib.sfm_error_string.restype = ctypes.c_char_p
                lib.sfm_error_string.argtypes = [ctypes.c_int]
                self.path, self._lib = path, lib
            return self._lib

    def num_sms(self, device: torch.device) -> int:
        """The SM count of ``device``, looked up once per device."""
        num_sms = self._num_sms.get(device.index)
        if num_sms is None:
            if _capturing():
                raise RuntimeError(
                    f"{self.symbol}: device properties read inside a CUDA "
                    "graph capture; run the step once before capturing it")
            num_sms = torch.cuda.get_device_properties(
                device).multi_processor_count
            self._num_sms[device.index] = num_sms
        return num_sms

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raises if the launch
        was refused. Arguments must already have been checked."""
        lib = self.build()
        num_sms = self.num_sms(device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, self.symbol)(*args, num_sms, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} kernel launch failed: "
                               + lib.sfm_error_string(err).decode())
        self.launches += 1


def launch_counts() -> dict:
    """Every kernel's launch count, keyed by kernel."""
    return {k: k.launches for k in CudaKernel.instances}
