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
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from typing import Sequence

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")


class BuildError(RuntimeError):
    """The compiler is missing or refused the source."""


def build_shared_library(name: str, sources: Sequence[str], compiler: str,
                         flags: Sequence[str], timeout: float = 600.0) -> str:
    """Compile ``sources`` into ``BUILD_DIR/<name>-<hash>.so``; return the
    path. Reuses an existing build of the same sources and flags."""
    digest = hashlib.sha256(" ".join([compiler, *flags]).encode())
    for src in sources:
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
