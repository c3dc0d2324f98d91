"""Build the port's CUDA sources into shared libraries with a C interface.

nvcc compiles ``csrc/*.cu`` by hand for Hopper (``sm_90a``) into
``hammlet_tpu_torch/build/``, at first use, keyed by a hash of the sources
and flags, so a fresh checkout builds itself. The libraries are loaded with
ctypes: no PyTorch headers are compiled, which keeps a build to seconds.
A missing nvcc or a failed build raises; nothing falls back to a plain
version. Library loads of one process take ``LOCK`` (chains of ``-M`` run
in threads and may reach a kernel's first use together); builds of one
library take that library's own lock, so two libraries build side by side.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

#: held around every first library load in this process; reentrant so that
#: a loader can build under it
LOCK = threading.RLock()

#: one lock per library name, held around its build
_BUILD_LOCKS: dict[str, threading.Lock] = {}
_BUILD_LOCKS_LOCK = threading.Lock()

#: ``-Xptxas=-v`` only prints each kernel's registers, shared memory and
#: spills into the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built"
    )


class BuildResult(NamedTuple):
    """Where a library was built, how long nvcc took (0 when it was already
    built), and nvcc's log."""

    path: Path
    seconds: float
    log: str


def build(name: str, sources: list[Path]) -> BuildResult:
    """Compile ``sources`` into ``build/lib{name}-{hash}.so`` unless a
    library of the same sources and flags is already there. Threads of one
    process build one library one at a time, and different libraries at
    once; processes write their own temporary file and rename it into
    place."""
    with _BUILD_LOCKS_LOCK:
        lock = _BUILD_LOCKS.setdefault(name, threading.Lock())
    with lock:
        return _build_locked(name, sources)


def _build_locked(name: str, sources: list[Path]) -> BuildResult:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}-{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in sources)],
        capture_output=True,
        text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return BuildResult(out, seconds, proc.stdout + proc.stderr)
