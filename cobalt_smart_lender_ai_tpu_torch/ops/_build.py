"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``_build/<name>-<md5>.so`` inside the package (the digest covers the
source and the flags, so an edit rebuilds). Nothing is built at import time:
the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: Compiler output of each build done by this process (``-Xptxas=-v`` lists
#: every kernel's registers, shared memory and spills).
build_log: dict[str, str] = {}
#: nvcc wall seconds of each build done by this process.
build_seconds: dict[str, float] = {}
#: Libraries whose build seconds a program handle has taken.
_TAKEN: set[str] = set()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda/bin); "
        "the CUDA kernels are built on the machine with the GPU"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the md5 of source + flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.md5(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed library exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{build_log[name]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib


def take_build_seconds(name: str) -> float:
    """The nvcc seconds of this process's build of ``name`` the first time
    they are asked for, then 0 (0 too when the library came from
    ``_build/``): the program registry books a library's build once."""
    with _LOCK:
        if name in _TAKEN:
            return 0.0
        _TAKEN.add(name)
        return build_seconds.get(name, 0.0)


def build_stats() -> dict[str, float]:
    """This process's kernel builds — the run ledger's ``compile`` block:
    libraries built by nvcc, their wall seconds, libraries loaded."""
    return {
        "kernel_builds": len(build_seconds),
        "kernel_build_seconds": round(sum(build_seconds.values()), 6),
        "kernels_loaded": len(_LIBS),
    }
