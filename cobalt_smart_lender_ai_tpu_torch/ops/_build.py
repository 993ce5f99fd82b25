"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use into ``<cache>/<name>-<md5>.so``. The digest covers the source, the
flags and the compiler's identity (`compiler_identity`: its ``--version``
and the host's machine type), so an edit, another toolkit or another host
architecture rebuilds rather than loading a library it did not build. The
cache directory is the package's ``_build/`` unless
`compilecache.bootstrap_compile_cache` chose another.
Nothing is built at import time: the CPU tests import every module of the
port.

`resolve_library` is the build cache that this module's `build` and the g++
reader (`native`) share: a library found in the cache directory is a hit;
one not found is a miss, compiled beside it under a temporary name, its
compiler seconds written to ``<library>.json`` (and kept in
`build_seconds`, which `build_stats` and the program registry read) and
renamed into place (a build faster than ``min_cache_seconds`` goes to the
process's private directory instead). Each library is resolved once a process, and each
resolution is reported to the listeners that
`compilecache.install_compile_telemetry` adds.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import json
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
from functools import lru_cache
from pathlib import Path
from typing import Callable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
#: The default cache directory, inside the package (listed in .gitignore).
PACKAGE_BUILD_DIR = _PKG / "_build"
#: Where the libraries build; `compilecache.bootstrap_compile_cache` sets it.
BUILD_DIR = PACKAGE_BUILD_DIR
#: Builds faster than this many seconds are not kept in a shared cache
#: directory (`CompileCacheConfig.min_compile_time_secs`).
min_cache_seconds = 0.0

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
#: Compiler wall seconds of each library this process built (nvcc and g++).
build_seconds: dict[str, float] = {}
#: Libraries whose build seconds a program handle has taken.
_TAKEN: set[str] = set()

_CACHE_LOCK = threading.Lock()
#: ``listener(event, name, seconds)`` for each resolution: ``"hit"`` with the
#: recorded build seconds, ``"miss"`` with 0, then ``"compile"`` with the
#: build's seconds.
LISTENERS: list[Callable[[str, str, float], None]] = []
_RESOLVED: dict[Path, Path] = {}
_PRIVATE: Path | None = None


def private_dir() -> Path:
    """A directory of this process's own, removed at exit: where libraries
    build when the shared cache is off, or too fast to keep."""
    global _PRIVATE
    with _CACHE_LOCK:
        if _PRIVATE is None:
            _PRIVATE = Path(tempfile.mkdtemp(prefix="cobalt_build_"))
            atexit.register(shutil.rmtree, _PRIVATE, True)
        return _PRIVATE


def recorded_seconds(library: Path) -> float:
    """The compiler seconds written beside ``library`` when it was built
    (0 when there is no record)."""
    try:
        return float(json.loads(library.with_name(library.name + ".json").read_text())["seconds"])
    except (OSError, ValueError, KeyError, TypeError):
        return 0.0


def _report(event: str, name: str, seconds: float) -> None:
    for listener in list(LISTENERS):
        listener(event, name, seconds)


def resolve_library(name: str, out: Path, compile_to: Callable[[Path], None]) -> Path:
    """The library ``out``, built by ``compile_to(tmp_path)`` unless it is
    already in the cache; ``name`` labels the reports. A concurrent build
    of the same library sees all or nothing (``os.replace``)."""
    with _CACHE_LOCK:
        done = _RESOLVED.get(out)
    if done is not None and done.exists():
        return done
    if out.exists():
        _report("hit", name, recorded_seconds(out))
        path = out
    else:
        _report("miss", name, 0.0)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        try:
            compile_to(tmp)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        seconds = build_seconds[name] = time.perf_counter() - t0
        _report("compile", name, seconds)
        if seconds < min_cache_seconds and out.parent != _PRIVATE:
            path = private_dir() / out.name
            shutil.move(tmp, path)
        else:
            record = out.with_name(f"{out.name}.json.{os.getpid()}.{threading.get_ident()}.tmp")
            record.write_text(json.dumps({"name": name, "seconds": seconds}))
            os.replace(record, out.with_name(out.name + ".json"))
            os.replace(tmp, out)
            path = out
    with _CACHE_LOCK:
        _RESOLVED[out] = path
    return path


@lru_cache(maxsize=None)
def compiler_identity(compiler: str | None) -> str:
    """What a library's cache key records of the compiler that builds it:
    its ``--version`` output and the host's machine type (``none`` for a
    missing compiler, which then cannot build)."""
    version = "none"
    if compiler is not None:
        try:
            proc = subprocess.run([compiler, "--version"], capture_output=True, text=True, timeout=60)
            version = proc.stdout.strip() or proc.stderr.strip()
        except (OSError, subprocess.SubprocessError) as exc:
            version = f"unavailable: {exc}"
    return f"{version}\n{platform.machine()}"


def _nvcc_or_none() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


def _nvcc() -> str:
    found = _nvcc_or_none()
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda/bin); "
        "the CUDA kernels are built on the machine with the GPU"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the md5 of source, flags
    and nvcc's identity."""
    src = CSRC / f"{name}.cu"
    key = " ".join(NVCC_FLAGS) + "\n" + compiler_identity(_nvcc_or_none())
    digest = hashlib.md5(src.read_bytes() + key.encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its keyed library is in the cache."""

    def compile_to(tmp: Path) -> None:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_log[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                f"{build_log[name]}"
            )

    return resolve_library(name, library_path(name), compile_to)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib


def take_build_seconds(name: str) -> float:
    """The compiler seconds of this process's build of ``name`` the first time
    they are asked for, then 0 (0 too when the library came from the
    cache): the program registry books a library's build once."""
    with _LOCK:
        if name in _TAKEN:
            return 0.0
        _TAKEN.add(name)
        return build_seconds.get(name, 0.0)


def build_stats() -> dict[str, float]:
    """This process's kernel builds — the run ledger's ``compile`` block:
    the nvcc kernels among `build_seconds` (the g++ reader left out; the
    ``cobalt_compile_*`` counters count every library), their wall seconds,
    kernels loaded."""
    kernels = [s for n, s in build_seconds.items() if (CSRC / f"{n}.cu").is_file()]
    return {
        "kernel_builds": len(kernels),
        "kernel_build_seconds": round(sum(kernels), 6),
        "kernels_loaded": len(_LIBS),
    }
