"""The port's native CSV reader: ``csv_reader.cc`` (C++) over ctypes.

The port's copy of the reference's ``native/`` package. The reference reads
its stored tables with pandas' C engine or, when ``g++`` builds it, with its
own C++ reader; the port reads them with `io.frames.csv_to_frame` (numpy,
no pandas) or with this reader, which gives the same `RawFrame` for the
same bytes: the same columns, dtypes (int64, float64, or ``U`` with a
missing mask), values bit for bit (-0.0 kept) and missing cells, and a
quoted ``""`` read as the empty string. ``csv_reader.cc`` says where its
rules differ from the reference reader's (the codec's, not pandas').

The library is compiled with ``g++`` at first use into the build cache
(``_build/`` inside the package unless `compilecache.bootstrap_compile_cache`
chose another directory), as ``csv_reader-<md5>.so`` keyed by the source, the
flags and g++'s identity (an edit or another compiler rebuilds); nothing is
built at import time. ``read_csv(..., engine="auto")`` falls back to
`csv_to_frame` with one ``WARNING`` when the library cannot be built or
loaded; ``engine="native"`` raises then, and ``engine="frames"`` always
takes the codec. The reader parses in threads
of its own, so it needs no worker processes (and may run with CUDA
initialised).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame
from cobalt_smart_lender_ai_tpu_torch.io.frames import _decode, csv_to_frame
from cobalt_smart_lender_ai_tpu_torch.ops import _build as _cache

__all__ = ["ENGINES", "native_available", "parse_csv_columns", "read_csv"]

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).with_name("csv_reader.cc")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
#: The engines of `read_csv`.
ENGINES = ("auto", "native", "frames")
#: Threads of one parse (the card's machine has 8 cores).
MAX_THREADS = 8

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_ERR: str | None = None


def library_path() -> Path:
    """Where the reader builds to in the build cache's directory
    (``ops._build.BUILD_DIR``), keyed by the md5 of source, flags and
    g++'s identity."""
    key = " ".join(GXX_FLAGS) + "\n" + _cache.compiler_identity(shutil.which("g++"))
    digest = hashlib.md5(SOURCE.read_bytes() + key.encode())
    return _cache.BUILD_DIR / f"csv_reader-{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    """The reader's library, from the build cache (`ops._build.resolve_library`)
    or built by g++ into it."""

    def compile_to(tmp: Path) -> None:
        gxx = shutil.which("g++")
        if gxx is None:
            raise FileNotFoundError("g++ not found on PATH")
        proc = subprocess.run(
            [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{proc.stderr}")

    return _cache.resolve_library("csv_reader", library_path(), compile_to)


def _load() -> ctypes.CDLL | None:
    """The reader's library, built first if needed; None (the reason in
    ``_LIB_ERR``, logged once) when it cannot be built or loaded."""
    global _LIB, _LIB_ERR
    with _LOCK:
        if _LIB is not None or _LIB_ERR is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError) as exc:
            _LIB_ERR = f"native csv reader unavailable: {exc}"
            logger.warning("%s; reading CSV with io.frames.csv_to_frame", _LIB_ERR)
            return None
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.cobalt_csv_parse.argtypes = [ctypes.c_char_p, i64, ctypes.c_int]
        lib.cobalt_csv_parse.restype = ptr
        for fn, res in (("nrows", i64), ("ncols", i64)):
            getattr(lib, f"cobalt_csv_{fn}").argtypes = [ptr]
            getattr(lib, f"cobalt_csv_{fn}").restype = res
        lib.cobalt_csv_col_name.argtypes = [ptr, i64]
        lib.cobalt_csv_col_name.restype = ctypes.c_char_p
        lib.cobalt_csv_col_kind.argtypes = [ptr, i64]
        lib.cobalt_csv_col_kind.restype = ctypes.c_int
        lib.cobalt_csv_col_width.argtypes = [ptr, i64]
        lib.cobalt_csv_col_width.restype = i64
        lib.cobalt_csv_last_error.argtypes = [ptr]
        lib.cobalt_csv_last_error.restype = ctypes.c_char_p
        lib.cobalt_csv_fill.argtypes = [ptr, ptr, ptr]
        lib.cobalt_csv_fill.restype = None
        lib.cobalt_csv_free.argtypes = [ptr]
        lib.cobalt_csv_free.restype = None
        _LIB = lib
        return lib


def native_available() -> bool:
    """Whether the reader builds (or is built) and loads here."""
    return _load() is not None


def _parse(data: bytes) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """``(columns, missing masks of the string columns)`` of CSV bytes."""
    lib = _load()
    if lib is None:
        raise RuntimeError(_LIB_ERR or "native csv reader unavailable")
    if b"\r\n" in data:
        data = data.replace(b"\r\n", b"\n")  # as the codec reads line ends
    threads = min(MAX_THREADS, os.cpu_count() or 1)
    handle = lib.cobalt_csv_parse(data, len(data), threads)
    if not handle:
        raise RuntimeError("cobalt_csv_parse returned NULL")
    try:
        err = lib.cobalt_csv_last_error(handle)
        if err:
            raise ValueError(err.decode())
        n, f = lib.cobalt_csv_nrows(handle), lib.cobalt_csv_ncols(handle)
        names = [lib.cobalt_csv_col_name(handle, j).decode() for j in range(f)]
        outs, masks = [], []
        for j in range(f):
            kind = lib.cobalt_csv_col_kind(handle, j)
            if kind == 1:
                width = lib.cobalt_csv_col_width(handle, j)
                outs.append(np.zeros((n, width), np.uint8))
                masks.append(np.zeros(n, np.bool_))
            else:
                outs.append(np.empty(n, np.float64 if kind == 0 else np.int64))
                masks.append(None)
        out_ptrs = (ctypes.c_void_p * max(f, 1))(*[o.ctypes.data for o in outs])
        mask_ptrs = (ctypes.c_void_p * max(f, 1))(*[0 if m is None else m.ctypes.data for m in masks])
        lib.cobalt_csv_fill(handle, out_ptrs, mask_ptrs)
    finally:
        lib.cobalt_csv_free(handle)
    columns, missing = {}, {}
    for name, out, mask in zip(names, outs, masks):
        if mask is None:
            columns[name] = out
        else:
            columns[name] = _decode(out.reshape(-1).view(f"S{out.shape[1]}"))
            missing[name] = mask
    return columns, missing


def parse_csv_columns(data: bytes) -> dict[str, np.ndarray]:
    """CSV bytes as ``{name: column}``: int64 or float64 numbers, ``U``
    strings (a missing cell is ``""``). Raises RuntimeError when the reader
    is unavailable, ValueError on a malformed table."""
    return _parse(data)[0]


def read_csv(source: bytes | str | Path, engine: str = "auto") -> RawFrame:
    """A CSV table (bytes or a path) as a `RawFrame`, equal to
    `io.frames.csv_to_frame`'s. ``engine="auto"`` reads with the native
    reader when it builds, else with the codec; ``"native"`` requires the
    reader; ``"frames"`` takes the codec."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    data = Path(source).read_bytes() if isinstance(source, (str, Path)) else source
    if engine == "frames" or (engine == "auto" and not native_available()):
        return csv_to_frame(data)
    return RawFrame(*_parse(data))
