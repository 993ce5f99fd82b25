"""The kernel-build cache shared by every entry point, and its telemetry.

The port's counterpart of the reference's persistent XLA compile cache. The
port compiles three libraries: the two nvcc kernels (`ops._build`) and the
g++ CSV reader (`native`). Each is keyed by the md5 of its source, its
flags and its compiler's identity (``--version`` and the host's machine
type), and kept in a cache directory, so a process that finds it there
loads it instead of compiling. Every long-running entry point (pipeline, retrain,
serving, the portfolio and artifact tools, `chip_smoke.py`) calls
`bootstrap_compile_cache` at startup. It does two independent things:

1. Chooses the cache directory (the package's ``_build/`` by default) and
   the build seconds below which a library is not kept there.
2. Makes both builders report each library they resolve into
   `default_registry()` as the ``cobalt_compile_*`` families, so `/metrics`,
   the run ledger and `chip_smoke.py` can prove statements like "the
   second process compiled nothing".

Both are idempotent. An unwritable cache directory degrades to a directory
private to the process rather than failing the caller. Opt out of the
shared cache with ``COBALT_COMPILE_CACHE=0``: every process then compiles
into its own directory; the telemetry stays on regardless.

Exposed metrics, counted where the builders resolve a library:

- ``cobalt_compile_total`` / ``cobalt_compile_seconds`` — libraries compiled
  by this process and the compiler's wall seconds for each.
- ``cobalt_compile_cache_hits_total`` / ``cobalt_compile_cache_misses_total``
  — libraries found in the cache directory / not found there.
- ``cobalt_compile_cache_saved_seconds_total`` — the compiler seconds
  recorded beside each library found (``<library>.json``) when it was
  built: the build the hit avoided.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any

from cobalt_smart_lender_ai_tpu_torch.config import CompileCacheConfig
from cobalt_smart_lender_ai_tpu_torch.ops import _build
from cobalt_smart_lender_ai_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    default_registry,
    log_buckets,
)

__all__ = [
    "bootstrap_compile_cache",
    "compile_stats",
    "install_compile_telemetry",
    "publish_compile_metrics",
]

logger = logging.getLogger(__name__)

_DISABLE_ENV = "COBALT_COMPILE_CACHE"
_MIN_SECS_ENV = "COBALT_COMPILE_CACHE_MIN_SECS"

_bootstrapped: str | None = None
_bootstrap_done = False
_listeners_installed = False


def _metrics() -> dict[str, Any]:
    reg = default_registry()
    return {
        "compiles": reg.counter(
            "cobalt_compile_total",
            "kernel libraries compiled (nvcc, g++) by this process",
        ),
        "compile_seconds": reg.histogram(
            "cobalt_compile_seconds",
            "compiler wall seconds per kernel library built",
            buckets=log_buckets(1e-3, 600.0, per_decade=3),
        ),
        "hits": reg.counter(
            "cobalt_compile_cache_hits_total",
            "kernel libraries found in the build cache",
        ),
        "misses": reg.counter(
            "cobalt_compile_cache_misses_total",
            "kernel libraries not found in the build cache",
        ),
        "saved_seconds": reg.counter(
            "cobalt_compile_cache_saved_seconds_total",
            "compiler seconds avoided by build-cache hits",
        ),
    }


def _on_resolve(event: str, name: str, seconds: float) -> None:
    m = _metrics()
    if event == "hit":
        m["hits"].inc()
        m["saved_seconds"].inc(max(0.0, seconds))
    elif event == "miss":
        m["misses"].inc()
    elif event == "compile":
        m["compiles"].inc()
        m["compile_seconds"].observe(seconds)


def install_compile_telemetry() -> bool:
    """Make the builders report into ``cobalt_compile_*``. Idempotent.

    The listener resolves `default_registry()` at each report rather than
    capturing metric objects from a registry that tests may reset."""
    global _listeners_installed
    if not _listeners_installed:
        _build.LISTENERS.append(_on_resolve)
        _listeners_installed = True
    return True


def _use_directory(directory: Path, min_secs: float) -> None:
    _build.BUILD_DIR = directory
    _build.min_cache_seconds = min_secs


def _private() -> None:
    _use_directory(_build.private_dir(), 0.0)


def bootstrap_compile_cache(config: CompileCacheConfig | None = None) -> str | None:
    """Choose the build cache with config and environment policy applied.

    The single bootstrap shared by every entry point: one source of truth
    for the cache directory and the threshold below which a build is not
    kept there. Precedence:

    - ``COBALT_COMPILE_CACHE=0|false|off|no`` disables the shared cache: the
      libraries build into a directory private to the process (telemetry
      still installs).
    - ``COBALT_COMPILE_CACHE_MIN_SECS`` overrides the threshold.
    - Otherwise ``config`` (default `CompileCacheConfig()`) decides;
      ``cache_dir=None`` keeps the package's ``_build/``.

    Idempotent: the first call wins and later calls return its result, so
    library code may call this freely without clobbering an entry point's
    explicit configuration. Returns the cache directory in effect, or None
    when the shared cache is disabled or its directory cannot be written.
    """
    global _bootstrapped, _bootstrap_done
    install_compile_telemetry()
    if _bootstrap_done:
        return _bootstrapped
    cfg = config or CompileCacheConfig()
    _bootstrap_done = True
    _bootstrapped = None
    if os.environ.get(_DISABLE_ENV, "").strip().lower() in ("0", "false", "off", "no"):
        _private()
        return None
    if not cfg.enabled:
        _private()
        return None
    min_secs = cfg.min_compile_time_secs
    env_min = os.environ.get(_MIN_SECS_ENV)
    if env_min is not None:
        try:
            min_secs = float(env_min)
        except ValueError:
            pass
    directory = _build.PACKAGE_BUILD_DIR if cfg.cache_dir is None else Path(cfg.cache_dir).expanduser()
    try:
        directory.mkdir(parents=True, exist_ok=True)
        if not os.access(directory, os.W_OK):
            raise PermissionError(f"{directory} is not writable")
    except OSError as e:
        logger.warning("kernel build cache disabled (%s unwritable: %s)", directory, e)
        _private()
        return None
    _use_directory(directory, float(min_secs))
    _bootstrapped = str(directory)
    return _bootstrapped


def compile_stats() -> dict[str, float]:
    """Current ``cobalt_compile_*`` values, for the run ledger and the card
    checks ("second process: hits > 0, nothing compiled")."""
    m = _metrics()
    return {
        "backend_compiles": m["compiles"].value,
        "backend_compile_seconds": m["compile_seconds"].sum,
        "cache_hits": m["hits"].value,
        "cache_misses": m["misses"].value,
        "cache_saved_seconds": m["saved_seconds"].value,
    }


def publish_compile_metrics(registry: MetricsRegistry) -> None:
    """Show the ``cobalt_compile_*`` families on ``registry``'s page too (a
    service's `/metrics` renders its own registry, not the default one)."""
    if registry is default_registry():
        return
    for family in _metrics().values():
        registry.share(family)
