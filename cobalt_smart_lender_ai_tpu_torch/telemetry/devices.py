"""Device + host telemetry: memory gauges and sampled counter series.

Two legs:

- `install_device_metrics` publishes ``cobalt_device_mem_bytes{device}``
  and ``cobalt_host_rss_bytes`` gauges onto a `MetricsRegistry` as
  collect-time callbacks — NaN where nothing is reported (a CPU run), as
  every other ``set_function`` gauge of the stack.
- `DeviceSampler` is a background daemon thread that snapshots the same
  values (plus any registered extra series — the micro-batcher registers
  its queue depth) into bounded rings, which `telemetry.traceexport`
  renders as Perfetto **counter tracks** (``"ph": "C"``) beside the span
  timeline.

The card's memory comes from PyTorch's caching allocator and from
``cudaMemGetInfo``, under the reference's keys:

- ``bytes_in_use`` <- ``torch.cuda.memory_stats(i)["allocated_bytes.all.current"]``
  (bytes held by live tensors);
- ``peak_bytes_in_use`` <- ``memory_stats(i)["allocated_bytes.all.peak"]``;
- ``bytes_limit`` <- the total of ``torch.cuda.mem_get_info(i)`` (the
  card's memory).

``reserved_bytes`` (the caching allocator's pool, what ``nvidia-smi``
counts for the process) is not ``bytes_in_use``: freed tensors return
their blocks to the pool, which keeps them. A CPU run has no device memory
to report: its one device row carries no memory stats, as the reference's
CPU rows do.

Reading memory never initialises CUDA: a process that has not touched
the card (and a child forked from one that has) reads no device memory;
only `device_info` names the cards (``torch.cuda.get_device_name``). The
sampler takes its values before it takes its lock, never logs and never
touches a metrics registry, so a fork while it runs (the CSV codec forks
workers from 200,000 rows) leaves a child no lock it could need; the child
drops the inherited sampler state.

Stdlib-only besides torch; the sampler is opt-in
(`default_device_sampler().start()`), so nothing spawns a thread unless a
harness or server asks for one.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable

import torch

__all__ = [
    "DeviceSampler",
    "default_device_sampler",
    "device_info",
    "host_rss_bytes",
    "install_device_metrics",
]


def host_rss_bytes() -> float | None:
    """Resident set size of this process in bytes, or None when the
    platform offers no cheap way to read it (Linux reads
    ``/proc/self/status``, elsewhere the ``resource`` peak RSS stands
    in)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except OSError:
        pass
    try:
        import resource
        import sys

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is KiB on Linux, bytes on macOS — and the peak, not the
        # current, RSS.
        return float(rss) * (1.0 if sys.platform == "darwin" else 1024.0)
    except (ImportError, OSError):
        return None


def _cuda_devices() -> list[int]:
    """Indices of the CUDA devices this process has initialised (none in a
    CPU run, before the first CUDA call, or in a forked child)."""
    if not torch.cuda.is_initialized():
        return []
    return list(range(torch.cuda.device_count()))


def _device_mem_stats(index: int) -> dict[str, float]:
    """The reference's three memory keys for CUDA device ``index``."""
    stats = torch.cuda.memory_stats(index)
    _, total = torch.cuda.mem_get_info(index)
    return {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": float(total),
    }


def device_info() -> list[dict[str, Any]]:
    """One JSON-able row per device (id, kind, platform, memory stats on
    a card) — the run ledger's ``devices`` block. A CPU run has one row,
    without memory stats."""
    if not torch.cuda.is_available():
        return [{"id": 0, "kind": "cpu", "platform": "cpu", "str": "cpu"}]
    rows = []
    live = set(_cuda_devices())
    for i in range(torch.cuda.device_count()):
        row: dict[str, Any] = {
            "id": i,
            "kind": torch.cuda.get_device_name(i),
            "platform": "gpu",
            "str": f"cuda:{i}",
        }
        if i in live:
            row["memory_stats"] = _device_mem_stats(i)
        rows.append(row)
    return rows


def install_device_metrics(metrics_registry: Any | None = None) -> None:
    """Publish the device/host memory gauges onto ``metrics_registry``
    (default: the process-wide registry, resolved at call time). Safe to
    call repeatedly — callbacks are simply rewired. One
    ``cobalt_device_mem_bytes`` child per row of `device_info` (``cpu``,
    always NaN, on a machine without CUDA)."""
    if metrics_registry is None:
        from cobalt_smart_lender_ai_tpu_torch.telemetry.metrics import (
            default_registry,
        )

        metrics_registry = default_registry()
    g_mem = metrics_registry.gauge(
        "cobalt_device_mem_bytes",
        "bytes held by live tensors on each device "
        "(torch.cuda.memory_stats allocated_bytes.all.current; NaN before "
        "the process touches the card)",
        ("device",),
    )
    for row in device_info():

        def _bytes_in_use(index=row["id"], cuda=row["platform"] == "gpu") -> float:
            if not cuda or index not in _cuda_devices():
                return float("nan")
            return _device_mem_stats(index)["bytes_in_use"]

        g_mem.labels(device=row["str"]).set_function(_bytes_in_use)
    metrics_registry.gauge(
        "cobalt_host_rss_bytes",
        "resident set size of this process (NaN when unreadable)",
    ).set_function(lambda: host_rss_bytes() or float("nan"))


class DeviceSampler:
    """Background sampler feeding Perfetto counter tracks.

    Samples every ``interval_s`` into per-series bounded rings of
    ``(t_monotonic_s, value)`` pairs. Built-in series: one
    ``device_mem_bytes:cuda:<i>`` per initialised CUDA device, plus
    ``host_rss_bytes``. Extra series (queue depth, in-flight counts)
    register via `add_series(name, fn)`; a callback that raises is skipped
    for that tick."""

    def __init__(
        self,
        *,
        interval_s: float = 0.25,
        capacity: int = 4096,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.interval_s = max(0.01, float(interval_s))
        self.capacity = max(16, int(capacity))
        self._clock = clock
        self._lock = threading.Lock()
        self._series: dict[str, deque[tuple[float, float]]] = {}
        self._extra: dict[str, Callable[[], float]] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add_series(self, name: str, fn: Callable[[], float]) -> None:
        with self._lock:
            self._extra[name] = fn

    def remove_series(self, name: str) -> None:
        """Stop sampling ``name``; already-sampled points stay exportable
        (a server shutting down must not erase the trace it just made)."""
        with self._lock:
            self._extra.pop(name, None)

    def _append(self, name: str, t: float, value: float) -> None:
        ring = self._series.get(name)
        if ring is None:
            ring = self._series.setdefault(name, deque(maxlen=self.capacity))
        ring.append((t, float(value)))

    def sample_once(self) -> None:
        """Take one sample of every series now (also what the thread does
        each tick). The values are read before the lock is taken."""
        t = self._clock()
        values: list[tuple[str, float]] = [
            (f"device_mem_bytes:cuda:{i}", _device_mem_stats(i)["bytes_in_use"])
            for i in _cuda_devices()
        ]
        rss = host_rss_bytes()
        if rss is not None:
            values.append(("host_rss_bytes", rss))
        with self._lock:
            extra = list(self._extra.items())
        for name, fn in extra:
            try:
                values.append((name, float(fn())))
            except Exception:
                continue  # a series that cannot be read skips this tick
        with self._lock:
            for name, v in values:
                self._append(name, t, v)

    def series(self) -> dict[str, list[tuple[float, float]]]:
        """Snapshot of every sampled series (name -> [(t_s, value), ...])."""
        with self._lock:
            return {k: list(v) for k, v in self._series.items() if v}

    def start(self) -> "DeviceSampler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def _run() -> None:
            while not self._stop.wait(self.interval_s):
                self.sample_once()

        self._thread = threading.Thread(
            target=_run, name="cobalt-device-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def _after_fork_in_child(self) -> None:
        """The sampler thread does not exist in a forked child: drop its
        handle and take fresh locks."""
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None


_default_lock = threading.Lock()
_default: DeviceSampler | None = None


def default_device_sampler() -> DeviceSampler:
    """The process-wide sampler (lazily created, NOT auto-started)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = DeviceSampler()
        return _default


def _reset_after_fork() -> None:
    global _default_lock
    _default_lock = threading.Lock()
    if _default is not None:
        _default._after_fork_in_child()


os.register_at_fork(after_in_child=_reset_after_fork)
