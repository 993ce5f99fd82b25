"""Process-wide registry of the port's kernels and their measured cost.

Every hand-written kernel entry (`ops.score.fused_score`,
`ops.histogram.gradient_histogram_channels`) registers one
`ProgramHandle` per shape key here under a stable, readable name
(``score_forest/f32/64/shap``, ``gradient_histogram/F20xB255``) and
records every launch through it (so does each step of the device ingest,
``ingest.<step>[rows=N,features=F]`` of kind ``"ingest"``): the dispatch count, the device seconds
of the launch, the rows and the kernel's own count of FLOPs and bytes for
that call's shapes. The registry derives achieved FLOP/s and a roofline
estimate where it knows the card's peaks, and plain dispatch accounting
where it does not.

Device seconds come from a pair of ``torch.cuda.Event(enable_timing=True)``
recorded on the launching stream around the launch; nothing synchronises
the stream or the device. The pairs come from a pool per handle. Finished
pairs are resolved (``query()`` and ``elapsed_time()``) when the table is
read: a snapshot, a ``/metrics`` collect, a run ledger. When every pair of
the pool is still in flight, only the oldest pair's end event is waited
on. On the CPU (the plain versions) a dispatch records wall seconds from
``time.perf_counter``, as the reference does on the CPU, under a handle of
kind ``"plain"``; kernel handles are of kind ``"kernel"``.

Nothing here catches an exception: a launch that raises raises as before,
and its dispatch is not recorded.

Three consumers read the same table:

- ``GET /debug/programs`` (live serving view);
- ``cobalt_program_*`` metric families, published into any
  `MetricsRegistry` via `install_program_metrics` (collect-time
  callbacks);
- `telemetry.runledger.RunLedger`, which snapshots the table into the
  per-run JSON artifact that the reference's ``tools/obs_report.py``
  renders and diffs.
"""

from __future__ import annotations

import collections
import functools
import threading
import weakref
from typing import Any, Callable, Mapping

__all__ = [
    "EVENT_POOL",
    "ProgramHandle",
    "ProgramRegistry",
    "default_program_registry",
    "install_program_metrics",
    "launch_handle",
    "peak_bytes_estimate",
    "peak_flops_estimate",
    "program_handle",
    "program_table",
    "set_default_program_registry",
]

#: Published peaks of the cards the port knows, by device-name prefix:
#: (FP32 non-tensor-core FLOP/s, HBM bytes/s). NVIDIA H100 SXM data sheet:
#: 67 TFLOP/s FP32 and 3.35 TB/s HBM3. Any other device (every CPU) maps to
#: None, and then no roofline is reported.
_PEAKS_BY_KIND: tuple[tuple[str, float, float], ...] = (
    ("nvidia h100", 67e12, 3.35e12),
)

#: Event pairs one handle keeps in flight before a launch waits on the
#: oldest pair's end event.
EVENT_POOL = 256


def _peaks(device_kind: str | None) -> tuple[float, float] | None:
    if not device_kind:
        return None
    kind = device_kind.lower()
    for prefix, flops, nbytes in _PEAKS_BY_KIND:
        if kind.startswith(prefix):
            return flops, nbytes
    return None


def peak_flops_estimate(device_kind: str | None) -> float | None:
    """Peak FP32 FLOP/s of a device kind, or None when unknown."""
    peaks = _peaks(device_kind)
    return None if peaks is None else peaks[0]


def peak_bytes_estimate(device_kind: str | None) -> float | None:
    """Peak memory bytes/s of a device kind, or None when unknown."""
    peaks = _peaks(device_kind)
    return None if peaks is None else peaks[1]


class ProgramHandle:
    """Accounting cell for one named kernel entry and shape key. A launch
    site calls `start` just before the launch and `stop` just after it (a
    CUDA launch), or `record_dispatch` with wall seconds (the CPU)."""

    __slots__ = (
        "name", "kind", "meta", "_lock", "_pending", "_free",
        "compiles", "compile_seconds", "flops_total", "bytes_total",
        "dispatches", "dispatch_seconds", "rows",
    )

    def __init__(self, name: str, kind: str, meta: dict[str, Any]):
        self.name = name
        self.kind = kind
        self.meta = meta
        self._lock = threading.Lock()
        self._pending: collections.deque = collections.deque()
        self._free: list = []
        self.compiles = 0
        self.compile_seconds = 0.0
        self.flops_total = 0.0
        self.bytes_total = 0.0
        self.dispatches = 0
        self.dispatch_seconds = 0.0
        self.rows = 0

    def record_compile(self, seconds: float) -> None:
        """One build of this program's kernel library (``nvcc`` wall
        seconds; 0 when the library came from the build directory)."""
        with self._lock:
            self.compiles += 1
            self.compile_seconds += max(0.0, float(seconds))

    def record_dispatch(
        self, seconds: float, *, count: int = 1, rows: int = 0,
        flops: float = 0.0, nbytes: float = 0.0,
    ) -> None:
        """``count`` dispatches that took ``seconds`` in all (wall seconds
        of the plain version on the CPU)."""
        with self._lock:
            self.dispatches += int(count)
            self.dispatch_seconds += max(0.0, float(seconds))
            self.rows += int(rows)
            self.flops_total += flops
            self.bytes_total += nbytes

    def start(self, stream) -> tuple:
        """Record a start event on ``stream`` (a ``torch.cuda.Stream``)
        just before a launch; returns the pair for `stop`."""
        pair = self._take_pair()
        pair[0].record(stream)
        return pair

    def stop(
        self, pair: tuple, stream, *, rows: int = 0,
        flops: float = 0.0, nbytes: float = 0.0,
    ) -> None:
        """Record the end event on ``stream`` just after a launch and
        count the dispatch; its seconds are resolved when the table is
        read."""
        pair[1].record(stream)
        with self._lock:
            self._pending.append(pair)
            self.dispatches += 1
            self.rows += int(rows)
            self.flops_total += flops
            self.bytes_total += nbytes

    def _take_pair(self) -> tuple:
        with self._lock:
            if not self._free:
                self._resolve_locked()
            if self._free:
                return self._free.pop()
            if len(self._pending) < EVENT_POOL:
                return _new_pair()
            oldest = self._pending.popleft()
        oldest[1].synchronize()  # the oldest launch only, never the stream
        seconds = oldest[0].elapsed_time(oldest[1]) / 1e3
        with self._lock:
            self.dispatch_seconds += seconds
        return oldest

    def _resolve_locked(self) -> None:
        """Add the seconds of every finished pair, oldest first, and put
        the pairs back in the pool. A pair in flight stops the scan (pairs
        of one stream finish in order)."""
        pending = self._pending
        while pending and pending[0][1].query():
            start, end = pending.popleft()
            self.dispatch_seconds += start.elapsed_time(end) / 1e3
            self._free.append((start, end))

    def resolved(self) -> tuple[int, float, float, float]:
        """(dispatches, dispatch seconds of the finished ones, FLOPs and
        bytes per dispatch) after resolving the finished pairs."""
        with self._lock:
            self._resolve_locked()
            n = self.dispatches
            return (
                n,
                self.dispatch_seconds,
                self.flops_total / n if n else 0.0,
                self.bytes_total / n if n else 0.0,
            )

    def snapshot(self) -> dict[str, Any]:
        """One JSON-able table row with the derived rates."""
        n, disp_s, flops, nbytes = self.resolved()
        with self._lock:
            in_flight = len(self._pending)
            row: dict[str, Any] = {
                "name": self.name,
                "kind": self.kind,
                "compiles": self.compiles,
                "compile_seconds": round(self.compile_seconds, 6),
                "flops": flops if n else None,
                "bytes_accessed": nbytes if n else None,
                "dispatches": n,
                "dispatch_seconds": round(disp_s, 6),
                "rows": self.rows,
                "dispatches_in_flight": in_flight,
            }
        row.update(self.meta)
        timed = n - in_flight
        achieved = None
        if flops and disp_s > 0 and timed > 0:
            achieved = flops * timed / disp_s
        row["achieved_flops_per_second"] = achieved
        peaks = _peaks(row.get("device_kind"))
        bound = None if peaks is None or not n else max(flops / peaks[0], nbytes / peaks[1])
        row["bound_seconds"] = bound
        row["roofline_utilization"] = (
            None if bound is None or disp_s <= 0 or timed <= 0 else bound * timed / disp_s
        )
        return row


def _new_pair() -> tuple:
    import torch

    return (
        torch.cuda.Event(enable_timing=True),
        torch.cuda.Event(enable_timing=True),
    )


class ProgramRegistry:
    """Name-keyed collection of `ProgramHandle`s plus the metric-family
    publication machinery. One process-wide instance
    (`default_program_registry`) is shared by training and serving."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._programs: dict[str, ProgramHandle] = {}
        # (weakref to a metrics registry, replica label, device filter) the
        # table is published on; every new program is wired into each. Weak:
        # a dropped service's registry must not outlive it (a fleet rebuilds
        # replicas, and a registry's callbacks hold its service).
        self._sinks: list[tuple] = []

    def register(
        self,
        name: str,
        *,
        kind: str = "",
        meta: Mapping[str, Any] | None = None,
    ) -> ProgramHandle:
        """Get-or-create the program named ``name``; a known name returns
        its handle unchanged."""
        prog = self._programs.get(name)
        if prog is not None:
            return prog
        with self._lock:
            prog = self._programs.get(name)
            if prog is not None:
                return prog
            prog = ProgramHandle(name, kind, dict(meta or {}))
            self._programs[name] = prog
            sinks = self._live_sinks_locked()
        for reg, replica, device in sinks:
            _wire(reg, prog, replica, device)
        return prog

    def _live_sinks_locked(self) -> list[tuple]:
        """The sinks whose registries are alive, dropping the others."""
        live = [(ref(), replica, device) for ref, replica, device in self._sinks]
        self._sinks = [s for s, (reg, _, _) in zip(self._sinks, live) if reg is not None]
        return [row for row in live if row[0] is not None]

    def get(self, name: str) -> ProgramHandle | None:
        """The handle registered under ``name``, or None."""
        with self._lock:
            return self._programs.get(name)

    def table(self, *, kind: str | None = None) -> list[dict[str, Any]]:
        """All program rows, most dispatch-expensive first — the payload of
        ``GET /debug/programs`` and the ledger's ``programs`` block."""
        with self._lock:
            progs = list(self._programs.values())
        rows = [p.snapshot() for p in progs]
        if kind is not None:
            rows = [r for r in rows if r["kind"] == kind]
        rows.sort(key=lambda r: (-r["dispatch_seconds"], r["name"]))
        return rows

    def totals(self) -> dict[str, float]:
        rows = self.table()
        return {
            "programs": len(rows),
            "compiles": sum(r["compiles"] for r in rows),
            "compile_seconds": round(sum(r["compile_seconds"] for r in rows), 6),
            "dispatches": sum(r["dispatches"] for r in rows),
            "dispatch_seconds": round(sum(r["dispatch_seconds"] for r in rows), 6),
        }

    def entry_seconds(self, entry: str) -> float:
        """Seconds of the finished dispatches of every program of kernel
        entry ``entry`` (its kernel and plain rows), so far: what a caller
        whose own row spans such launches leaves out of that row."""
        with self._lock:
            progs = [p for p in self._programs.values() if p.meta.get("entry") == entry]
        return sum(p.resolved()[1] for p in progs)

    def reset(self) -> None:
        """Drop every program AND sink — test isolation only."""
        with self._lock:
            self._programs.clear()
            self._sinks.clear()

    # -- metric publication ---------------------------------------------------

    def publish(
        self, metrics_registry: Any, *, replica: str | None = None, device: str | None = None
    ) -> None:
        """Export the table as ``cobalt_program_*`` families on
        ``metrics_registry`` via collect-time callbacks. ``replica`` adds a
        ``replica`` label and ``device`` keeps only the programs whose
        ``device`` is it (a fleet with a replica per card publishes each
        replica's own rows). Idempotent per (registry, replica)."""
        with self._lock:
            self._live_sinks_locked()
            self._sinks = [
                s for s in self._sinks if not (s[0]() is metrics_registry and s[1] == replica)
            ]
            self._sinks.append((weakref.ref(metrics_registry), replica, device))
            progs = list(self._programs.values())
        for prog in progs:
            _wire(metrics_registry, prog, replica, device)


def _wire(reg: Any, prog: ProgramHandle, replica: str | None = None, device: str | None = None) -> None:
    """One program's children of the ``cobalt_program_*`` families, with
    the reference's names, types and labels."""
    if device is not None and prog.meta.get("device") != device:
        return
    labelnames = ("program",) if replica is None else ("program", "replica")

    def child(family):
        if replica is None:
            return family.labels(program=prog.name)
        return family.labels(program=prog.name, replica=replica)

    child(
        reg.counter(
            "cobalt_program_dispatches_total",
            "dispatches through each named kernel entry and shape",
            labelnames,
        )
    ).set_function(lambda p=prog: p.dispatches)
    child(
        reg.counter(
            "cobalt_program_dispatch_seconds_total",
            "cumulative seconds of each named program's finished "
            "dispatches (CUDA events on the card, wall on the CPU)",
            labelnames,
        )
    ).set_function(lambda p=prog: p.resolved()[1])
    child(
        reg.counter(
            "cobalt_program_compile_seconds_total",
            "cumulative nvcc wall seconds building each named program",
            labelnames,
        )
    ).set_function(lambda p=prog: p.compile_seconds)
    child(
        reg.gauge(
            "cobalt_program_flops",
            "the kernel's own FLOP count per dispatch of each program "
            "(NaN before its first dispatch)",
            labelnames,
        )
    ).set_function(lambda p=prog: _per_dispatch(p, 2))
    child(
        reg.gauge(
            "cobalt_program_bytes_accessed",
            "the kernel's own count of bytes moved per dispatch "
            "(NaN before its first dispatch)",
            labelnames,
        )
    ).set_function(lambda p=prog: _per_dispatch(p, 3))

    def _achieved(p=prog):
        v = p.snapshot()["achieved_flops_per_second"]
        return float("nan") if v is None else v

    child(
        reg.gauge(
            "cobalt_program_achieved_flops_per_second",
            "achieved FLOP/s through each program (FLOPs x timed "
            "dispatches / their seconds; NaN until both sides exist)",
            labelnames,
        )
    ).set_function(_achieved)


def _per_dispatch(prog: ProgramHandle, field: int) -> float:
    resolved = prog.resolved()
    return resolved[field] if resolved[0] else float("nan")


_default_lock = threading.Lock()
_default: ProgramRegistry | None = None


def default_program_registry() -> ProgramRegistry:
    """The process-wide program registry (lazily created)."""
    global _default
    if _default is not None:
        return _default
    with _default_lock:
        if _default is None:
            _default = ProgramRegistry()
        return _default


def set_default_program_registry(reg: ProgramRegistry) -> ProgramRegistry:
    """Swap the process default (tests); returns the previous one."""
    global _default
    with _default_lock:
        if _default is None:
            _default = ProgramRegistry()
        prev = _default
        _default = reg
    return prev


def program_table(*, kind: str | None = None) -> list[dict[str, Any]]:
    """The default registry's table: ``GET /debug/programs``' payload."""
    return default_program_registry().table(kind=kind)


def install_program_metrics(metrics_registry: Any | None = None) -> None:
    """Publish ``cobalt_program_*`` onto ``metrics_registry`` (default: the
    process-wide `telemetry.metrics.default_registry()`, resolved at call
    time so tests that swap it publish onto the fresh one)."""
    if metrics_registry is None:
        from cobalt_smart_lender_ai_tpu_torch.telemetry.metrics import (
            default_registry,
        )

        metrics_registry = default_registry()
    default_program_registry().publish(metrics_registry)


@functools.cache
def _device_kind(device: str) -> str:
    if device.startswith("cuda"):
        import torch

        return torch.cuda.get_device_name(torch.device(device))
    return device


def program_handle(name: str, kind: str, device, **meta: Any) -> ProgramHandle:
    """Get-or-create the program ``name`` of ``kind`` that runs on
    ``device`` (a ``torch.device``); its table row carries the device, the
    device's kind and ``meta``."""
    reg = default_program_registry()
    prog = reg._programs.get(name)
    if prog is not None:
        return prog
    dev = str(device)
    if device.type == "cuda" and device.index is None:
        import torch

        dev = f"cuda:{torch.cuda.current_device()}"
    return reg.register(
        name, kind=kind, meta={"device": dev, "device_kind": _device_kind(dev), **meta}
    )


def launch_handle(
    entry: str, key: str, device, build_seconds: Callable[[], float], **meta: Any
) -> ProgramHandle:
    """The handle of kernel entry ``entry`` at shape key ``key`` on
    ``device`` (a ``torch.device``): ``<entry>/<key>`` of kind ``"kernel"``
    on a CUDA device, ``<entry>_plain/<key>`` of kind ``"plain"`` on the
    CPU. A new kernel handle records one compile of ``build_seconds()``
    (the library's nvcc seconds the first time they are asked for, then
    0). ``meta`` joins the handle's table row."""
    cuda = device.type == "cuda"
    name = f"{entry}/{key}" if cuda else f"{entry}_plain/{key}"
    prog = program_handle(name, "kernel" if cuda else "plain", device, entry=entry, **meta)
    if cuda and prog.compiles == 0:
        prog.record_compile(build_seconds())
    return prog
