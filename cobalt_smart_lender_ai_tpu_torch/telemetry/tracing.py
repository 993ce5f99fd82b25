"""Lightweight always-on spans — the Dapper-shaped third leg of telemetry.

Metrics aggregate, logs narrate; spans answer "where did *this* run spend
its time". Following Dapper's low-overhead always-on design (Sigelman et
al., 2010) the tracer is cheap enough to leave enabled: a span is one clock
read on entry, one on exit, and an append into a bounded ring buffer — no
I/O, no sampling daemon. The ring holds the most recent ``capacity``
finished spans; `export()` dumps them JSON-able for bench records, tests
and ad-hoc inspection.

- `span(name, **attrs)` — context manager. Nesting is tracked through a
  contextvar, so child spans record their parent id without explicit
  plumbing (and correctly across threads: each thread starts parentless
  unless the caller propagates context).
- The clock is injectable (`Tracer(clock=...)`), so span timing is exact
  under fake clocks in tests.
- While a ``torch.profiler`` session is capturing, each span also enters
  ``torch.profiler.record_function(name)``, so the same stage names line
  up with the card's kernels on the profiler's timeline. Outside a session
  a span costs one cheap check (`torch.autograd._profiler_enabled`) and
  adds no record.
- `record_span(name, start, end)` — after-the-fact registration for code
  that already measured a phase (the pipeline's ``tick()`` timings) so it
  lands in the same ring with the same parent semantics.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import sys
import threading
import time
from typing import Any, Callable, Iterator

__all__ = [
    "Span",
    "Tracer",
    "current_trace_ids",
    "default_tracer",
    "record_span",
    "span",
]


class Span:
    """One finished (or in-flight) timed region.

    ``trace_id`` is the span_id of the root span of the request/run this
    span belongs to (Dapper's trace id): a root span is its own trace, a
    child inherits its parent's. Every telemetry surface joins on it — log
    lines carry it, flight records index by it, and the Chrome-trace export
    puts it in each event's args. ``thread_id`` is captured at creation so
    the export can lay spans out per-thread (Perfetto tracks)."""

    __slots__ = (
        "name", "span_id", "parent_id", "trace_id", "start_s", "end_s",
        "attrs", "thread_id", "thread_name",
    )

    def __init__(
        self,
        name: str,
        span_id: int,
        parent_id: int | None,
        start_s: float,
        attrs: dict[str, Any],
        trace_id: int | None = None,
    ):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id if trace_id is not None else span_id
        self.start_s = start_s
        self.end_s: float | None = None
        self.attrs = attrs
        t = threading.current_thread()
        self.thread_id = t.ident or 0
        self.thread_name = t.name

    @property
    def duration_s(self) -> float | None:
        if self.end_s is None:
            return None
        return self.end_s - self.start_s

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "thread_id": self.thread_id,
            "thread_name": self.thread_name,
            "start_s": round(self.start_s, 6),
            "duration_s": (
                None
                if self.duration_s is None
                else round(self.duration_s, 6)
            ),
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class Tracer:
    """Span factory + bounded ring buffer of finished spans.

    One default tracer per process (`default_tracer()`); tests build their
    own with a fake clock. ``profiler_annotations`` gates the
    `torch.profiler.record_function` pass-through (on by default; it adds
    nothing outside an active ``torch.profiler`` session)."""

    def __init__(
        self,
        *,
        clock: Callable[[], float] = time.monotonic,
        capacity: int = 2048,
        profiler_annotations: bool = True,
    ):
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: collections.deque[Span] = collections.deque(
            maxlen=capacity
        )
        self._ids = itertools.count(1)
        self._current: contextvars.ContextVar[Span | None] = (
            contextvars.ContextVar("cobalt_current_span", default=None)
        )
        self._profiler_annotations = profiler_annotations

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def current(self) -> Span | None:
        return self._current.get()

    @contextlib.contextmanager
    def _annotation(self, name: str) -> Iterator[None]:
        if not (self._profiler_annotations and _profiler_active()):
            yield
            return
        import torch.profiler

        with torch.profiler.record_function(name):
            yield

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        """Time the block; record a finished `Span` in the ring."""
        parent = self._current.get()
        sp = Span(
            name,
            next(self._ids),
            None if parent is None else parent.span_id,
            self._clock(),
            attrs,
            trace_id=None if parent is None else parent.trace_id,
        )
        token = self._current.set(sp)
        try:
            with self._annotation(name):
                yield sp
        finally:
            sp.end_s = self._clock()
            self._current.reset(token)
            with self._lock:
                self._ring.append(sp)

    def record_span(
        self,
        name: str,
        start_s: float,
        end_s: float,
        **attrs: Any,
    ) -> Span:
        """Register an already-measured region (parented to the span in
        scope, if any)."""
        parent = self._current.get()
        sp = Span(
            name,
            next(self._ids),
            None if parent is None else parent.span_id,
            start_s,
            attrs,
            trace_id=None if parent is None else parent.trace_id,
        )
        sp.end_s = end_s
        with self._lock:
            self._ring.append(sp)
        return sp

    def export(self, limit: int | None = None) -> list[dict[str, Any]]:
        """Most recent finished spans, oldest first, JSON-able."""
        with self._lock:
            spans = list(self._ring)
        if limit is not None:
            spans = spans[-limit:]
        return [s.to_dict() for s in spans]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


def _profiler_active() -> bool:
    """Whether a ``torch.profiler`` session is capturing on this thread.
    torch is imported by then if anything is profiling, so a process that
    never imported it pays nothing here."""
    torch = sys.modules.get("torch")
    return torch is not None and bool(torch.autograd._profiler_enabled())


_default_tracer = Tracer()


def default_tracer() -> Tracer:
    return _default_tracer


def span(name: str, **attrs: Any):
    """``with span("pipeline.rfe", rows=n): ...`` on the default tracer."""
    return _default_tracer.span(name, **attrs)


def record_span(name: str, start_s: float, end_s: float, **attrs: Any) -> Span:
    return _default_tracer.record_span(name, start_s, end_s, **attrs)


def current_trace_ids() -> tuple[int, int] | None:
    """(trace_id, span_id) of the span in scope on the default tracer, or
    None outside any span — the join key `StructuredLogger` stamps on every
    log line so logs, flight records and the trace export correlate."""
    sp = _default_tracer.current()
    if sp is None:
        return None
    return (sp.trace_id, sp.span_id)
