"""Structured JSON request logs with contextvar-propagated request ids.

The adapters' only log surface before this was the stdlib handler's silenced
access log and `print` lines from the CLI — a non-2xx left no trace an
operator could correlate with a client report. Here every log record is one
JSON object per line (machine-parseable, greppable by key) and every record
emitted while a request context is open carries that request's id:

- `request_context(request_id=None)` — context manager for the request
  boundary. Honors an id the client sent (``X-Request-ID``), otherwise
  generates one; the HTTP server echoes it back on the response so a client
  report always names a correlatable id.
- `current_request_id()` — whatever id is in scope (a `contextvars`
  ContextVar, so it propagates through nested spans and helper calls on the
  same thread without plumbing an argument through every signature).
- `get_logger(name)` — a `StructuredLogger` whose ``info/warning/error``
  take an event name plus key=value fields and emit one JSON line through
  the stdlib logging tree (so handlers, levels and capture in tests all
  keep working).

The micro-batcher dispatches on its own worker thread, where the submitting
request's context is not live; `MicroBatcher.submit` captures
`current_request_id()` at enqueue time and the batch span/log carries the
captured ids (tests/test_telemetry.py pins that propagation).

Log schema (README "Observability")::

    {"ts": <unix seconds>, "level": "INFO", "logger": "cobalt.serve",
     "event": "request_error", "request_id": "...",
     "trace_id": <int>, "span_id": <int>, ...fields}

``trace_id``/``span_id`` appear whenever a span is in scope on the default
tracer — the same ids the flight recorder and ``GET /debug/trace`` carry,
so one grep joins a log line to its flight record and Perfetto track.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging as _logging
import time
import uuid
from typing import Any, Iterator

__all__ = [
    "StructuredLogger",
    "current_request_id",
    "get_logger",
    "new_request_id",
    "request_context",
]

_request_id: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "cobalt_request_id", default=None
)


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


def current_request_id() -> str | None:
    return _request_id.get()


@contextlib.contextmanager
def request_context(request_id: str | None = None) -> Iterator[str]:
    """Bind a request id for the duration of the block (honor the caller's
    id, else mint one) and yield it."""
    rid = request_id or new_request_id()
    token = _request_id.set(rid)
    try:
        yield rid
    finally:
        _request_id.reset(token)


def _json_default(o: Any) -> str:
    return str(o)


class StructuredLogger:
    """Thin wrapper over a stdlib logger emitting one JSON object per line.

    ``logger.info("reload", status="ok", model_key=key)`` →

        {"ts": ..., "level": "INFO", "logger": "cobalt.serve",
         "event": "reload", "request_id": ..., "status": "ok",
         "model_key": "..."}

    ``request_id`` is included automatically when a `request_context` is
    open (omitted otherwise, not null-padded). Field values must be
    JSON-able; anything else is stringified rather than raising — a log
    call must never take down the request it describes."""

    def __init__(self, logger: _logging.Logger, clock=time.time):
        self._logger = logger
        self._clock = clock

    @property
    def stdlib(self) -> _logging.Logger:
        return self._logger

    def _emit(self, level: int, event: str, fields: dict[str, Any]) -> None:
        if not self._logger.isEnabledFor(level):
            return
        record: dict[str, Any] = {
            "ts": round(self._clock(), 6),
            "level": _logging.getLevelName(level),
            "logger": self._logger.name,
            "event": event,
        }
        rid = current_request_id()
        if rid is not None:
            record["request_id"] = rid
        # Stamp the active trace/span id next to the request id so logs,
        # flight records and GET /debug/trace all join on one key. Lazy
        # import: logging must not cost a tracing import at module load for
        # consumers that never trace (and tracing imports nothing back).
        if "trace_id" not in fields:
            from cobalt_smart_lender_ai_tpu_torch.telemetry.tracing import (
                current_trace_ids,
            )

            ids = current_trace_ids()
            if ids is not None:
                record["trace_id"], record["span_id"] = ids
        # Same for the control-plane event id: a line written while an
        # `event_context` is open in this thread carries the journal's join
        # key, so logs, flight records, traces and the journal share one id.
        if "event_id" not in fields:
            from cobalt_smart_lender_ai_tpu_torch.telemetry.events import (
                current_event_id,
            )

            eid = current_event_id()
            if eid is not None:
                record["event_id"] = eid
        record.update(fields)
        self._logger.log(
            level, json.dumps(record, default=_json_default, sort_keys=False)
        )

    def debug(self, event: str, **fields: Any) -> None:
        self._emit(_logging.DEBUG, event, fields)

    def info(self, event: str, **fields: Any) -> None:
        self._emit(_logging.INFO, event, fields)

    def warning(self, event: str, **fields: Any) -> None:
        self._emit(_logging.WARNING, event, fields)

    def error(self, event: str, **fields: Any) -> None:
        self._emit(_logging.ERROR, event, fields)


def get_logger(name: str) -> StructuredLogger:
    """Structured logger under the ``cobalt`` logging namespace; the same
    name returns a wrapper over the same stdlib logger, so handler/level
    configuration applies uniformly."""
    if not name.startswith("cobalt"):
        name = f"cobalt.{name}"
    return StructuredLogger(_logging.getLogger(name))
