"""Asyncio HTTP/1.1 server over a `ScorerService`: one event loop from the
socket to the micro-batcher's future.

Routes: ``POST /predict``, ``POST /predict_bulk_csv``,
``POST /feature_importance_bulk``, ``POST /admin/reload``,
``POST /admin/promote`` (body ``{"force": bool}``) and
``POST /admin/rollback`` (body ``{"reason": str}``), the fleet's
``POST /admin/quarantine`` (body ``{"replica": i, "reason": str}``),
``/admin/readmit`` (``{"replica": i}``) and ``/admin/autoscaler``, ``GET /healthz``,
``GET /readyz``, and the reference's observability routes: ``GET /metrics``
(Prometheus text, or OpenMetrics with exemplars on ``Accept:
application/openmetrics-text``), ``GET /slo``, ``GET /drift`` (per-feature
PSI against the training snapshot), ``GET /events`` (the control-plane
journal: ``?component=`` and ``?kind=`` from its taxonomy, ``?since=`` a
finite timestamp, ``?limit=`` 1..1000; 422 otherwise),
``GET /debug/requests`` and ``/debug/slowest`` (``?limit=``, ``?n=``/``?k=``,
1..1000, and ``?phase=``, one of the flight recorder's phases; 422
otherwise), ``GET /debug/programs`` (the kernel cost table) and
``GET /debug/trace`` (the span ring as Perfetto JSON).
Typed request errors (`reliability.errors`) keep their status and
headers: 422 invalid input, 413 payload too large, 429 shed (with
``Retry-After``), 503 circuit open (with ``Retry-After``), 504 deadline
exceeded, 500 worker dead, 409 promotion rejected (with the gate's
``report``) or rollback failed; the importance route answers 400 on empty
data, and a bulk failure that is not typed is a 500 ``bulk_failed``.

The three scoring routes hold an admission slot (`ScorerService.admission`)
while they score. ``POST /admin/reload`` (body ``{"model_key": ...}``,
optional) is never gated: it swaps the model on the loop's executor, so the
loop keeps serving, and answers 200 with the swap's result, 500
``reload_failed`` on a rollback, or 503 while the store's circuit is open.
The promote and rollback routes are ungated too and run on the executor, as
do the fleet's admin routes, which answer a typed 422 on a service that is
not a `serve.replicas.ReplicaSet`. When the server starts, the service's
journal is attached to its store and ships its segments
(`ScorerService.start_history`), and a fleet's supervisor starts its loop.

Every request runs inside a `request_context` (a client's
``X-Request-ID`` is honoured, else one is minted; it is echoed on the
response) and a root ``http.request`` span: its latency and status feed
``cobalt_request_latency_seconds``, a data-plane request is
flight-recorded with its phases, and a non-2xx writes one structured log
line.
"""

from __future__ import annotations

import asyncio
import contextlib
import email.parser
import email.policy
import json
import math
import threading
from http.client import responses as _REASONS
from typing import Any
from urllib.parse import parse_qs, urlsplit

from cobalt_smart_lender_ai_tpu_torch.reliability.errors import (
    ReloadFailed,
    RequestError,
    ValidationError,
    error_response,
)
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
from cobalt_smart_lender_ai_tpu_torch.telemetry import (
    EXPOSITION_CONTENT_TYPE,
    META_ROUTES,
    OPENMETRICS_CONTENT_TYPE,
    TRACE_CONTENT_TYPE,
    collect_phases,
    default_program_registry,
    default_tracer,
    get_logger,
    render_chrome_trace,
    request_context,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.events import EVENT_KINDS
from cobalt_smart_lender_ai_tpu_torch.telemetry.flight import PHASES

__all__ = ["AsyncScorerServer", "make_async_server", "serve_forever"]

_LOG = get_logger("cobalt.serve.http_asyncio")

#: Hard ceiling for ``?limit=`` on the debug routes.
DEBUG_LIMIT_MAX = 1000

#: Routes that become metric label values; anything else is "unmatched", so
#: a path-scanning client cannot mint one label per probe.
_KNOWN_ROUTES = frozenset(
    {
        "/predict",
        "/predict_bulk_csv",
        "/feature_importance_bulk",
        "/admin/reload",
        "/admin/promote",
        "/admin/rollback",
        "/admin/quarantine",
        "/admin/readmit",
        "/admin/autoscaler",
        "/healthz",
        "/readyz",
        "/metrics",
        "/slo",
        "/drift",
        "/events",
        "/debug/requests",
        "/debug/slowest",
        "/debug/trace",
        "/debug/programs",
    }
)

#: The fleet's admin routes (`serve.replicas.ReplicaSet` only).
_FLEET_ADMIN = ("/admin/quarantine", "/admin/readmit", "/admin/autoscaler")

#: Request-line and header-line ceiling: a hostile peer must not buffer
#: unbounded bytes into the loop.
_MAX_LINE_BYTES = 65536


class _BadRequest(Exception):
    """The request did not parse — answered 400 and the connection closed."""


async def _read_request(reader: asyncio.StreamReader):
    """Parse one request: ``(method, path, headers, body)``, or ``None`` when
    the peer closed cleanly between requests."""
    line = await reader.readline()
    if not line:
        return None
    if len(line) > _MAX_LINE_BYTES:
        raise _BadRequest("request line too long")
    parts = line.decode("latin-1").split()
    if len(parts) != 3:
        raise _BadRequest("malformed request line")
    method, target, _version = parts
    headers: dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n"):
            break
        if not h:
            raise _BadRequest("connection closed inside headers")
        if len(h) > _MAX_LINE_BYTES:
            raise _BadRequest("header line too long")
        name, sep, value = h.decode("latin-1").partition(":")
        if not sep:
            raise _BadRequest("malformed header line")
        headers[name.strip().lower()] = value.strip()
    try:
        length = int(headers.get("content-length", "0"))
    except ValueError:
        raise _BadRequest("malformed Content-Length") from None
    body = await reader.readexactly(length) if length > 0 else b""
    return method, target, headers, body


def _extract_csv(body: bytes, content_type: str) -> bytes:
    """The uploaded file of a multipart/form-data body (the part named
    ``file``, or any part with a filename), or a raw CSV body."""
    if content_type.startswith("multipart/form-data"):
        msg = email.parser.BytesParser(policy=email.policy.default).parsebytes(
            b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body
        )
        for part in msg.iter_parts():
            if part.get_content_disposition() == "form-data" and (
                part.get_param("name", header="content-disposition") == "file"
                or part.get_filename() is not None
            ):
                return part.get_payload(decode=True)
        raise ValidationError("multipart body contains no file part")
    return body


def _json_body(body: bytes):
    try:
        return json.loads(body.decode() or "{}")
    except (UnicodeDecodeError, json.JSONDecodeError):
        raise ValidationError("body is not valid JSON") from None


def validate_debug_limit(value: int, name: str = "limit") -> int:
    """The debug routes' ``limit`` bound (1..DEBUG_LIMIT_MAX), 422 outside."""
    if not 1 <= value <= DEBUG_LIMIT_MAX:
        raise ValidationError(f"query param {name!r} must be between 1 and {DEBUG_LIMIT_MAX}")
    return value


def validate_debug_phase(phase: str | None) -> str | None:
    """The debug routes' ``phase``: one of the flight recorder's phases."""
    if phase is not None and phase not in PHASES:
        raise ValidationError(f"query param 'phase' must be one of {sorted(PHASES)}")
    return phase


def _query_limit(query: dict, legacy: str, default: int) -> int:
    """``?limit=`` (``?n=``/``?k=`` still accepted), bounded."""
    name = "limit" if "limit" in query else legacy
    raw = query.get(name, [None])[-1]
    if raw is None:
        return validate_debug_limit(default, name)
    try:
        value = int(raw)
    except ValueError:
        raise ValidationError(f"query param {name!r} must be an integer") from None
    return validate_debug_limit(value, name)


def validate_events_params(
    component: str | None,
    kind: str | None,
    since: str | None,
    limit: str | None,
) -> tuple[str | None, str | None, float | None, int | None]:
    """``GET /events`` query validation: ``component`` and ``kind`` from the
    `EVENT_KINDS` taxonomy (``kind`` scoped to the component when both are
    given), ``since`` a finite wall timestamp in seconds, ``limit`` the
    debug routes' bound; anything else is the typed 422."""
    if component is not None and component not in EVENT_KINDS:
        raise ValidationError(f"query param 'component' must be one of {sorted(EVENT_KINDS)}")
    if kind is not None:
        scope = (
            EVENT_KINDS[component]
            if component is not None
            else tuple(k for ks in EVENT_KINDS.values() for k in ks)
        )
        if kind not in scope:
            raise ValidationError(f"query param 'kind' must be one of {sorted(set(scope))}")
    since_t: float | None = None
    if since is not None:
        try:
            since_t = float(since)
        except ValueError:
            raise ValidationError("query param 'since' must be a timestamp in seconds") from None
        if not math.isfinite(since_t):
            raise ValidationError("query param 'since' must be a finite timestamp in seconds")
    limit_n: int | None = None
    if limit is not None:
        try:
            limit_n = int(limit)
        except ValueError:
            raise ValidationError("query param 'limit' must be an integer") from None
        validate_debug_limit(limit_n)
    return component, kind, since_t, limit_n


def events_payload(
    owner: Any, component: str | None, kind: str | None, since: str | None, limit: str | None
) -> dict:
    """``GET /events``: the owner's filtered journal snapshot, its count and
    the journal's own health (`EventJournal.stats`)."""
    component, kind, since_t, limit_n = validate_events_params(component, kind, since, limit)
    events = owner.events(component=component, kind=kind, since=since_t, limit=limit_n)
    return {"events": events, "count": len(events), "stats": owner.journal.stats()}


def debug_programs_payload() -> dict:
    """``GET /debug/programs``: the kernel cost table and its totals."""
    reg = default_program_registry()
    return {"programs": reg.table(), "totals": reg.totals()}


class _Response:
    """What a route answers: status, body bytes and content type (or a JSON
    object, encoded when it is written), and extra headers."""

    __slots__ = ("status", "obj", "data", "content_type", "headers")

    def __init__(self, status: int, obj=None, data: bytes | None = None,
                 content_type: str = "application/json", headers: dict | None = None):
        self.status = status
        self.obj = obj
        self.data = data
        self.content_type = content_type
        self.headers = headers or {}


class AsyncScorerServer:
    """The event-loop server. `serve_forever` blocks the calling thread on
    its own loop (the CLI); `start`/`close` run the loop on a background
    thread so tests and scripts can drive it synchronously."""

    def __init__(self, service: ScorerService, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self._host = host
        self._port = port
        self._bound_port: int | None = None
        self._server: asyncio.base_events.Server | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._start_error: BaseException | None = None
        self._conn_tasks: set[asyncio.Task] = set()

    async def start_async(self) -> "AsyncScorerServer":
        """Bind inside an already-running loop."""
        self._server = await asyncio.start_server(
            self._serve_connection, self._host, self._port
        )
        self._bound_port = self._server.sockets[0].getsockname()[1]
        # Journal shipping and fleet supervision are serving concerns: they
        # start with the socket.
        self.service.start_history()
        start_supervisor = getattr(self.service, "start_supervisor", None)
        if start_supervisor is not None:
            start_supervisor()
        return self

    def start(self) -> "AsyncScorerServer":
        """Run a dedicated event loop on a background thread; return once
        the port is bound."""
        self._loop = asyncio.new_event_loop()
        started = threading.Event()

        def _run() -> None:
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self.start_async())
            except BaseException as exc:  # surface bind failures to start()
                self._start_error = exc
                started.set()
                return
            started.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=_run, daemon=True, name="asyncio-http")
        self._thread.start()
        if not started.wait(timeout=30.0):
            raise RuntimeError("asyncio server failed to start within 30s")
        if self._start_error is not None:
            raise self._start_error
        return self

    @property
    def port(self) -> int:
        if self._bound_port is None:
            raise RuntimeError("server is not started")
        return self._bound_port

    def close(self) -> None:
        """Stop accepting, cancel idle connections, join the loop thread.
        The service is not closed: the caller owns it."""
        loop, thread = self._loop, self._thread
        if loop is None:
            return

        async def _shutdown() -> None:
            if self._server is not None:
                self._server.close()
                await self._server.wait_closed()
            for task in list(self._conn_tasks):
                task.cancel()
            if self._conn_tasks:
                await asyncio.gather(*self._conn_tasks, return_exceptions=True)

        with contextlib.suppress(Exception):
            asyncio.run_coroutine_threadsafe(_shutdown(), loop).result(timeout=10.0)
        loop.call_soon_threadsafe(loop.stop)
        if thread is not None:
            thread.join(timeout=10.0)
        loop.close()
        self._loop = self._thread = None

    async def _serve_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """One task per connection; its requests run in sequence (HTTP/1.1
        keep-alive, no pipelining)."""
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        try:
            while True:
                try:
                    req = await _read_request(reader)
                except _BadRequest as exc:
                    # No route, request id or span yet to attribute it to.
                    await self._write(
                        writer, _Response(400, {"detail": str(exc), "error": "bad_request"}), None, False
                    )
                    break
                except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
                    break
                if req is None:
                    break
                method, target, headers, body = req
                keep_alive = headers.get("connection", "").lower() != "close"
                await self._dispatch_request(method, target, headers, body, writer, keep_alive)
                if not keep_alive:
                    break
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    async def _dispatch_request(
        self, method: str, target: str, headers: dict, body: bytes,
        writer: asyncio.StreamWriter, keep_alive: bool,
    ) -> None:
        """One request's envelope: its request id, a root ``http.request``
        span (whose id is the request's trace id), the route, the response
        write (the ``serialize`` phase of a data-plane request), then the
        latency observation, the flight record and, on a non-2xx, a log
        line."""
        service = self.service
        split = urlsplit(target)
        path = split.path
        route = path if path in _KNOWN_ROUTES else "unmatched"
        with request_context(headers.get("x-request-id") or None) as rid:
            with collect_phases() as phases, default_tracer().span(
                "http.request", route=route, method=method, request_id=rid
            ) as root:
                resp = await self._handle(method, path, parse_qs(split.query), headers, body)
                if path in META_ROUTES:
                    await self._write(writer, resp, rid, keep_alive)
                else:
                    with service.phase("serialize"):
                        await self._write(writer, resp, rid, keep_alive)
            duration_s = root.duration_s or 0.0
            code = None
            if resp.status >= 400 and isinstance(resp.obj, dict):
                code = resp.obj.get("error")
            service.observe_request(route, resp.status, duration_s, code=code, trace_id=root.trace_id)
            if route not in META_ROUTES:
                service.flight.record(
                    request_id=rid,
                    trace_id=root.trace_id,
                    route=route,
                    method=method,
                    status=resp.status,
                    duration_s=duration_s,
                    code=code,
                    phases=phases.phases,
                )
            if resp.status >= 400:
                _LOG.warning(
                    "request_error",
                    method=method,
                    route=route,
                    status=resp.status,
                    code=code or "error",
                    duration_ms=round(duration_s * 1000.0, 3),
                    trace_id=root.trace_id,
                    span_id=root.span_id,
                )

    @staticmethod
    async def _write(
        writer: asyncio.StreamWriter, resp: _Response, request_id: str | None, keep_alive: bool
    ) -> None:
        data = resp.data if resp.data is not None else json.dumps(resp.obj).encode()
        lines = [
            f"HTTP/1.1 {resp.status} {_REASONS.get(resp.status, 'Unknown')}",
            f"Content-Type: {resp.content_type}",
            f"Content-Length: {len(data)}",
        ]
        if request_id:
            lines.append(f"X-Request-ID: {request_id}")
        lines.extend(f"{name}: {value}" for name, value in resp.headers.items())
        lines.append(f"Connection: {'keep-alive' if keep_alive else 'close'}")
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + data)
        await writer.drain()

    async def _handle(self, method: str, path: str, query: dict, headers: dict, body: bytes) -> _Response:
        """Route one request."""
        service = self.service
        try:
            if method == "GET":
                resp = self._get(path, query, headers)
                if resp is not None:
                    return resp
            if method == "POST" and path == "/admin/reload":
                return await self._reload(body)
            if method == "POST" and path == "/admin/promote":
                payload = _json_body(body)
                force = isinstance(payload, dict) and bool(payload.get("force", False))
                return _Response(200, await asyncio.to_thread(service.promote_canary, force=force))
            if method == "POST" and path == "/admin/rollback":
                payload = _json_body(body)
                reason = (
                    str(payload.get("reason", "manual")) if isinstance(payload, dict) else "manual"
                )
                return _Response(200, await asyncio.to_thread(service.rollback_model, reason=reason))
            if method == "POST" and path in _FLEET_ADMIN:
                return await self._fleet_admin(path, body)
            if method == "POST" and path == "/predict":
                with service.admission.admit():
                    return _Response(200, await service.predict_single_async(_json_body(body)))
            if method == "POST" and path == "/predict_bulk_csv":
                with service.admission.admit():
                    csv_bytes = _extract_csv(body, headers.get("content-type", ""))
                    try:
                        return _Response(200, await service.predict_bulk_csv_async(csv_bytes))
                    except RequestError:
                        raise
                    except Exception as e:  # the reference answers 500 here
                        return _Response(
                            500, {"detail": f"Bulk prediction failed: {e}", "error": "bulk_failed"}
                        )
            if method == "POST" and path == "/feature_importance_bulk":
                with service.admission.admit():
                    payload = _json_body(body)  # malformed JSON -> 422
                    try:
                        return _Response(200, await service.feature_importance_bulk_async(payload))
                    except ValidationError as e:
                        return _Response(400, e.body())  # empty data is a 400 on this route
            if method not in ("GET", "POST"):
                return _Response(
                    501,
                    {"detail": f"Unsupported method ({method!r})", "error": "unsupported_method"},
                )
            return _Response(404, {"detail": "Not Found"})
        except RequestError as e:
            status, obj, extra = error_response(e)
            return _Response(status, obj, headers=extra)
        except Exception as e:
            return _Response(500, {"detail": f"Internal server error: {e}", "error": "internal"})

    async def _fleet_admin(self, path: str, body: bytes) -> _Response:
        """The fleet's admin plane on the executor: quarantine or readmit a
        replica, or the autoscaler's steering. Ungated: an operator must be
        able to pull a sick replica while the data plane sheds."""
        payload = _json_body(body)
        if not isinstance(payload, dict):
            raise ValidationError("body must be a JSON object")
        method, args, kwargs = {
            "/admin/quarantine": (
                "quarantine_replica",
                (payload.get("replica"),),
                {"reason": str(payload.get("reason", "manual quarantine"))},
            ),
            "/admin/readmit": ("readmit_replica", (payload.get("replica"),), {}),
            "/admin/autoscaler": ("autoscaler_admin", (payload,), {}),
        }[path]
        fn = getattr(self.service, method, None)
        if fn is None:
            raise ValidationError(
                f"service is not a replicated fleet; {path} requires replicas >= 2"
            )
        return _Response(200, await asyncio.to_thread(fn, *args, **kwargs))

    async def _reload(self, body: bytes) -> _Response:
        """``POST /admin/reload``: the swap runs on the default executor (it
        restores, packs and warms the candidate), so the loop keeps
        serving."""
        payload = _json_body(body)
        if not isinstance(payload, dict):
            raise ValidationError("body must be a JSON object")
        result = await asyncio.to_thread(
            self.service.reload_from_store, model_key=payload.get("model_key")
        )
        if result["status"] == "ok":
            return _Response(200, result)
        failed = ReloadFailed(f"reload rolled back: {result['error']}")
        return _Response(
            500, {**failed.body(), "status": result["status"], "model_key": result["model_key"]}
        )

    def _get(self, path: str, query: dict, headers: dict) -> _Response | None:
        """A GET route's response, or None when no GET route matches."""
        service = self.service
        if path == "/healthz":
            return _Response(200, service.health())
        if path == "/readyz":
            ready, payload = service.ready()
            return _Response(200 if ready else 503, payload)
        if path == "/metrics":
            openmetrics = "application/openmetrics-text" in headers.get("accept", "")
            return _Response(
                200,
                data=service.registry.render(openmetrics=openmetrics).encode(),
                content_type=OPENMETRICS_CONTENT_TYPE if openmetrics else EXPOSITION_CONTENT_TYPE,
            )
        if path == "/slo":
            if service.slo is None:
                return _Response(404, {"detail": "SLO engine disabled", "error": "slo_disabled"})
            return _Response(200, service.slo.evaluate(force=True))
        if path == "/drift":
            return _Response(200, service.drift_report())
        if path == "/events":
            if getattr(service, "journal", None) is None:
                return _Response(404, {"detail": "events disabled", "error": "events_disabled"})
            return _Response(
                200,
                events_payload(
                    service,
                    *(query.get(name, [None])[-1] for name in ("component", "kind", "since", "limit")),
                ),
            )
        if path == "/debug/requests":
            n = _query_limit(query, "n", 50)
            phase = validate_debug_phase(query.get("phase", [None])[-1])
            return _Response(
                200,
                {
                    "recent": service.flight.records(n, phase),
                    "errors": service.flight.errors(n, phase),
                    "stats": service.flight.stats(),
                },
            )
        if path == "/debug/slowest":
            k = _query_limit(query, "k", service.flight.top_k)
            phase = validate_debug_phase(query.get("phase", [None])[-1])
            return _Response(
                200, {"slowest": service.flight.slowest(k, phase), "stats": service.flight.stats()}
            )
        if path == "/debug/programs":
            return _Response(200, debug_programs_payload())
        if path == "/debug/trace":
            return _Response(
                200,
                data=render_chrome_trace(default_tracer()).encode(),
                content_type=TRACE_CONTENT_TYPE,
            )
        return None


def make_async_server(
    service: ScorerService, host: str = "127.0.0.1", port: int = 0
) -> AsyncScorerServer:
    """Build and start the background-thread server; port 0 picks a free
    port. Callers own ``.close()`` (and the service)."""
    return AsyncScorerServer(service, host, port).start()


def serve_forever(service: ScorerService, host: str = "0.0.0.0", port: int = 8000) -> None:
    """Blocking server loop for the CLI; drains the service at exit."""

    async def _main() -> None:
        server = await AsyncScorerServer(service, host, port).start_async()
        async with server._server:
            await server._server.serve_forever()

    try:
        asyncio.run(_main())
    except KeyboardInterrupt:
        pass
    finally:
        service.close()
