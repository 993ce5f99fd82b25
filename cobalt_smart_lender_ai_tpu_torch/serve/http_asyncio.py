"""Asyncio HTTP/1.1 server over a `ScorerService`: one event loop from the
socket to the micro-batcher's future.

Routes: ``POST /predict``, ``POST /predict_bulk_csv``,
``POST /feature_importance_bulk``, ``GET /healthz``, ``GET /readyz``.
Typed request errors (`reliability.errors`) keep their status: 422 invalid
input, 413 payload too large, 504 deadline exceeded; the importance route
answers 400 on empty data, and a bulk failure that is not typed is a 500
``bulk_failed``.
"""

from __future__ import annotations

import asyncio
import contextlib
import email.parser
import email.policy
import json
import threading
from http.client import responses as _REASONS
from urllib.parse import urlsplit

from cobalt_smart_lender_ai_tpu_torch.reliability.errors import (
    RequestError,
    ValidationError,
    error_response,
)
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

__all__ = ["AsyncScorerServer", "make_async_server", "serve_forever"]

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
    return method, urlsplit(target).path, headers, body


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
                    await self._write(writer, 400, {"detail": str(exc), "error": "bad_request"}, False)
                    break
                except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
                    break
                if req is None:
                    break
                method, path, headers, body = req
                keep_alive = headers.get("connection", "").lower() != "close"
                status, obj = await self._handle(method, path, headers, body)
                await self._write(writer, status, obj, keep_alive)
                if not keep_alive:
                    break
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    @staticmethod
    async def _write(writer: asyncio.StreamWriter, status: int, obj, keep_alive: bool) -> None:
        data = json.dumps(obj).encode()
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n"
        ).encode("latin-1")
        writer.write(head + data)
        await writer.drain()

    async def _handle(self, method: str, path: str, headers: dict, body: bytes):
        """Route one request -> ``(status, JSON body)``."""
        service = self.service
        try:
            if method == "GET" and path == "/healthz":
                return 200, service.health()
            if method == "GET" and path == "/readyz":
                ready, payload = service.ready()
                return (200 if ready else 503), payload
            if method == "POST" and path == "/predict":
                return 200, await service.predict_single_async(_json_body(body))
            if method == "POST" and path == "/predict_bulk_csv":
                csv_bytes = _extract_csv(body, headers.get("content-type", ""))
                try:
                    return 200, await service.predict_bulk_csv_async(csv_bytes)
                except RequestError:
                    raise
                except Exception as e:  # the reference answers 500 here
                    return 500, {"detail": f"Bulk prediction failed: {e}", "error": "bulk_failed"}
            if method == "POST" and path == "/feature_importance_bulk":
                payload = _json_body(body)  # malformed JSON -> 422
                try:
                    return 200, await service.feature_importance_bulk_async(payload)
                except ValidationError as e:
                    return 400, e.body()  # empty data is a 400 on this route
            if method not in ("GET", "POST"):
                return 501, {"detail": f"Unsupported method ({method!r})", "error": "unsupported_method"}
            return 404, {"detail": "Not Found"}
        except RequestError as e:
            return error_response(e)
        except Exception as e:
            return 500, {"detail": f"Internal server error: {e}", "error": "internal"}


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
