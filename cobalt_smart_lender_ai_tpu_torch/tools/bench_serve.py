"""Serving benchmarks of the port (the port's copy of the reference's
``bench_serve.py``): the closed loop, the async HTTP grid, the chaos fleet,
the open-loop traffic fleet and the bulk path, each writing the reference's
record.

Trains a small GBDT on the synthetic LendingClub frame in-process (no
store, no network) on ``--device`` (``cuda`` unless ``--device cpu`` is
given; ``cuda`` without a card raises), then hammers
`ScorerService.predict_single` from N closed-loop client threads — each
client issues its next request the moment the previous one resolves,
exactly the concurrency shape the micro-batcher coalesces. ``--mode both``
measures batcher-on vs batcher-off on the same trained model:

    python -m cobalt_smart_lender_ai_tpu_torch.tools.bench_serve --clients 32 --duration-s 5

``--mix mixed`` interleaves bulk-CSV calls (1 in 8) with single-row scoring;
``--smoke`` is the short profile (4 clients, ~1s per mode);
``--http-smoke`` also drives load over real sockets and scrapes
``/metrics`` during it. Latency percentiles are over single-row requests
only, and the warmup window is excluded from every metric. On the card
every micro-batch and bulk chunk is one ``score_forest`` launch
(``csrc/score_forest.cu``), and the in-process fit runs the
``gradient_histogram`` kernel once per tree level.

The other modes, one record each:

- ``--async-clients``: ``--client-counts`` closed-loop HTTP clients from one
  event loop against each adapter in ``--impls`` (``serve_async_http``);
- ``--chaos``: a supervised ``--chaos-replicas`` fleet with one replica's
  worker killed and then hung mid-run (``serve_chaos``);
- ``--traffic SHAPE``: an open-loop seeded arrival schedule
  (`reliability.traffic`) against an autoscaled fleet (``serve_traffic``);
- ``--bulk``: one ``--bulk-rows`` matrix scored through
  `ScorerService.predict_proba` at each ``--bulk-shards`` setting
  (``bulk_scoring``: rows/s per shard count and a bit-identity check).

``--force-devices n`` names the one card ``n`` times
(`tools.bench_common.force_devices`): the shards of a mesh then share one
physical card, so the bulk record measures no scaling, and it says so in
its ``force_devices`` block. The clients stay in this process, as in the
reference.

Each record carries the reference's keys, with ``platform`` ``"gpu"`` or
``"cpu"`` and a ``card`` block (`tools.bench_common`). It goes to ``--out``
or stdout; ``--trend-out`` appends its metrics to a trend file
(``TREND_torch.json`` when given without a path), never to the
committed ``TREND.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.tools.bench_common import (
    DEFAULT_TREND,
    append_trend,
    card_block,
    device_count,
    force_devices,
    host_cpu_cores,
    platform_tag,
    summary,
    write_record,
)


def _percentile(samples: list[float], q: float) -> float:
    """Nearest-rank percentile; ``samples`` must be sorted ascending."""
    if not samples:
        return float("nan")
    idx = min(len(samples) - 1, max(0, int(round(q * (len(samples) - 1)))))
    return samples[idx]


def _fetch_events(port: int, **params) -> dict:
    """``GET /events`` against the bench server — the fleet's event
    journal is the bench's source of truth for control-plane state
    (heals, resizes, brownout rungs), read over the same HTTP surface an
    operator would use instead of reaching into fleet internals."""
    import urllib.request
    from urllib.parse import urlencode

    qs = urlencode({k: v for k, v in params.items() if v is not None})
    url = f"http://127.0.0.1:{port}/events" + (f"?{qs}" if qs else "")
    with urllib.request.urlopen(url, timeout=5.0) as resp:
        return json.loads(resp.read().decode())


def _events_block(port: int) -> dict | None:
    """The committed record's journal snapshot (``events.journal`` +
    ``events.stats``) — the input `tools/incident_report.py` stitches
    into a postmortem. ``None`` if the server is already gone."""
    try:
        doc = _fetch_events(port)
    except Exception:
        return None
    return {"journal": doc.get("events", []), "stats": doc.get("stats", {})}


def build_service(config, n_rows: int, seed: int = 7, *, device="cuda"):
    """Train a small serving-contract model on ``device`` and wrap it in a
    `ScorerService` there (the reference's ``serving_artifact`` recipe,
    minus the object store). Returns the service and the (N, 20) float32
    tree matrix on the host."""
    from cobalt_smart_lender_ai_tpu_torch.data import schema
    from cobalt_smart_lender_ai_tpu_torch.data.clean import clean_raw_frame
    from cobalt_smart_lender_ai_tpu_torch.data.features import (
        engineer_features,
        prepare_cleaned_frame,
    )
    from cobalt_smart_lender_ai_tpu_torch.data.synthetic import (
        synthetic_lendingclub_frame,
    )
    from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact
    from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier
    from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

    dev = resolve_device(device)
    raw = synthetic_lendingclub_frame(n_rows=n_rows, seed=seed)
    cleaned, _ = clean_raw_frame(raw)
    tree_ff, _, _ = engineer_features(prepare_cleaned_frame(cleaned), device=dev)
    ff = tree_ff.select(schema.SERVING_FEATURES)
    model = GBDTClassifier(n_estimators=25, max_depth=3, n_bins=64, device=dev)
    model.fit(ff.X, ff.y)
    artifact = GBDTArtifact(
        forest=model.forest,
        feature_names=tuple(schema.SERVING_FEATURES),
        bin_edges=model.bin_spec.edges.cpu().numpy(),
    )
    return ScorerService(artifact, config, device=dev), ff.X.cpu().numpy()


def build_csv(X: np.ndarray, names) -> bytes:
    """The bulk-CSV body of ``X``'s rows: a header of ``names``, each value
    as float32's shortest text, a missing value as an empty cell (what
    pandas' ``to_csv`` writes for the reference's mixed mode)."""
    lines = [",".join(names)]
    lines += [",".join("" if np.isnan(v) else str(v) for v in row) for row in X]
    return ("\n".join(lines) + "\n").encode()


def build_payloads(X, n_payloads: int = 256) -> list[dict]:
    """Distinct request bodies cycled by the clients, keyed by the aliased
    wire-format field names the validation schema expects. The tree matrix
    carries NaN (trees route missing natively) but the single-input schema
    requires finite values, so NaN becomes 0.0 on the wire."""
    import math

    from cobalt_smart_lender_ai_tpu_torch.data import schema

    keys = [
        schema.SERVING_FIELD_ALIASES.get(name, name)
        for name in schema.SERVING_FEATURES
    ]
    payloads = []
    for i in range(min(n_payloads, X.shape[0])):
        payloads.append(
            {
                k: float(v) if math.isfinite(v) else 0.0
                for k, v in zip(keys, X[i])
            }
        )
    return payloads


def run_load(
    service,
    payloads: list[dict],
    csv_bytes: bytes | None,
    *,
    clients: int,
    duration_s: float,
    warmup_s: float,
    mix: str,
) -> dict:
    """Drive `clients` closed-loop threads against `service` and return the
    steady-state (post-warmup) throughput/latency summary."""
    start_barrier = threading.Barrier(clients + 1)
    stop_at = [0.0]  # filled in after the barrier releases
    record_from = [0.0]
    single_lat: list[list[float]] = [[] for _ in range(clients)]
    bulk_lat: list[list[float]] = [[] for _ in range(clients)]
    bulk_rows: list[int] = [0] * clients
    errors: list[int] = [0] * clients

    def client(idx: int) -> None:
        start_barrier.wait()
        i = idx  # offset so clients don't all score the same row
        while True:
            now = time.monotonic()
            if now >= stop_at[0]:
                return
            is_bulk = csv_bytes is not None and mix == "mixed" and i % 8 == 7
            t0 = time.perf_counter()
            try:
                if is_bulk:
                    resp = service.predict_bulk_csv(csv_bytes)
                    n = len(resp["predictions"])
                else:
                    service.predict_single(payloads[i % len(payloads)])
                    n = 0
            except Exception:
                errors[idx] += 1
                i += 1
                continue
            elapsed_ms = (time.perf_counter() - t0) * 1e3
            if now >= record_from[0]:
                if is_bulk:
                    bulk_lat[idx].append(elapsed_ms)
                    bulk_rows[idx] += n
                else:
                    single_lat[idx].append(elapsed_ms)
            i += 1

    threads = [
        threading.Thread(target=client, args=(i,), daemon=True)
        for i in range(clients)
    ]
    for t in threads:
        t.start()
    t_start = time.monotonic()
    record_from[0] = t_start + warmup_s
    stop_at[0] = record_from[0] + duration_s
    start_barrier.wait()
    for t in threads:
        t.join()

    singles = sorted(lat for per in single_lat for lat in per)
    bulks = sorted(lat for per in bulk_lat for lat in per)
    n_singles, n_bulks = len(singles), len(bulks)
    result = {
        "requests": n_singles + n_bulks,
        "qps": round((n_singles + n_bulks) / duration_s, 1),
        "single_qps": round(n_singles / duration_s, 1),
        "errors": sum(errors),
        "p50_ms": round(_percentile(singles, 0.50), 3),
        "p95_ms": round(_percentile(singles, 0.95), 3),
        "p99_ms": round(_percentile(singles, 0.99), 3),
        "p99.9_ms": round(_percentile(singles, 0.999), 3),
        "max_ms": round(singles[-1], 3) if singles else float("nan"),
        "mean_ms": round(statistics.fmean(singles), 3) if singles else float("nan"),
    }
    if n_bulks:
        result["bulk_calls"] = n_bulks
        result["bulk_rows_per_s"] = round(sum(bulk_rows) / duration_s, 1)
        result["bulk_p95_ms"] = round(_percentile(bulks, 0.95), 3)
    if service.batcher is not None:
        result["microbatch"] = service.batcher.stats()
    phases = _phase_breakdown(service.registry)
    if phases:
        result["phases"] = phases
    return result


def _phase_breakdown(registry) -> dict[str, dict]:
    """Where the time went, per request phase, from the
    ``cobalt_request_phase_seconds`` histogram the service populates on
    every `predict_single` — the bench-record answer to "queue-wait or
    dispatch or SHAP?". Includes warmup traffic (cumulative counters), so
    cold compiles show up in the phase that paid them."""
    fam = registry.snapshot().get("cobalt_request_phase_seconds")
    if not fam:
        return {}
    out: dict[str, dict] = {}
    total_s = sum(s["sum"] for s in fam["samples"]) or 1.0
    for sample in fam["samples"]:
        phase = sample["labels"].get("phase", "?")
        count = sample["count"]
        if not count:
            continue
        out[phase] = {
            "count": count,
            "mean_ms": round(sample["sum"] / count * 1e3, 3),
            "total_ms": round(sample["sum"] * 1e3, 1),
            "share": round(sample["sum"] / total_s, 3),
        }
    return out


def run_http_smoke(
    config,
    artifact,
    payloads: list[dict],
    *,
    clients: int,
    duration_s: float,
    device="cuda",
) -> dict:
    """Stand up the asyncio HTTP server on a loopback port, drive concurrent
    POST /predict load over real sockets, and scrape ``GET /metrics`` both
    mid-load and after — validating the exposition parses and the
    request-latency histogram actually counted the traffic. This is the CI
    gate for the telemetry wiring (tier1.yml bench-smoke job)."""
    import http.client

    from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server
    from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
    from cobalt_smart_lender_ai_tpu_torch.telemetry import parse_exposition

    service = ScorerService(artifact, config, device=device)
    server = make_async_server(service)
    port = server.port

    errors = [0] * clients
    requests = [0] * clients
    stop_at = time.monotonic() + duration_s

    def client(idx: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        i = idx
        while time.monotonic() < stop_at:
            body = json.dumps(payloads[i % len(payloads)])
            try:
                conn.request(
                    "POST",
                    "/predict",
                    body,
                    {"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                resp.read()
                requests[idx] += 1
                if resp.status != 200:
                    errors[idx] += 1
            except Exception:
                errors[idx] += 1
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            i += 1
        conn.close()

    def scrape(path: str = "/metrics", accept: str | None = None) -> tuple[str, str]:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            conn.request("GET", path, headers={"Accept": accept} if accept else {})
            resp = conn.getresponse()
            text = resp.read().decode()
            return text, resp.getheader("Content-Type") or ""
        finally:
            conn.close()

    threads = [
        threading.Thread(target=client, args=(i,), daemon=True)
        for i in range(clients)
    ]
    try:
        for t in threads:
            t.start()
        # scrape while the load is live: the endpoint must serve cleanly
        # under concurrent traffic, not just at rest
        time.sleep(duration_s / 2)
        during_text, during_ctype = scrape()
        parse_exposition(during_text)
        for t in threads:
            t.join()
        final_text, _ = scrape()
        families = parse_exposition(final_text)
        # the OpenMetrics variant (exemplar trace ids on latency buckets)
        # must parse through the same strict parser
        om_text, om_ctype = scrape(accept="application/openmetrics-text")
        parse_exposition(om_text)
        slo_report = json.loads(scrape("/slo")[0])
        slowest = json.loads(scrape("/debug/slowest?k=3")[0])
    finally:
        server.close()
        service.close()

    latency = families.get("cobalt_request_latency_seconds", {"samples": {}})
    latency_count = sum(
        v
        for k, v in latency["samples"].items()
        if k.startswith("cobalt_request_latency_seconds_count")
    )
    batch_rows = families.get("cobalt_microbatch_batch_rows", {"samples": {}})
    batch_count = sum(
        v
        for k, v in batch_rows["samples"].items()
        if k.startswith("cobalt_microbatch_batch_rows_count")
    )
    top = (slowest.get("slowest") or [{}])[0]
    top_phases = top.get("phases_ms") or {}
    return {
        "requests": sum(requests),
        "errors": sum(errors),
        "families": len(families),
        "scrape_during_load_ok": bool(during_ctype.startswith("text/plain")),
        "openmetrics_ok": bool(
            om_ctype.startswith("application/openmetrics-text")
            and om_text.rstrip().endswith("# EOF")
        ),
        "request_latency_count": int(latency_count),
        "microbatch_batch_count": int(batch_count),
        # SLO + flight-recorder forensics over real sockets — CI fails the
        # build on fast_burn and keeps the slowest request's phase verdict
        # in the committed record
        "slo_fast_burn": bool(slo_report.get("fast_burn")),
        "slo_burn_rates": {
            o["name"]: o["windows"][0]["burn_rate"]
            for o in slo_report.get("objectives", [])
        },
        "slowest_ms": top.get("duration_ms"),
        "slowest_phase": (
            max(top_phases, key=top_phases.get) if top_phases else None
        ),
    }


async def _read_http_response(reader) -> tuple[int, bytes]:
    """Minimal HTTP/1.1 response parse (status + Content-Length body) for
    the async closed-loop clients — keep-alive, no chunked encoding."""
    line = await reader.readline()
    if not line:
        raise ConnectionError("server closed connection")
    status = int(line.split(None, 2)[1])
    length = 0
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n"):
            break
        if not h:
            raise ConnectionError("connection closed inside headers")
        if h.lower().startswith(b"content-length:"):
            length = int(h.split(b":", 1)[1])
    body = await reader.readexactly(length) if length else b""
    return status, body


def _start_bench_server(impl: str, service) -> tuple[int, "object"]:
    """Stand up one adapter over ``service`` on a loopback port. Returns
    ``(port, shutdown_callable)``."""
    if impl != "asyncio":
        raise SystemExit(
            f"unknown serving impl {impl!r} (the threaded adapter was "
            "removed; only 'asyncio' remains)"
        )
    from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import (
        make_async_server,
    )

    server = make_async_server(service)
    return server.port, server.close


def run_async_load(
    port: int,
    payloads: list[dict],
    *,
    clients: int,
    duration_s: float,
    warmup_s: float,
) -> dict:
    """Drive ``clients`` concurrent closed-loop HTTP clients from ONE event
    loop (one harness thread total, vs `run_http_smoke`'s thread per client)
    — so a 512-client run measures the server, not the harness's ability to
    schedule 512 OS threads. Each client holds a keep-alive connection and
    issues its next request the moment the previous response lands.

    Every non-200 counts as an error; an error body that fails to carry the
    typed ``"error"`` code from `reliability.errors` counts as *untyped* —
    the CI gate for the taxonomy surviving the async rewrite."""
    import asyncio

    from cobalt_smart_lender_ai_tpu_torch.telemetry import parse_exposition

    bodies = [json.dumps(p).encode() for p in payloads]
    requests_bytes = [
        (
            f"POST /predict HTTP/1.1\r\nHost: bench\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(b)}\r\n\r\n"
        ).encode() + b
        for b in bodies
    ]

    lat: list[list[float]] = [[] for _ in range(clients)]
    counts = [0] * clients
    errors = [0] * clients
    untyped = [0] * clients
    scrape_ok = [False]

    async def client(idx: int, record_from: float, stop_at: float) -> None:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        i = idx  # offset so clients don't all score the same row
        try:
            while time.monotonic() < stop_at:
                req = requests_bytes[i % len(requests_bytes)]
                t0 = time.perf_counter()
                try:
                    writer.write(req)
                    await writer.drain()
                    status, body = await _read_http_response(reader)
                except (ConnectionError, asyncio.IncompleteReadError):
                    # A clean close between requests is normal HTTP/1.1,
                    # not a scoring error — reconnect and retry.
                    writer.close()
                    reader, writer = await asyncio.open_connection(
                        "127.0.0.1", port
                    )
                    continue
                elapsed_ms = (time.perf_counter() - t0) * 1e3
                recording = time.monotonic() >= record_from
                if recording:
                    counts[idx] += 1
                    lat[idx].append(elapsed_ms)
                if status != 200:
                    if recording:
                        errors[idx] += 1
                    try:
                        typed = "error" in json.loads(body.decode())
                    except Exception:
                        typed = False
                    if not typed:
                        untyped[idx] += 1
                i += 1
        finally:
            writer.close()

    async def scraper(stop_at: float) -> None:
        # scrape /metrics while the load is live — the observability plane
        # must serve cleanly from the same loop that serves the data plane
        await asyncio.sleep(max(0.05, (stop_at - time.monotonic()) / 2))
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            writer.write(b"GET /metrics HTTP/1.1\r\nHost: bench\r\n\r\n")
            await writer.drain()
            status, body = await _read_http_response(reader)
            parse_exposition(body.decode())
            scrape_ok[0] = status == 200
        finally:
            writer.close()

    async def drive() -> None:
        t_start = time.monotonic()
        record_from = t_start + warmup_s
        stop_at = record_from + duration_s
        await asyncio.gather(
            scraper(stop_at),
            *(client(i, record_from, stop_at) for i in range(clients)),
        )

    asyncio.run(drive())
    singles = sorted(x for per in lat for x in per)
    n = len(singles)
    return {
        "clients": clients,
        "requests": n,
        "qps": round(n / duration_s, 1),
        "errors": sum(errors),
        "untyped_errors": sum(untyped),
        "scrape_during_load_ok": scrape_ok[0],
        "p50_ms": round(_percentile(singles, 0.50), 3),
        "p95_ms": round(_percentile(singles, 0.95), 3),
        "p99_ms": round(_percentile(singles, 0.99), 3),
        "p99.9_ms": round(_percentile(singles, 0.999), 3),
        "max_ms": round(singles[-1], 3) if singles else float("nan"),
        "mean_ms": round(statistics.fmean(singles), 3) if singles else float("nan"),
    }


def run_inproc_comparison(
    artifact,
    payloads: list[dict],
    *,
    clients: int,
    duration_s: float,
    warmup_s: float,
    mb_kwargs: dict,
    device="cuda",
) -> dict:
    """The BENCH_SERVE_r02 protocol (in-process clients, no sockets) at the
    r03 client count, once per request model: ``clients`` coroutines
    suspended on `predict_single_async` awaitable futures vs ``clients`` OS
    threads blocked in `predict_single`. This is the apples-to-apples
    successor to r02's 32-thread `queue_wait` number — the HTTP sections
    above it add socket/parse cost that r02 never paid."""
    import asyncio

    from cobalt_smart_lender_ai_tpu_torch.config import ReliabilityConfig, ServeConfig
    from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

    def _mk_service():
        return ScorerService(
            artifact,
            ServeConfig(
                microbatch_enabled=True,
                score_cache_size=0,
                slo_p99_ms=250.0,
                slo_p999_ms=2000.0,
                reliability=ReliabilityConfig(
                    max_in_flight=max(256, clients * 2)
                ),
                **mb_kwargs,
            ),
            device=device,
        )

    out: dict[str, dict] = {}

    service = _mk_service()
    print(
        f"[bench] in-process async @ {clients} clients (r02 protocol)...",
        file=sys.stderr,
    )
    lat: list[list[float]] = [[] for _ in range(clients)]
    errors = [0] * clients

    async def aclient(idx: int, record_from: float, stop_at: float) -> None:
        i = idx
        while time.monotonic() < stop_at:
            t0 = time.perf_counter()
            try:
                await service.predict_single_async(payloads[i % len(payloads)])
            except Exception:
                errors[idx] += 1
                i += 1
                continue
            elapsed_ms = (time.perf_counter() - t0) * 1e3
            if time.monotonic() >= record_from:
                lat[idx].append(elapsed_ms)
            i += 1

    async def adrive() -> None:
        t_start = time.monotonic()
        record_from = t_start + warmup_s
        stop_at = record_from + duration_s
        await asyncio.gather(
            *(aclient(i, record_from, stop_at) for i in range(clients))
        )

    asyncio.run(adrive())
    singles = sorted(x for per in lat for x in per)
    row = {
        "clients": clients,
        "requests": len(singles),
        "qps": round(len(singles) / duration_s, 1),
        "errors": sum(errors),
        "p50_ms": round(_percentile(singles, 0.50), 3),
        "p99_ms": round(_percentile(singles, 0.99), 3),
        "p99.9_ms": round(_percentile(singles, 0.999), 3),
        "phases": _phase_breakdown(service.registry),
        "microbatch": service.batcher.stats(),
    }
    service.close()
    out["async_futures"] = row

    service = _mk_service()
    print(
        f"[bench] in-process threaded @ {clients} clients (r02 protocol)...",
        file=sys.stderr,
    )
    row = run_load(
        service,
        payloads,
        None,
        clients=clients,
        duration_s=duration_s,
        warmup_s=warmup_s,
        mix="single",
    )
    row["phases"] = _phase_breakdown(service.registry)
    service.close()
    out["blocking_threads"] = row
    return out


def run_async_http_bench(
    artifact,
    payloads: list[dict],
    *,
    impls: list[str],
    client_counts: list[int],
    duration_s: float,
    warmup_s: float,
    mb_kwargs: dict,
    device="cuda",
) -> dict:
    """The BENCH_SERVE_r03 protocol: the same trained artifact served by
    each adapter in ``impls`` (asyncio, since the threaded rollback adapter
    was removed), driven at every requested client count over real sockets
    by `run_async_load`. The score cache is OFF so every request exercises
    the full request path (the r02 in-process baseline predates the cache);
    the batcher is ON — the protocol isolates the frontend."""
    from cobalt_smart_lender_ai_tpu_torch.config import ReliabilityConfig, ServeConfig
    from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

    results: dict[str, dict] = {}
    for impl in impls:
        per_impl: dict[str, dict] = {}
        for clients in client_counts:
            # Admission must clear the closed-loop concurrency or the bench
            # measures the shedder instead of the request path.
            max_in_flight = max(256, clients * 2)
            config = ServeConfig(
                microbatch_enabled=True,
                score_cache_size=0,
                slo_p99_ms=250.0,
                slo_p999_ms=2000.0,
                reliability=ReliabilityConfig(max_in_flight=max_in_flight),
                **mb_kwargs,
            )
            service = ScorerService(artifact, config, device=device)
            port, shutdown = _start_bench_server(impl, service)
            print(
                f"[bench] {impl} @ {clients} async clients, "
                f"{duration_s:g}s measured (+{warmup_s:g}s warmup)...",
                file=sys.stderr,
            )
            try:
                row = run_async_load(
                    port,
                    payloads,
                    clients=clients,
                    duration_s=duration_s,
                    warmup_s=warmup_s,
                )
            finally:
                shutdown()
            row["phases"] = _phase_breakdown(service.registry)
            if service.batcher is not None:
                row["microbatch"] = service.batcher.stats()
            service.close()
            per_impl[f"clients_{clients}"] = row
        results[impl] = per_impl
    inproc = run_inproc_comparison(
        artifact,
        payloads,
        clients=client_counts[0],
        duration_s=duration_s,
        warmup_s=warmup_s,
        mb_kwargs=mb_kwargs,
        device=device,
    )
    record = {
        "bench": "serve_async_http",
        "baseline": "r02_protocol_inproc: the first client count's clients "
        "in-process (no sockets), as coroutines and as threads",
        "duration_s": duration_s,
        "warmup_s": warmup_s,
        "client_counts": client_counts,
        "impls": impls,
        "score_cache": "off (every request exercises the full path)",
        "admission": "max_in_flight raised to max(256, 2x clients) per cell "
        "so the bench measures the request path, not the shedder",
        "notes": [
            "Clients run in this process, beside the server, and share its "
            "host cores.",
            "The micro-batcher is on and the score cache off, so every "
            "request takes the full path to one score_forest launch a "
            "coalesced batch.",
        ],
        "microbatch_knobs": {
            "max_wait_ms": mb_kwargs.get("microbatch_max_wait_ms", 2.0),
            "max_rows": mb_kwargs.get("microbatch_max_rows", 64),
        },
        "r02_protocol_inproc": inproc,
        "platform": platform_tag(resolve_device(device)),
        "host_cpu_cores": host_cpu_cores(),
        "results": results,
    }
    return record


def run_chaos_bench(
    artifact,
    payloads: list[dict],
    *,
    clients: int,
    duration_s: float,
    warmup_s: float,
    replicas: int = 3,
    mb_kwargs: dict,
    heal_timeout_s: float = 30.0,
    device="cuda",
) -> dict:
    """The BENCH_CHAOS protocol (chaos-fleet CI job): a supervised
    N-replica fleet behind the asyncio adapter under closed-loop async
    clients, with a `ChaosPlan` killing and then hanging one replica's
    micro-batch worker mid-run. The record is the self-healing headline:
    ``load.errors`` and ``load.untyped_errors`` must stay 0 (worker
    watchdog turns the kill into typed ``worker_dead`` futures, hedged
    failover rescues them on a healthy replica) and the supervisor must
    quarantine, rebuild and readmit the hurt replica within the heal
    budget — all without an operator."""
    from cobalt_smart_lender_ai_tpu_torch.config import ReliabilityConfig, ServeConfig
    from cobalt_smart_lender_ai_tpu_torch.reliability import ChaosPlan
    from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet
    from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
    from cobalt_smart_lender_ai_tpu_torch.serve.supervisor import HEALTHY

    replicas = max(2, replicas)
    target = 1 % replicas
    hang_s = 1.5
    config = ServeConfig(
        replicas=replicas,
        microbatch_enabled=True,
        score_cache_size=0,
        slo_p99_ms=250.0,
        slo_p999_ms=2000.0,
        # snappy supervision so time-to-heal measures the rebuild, not the
        # probe cadence
        supervisor_probe_interval_s=0.25,
        supervisor_probe_deadline_s=0.5,
        supervisor_probe_failures=1,
        supervisor_drain_timeout_s=2.0,
        reliability=ReliabilityConfig(max_in_flight=max(256, clients * 2)),
        **mb_kwargs,
    )
    fleet = ReplicaSet(
        [ScorerService(artifact, config, device=device) for _ in range(replicas)], config
    )
    port, shutdown = _start_bench_server("asyncio", fleet)  # starts supervisor
    plan = ChaosPlan(seed=11, registry=fleet.registry)
    plan.inject(fleet)

    chaos_at: list = [None]
    healed_in: list = [None]

    def saboteur() -> None:
        # Mid-run: murder the target's worker (queued futures -> typed
        # worker_dead, watchdog restarts it), then wedge the restarted
        # worker so probes time out and the supervisor quarantines + heals.
        time.sleep(warmup_s + duration_s / 3.0)
        chaos_at[0] = time.monotonic()
        plan.kill_worker(replica=target, max_events=1)
        plan.hang_dispatch(replica=target, hang_s=hang_s, max_events=1)
        print(
            f"[bench] chaos: kill + {hang_s:g}s hang on replica {target}",
            file=sys.stderr,
        )
        # Heal detection over GET /events: the target replica is healed
        # when the journal shows a transition back to "healthy" after its
        # quarantine — the same causal record `tools/incident_report.py`
        # reads, observed through the operator's HTTP surface rather than
        # by reaching into fleet internals.
        give_up = chaos_at[0] + heal_timeout_s
        while time.monotonic() < give_up:
            try:
                doc = _fetch_events(
                    port, component="supervisor", kind="transition"
                )
            except Exception:
                time.sleep(0.1)
                continue
            quarantined = False
            for event in doc.get("events", []):  # oldest-first
                if event.get("replica") != target:
                    continue
                to = (event.get("payload") or {}).get("to")
                if to == "quarantined":
                    quarantined = True
                elif to == "healthy" and quarantined:
                    healed_in[0] = round(
                        time.monotonic() - chaos_at[0], 3
                    )
                    return
            time.sleep(0.05)

    sab = threading.Thread(target=saboteur, daemon=True)
    sab.start()
    print(
        f"[bench] chaos fleet: {replicas} replicas @ {clients} async "
        f"clients, {duration_s:g}s measured (+{warmup_s:g}s warmup)...",
        file=sys.stderr,
    )
    try:
        row = run_async_load(
            port,
            payloads,
            clients=clients,
            duration_s=duration_s,
            warmup_s=warmup_s,
        )
        sab.join(timeout=heal_timeout_s + 5.0)
        events_block = _events_block(port)
    finally:
        shutdown()
    h = fleet.replica_health[target]
    supervisor_block = {
        "target_replica": target,
        "quarantines": h.quarantines,
        "rebuilds_ok": int(
            fleet.supervisor._m_rebuilds.labels(
                replica=str(target), outcome="ok"
            ).value
        ),
        "heal_s": healed_in[0],
        "states_at_end": [x.state for x in fleet.replica_health],
        "all_healthy": all(
            x.state == HEALTHY for x in fleet.replica_health
        ),
        "hedges_rescued": int(
            fleet._m_hedges.labels(outcome="rescued").value
        ),
        "worker_restarts": sum(
            int(rep.batcher.stats().get("worker_restarts", 0))
            for rep in fleet.replicas
            if rep.batcher is not None
        ),
    }
    chaos_block = {
        "seed": 11,
        "kill_worker_events": int(plan.events.get("kill", 0)),
        "hang_events": int(plan.events.get("hang", 0)),
        "hang_s": hang_s,
        "injected_mid_run": True,
    }
    plan.release()
    fleet.close()
    record = {
        "bench": "serve_chaos",
        "protocol": "kill + hang one replica's micro-batch worker mid-run; "
        "gate errors==0, untyped==0, heal within budget",
        "replicas": replicas,
        "clients": clients,
        "duration_s": duration_s,
        "warmup_s": warmup_s,
        "heal_timeout_s": heal_timeout_s,
        "load": row,
        "chaos": chaos_block,
        "supervisor": supervisor_block,
        "events": events_block,
        "platform": platform_tag(resolve_device(device)),
        "host_cpu_cores": host_cpu_cores(),
    }
    return record


def run_traffic_bench(
    artifact,
    payloads: list[dict],
    *,
    shape_name: str,
    base_rps: float,
    peak_rps: float,
    duration_s: float,
    seed: int = 0,
    start_replicas: int = 1,
    max_replicas: int = 3,
    device="cuda",
) -> dict:
    """The BENCH_TRAFFIC protocol (autoscale-smoke CI job): ONE replica
    behind the asyncio adapter with the load-adaptive control loop enabled
    (`serve.autoscaler`), driven by an **open-loop** seeded arrival schedule
    from `reliability.traffic` — arrivals fire at their scheduled time no
    matter how slow the server is, so overload is measured, not hidden by
    client self-throttling. A ``flash_crowd`` run is the headline: the spike
    must force scale-ups, a sustained fast-burn at the replica ceiling must
    walk the brownout ladder (``degraded: true`` responses without SHAP),
    and the decay must release every rung and retire the extra capacity —
    with zero errors and zero untyped error bodies end to end."""
    import asyncio
    from cobalt_smart_lender_ai_tpu_torch.config import ReliabilityConfig, ServeConfig
    from cobalt_smart_lender_ai_tpu_torch.data import schema
    from cobalt_smart_lender_ai_tpu_torch.reliability.traffic import (
        KIND_BULK,
        KIND_SHAP,
        TenantPopulation,
        TrafficGenerator,
        shape_by_name,
    )
    from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet
    from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

    config = ServeConfig(
        replicas=start_replicas,
        microbatch_enabled=True,
        score_cache_size=0,
        # Tight latency objectives + short burn windows: the flash-crowd
        # plateau must register as a fast burn within the run, and the decay
        # must clear it before the run ends.
        slo_p99_ms=25.0,
        slo_p999_ms=120.0,
        slo_windows_s=(3.0, 12.0),
        history_enabled=True,
        history_interval_s=0.5,
        history_tiers=((0.5, 720),),
        supervisor_probe_interval_s=0.5,
        supervisor_probe_deadline_s=1.0,
        supervisor_drain_timeout_s=2.0,
        autoscaler_enabled=True,
        autoscaler_interval_s=0.25,
        autoscaler_min_replicas=1,
        autoscaler_max_replicas=max_replicas,
        autoscaler_scale_up_cooldown_s=1.0,
        autoscaler_scale_down_cooldown_s=2.0,
        autoscaler_stable_ticks=4,
        autoscaler_queue_wait_high_ms=15.0,
        autoscaler_queue_wait_low_ms=4.0,
        # brownout_max_level=3 (the default): the ladder degrades SHAP and
        # widens coalescing but never sheds, so "errors == 0" stays a hard
        # gate even at the spike's peak.
        reliability=ReliabilityConfig(max_in_flight=1024),
    )
    fleet = ReplicaSet(
        [ScorerService(artifact, config, device=device) for _ in range(start_replicas)],
        config,
    )
    port, shutdown = _start_bench_server("asyncio", fleet)

    gen = TrafficGenerator(
        shape_by_name(shape_name, seed),
        base_rps=base_rps,
        peak_rps=peak_rps,
        duration_s=duration_s,
        tenants=TenantPopulation(
            list(payloads[0]),
            # Int-typed wire fields must survive jitter integral or the
            # validation schema 422s every single-row request.
            [
                schema.SERVING_FIELD_ALIASES.get(n, n)
                for n in schema.SERVING_INT_FEATURES
            ],
            base_rows=payloads,
            jitter=0.03,
            seed=seed,
        ),
        seed=seed,
    )
    schedule = gen.schedule()
    csv_header = ",".join(payloads[0]) + "\n"

    def _body(arrival) -> tuple[str, bytes, str]:
        if arrival.kind == KIND_BULK:
            rows = "".join(
                ",".join(f"{v:g}" for v in arrival.payload.values()) + "\n"
                for _ in range(gen.bulk_rows)
            )
            return (
                "/predict_bulk_csv",
                (csv_header + rows).encode(),
                "text/csv",
            )
        if arrival.kind == KIND_SHAP:
            return (
                "/feature_importance_bulk",
                json.dumps({"data": [arrival.payload]}).encode(),
                "application/json",
            )
        return "/predict", json.dumps(arrival.payload).encode(), "application/json"

    n_conns = 64
    lat: list[float] = []
    counts = {"requests": 0, "errors": 0, "untyped": 0, "shed": 0,
              "degraded": 0}
    by_kind: dict[str, int] = {}
    timeline: list[dict] = []

    async def sampler(stop_at: float) -> None:
        # replica-count / brownout-level timeline alongside the load — the
        # committed record shows the control loop acting, not just its
        # end-state counters. Both series are *derived from the event
        # journal* over GET /events (resize payload "to", brownout payload
        # "level"): if an actuation ever failed to journal, this timeline
        # would go flat and the record would show it.
        loop = asyncio.get_running_loop()
        replicas_now, level_now = start_replicas, 0
        while loop.time() < stop_at:
            try:
                doc = await loop.run_in_executor(
                    None,
                    lambda: _fetch_events(port, component="autoscaler"),
                )
                replicas_now, level_now = start_replicas, 0
                for event in doc.get("events", []):  # oldest-first
                    payload = event.get("payload") or {}
                    if event.get("kind") == "resize":
                        replicas_now = int(
                            payload.get("to", replicas_now)
                        )
                    elif event.get("kind") == "brownout":
                        level_now = int(payload.get("level", level_now))
            except Exception:
                pass  # server mid-bind or draining: keep last-known state
            timeline.append(
                {
                    "t": round(time.monotonic() - t0[0], 2),
                    "replicas": replicas_now,
                    "brownout_level": level_now,
                }
            )
            await asyncio.sleep(0.5)

    t0 = [0.0]

    async def fire(arrival, conns: "asyncio.Queue") -> None:
        await asyncio.sleep(max(0.0, t0[0] + arrival.t - time.monotonic()))
        t_sched = t0[0] + arrival.t  # latency from *scheduled* fire time:
        # a backed-up harness queue counts against the server (open loop)
        path, body, ctype = _body(arrival)
        req = (
            f"POST {path} HTTP/1.1\r\nHost: bench\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n\r\n"
        ).encode() + body
        reader, writer = await conns.get()
        try:
            try:
                writer.write(req)
                await writer.drain()
                status, resp_body = await _read_http_response(reader)
            except (ConnectionError, asyncio.IncompleteReadError):
                writer.close()
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", port
                )
                writer.write(req)
                await writer.drain()
                status, resp_body = await _read_http_response(reader)
            lat.append((time.monotonic() - t_sched) * 1e3)
            counts["requests"] += 1
            by_kind[arrival.kind] = by_kind.get(arrival.kind, 0) + 1
            if status == 200:
                if arrival.kind == "single" and b'"degraded"' in resp_body:
                    counts["degraded"] += 1
            else:
                try:
                    typed = "error" in json.loads(resp_body.decode())
                except Exception:
                    typed = False
                if status == 429 and typed:
                    counts["shed"] += 1  # designed backpressure, not failure
                else:
                    counts["errors"] += 1
                    if not typed:
                        counts["untyped"] += 1
        finally:
            conns.put_nowait((reader, writer))

    async def drive() -> None:
        conns: asyncio.Queue = asyncio.Queue()
        for _ in range(n_conns):
            conns.put_nowait(await asyncio.open_connection("127.0.0.1", port))
        t0[0] = time.monotonic()
        # The sampler outlives the arrivals by a quiet settle window — the
        # idle evidence the control loop needs to release remaining rungs
        # and retire the surge capacity before the record is cut.
        settle = max(8.0, duration_s / 3.0)
        stop_at = asyncio.get_running_loop().time() + duration_s + settle
        await asyncio.gather(
            sampler(stop_at), *(fire(a, conns) for a in schedule)
        )
        while not conns.empty():
            _, writer = conns.get_nowait()
            writer.close()

    print(
        f"[bench] traffic {shape_name}: {len(schedule)} open-loop arrivals, "
        f"{base_rps:g}->{peak_rps:g} rps over {duration_s:g}s, "
        f"{start_replicas}->{max_replicas} replicas available...",
        file=sys.stderr,
    )
    try:
        asyncio.run(drive())
        events_block = _events_block(port)
    finally:
        shutdown()
    scaler = fleet.autoscaler
    autoscaler_block = {
        "resizes_up": int(scaler._m_resizes.labels(direction="up").value),
        "resizes_down": int(scaler._m_resizes.labels(direction="down").value),
        "retunes_busy": int(scaler._m_retunes.labels(profile="busy").value),
        "retunes_idle": int(scaler._m_retunes.labels(profile="idle").value),
        "brownout_engaged": int(
            scaler._m_brownouts.labels(direction="engage").value
        ),
        "brownout_released": int(
            scaler._m_brownouts.labels(direction="release").value
        ),
        "final_level": fleet.brownout.level,
        "max_level_seen": max(
            (p["brownout_level"] for p in timeline), default=0
        ),
        "final_replicas": len(fleet.replicas),
        "max_replicas_seen": max(
            (p["replicas"] for p in timeline), default=start_replicas
        ),
        "ticks": int(scaler._m_ticks.value),
        "timeline": timeline,
    }
    fleet.close()
    singles = sorted(lat)
    record = {
        "bench": "serve_traffic",
        "protocol": "open-loop seeded arrivals against an autoscaled fleet; "
        "gate errors==0, untyped==0, >=1 scale-up and scale-down, brownout "
        "engaged and fully released",
        "traffic": gen.summary(),
        "start_replicas": start_replicas,
        "load": {
            "requests": counts["requests"],
            "qps": round(counts["requests"] / duration_s, 1),
            "errors": counts["errors"],
            "untyped_errors": counts["untyped"],
            "shed": counts["shed"],
            "degraded": counts["degraded"],
            "by_kind": by_kind,
            "p50_ms": round(_percentile(singles, 0.50), 3),
            "p95_ms": round(_percentile(singles, 0.95), 3),
            "p99_ms": round(_percentile(singles, 0.99), 3),
            "p99.9_ms": round(_percentile(singles, 0.999), 3),
            "max_ms": round(singles[-1], 3) if singles else float("nan"),
        },
        "autoscaler": autoscaler_block,
        "events": events_block,
        "platform": platform_tag(resolve_device(device)),
        "host_cpu_cores": host_cpu_cores(),
    }
    return record


def run_bulk_bench(
    artifact,
    X,
    *,
    shard_counts: list[int],
    query_rows: int,
    repeats: int,
    max_batch_rows: int,
    device="cuda",
) -> dict:
    """Score one (query_rows, F) matrix through the bulk path at each shard
    count and report rows/s (best of ``repeats``, after a full warmup pass
    that absorbs the compiles). Every shard count must produce bit-identical
    probabilities to the single-device path — the partitioner's contract —
    and the record says so explicitly."""
    from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
    from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

    reps = max(1, int(np.ceil(query_rows / X.shape[0])))
    Xq = np.tile(np.nan_to_num(X, nan=0.0), (reps, 1))[:query_rows]
    results: dict[str, dict] = {}
    reference = None
    for shards in shard_counts:
        config = ServeConfig(
            microbatch_enabled=False,
            max_batch_rows=max_batch_rows,
            bulk_shards=shards,
            score_cache_size=0,
        )
        service = ScorerService(artifact, config, device=device)
        actual = service._model.bulk_part.n_shards
        print(
            f"[bench] bulk shards={shards} (resolved {actual}): warmup + "
            f"{repeats} timed passes over {query_rows} rows...",
            file=sys.stderr,
        )
        probs = service.predict_proba(Xq)  # warmup pass pays the compiles
        best_s = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            probs = service.predict_proba(Xq)
            best_s = min(best_s, time.perf_counter() - t0)
        if reference is None:
            reference = probs
        entry = {
            "requested_shards": shards,
            "shards": actual,
            "rows_per_s": round(query_rows / best_s, 1),
            "best_pass_ms": round(best_s * 1e3, 3),
            "dispatches": int(
                service.registry.snapshot()["cobalt_bulk_dispatches_total"][
                    "samples"
                ][0]["value"]
            ),
            "bit_identical_to_single": bool(
                np.array_equal(reference, probs)
            ),
            "mesh": service._model.bulk_part.describe()["mesh"],
        }
        results[f"shards_{actual}"] = entry
        service.close()
    record = {
        "bench": "bulk_scoring",
        "query_rows": query_rows,
        "max_batch_rows": max_batch_rows,
        "platform": platform_tag(resolve_device(device)),
        "devices": device_count(resolve_device(device)),
        "host_cpu_cores": host_cpu_cores(),
        "results": results,
    }
    keys = sorted(results, key=lambda k: results[k]["shards"])
    if len(keys) >= 2:
        base = results[keys[0]]["rows_per_s"]
        top = results[keys[-1]]["rows_per_s"]
        if base > 0:
            record["speedup"] = round(top / base, 2)
    record["bit_identical"] = all(
        r["bit_identical_to_single"] for r in results.values()
    )
    return record


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="bench_serve", description=__doc__.split("\n\n")[0]
    )
    parser.add_argument("--clients", type=int, default=32)
    parser.add_argument("--duration-s", type=float, default=5.0)
    parser.add_argument("--warmup-s", type=float, default=1.5)
    parser.add_argument("--rows", type=int, default=2000,
                        help="synthetic training rows")
    parser.add_argument("--mix", choices=("single", "mixed"), default="single")
    parser.add_argument("--mode", choices=("both", "on", "off"), default="both")
    parser.add_argument("--microbatch-wait-ms", type=float, default=None)
    parser.add_argument("--microbatch-max-rows", type=int, default=None)
    parser.add_argument("--smoke", action="store_true",
                        help="short profile: 4 clients, ~1s per mode")
    parser.add_argument("--bulk", action="store_true",
                        help="run the sharded bulk-scoring bench instead of "
                        "the closed-loop single-row bench")
    parser.add_argument("--bulk-rows", type=int, default=65536,
                        help="rows in the bulk query matrix")
    parser.add_argument("--bulk-shards", default="1,-1",
                        help="comma-separated bulk_shards settings to "
                        "compare (-1 = every visible device)")
    parser.add_argument("--bulk-repeats", type=int, default=3,
                        help="timed passes per shard count (best is kept)")
    parser.add_argument("--max-batch-rows", type=int, default=4096,
                        help="per-shard row cap of one launch")
    parser.add_argument("--force-devices", type=int, default=None,
                        help="name the one device this many times as the "
                        "visible devices (the shards share one card)")
    parser.add_argument("--async-clients", action="store_true",
                        help="run the async serving bench instead: drive "
                        "--client-counts concurrent closed-loop HTTP clients "
                        "from ONE event loop against each adapter in --impls")
    parser.add_argument("--client-counts", default="128,256,512",
                        help="comma-separated client counts for "
                        "--async-clients")
    parser.add_argument("--impls", default="asyncio",
                        help="comma-separated adapters for --async-clients "
                        "(only 'asyncio' exists)")
    parser.add_argument("--chaos", action="store_true",
                        help="run the self-healing fleet chaos bench: a "
                        "supervised replica fleet behind the asyncio "
                        "adapter with one replica's worker killed + hung "
                        "mid-run")
    parser.add_argument("--chaos-replicas", type=int, default=3,
                        help="fleet size for --chaos")
    parser.add_argument("--traffic", default=None,
                        metavar="SHAPE",
                        help="run the load-adaptive fleet bench: an open-"
                        "loop seeded arrival schedule of this shape "
                        "(flash_crowd, diurnal, bursty, ramp, steady) "
                        "against an autoscaler-enabled fleet")
    parser.add_argument("--traffic-base-rps", type=float, default=8.0,
                        help="trough arrival rate for --traffic")
    parser.add_argument("--traffic-peak-rps", type=float, default=600.0,
                        help="peak arrival rate for --traffic")
    parser.add_argument("--traffic-duration-s", type=float, default=24.0,
                        help="arrival-schedule length for --traffic "
                        "(a settle window is appended on top)")
    parser.add_argument("--traffic-seed", type=int, default=0,
                        help="arrival-schedule seed for --traffic")
    parser.add_argument("--traffic-max-replicas", type=int, default=3,
                        help="autoscaler replica ceiling for --traffic")
    parser.add_argument("--http-smoke", action="store_true",
                        help="also drive load over real HTTP and scrape "
                        "/metrics during it (result lands under "
                        "record['metrics_scrape'])")
    parser.add_argument("--out", default=None,
                        help="write the JSON line to this path (default: "
                        "stdout)")
    parser.add_argument("--trace-out", default=None,
                        help="write the run's span ring as Chrome Trace "
                        "Event / Perfetto JSON to this path")
    parser.add_argument("--ledger-out", default=None,
                        help="write a run ledger (env, headline, program "
                        "cost table) to this path; render with "
                        "tools.obs_report")
    parser.add_argument("--trend-out", nargs="?", const=DEFAULT_TREND,
                        default=None,
                        help="append this run's headline metrics to a trend "
                        f"file (default path: {DEFAULT_TREND}; gate with "
                        "tools.perf_sentinel check)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser.parse_args(argv)


def _serving_inputs(args, dev: torch.device) -> tuple:
    """The trained artifact and its request payloads (the mode benches'
    shared preamble)."""
    from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig

    print(f"[bench] training model ({args.rows} synthetic rows)...",
          file=sys.stderr)
    service, X = build_service(
        ServeConfig(microbatch_enabled=False),
        n_rows=args.rows,
        device=dev,
    )
    artifact = service.artifact
    service.close()
    return artifact, X, build_payloads(X)


def _mb_kwargs(args) -> dict:
    mb_kwargs = {}
    if args.microbatch_wait_ms is not None:
        mb_kwargs["microbatch_max_wait_ms"] = args.microbatch_wait_ms
    if args.microbatch_max_rows is not None:
        mb_kwargs["microbatch_max_rows"] = args.microbatch_max_rows
    return mb_kwargs


def run(args, dev: torch.device) -> dict:
    """The record of the mode ``args`` selects, on ``dev``."""
    from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig

    if args.bulk:
        print(f"[bench] training model ({args.rows} synthetic rows)...",
              file=sys.stderr)
        service, X = build_service(
            ServeConfig(microbatch_enabled=False),
            n_rows=args.rows,
            device=dev,
        )
        artifact = service.artifact
        service.close()
        return run_bulk_bench(
            artifact,
            X,
            shard_counts=[int(s) for s in args.bulk_shards.split(",")],
            query_rows=args.bulk_rows,
            repeats=args.bulk_repeats,
            max_batch_rows=args.max_batch_rows,
            device=dev,
        )

    mb_kwargs = _mb_kwargs(args)
    if args.async_clients:
        client_counts = [int(c) for c in args.client_counts.split(",")]
        impls = [s.strip() for s in args.impls.split(",") if s.strip()]
        if args.smoke:
            client_counts = [min(c, 16) for c in client_counts][:1]
        artifact, _, payloads = _serving_inputs(args, dev)
        return run_async_http_bench(
            artifact,
            payloads,
            impls=impls,
            client_counts=client_counts,
            duration_s=args.duration_s,
            warmup_s=args.warmup_s,
            mb_kwargs=mb_kwargs,
            device=dev,
        )

    if args.chaos:
        artifact, _, payloads = _serving_inputs(args, dev)
        return run_chaos_bench(
            artifact,
            payloads,
            clients=args.clients,
            duration_s=args.duration_s,
            warmup_s=args.warmup_s,
            replicas=args.chaos_replicas,
            mb_kwargs=mb_kwargs,
            device=dev,
        )

    if args.traffic:
        artifact, _, payloads = _serving_inputs(args, dev)
        if args.smoke:
            args.traffic_duration_s = min(args.traffic_duration_s, 18.0)
            args.traffic_peak_rps = min(args.traffic_peak_rps, 400.0)
        return run_traffic_bench(
            artifact,
            payloads,
            shape_name=args.traffic,
            base_rps=args.traffic_base_rps,
            peak_rps=args.traffic_peak_rps,
            duration_s=args.traffic_duration_s,
            seed=args.traffic_seed,
            max_replicas=args.traffic_max_replicas,
            device=dev,
        )

    from cobalt_smart_lender_ai_tpu_torch.data import schema
    from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
    from cobalt_smart_lender_ai_tpu_torch.telemetry import snapshot

    modes = {"both": ("off", "on"), "on": ("on",), "off": ("off",)}[args.mode]
    results: dict[str, dict] = {}
    service = None
    X = None
    for mode in modes:
        config = ServeConfig(microbatch_enabled=(mode == "on"), **mb_kwargs)
        if service is None:
            print(f"[bench] training model ({args.rows} synthetic rows)...",
                  file=sys.stderr)
            service, X = build_service(config, n_rows=args.rows, device=dev)
        else:
            # same trained artifact, a fresh service per mode
            service = ScorerService(service.artifact, config, device=dev)
        payloads = build_payloads(X)
        csv_bytes = None
        if args.mix == "mixed":
            csv_bytes = build_csv(X[:64], schema.SERVING_FEATURES)
        print(
            f"[bench] batcher_{mode}: {args.clients} clients, "
            f"{args.duration_s:g}s measured (+{args.warmup_s:g}s warmup)...",
            file=sys.stderr,
        )
        results[f"batcher_{mode}"] = run_load(
            service,
            payloads,
            csv_bytes,
            clients=args.clients,
            duration_s=args.duration_s,
            warmup_s=args.warmup_s,
            mix=args.mix,
        )
        # attach this mode's metric values + recent spans so the bench
        # record carries the run's internals, not just the headline
        results[f"batcher_{mode}"]["telemetry"] = snapshot(
            service.registry, span_limit=32
        )
        artifact = service.artifact
        service.close()

    record_scrape = None
    if args.http_smoke:
        print(
            f"[bench] http smoke: {min(args.clients, 4)} clients over real "
            "sockets, scraping /metrics...",
            file=sys.stderr,
        )
        # The gate below is "no fast burn", not the production 10ms target.
        record_scrape = run_http_smoke(
            ServeConfig(
                microbatch_enabled=True,
                slo_p99_ms=250.0,
                slo_p999_ms=2000.0,
                **mb_kwargs,
            ),
            artifact,
            payloads,
            clients=min(args.clients, 4),
            duration_s=min(args.duration_s, 2.0),
            device=dev,
        )

    record = {
        "bench": "serve_throughput",
        "clients": args.clients,
        "duration_s": args.duration_s,
        "mix": args.mix,
        "platform": platform_tag(dev),
        "results": results,
    }
    if record_scrape is not None:
        record["metrics_scrape"] = record_scrape
    if "batcher_on" in results and "batcher_off" in results:
        off, on = results["batcher_off"], results["batcher_on"]
        if off["qps"] > 0:
            record["qps_speedup"] = round(on["qps"] / off["qps"], 2)
    return record


def _write_ledger(args, record: dict) -> None:
    if not args.ledger_out:
        return
    from cobalt_smart_lender_ai_tpu_torch.telemetry import (
        RunLedger,
        install_device_metrics,
        install_program_metrics,
    )

    install_program_metrics()
    install_device_metrics()
    ledger = RunLedger(
        "bench_serve",
        meta={
            "bulk": bool(args.bulk),
            "clients": args.clients,
            "duration_s": args.duration_s,
            "rows": args.rows,
            "mix": args.mix,
        },
    )
    ledger.set(
        "headline",
        {k: v for k, v in record.items() if k != "results"}
        | {
            name: {k: v for k, v in r.items() if k != "telemetry"}
            for name, r in (record.get("results") or {}).items()
        },
    )
    ledger.write(args.ledger_out)
    print(f"[bench] run ledger written to {args.ledger_out}", file=sys.stderr)


def summary_text(record: dict) -> str:
    """One line of a record's headline numbers."""
    bench = record["bench"]
    if bench == "serve_throughput":
        cells = [
            f"{mode} qps {row['qps']} p99 {row['p99_ms']} ms"
            for mode, row in record["results"].items()
        ]
        return f"{bench} c{record['clients']} {record['mix']}: " + "; ".join(cells)
    if bench == "serve_async_http":
        cells = [
            f"{impl} {cell} qps {row['qps']} p99 {row['p99_ms']} ms"
            for impl, per in record["results"].items()
            for cell, row in per.items()
        ]
        return f"{bench}: " + "; ".join(cells)
    if bench in ("serve_chaos", "serve_traffic"):
        load = record["load"]
        return (
            f"{bench}: qps {load['qps']} p99.9 {load['p99.9_ms']} ms, errors "
            f"{load['errors']}, untyped {load['untyped_errors']}"
        )
    cells = [
        f"{name} {row['rows_per_s']} rows/s"
        for name, row in record["results"].items()
    ]
    return (
        f"{bench} {record['query_rows']} rows: " + "; ".join(cells)
        + f"; bit_identical {record['bit_identical']}"
    )


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.smoke:
        args.clients = min(args.clients, 4)
        args.duration_s = min(args.duration_s, 1.0)
        args.warmup_s = min(args.warmup_s, 0.5)
        args.rows = min(args.rows, 800)
        args.bulk_rows = min(args.bulk_rows, 16384)
        args.bulk_repeats = min(args.bulk_repeats, 2)
    with force_devices(args.force_devices, dev) as forced:
        record = run(args, dev)
    record["card"] = card_block(dev)
    if forced is not None:
        record["force_devices"] = forced
    write_record(record, args.out)
    _write_ledger(args, record)
    append_trend(args.trend_out, record, "tools.bench_serve")
    if args.trace_out and record["bench"] == "serve_throughput":
        from cobalt_smart_lender_ai_tpu_torch.telemetry import (
            default_tracer,
            render_chrome_trace,
        )

        with open(args.trace_out, "w") as fh:
            fh.write(render_chrome_trace(default_tracer()))
        print(f"[bench] perfetto trace written to {args.trace_out}",
              file=sys.stderr)
    summary("bench_serve", summary_text(record), dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
