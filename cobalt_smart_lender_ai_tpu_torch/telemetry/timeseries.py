"""In-process time-series history: tiered downsampled rings over any scrape.

The reference's ``telemetry/timeseries.py``, module for module: the same
rings, derived series names, float arithmetic, segment documents and
dashboard HTML, so a history shipped by either package reads in both.
Everything else in `telemetry/` is point-in-time — `/metrics` is a
cumulative snapshot, `/slo` and the flight recorder look at bounded
rings of the recent past, a RunLedger captures one run. Nothing answers
"was p99.9 like this an hour ago?" without an external Prometheus. This
module is the zero-dependency answer: a `TimeSeriesStore` background
sampler (injectable clock, same shape as `devices.DeviceSampler`)
scrapes a `MetricsRegistry` — or any callable returning the
`parse_exposition` dict shape, e.g. `aggregate.merge_registries` over a
replica fleet — at a fixed interval into **tiered downsampled rings**
(default 10s x 360 / 1m x 720 / 10m x 1008: one hour fine, half a day
medium, a week coarse, all bounded memory), converting as it goes:

- **counters** become windowed rates (delta / elapsed within each tier
  bucket) under the derived series name ``<sample>:rate|<labels>`` —
  the request-count rate of the latency histogram IS the QPS series;
- **histograms** become per-window quantile estimates
  (``<family>:p50/p95/p99/p999|<labels>``, linear interpolation inside
  the delta bucket counts, the promql ``histogram_quantile`` estimator)
  plus a ``:rate`` series from ``_count``;
- **gauges** are carried as-is (last value wins within a bucket).

Durability: give the store an `io.store.ObjectStore` and it
periodically ships **append-only, md5-pinned snapshot segments** (each
one the finest tier's points since the previous ship, written via
``put_json`` + ``write_pointer``) and garbage-collects segments beyond
``retain_segments``. `load_segments` round-trips them, skipping any
segment whose pointer no longer verifies — a torn write degrades to a
gap, never a crash.

Served at ``GET /history`` (JSON) and ``GET /dashboard`` (stdlib HTML +
inline SVG sparklines) by `serve.http_asyncio`.
"""

from __future__ import annotations

import html
import math
import threading
import time
from collections import deque
from typing import Any, Callable, Mapping, Sequence

from cobalt_smart_lender_ai_tpu_torch.telemetry.aggregate import split_sample_key

__all__ = [
    "DEFAULT_QUANTILES",
    "DEFAULT_TIERS",
    "TimeSeriesStore",
    "load_segments",
    "render_dashboard",
    "sparkline_svg",
]

#: (bucket width seconds, ring capacity) — finest first. Spans: 1 h at
#: 10 s, 12 h at 1 m, one week at 10 m; ~17 KB per series per tier at
#: float pairs, bounded regardless of process lifetime.
DEFAULT_TIERS: tuple[tuple[float, int], ...] = (
    (10.0, 360),
    (60.0, 720),
    (600.0, 1008),
)

DEFAULT_QUANTILES: tuple[float, ...] = (0.5, 0.95, 0.99, 0.999)

_QUANTILE_NAMES = {0.5: "p50", 0.95: "p95", 0.99: "p99", 0.999: "p999"}


def _quantile_name(q: float) -> str:
    return _QUANTILE_NAMES.get(q) or ("p" + f"{q * 100:g}".replace(".", ""))


def _quantile_from_deltas(
    edges: Sequence[tuple[float, float]], q: float
) -> float:
    """promql-style quantile estimate from (le, cumulative count) deltas
    of ONE window. Linear interpolation inside the located bucket; the
    +Inf bucket reports its lower edge (no upper bound to interpolate
    to). NaN when the window saw no observations."""
    if not edges:
        return float("nan")
    total = edges[-1][1]
    if total <= 0:
        return float("nan")
    rank = q * total
    prev_le, prev_c = 0.0, 0.0
    for le, c in edges:
        if c >= rank:
            if math.isinf(le):
                return prev_le
            if c <= prev_c:
                return le
            return prev_le + (le - prev_le) * (rank - prev_c) / (c - prev_c)
        prev_le, prev_c = le, c
    return prev_le


class _TierState:
    """One tier's rings plus the open-bucket accumulators that let a
    bucket's value refine as more ticks land inside it."""

    __slots__ = ("width_s", "capacity", "rings", "open")

    def __init__(self, width_s: float, capacity: int) -> None:
        self.width_s = max(1e-9, float(width_s))
        self.capacity = max(2, int(capacity))
        # series key -> deque of [bucket_start_t, value] (last entry
        # mutable while its bucket is open)
        self.rings: dict[str, deque] = {}
        # series key -> (bucket_id, accumulator) where accumulator is
        # (delta_sum, dt_sum) for rates, {le: delta} histogram deltas,
        # or None for gauges
        self.open: dict[str, tuple[int, Any]] = {}

    def bucket_id(self, t: float) -> int:
        return int(t // self.width_s)

    def _point(self, key: str, t: float, value: float) -> None:
        ring = self.rings.get(key)
        if ring is None:
            ring = self.rings.setdefault(key, deque(maxlen=self.capacity))
        bid = self.bucket_id(t)
        bstart = bid * self.width_s
        if ring and ring[-1][0] == bstart:
            ring[-1][1] = value
        else:
            ring.append([bstart, value])

    def set_gauge(self, key: str, t: float, value: float) -> None:
        self._point(key, t, value)

    def add_rate(self, key: str, t: float, delta: float, dt: float) -> None:
        bid = self.bucket_id(t)
        state = self.open.get(key)
        if state is not None and state[0] == bid:
            acc = state[1]
            acc[0] += delta
            acc[1] += dt
        else:
            acc = [delta, dt]
            self.open[key] = (bid, acc)
        if acc[1] > 0:
            self._point(key, t, acc[0] / acc[1])

    def add_hist(
        self,
        fam: str,
        labels: str,
        t: float,
        deltas: Mapping[float, float],
        quantiles: Sequence[float],
    ) -> None:
        state_key = fam + ("|" + labels if labels else "")
        bid = self.bucket_id(t)
        state = self.open.get(state_key)
        if state is not None and state[0] == bid:
            acc = state[1]
            for le, d in deltas.items():
                acc[le] = acc.get(le, 0.0) + d
        else:
            acc = dict(deltas)
            self.open[state_key] = (bid, acc)
        # the per-window deltas of cumulative buckets are themselves
        # cumulative in le; clamp to monotone non-decreasing for safety
        cum = []
        running = 0.0
        for le, d in sorted(acc.items()):
            running = max(running, d)
            cum.append((le, running))
        if running <= 0:
            return  # no observations this window: no quantile point
        suffix = "|" + labels if labels else ""
        for q in quantiles:
            self._point(
                f"{fam}:{_quantile_name(q)}{suffix}",
                t,
                _quantile_from_deltas(cum, q),
            )


class TimeSeriesStore:
    """Background sampler scraping metrics into tiered history rings.

    Pass exactly one of ``registry`` (a `MetricsRegistry`; scraped via
    its text exposition) or
    ``scrape`` (a zero-arg callable returning the `parse_exposition`
    dict shape — `aggregate.merge_registries` over a fleet, a parsed
    remote scrape, a test fixture). Not auto-started; serving adapters
    call `start()` when the socket opens, tests drive `sample_once()`
    with a fake clock, exactly like `DeviceSampler`.
    """

    def __init__(
        self,
        *,
        registry: Any | None = None,
        scrape: Callable[[], Mapping[str, Mapping[str, Any]]] | None = None,
        interval_s: float = 10.0,
        tiers: Sequence[tuple[float, int]] = DEFAULT_TIERS,
        quantiles: Sequence[float] = DEFAULT_QUANTILES,
        clock: Callable[[], float] = time.time,
        store: Any | None = None,
        store_prefix: str = "telemetry/history",
        ship_interval_s: float = 300.0,
        retain_segments: int = 48,
    ) -> None:
        if (registry is None) == (scrape is None):
            raise ValueError("pass exactly one of registry= or scrape=")
        if registry is not None:
            from cobalt_smart_lender_ai_tpu_torch.telemetry.metrics import (
                parse_exposition,
            )

            self._scrape = lambda: parse_exposition(registry.render())
        else:
            self._scrape = scrape
        self.interval_s = max(0.01, float(interval_s))
        self.quantiles = tuple(quantiles)
        self._tiers = [_TierState(w, c) for w, c in tiers]
        if not self._tiers:
            raise ValueError("at least one tier is required")
        self._clock = clock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # previous cumulative snapshot: t, {key: value}, {(fam, labels):
        # {le: cumulative count}}
        self._prev_t: float | None = None
        self._prev_cum: dict[str, float] = {}
        self._prev_hist: dict[tuple[str, str], dict[float, float]] = {}
        # durable shipping
        self._store = store
        self.store_prefix = store_prefix.rstrip("/")
        self.ship_interval_s = max(0.0, float(ship_interval_s))
        self.retain_segments = max(1, int(retain_segments))
        self._shipped_until: float = -math.inf
        self._last_ship_t: float | None = None
        self._seq = 0
        self.ship_failures = 0
        self.sample_errors = 0

    # -- scraping ----------------------------------------------------------

    @staticmethod
    def _labels_of(key: str) -> str:
        _, _, labels = key.partition("|")
        return labels

    def sample_once(self) -> None:
        """One scrape -> ring update (what the thread does each tick);
        also ships a durable segment when one is due. A scrape or ship
        that raises increments a counter and is skipped — the sampler
        must never die of a transient store or callback fault."""
        t = self._clock()
        try:
            expo = self._scrape()
        except Exception:
            self.sample_errors += 1
            return
        gauges: dict[str, float] = {}
        counters: dict[str, float] = {}
        hists: dict[tuple[str, str], dict[float, float]] = {}
        for fam, block in expo.items():
            ftype = block.get("type", "untyped")
            samples = block.get("samples", {})
            if ftype == "histogram":
                for key, value in samples.items():
                    name, _, _ = key.partition("|")
                    if name == fam + "_bucket":
                        _, labels = split_sample_key(key)
                        raw_le = labels.pop("le", "+Inf")
                        le = (
                            math.inf
                            if raw_le == "+Inf"
                            else float(raw_le)
                        )
                        lbl = "|".join(
                            f"{k}={labels[k]}" for k in sorted(labels)
                        )
                        hists.setdefault((fam, lbl), {})[le] = float(value)
                    elif name == fam + "_count":
                        counters[
                            fam + ":rate"
                            + ("|" + self._labels_of(key)
                               if "|" in key else "")
                        ] = float(value)
                    # _sum is deliberately dropped: mean-over-window adds
                    # little next to the quantile series
            elif ftype == "counter":
                for key, value in samples.items():
                    name, _, labels = key.partition("|")
                    counters[
                        f"{name}:rate" + (f"|{labels}" if labels else "")
                    ] = float(value)
            else:  # gauge / untyped
                for key, value in samples.items():
                    v = float(value)
                    if not math.isnan(v):
                        gauges[key] = v
        with self._lock:
            prev_t = self._prev_t
            dt = None if prev_t is None else max(1e-9, t - prev_t)
            for tier in self._tiers:
                for key, v in gauges.items():
                    tier.set_gauge(key, t, v)
                if dt is None:
                    continue
                for key, cum in counters.items():
                    prev = self._prev_cum.get(key)
                    if prev is None:
                        continue
                    # counter reset (process restart behind a fleet
                    # scrape): treat the new cumulative as the delta
                    delta = cum - prev if cum >= prev else cum
                    tier.add_rate(key, t, delta, dt)
                for (fam, lbl), buckets in hists.items():
                    prevb = self._prev_hist.get((fam, lbl))
                    if prevb is None:
                        continue
                    deltas = {
                        le: c - prevb.get(le, 0.0)
                        if c >= prevb.get(le, 0.0)
                        else c
                        for le, c in buckets.items()
                    }
                    tier.add_hist(fam, lbl, t, deltas, self.quantiles)
            self._prev_t = t
            self._prev_cum = counters
            self._prev_hist = hists
        self._maybe_ship(t)

    # -- reads -------------------------------------------------------------

    def series_names(self) -> list[str]:
        """Every derived series currently held (union over tiers)."""
        with self._lock:
            names: set[str] = set()
            for tier in self._tiers:
                names.update(tier.rings)
            return sorted(names)

    def tiers(self) -> list[dict[str, float]]:
        return [
            {"width_s": t.width_s, "capacity": t.capacity}
            for t in self._tiers
        ]

    def _pick_tier(
        self, window_s: float | None, step_s: float | None
    ) -> _TierState:
        if step_s is not None:
            for tier in self._tiers:
                if tier.width_s >= step_s - 1e-9:
                    return tier
            return self._tiers[-1]
        if window_s is not None:
            for tier in self._tiers:
                if tier.width_s * tier.capacity >= window_s:
                    return tier
            return self._tiers[-1]
        return self._tiers[0]

    def query(
        self,
        series: str,
        *,
        window_s: float | None = None,
        step_s: float | None = None,
        now: float | None = None,
    ) -> dict[str, Any]:
        """Points for one series: ``{series, tier_s, points: [[t, v],
        ...]}``. ``step_s`` picks the finest tier at least that coarse;
        otherwise ``window_s`` picks the finest tier that spans the
        window; default is the finest tier. Unknown series -> KeyError
        (the adapters turn it into the typed 422)."""
        with self._lock:
            tier = self._pick_tier(window_s, step_s)
            ring = tier.rings.get(series)
            if ring is None and not any(
                series in t.rings for t in self._tiers
            ):
                raise KeyError(series)
            points = [list(p) for p in (ring or ())]
        if window_s is not None:
            cutoff = (now if now is not None else self._clock()) - window_s
            points = [p for p in points if p[0] >= cutoff]
        return {
            "series": series,
            "tier_s": tier.width_s,
            "points": points,
        }

    # -- durable segments --------------------------------------------------

    def _maybe_ship(self, t: float) -> None:
        if self._store is None or self.ship_interval_s <= 0:
            return
        if (
            self._last_ship_t is not None
            and t - self._last_ship_t < self.ship_interval_s
        ):
            return
        self._last_ship_t = t
        try:
            self.ship()
        except Exception:
            self.ship_failures += 1

    def ship(self) -> str | None:
        """Write one append-only segment (finest tier's points since the
        previous ship) as md5-pinned JSON, then GC old segments. Returns
        the segment key, or None when nothing new accumulated. Requires
        a durable store."""
        if self._store is None:
            raise ValueError("TimeSeriesStore has no durable store")
        with self._lock:
            finest = self._tiers[0]
            since = self._shipped_until
            series: dict[str, list[list[float]]] = {}
            hi = since
            for key, ring in finest.rings.items():
                pts = [list(p) for p in ring if p[0] > since]
                if pts:
                    series[key] = pts
                    hi = max(hi, pts[-1][0])
            if not series:
                return None
            self._seq += 1
            seq = self._seq
            doc = {
                "schema": 1,
                "seq": seq,
                "tier_s": finest.width_s,
                "from_t": None if math.isinf(since) else since,
                "to_t": hi,
                "series": series,
            }
        key = f"{self.store_prefix}/segment-{seq:08d}.json"
        self._store.put_json(key, doc)
        self._store.write_pointer(key)
        with self._lock:
            # only advance the high-water mark once the write held: a
            # failed ship re-ships the same points next time
            self._shipped_until = max(self._shipped_until, hi)
        self._gc_segments()
        return key

    def _gc_segments(self) -> None:
        from cobalt_smart_lender_ai_tpu_torch.io.store import PTR_SUFFIX

        segs = sorted(
            k
            for k in self._store.list(self.store_prefix + "/")
            if not k.endswith(PTR_SUFFIX)
        )
        for stale in segs[: -self.retain_segments]:
            for victim in (stale, stale + PTR_SUFFIX):
                try:
                    self._store.delete(victim)
                except Exception:
                    pass  # GC is advisory; the next ship retries

    # -- lifecycle (DeviceSampler's exact shape) ---------------------------

    def start(self) -> "TimeSeriesStore":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def _run() -> None:
            while not self._stop.wait(self.interval_s):
                self.sample_once()

        self._thread = threading.Thread(
            target=_run, name="cobalt-history-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def __enter__(self) -> "TimeSeriesStore":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def load_segments(
    store: Any, prefix: str = "telemetry/history"
) -> dict[str, list[list[float]]]:
    """Round-trip shipped segments back into ``{series: [[t, v], ...]}``
    (sorted, de-duplicated by bucket time — a re-shipped overlap after a
    failed write collapses cleanly). Segments whose md5 pointer fails
    `verify_pointer` are skipped: a torn write is a gap, not a crash."""
    from cobalt_smart_lender_ai_tpu_torch.io.store import PTR_SUFFIX

    prefix = prefix.rstrip("/")
    merged: dict[str, dict[float, float]] = {}
    for key in sorted(store.list(prefix + "/")):
        if key.endswith(PTR_SUFFIX):
            continue
        if not store.verify_pointer(key):
            continue
        try:
            doc = store.get_json(key)
        except Exception:
            continue
        if not isinstance(doc, dict) or doc.get("schema") != 1:
            continue
        for series, pts in (doc.get("series") or {}).items():
            dst = merged.setdefault(series, {})
            for t, v in pts:
                dst[float(t)] = float(v)
    return {
        series: [[t, pts[t]] for t in sorted(pts)]
        for series, pts in sorted(merged.items())
    }


# -- dashboard ---------------------------------------------------------------


def sparkline_svg(
    points: Sequence[Sequence[float]],
    *,
    width: int = 260,
    height: int = 44,
    stroke: str = "#2a6fb0",
) -> str:
    """One inline-SVG sparkline for ``[[t, v], ...]`` (NaN points make
    gaps). Pure string assembly — no dependency, no scripting."""
    finite = [
        (t, v) for t, v in points if not (math.isnan(v) or math.isinf(v))
    ]
    if len(finite) < 2:
        return (
            f'<svg width="{width}" height="{height}" '
            f'viewBox="0 0 {width} {height}">'
            f'<text x="4" y="{height - 6}" font-size="10" '
            f'fill="#999">(not enough points)</text></svg>'
        )
    t0, t1 = finite[0][0], finite[-1][0]
    vs = [v for _, v in finite]
    lo, hi = min(vs), max(vs)
    span_t = (t1 - t0) or 1.0
    span_v = (hi - lo) or 1.0
    pad = 3.0
    coords = " ".join(
        f"{pad + (t - t0) / span_t * (width - 2 * pad):.1f},"
        f"{height - pad - (v - lo) / span_v * (height - 2 * pad):.1f}"
        for t, v in finite
    )
    return (
        f'<svg width="{width}" height="{height}" '
        f'viewBox="0 0 {width} {height}" role="img">'
        f'<polyline fill="none" stroke="{stroke}" stroke-width="1.5" '
        f'points="{coords}"/></svg>'
    )


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    a = abs(v)
    if a >= 1e9 or (a < 1e-3 and a > 0):
        return f"{v:.3g}"
    if a >= 100:
        return f"{v:,.0f}"
    return f"{v:.3g}"


#: Dashboard panels: (title, [series-name prefixes to chart]).
_DASHBOARD_PANELS: tuple[tuple[str, tuple[str, ...]], ...] = (
    (
        "Latency quantiles (s)",
        (
            "cobalt_request_latency_seconds:p50",
            "cobalt_request_latency_seconds:p95",
            "cobalt_request_latency_seconds:p99",
            "cobalt_request_latency_seconds:p999",
        ),
    ),
    ("QPS (req/s)", ("cobalt_request_latency_seconds:rate",)),
    ("Queue depth", ("cobalt_microbatch_queue_depth",)),
    ("SLO burn rate", ("cobalt_slo_burn_rate", "cobalt_slo_fast_burn")),
    (
        "Device / host memory (bytes)",
        ("cobalt_device_mem_bytes", "cobalt_host_rss_bytes"),
    ),
)

_MAX_SERIES_PER_PANEL = 12


def render_dashboard(
    history: TimeSeriesStore,
    *,
    title: str = "cobalt serving dashboard",
    window_s: float | None = None,
) -> str:
    """The whole ``GET /dashboard`` page: one HTML string of inline SVG
    sparklines — latency quantiles, QPS, queue depth, SLO burn, device
    memory — plus an appendix listing every other series the store
    holds. Stdlib only; safe to open from a file or curl."""
    names = history.series_names()
    used: set[str] = set()
    sections: list[str] = []
    for panel_title, prefixes in _DASHBOARD_PANELS:
        rows: list[str] = []
        matches = [
            n for n in names if any(n.startswith(p) for p in prefixes)
        ]
        for name in matches[:_MAX_SERIES_PER_PANEL]:
            used.add(name)
            res = history.query(name, window_s=window_s)
            pts = res["points"]
            last = _fmt(pts[-1][1]) if pts else "—"
            rows.append(
                "<tr><td class='name'>"
                + html.escape(name)
                + "</td><td>"
                + sparkline_svg(pts)
                + f"</td><td class='last'>{html.escape(last)}</td></tr>"
            )
        if len(matches) > _MAX_SERIES_PER_PANEL:
            rows.append(
                f"<tr><td colspan='3' class='more'>… and "
                f"{len(matches) - _MAX_SERIES_PER_PANEL} more series "
                f"(query them via /history)</td></tr>"
            )
        body = (
            "<table>" + "".join(rows) + "</table>"
            if rows
            else "<p class='empty'>no samples yet</p>"
        )
        sections.append(
            f"<section><h2>{html.escape(panel_title)}</h2>{body}</section>"
        )
    rest = [n for n in names if n not in used]
    appendix = (
        "<section><h2>All other series</h2><ul>"
        + "".join(f"<li><code>{html.escape(n)}</code></li>" for n in rest)
        + "</ul></section>"
        if rest
        else ""
    )
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title><style>"
        "body{font-family:system-ui,sans-serif;margin:1.5rem;color:#222}"
        "h1{font-size:1.3rem}h2{font-size:1rem;margin:1.2rem 0 .3rem}"
        "table{border-collapse:collapse}td{padding:2px 10px 2px 0;"
        "vertical-align:middle}td.name{font-family:monospace;"
        "font-size:.78rem}td.last{font-variant-numeric:tabular-nums}"
        ".empty,.more{color:#888;font-size:.85rem}"
        "ul{columns:2;font-size:.78rem}</style></head><body>"
        f"<h1>{html.escape(title)}</h1>"
        "<p>Series history from the in-process "
        "<code>TimeSeriesStore</code>; raw points at "
        "<code>GET /history?series=&lt;name&gt;</code>.</p>"
        + "".join(sections)
        + appendix
        + "</body></html>"
    )
