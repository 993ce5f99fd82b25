"""In-process metrics registry with Prometheus text exposition — zero deps.

The serving and training layers accumulated per-object ad-hoc counters
(`MicroBatcher.stats()`, `AdmissionController.admitted`,
`CircuitBreaker.transitions`) visible only through `/readyz` or a debugger.
This module gives them one scrapeable home: a thread-safe `MetricsRegistry`
of labeled `Counter` / `Gauge` / `Histogram` families rendered in the
Prometheus text exposition format (version 0.0.4) by `render()`, served at
``GET /metrics`` by the HTTP server.

Design points, in the spirit of prometheus_client but dependency-free:

- **Families and children.** ``registry.counter(name, help, labelnames)``
  returns a family; ``family.labels(route="/predict", status="200")`` returns
  the child holding the actual value. Families are get-or-create: asking for
  an existing name returns the same family (so N `FaultInjectingStore`
  instances share one fault-counter family) but a type or labelname mismatch
  raises — silent re-registration is how two meanings end up on one name.
- **Collect callbacks.** A Gauge child can be bound to a function
  (`set_function`) sampled at render time — queue depths, in-flight counts
  and breaker state are reads of live objects, not stored values, so the
  scrape always reflects *now* without hooks threaded through every layer.
- **Log-spaced latency buckets.** `log_buckets()` spaces bucket bounds
  geometrically; request latencies are log-normal-ish, so linear buckets
  waste resolution exactly where the percentiles live.
- **Values are observable in-process.** Children expose ``.value`` (and
  Histogram ``.count``/``.sum``) so existing ``stats()`` dicts can be served
  *from* the registry — one source of truth, same wire contract.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Callable, Iterable, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "log_buckets",
    "parse_exposition",
    "render",
    "LATENCY_BUCKETS_S",
    "EXPOSITION_CONTENT_TYPE",
    "OPENMETRICS_CONTENT_TYPE",
]


def log_buckets(
    lo: float, hi: float, *, per_decade: int = 4
) -> tuple[float, ...]:
    """Geometrically-spaced bucket upper bounds covering [lo, hi].

    ``per_decade`` bounds per power of ten; the +Inf bucket is implicit
    (every `Histogram` appends it). Bounds are rounded to 4 significant
    digits so the exposed ``le`` labels stay human-readable."""
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    out: list[float] = []
    for i in range(n + 1):
        b = lo * 10 ** (i / per_decade)
        b = float(f"{b:.4g}")
        if not out or b > out[-1]:
            out.append(b)
    return tuple(out)


#: Default latency buckets: 0.5 ms .. 30 s, four per decade. Covers a warm
#: single-row score (~1 ms) through a first launch that builds its kernel
#: (tens of s).
LATENCY_BUCKETS_S: tuple[float, ...] = log_buckets(5e-4, 30.0, per_decade=4)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s: str) -> str:
    return (
        s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(labelnames: Sequence[str], labelvalues: Sequence[str]) -> str:
    """Rendered label block, in declared (not alphabetical) labelname order —
    the stable ordering the exposition tests pin."""
    if not labelnames:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label_value(v)}"'
        for n, v in zip(labelnames, labelvalues)
    )
    return "{" + inner + "}"


_VALID_METRIC = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_VALID_LABEL = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class _Child:
    """One (labelvalues -> value) cell; subclasses add the write verbs."""

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class CounterChild(_Child):
    def __init__(self, lock: threading.Lock):
        super().__init__(lock)
        self._fn: Callable[[], float] | None = None

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    def set_function(self, fn: Callable[[], float]) -> None:
        """Mirror an existing monotonic counter (e.g. an
        `AdmissionController` shed count) by sampling it at collect time —
        the source object stays the single writer, the registry the single
        exposition path. The caller is responsible for monotonicity."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return float("nan")  # a dead callback must not kill a scrape
        with self._lock:
            return self._value


class GaugeChild(_Child):
    def __init__(self, lock: threading.Lock):
        super().__init__(lock)
        self._fn: Callable[[], float] | None = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set_max(self, value: float) -> None:
        """Monotonic high-water mark (e.g. largest coalesced batch seen)."""
        with self._lock:
            self._value = max(self._value, float(value))

    def set_function(self, fn: Callable[[], float]) -> None:
        """Sample ``fn`` at collect time instead of storing a value."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return float("nan")  # a dead callback must not kill a scrape
        with self._lock:
            return self._value


class HistogramChild:
    def __init__(self, lock: threading.Lock, buckets: tuple[float, ...]):
        self._lock = lock
        self._bounds = buckets
        self._counts = [0] * (len(buckets) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        # bucket index -> (exemplar trace id, observed value, unix ts): the
        # most recent exemplar-carrying observation per bucket, the
        # OpenMetrics link from an aggregate bucket back to one concrete
        # request (GET /debug/trace resolves the id).
        self._exemplars: dict[int, tuple[str, float, float]] = {}

    def observe(self, value: float, exemplar: str | None = None) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            # linear scan: bucket lists are ~15 long and observe() is not
            # the hot path's hot path (one call per request/batch/stage)
            for i, bound in enumerate(self._bounds):
                if value <= bound:
                    self._counts[i] += 1
                    break
            else:
                i = len(self._bounds)
                self._counts[-1] += 1
            if exemplar is not None:
                self._exemplars[i] = (str(exemplar), value, time.time())

    def exemplars(self) -> list[tuple[float, str, float, float]]:
        """[(le, trace_id, observed_value, unix_ts)] — one per bucket that
        has seen an exemplar-carrying observation."""
        with self._lock:
            bounds = self._bounds + (math.inf,)
            return [
                (bounds[i], tid, v, ts)
                for i, (tid, v, ts) in sorted(self._exemplars.items())
            ]

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> list[tuple[float, int]]:
        """[(le, cumulative_count)] including the +Inf bucket."""
        with self._lock:
            out, running = [], 0
            for bound, c in zip(self._bounds, self._counts):
                running += c
                out.append((bound, running))
            out.append((math.inf, running + self._counts[-1]))
            return out


class _Family:
    kind = "untyped"
    _child_cls: type | None = None

    def __init__(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ):
        if not _VALID_METRIC.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _VALID_LABEL.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        return self._child_cls(self._lock)

    def labels(self, *labelvalues, **labelkw):
        """Child for one label combination; positional in declared order or
        keyword by labelname (prometheus_client's dual convention)."""
        if labelvalues and labelkw:
            raise ValueError("pass labels positionally or by name, not both")
        if labelkw:
            try:
                labelvalues = tuple(labelkw[n] for n in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e}; has {self.labelnames}"
                )
            if len(labelkw) != len(self.labelnames):
                extra = set(labelkw) - set(self.labelnames)
                raise ValueError(f"{self.name}: unknown labels {extra}")
        key = tuple(str(v) for v in labelvalues)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes {len(self.labelnames)} labels "
                f"{self.labelnames}, got {len(key)}"
            )
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
        return child

    def _items(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    # unlabeled families proxy the verbs straight through
    def _solo(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call .labels()"
            )
        return self._children[()]


class Counter(_Family):
    kind = "counter"
    _child_cls = CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._solo().set_function(fn)

    @property
    def value(self) -> float:
        return self._solo().value


class Gauge(_Family):
    kind = "gauge"
    _child_cls = GaugeChild

    def set(self, value: float) -> None:
        self._solo().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def set_max(self, value: float) -> None:
        self._solo().set_max(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._solo().set_function(fn)

    @property
    def value(self) -> float:
        return self._solo().value


class Histogram(_Family):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        *,
        buckets: Iterable[float] = LATENCY_BUCKETS_S,
    ):
        b = tuple(sorted(set(float(x) for x in buckets)))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        if b[-1] == math.inf:
            b = b[:-1]  # +Inf is implicit
        self.buckets = b
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return HistogramChild(self._lock, self.buckets)

    def observe(self, value: float, exemplar: str | None = None) -> None:
        self._solo().observe(value, exemplar=exemplar)

    @property
    def count(self) -> int:
        return self._solo().count

    @property
    def sum(self) -> float:
        return self._solo().sum


class MetricsRegistry:
    """Thread-safe collection of metric families.

    One registry per serving process (the module-level `default_registry`);
    tests and benches construct their own for isolation. ``counter`` /
    ``gauge`` / ``histogram`` are get-or-create: the same (name, kind,
    labelnames) returns the existing family, a conflicting redefinition
    raises."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.labelnames != tuple(
                    labelnames
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, requested "
                        f"{cls.kind}{tuple(labelnames)}"
                    )
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(
        self, name: str, help: str, labelnames: Sequence[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(
        self,
        name: str,
        help: str,
        labelnames: Sequence[str] = (),
        *,
        buckets: Iterable[float] = LATENCY_BUCKETS_S,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, labelnames, buckets=buckets
        )

    def share(self, family: _Family) -> None:
        """Show another registry's ``family`` on this one's page: the same
        object, so its values are the other registry's. A different family
        of the same name raises."""
        with self._lock:
            held = self._families.get(family.name)
            if held is not None and held is not family:
                raise ValueError(f"metric {family.name!r} already registered")
            self._families[family.name] = family

    def families(self) -> list[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def render(self, *, openmetrics: bool = False) -> str:
        """Prometheus text exposition format 0.0.4 for every family.

        With ``openmetrics=True`` the output is the OpenMetrics-flavored
        variant: histogram bucket lines carry their most recent exemplar
        (``# {trace_id="..."} value ts``) and the body ends with ``# EOF``.
        The adapters serve it on content negotiation
        (``Accept: application/openmetrics-text``); the classic format —
        what the strict `parse_exposition` and the CI scrape pin — stays
        byte-identical to before exemplars existed."""
        lines: list[str] = []
        for fam in self.families():
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for labelvalues, child in fam._items():
                if isinstance(child, HistogramChild):
                    ex: dict[float, tuple[str, float, float]] = {}
                    if openmetrics:
                        ex = {
                            le: (tid, v, ts)
                            for le, tid, v, ts in child.exemplars()
                        }
                    for le, cum in child.cumulative():
                        lv = labelvalues + (_format_value(le),)
                        ln = fam.labelnames + ("le",)
                        line = f"{fam.name}_bucket{_label_str(ln, lv)} {cum}"
                        e = ex.get(le)
                        if e is not None:
                            tid, v, ts = e
                            line += (
                                f' # {{trace_id="{_escape_label_value(tid)}"}}'
                                f" {_format_value(v)} {ts:.3f}"
                            )
                        lines.append(line)
                    ls = _label_str(fam.labelnames, labelvalues)
                    lines.append(
                        f"{fam.name}_sum{ls} {_format_value(child.sum)}"
                    )
                    lines.append(f"{fam.name}_count{ls} {child.count}")
                else:
                    ls = _label_str(fam.labelnames, labelvalues)
                    lines.append(
                        f"{fam.name}{ls} {_format_value(child.value)}"
                    )
        body = "\n".join(lines) + "\n" if lines else ""
        if openmetrics:
            body += "# EOF\n"
        return body

    def snapshot(self) -> dict:
        """JSON-able dump (bench records ride this next to their one line)."""
        out: dict[str, dict] = {}
        for fam in self.families():
            samples = []
            for labelvalues, child in fam._items():
                labels = dict(zip(fam.labelnames, labelvalues))
                if isinstance(child, HistogramChild):
                    samples.append(
                        {
                            "labels": labels,
                            "count": child.count,
                            "sum": round(child.sum, 6),
                            "buckets": {
                                _format_value(le): c
                                for le, c in child.cumulative()
                            },
                        }
                    )
                else:
                    v = child.value
                    samples.append(
                        {
                            "labels": labels,
                            "value": round(v, 6)
                            if isinstance(v, float) and math.isfinite(v)
                            else v,
                        }
                    )
            out[fam.name] = {
                "type": fam.kind,
                "help": fam.help,
                "samples": samples,
            }
        return out


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (what `/metrics` serves unless the service
    was built with its own)."""
    return _default_registry


def render(
    registry: MetricsRegistry | None = None, *, openmetrics: bool = False
) -> str:
    return (registry or _default_registry).render(openmetrics=openmetrics)


#: Content-Type for the exposition (adapters send it on ``GET /metrics``).
EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Content-Type for the exemplar-carrying OpenMetrics variant, served when
#: the scraper sends ``Accept: application/openmetrics-text``.
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


def parse_exposition(text: str) -> dict[str, dict]:
    """Strict parser for the subset of the text format `render` emits.

    Returns ``{family: {"type": ..., "samples": {sample_line_name+labels:
    value}}}`` and raises ``ValueError`` on any malformed line — CI's
    bench-smoke job scrapes a live ``/metrics`` and fails the build if the
    output doesn't parse, and the format tests
    round-trip escaping through it."""
    families: dict[str, dict] = {}
    sample_re = re.compile(
        r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
        r"(?:\{(?P<labels>.*)\})?"
        r" (?P<value>[^ ]+)"
        # optional OpenMetrics exemplar: `# {trace_id="..."} value [ts]`
        r"(?: # \{(?P<exemplar>[^}]*)\} [^ ]+(?: [^ ]+)?)?$"
    )
    label_re = re.compile(
        r'(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\.)*)"'
    )
    current: str | None = None
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 3:
                raise ValueError(f"line {lineno}: malformed HELP: {line!r}")
            families.setdefault(
                parts[2], {"type": "untyped", "samples": {}}
            )["help"] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                "counter", "gauge", "histogram", "summary", "untyped",
            ):
                raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
            current = parts[2]
            families.setdefault(current, {"samples": {}})["type"] = parts[3]
            continue
        if line.startswith("#"):
            continue  # comment
        m = sample_re.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        raw_labels = m.group("labels")
        labels: dict[str, str] = {}
        if raw_labels:
            consumed = 0
            for lm in label_re.finditer(raw_labels):
                labels[lm.group("name")] = (
                    lm.group("value")
                    .replace('\\"', '"')
                    .replace("\\n", "\n")
                    .replace("\\\\", "\\")
                )
                consumed = lm.end()
            leftover = raw_labels[consumed:].strip(", ")
            if leftover:
                raise ValueError(
                    f"line {lineno}: malformed labels {raw_labels!r}"
                )
        raw_v = m.group("value")
        if raw_v == "+Inf":
            value = math.inf
        elif raw_v == "-Inf":
            value = -math.inf
        else:
            value = float(raw_v)  # ValueError propagates, as intended
        name = m.group("name")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in families:
                base = name[: -len(suffix)]
                break
        fam = families.setdefault(base, {"type": "untyped", "samples": {}})
        key = name + "".join(
            f'|{k}={labels[k]}' for k in sorted(labels)
        )
        fam["samples"][key] = value
        raw_ex = m.group("exemplar")
        if raw_ex:
            fam.setdefault("exemplars", {})[key] = {
                lm.group("name"): lm.group("value")
                for lm in label_re.finditer(raw_ex)
            }
    return families
