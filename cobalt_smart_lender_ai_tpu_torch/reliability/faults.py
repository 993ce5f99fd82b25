"""`FaultInjectingStore`: seeded, deterministic fault injection over an
`ObjectStore` (the port's copy of the reference's ``reliability/faults.py``).

Reload, checkpoints and the store's retries are exercised under injected
faults rather than asserted: the double draws from one `random.Random(seed)`
once per rate-gated call, in call order, so a failing seed reproduces
exactly (and injects on the same calls as the reference's with that seed).
"""

from __future__ import annotations

import dataclasses
import random
import time
import weakref
from collections import Counter
from typing import Callable, Iterator, Mapping

from cobalt_smart_lender_ai_tpu_torch.io.store import ObjectStore
from cobalt_smart_lender_ai_tpu_torch.telemetry import (
    MetricsRegistry,
    default_registry,
)


class InjectedFault(ConnectionError):
    """Deliberate transient failure (ConnectionError so the default retry
    predicate classifies it transient, like a dropped backend connection)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Fault profile for one store operation.

    - ``rate`` — probability an individual call raises `InjectedFault`.
    - ``fail_after`` — deterministic variant: the first N calls succeed,
      every later call faults (until ``max_faults`` is spent).
    - ``corrupt_rate`` — ``get`` only: probability the returned bytes are
      corrupted (first byte flipped) instead of raising.
    - ``max_faults`` — total fault budget for the operation; ``None`` means
      unbounded. A bounded budget guarantees eventual success under retry.
    - ``delay_s`` / ``delay_jitter_s`` — latency injection: every call (even
      ones that then fault) sleeps ``delay_s`` plus a seeded uniform draw in
      ``[0, delay_jitter_s)`` through the store's injectable ``sleep``, so
      deadline and breaker tests exercise a *slow* store deterministically
      against a fake clock. Delays do not consume ``max_faults``.
    """

    rate: float = 0.0
    fail_after: int | None = None
    corrupt_rate: float = 0.0
    max_faults: int | None = None
    delay_s: float = 0.0
    delay_jitter_s: float = 0.0


class FaultInjectingStore(ObjectStore):
    """Wraps any `ObjectStore`; injects faults per-operation per `FaultSpec`.

    ``faults`` maps operation name (``"put"``, ``"get"``, ``"exists"``,
    ``"delete"``, ``"list"``) to its spec; unlisted operations run clean.
    ``calls`` / ``injected`` / ``delays`` / ``delayed_s`` are per-operation
    counters tests assert against. ``sleep`` is injectable (default
    `time.sleep`) so latency injection composes with a fake clock.
    """

    OPS = ("put", "get", "exists", "delete", "list")

    def __init__(
        self,
        inner: ObjectStore,
        *,
        seed: int = 0,
        faults: Mapping[str, FaultSpec] | None = None,
        sleep: Callable[[float], None] = time.sleep,
        registry: MetricsRegistry | None = None,
    ):
        self.inner = inner
        self.uri = inner.uri
        self.faults = dict(faults or {})
        unknown = set(self.faults) - set(self.OPS)
        if unknown:
            raise ValueError(f"unknown fault ops {sorted(unknown)}; use {self.OPS}")
        self._rng = random.Random(seed)
        self._sleep = sleep
        self.calls: Counter[str] = Counter()
        self.injected: Counter[str] = Counter()
        self.delays: Counter[str] = Counter()
        self.delayed_s: dict[str, float] = {}
        self._register_metrics(
            registry if registry is not None else default_registry()
        )

    def _register_metrics(self, reg: MetricsRegistry) -> None:
        """Mirror the per-operation counters into the registry with
        collect-time callbacks: the Counters above stay the single writer
        (tests keep asserting on them), and a scrape during a fault drill
        shows what the drill actually injected. Callbacks hold only a weak
        reference — a collected store reads NaN, never a crash or a leak."""
        self_ref = weakref.ref(self)

        def _sample(attr: str, op: str) -> Callable[[], float]:
            def read() -> float:
                store = self_ref()
                if store is None:
                    raise LookupError("fault store was garbage-collected")
                return float(getattr(store, attr).get(op, 0.0))

            return read

        families = (
            (
                "calls",
                "cobalt_store_fault_calls_total",
                "store calls seen by the fault-injecting wrapper",
            ),
            (
                "injected",
                "cobalt_store_faults_injected_total",
                "faults injected (raised errors + corrupted reads)",
            ),
            (
                "delays",
                "cobalt_store_fault_delays_total",
                "store calls given injected latency",
            ),
            (
                "delayed_s",
                "cobalt_store_fault_delay_seconds_total",
                "total injected latency",
            ),
        )
        for attr, name, help_text in families:
            fam = reg.counter(name, help_text, ("op",))
            for op in self.OPS:
                fam.labels(op=op).set_function(_sample(attr, op))

    # -- fault engine ---------------------------------------------------------
    def _budget_left(self, op: str, spec: FaultSpec) -> bool:
        return spec.max_faults is None or self.injected[op] < spec.max_faults

    def _maybe_delay(self, op: str, spec: FaultSpec) -> None:
        """Latency injection, before any fault draw: a slow backend is slow
        whether or not the call then fails. Jitter draws from the shared
        seeded rng only when configured, so specs without jitter leave the
        fault-draw sequence of existing seeds untouched."""
        delay = spec.delay_s
        if spec.delay_jitter_s:
            delay += spec.delay_jitter_s * self._rng.random()
        if delay > 0.0:
            self.delays[op] += 1
            self.delayed_s[op] = self.delayed_s.get(op, 0.0) + delay
            self._sleep(delay)

    def _inject(self, op: str) -> None:
        """Count the call; apply injected latency; raise if this call draws
        a fault."""
        self.calls[op] += 1
        spec = self.faults.get(op)
        if spec is None:
            return
        self._maybe_delay(op, spec)
        if not self._budget_left(op, spec):
            return
        if spec.fail_after is not None and self.calls[op] > spec.fail_after:
            self.injected[op] += 1
            raise InjectedFault(f"injected {op} fault (call {self.calls[op]})")
        if spec.rate and self._rng.random() < spec.rate:
            self.injected[op] += 1
            raise InjectedFault(f"injected {op} fault (call {self.calls[op]})")

    def _maybe_corrupt(self, data: bytes) -> bytes:
        spec = self.faults.get("get")
        if (
            spec is not None
            and spec.corrupt_rate
            and self._budget_left("get", spec)
            and self._rng.random() < spec.corrupt_rate
        ):
            self.injected["get"] += 1
            return bytes([data[0] ^ 0xFF]) + data[1:] if data else b"\x00"
        return data

    # -- byte-blob contract ---------------------------------------------------
    def put_bytes(self, key: str, data: bytes) -> None:
        self._inject("put")
        self.inner.put_bytes(key, data)

    def get_bytes(self, key: str) -> bytes:
        self._inject("get")
        return self._maybe_corrupt(self.inner.get_bytes(key))

    def exists(self, key: str) -> bool:
        self._inject("exists")
        return self.inner.exists(key)

    def delete(self, key: str) -> None:
        self._inject("delete")
        self.inner.delete(key)

    def list(self, prefix: str = "") -> Iterator[str]:
        self._inject("list")
        return self.inner.list(prefix)
