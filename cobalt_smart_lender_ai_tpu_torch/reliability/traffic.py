"""Synthetic workload generation for load testing the serving fleet.

The reference's ``reliability/traffic.py``, module for module: the same
seeded schedules, arrival for arrival. The chaos harness
(`reliability.chaos`) answers "does the fleet survive *failure*?"; this
module supplies the other axis — "does it survive *load* it wasn't
provisioned for?" — by replaying a synthetic tenant population through
HTTP clients (``chip_smoke.py``'s phase 16) with realistic arrival
processes:

- `TrafficShape` — a composable intensity curve over normalized run phase
  ``[0, 1]`` → multiplier ``[0, 1]``; the named shapes (``diurnal``,
  ``bursty``, ``flash_crowd``, ``ramp``, ``steady``) can be added, scaled
  and clamped to build new profiles.
- `TenantPopulation` — a seeded population with Zipf-ish request weights and
  per-tenant payload jitter, so score-cache behavior under load is realistic
  (hot tenants repeat, cold tenants churn) without any real data.
- `TrafficGenerator` — turns (shape, base/peak RPS, request mix) into an
  **open-loop** arrival schedule: a time-varying Poisson process sampled per
  tick. Open-loop matters — closed-loop clients self-throttle when the
  server slows down, hiding exactly the overload the autoscaler exists to
  absorb (coordinated omission).

Everything is seeded and clock-free: the schedule is a pure function of
(seed, shape, rates, duration), so a failing run replays exactly.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Iterator, Sequence

#: Request kinds a generated arrival can carry. ``single`` posts one row to
#: ``/predict``; ``bulk`` posts ``bulk_rows`` rows of CSV; ``shap`` posts a
#: single row to ``/feature_importance_bulk`` (the SHAP-bearing route — the
#: one the brownout ladder degrades first).
KIND_SINGLE = "single"
KIND_BULK = "bulk"
KIND_SHAP = "shap"
KINDS = (KIND_SINGLE, KIND_BULK, KIND_SHAP)


@dataclasses.dataclass(frozen=True)
class TrafficShape:
    """A named intensity curve: ``phase in [0, 1] -> multiplier in [0, 1]``.

    The multiplier interpolates between ``base_rps`` (0.0) and ``peak_rps``
    (1.0) in `TrafficGenerator.target_rps`. Shapes compose: ``a + b``
    averages two curves, ``a.scaled(0.5)`` attenuates one — both return new
    shapes, clamped back into [0, 1].
    """

    name: str
    fn: Callable[[float], float]

    def at(self, phase: float) -> float:
        return min(1.0, max(0.0, float(self.fn(min(1.0, max(0.0, phase))))))

    def __add__(self, other: "TrafficShape") -> "TrafficShape":
        return TrafficShape(
            f"{self.name}+{other.name}",
            lambda p, a=self, b=other: 0.5 * (a.at(p) + b.at(p)),
        )

    def scaled(self, k: float) -> "TrafficShape":
        return TrafficShape(
            f"{self.name}*{k:g}", lambda p, a=self, k=k: k * a.at(p)
        )


def _diurnal(phase: float) -> float:
    # One full day compressed into the run: trough at the start/end, peak
    # mid-run (raised cosine).
    return 0.5 - 0.5 * math.cos(2.0 * math.pi * phase)


def _ramp(phase: float) -> float:
    return phase


def _flash_crowd(phase: float) -> float:
    # Quiet baseline, a near-instant spike to peak at 30% of the run, a
    # plateau, then exponential decay back to baseline — the news-link /
    # cron-stampede shape. The plateau is long enough (25% of the run) for
    # burn-rate windows to see sustained overload, and the decay leaves the
    # tail of the run quiet enough for scale-down + brownout release.
    if phase < 0.30:
        return 0.05
    if phase < 0.55:
        return 1.0
    return 0.05 + 0.95 * math.exp(-12.0 * (phase - 0.55))


def steady(level: float = 1.0) -> TrafficShape:
    return TrafficShape("steady", lambda p, lvl=level: lvl)


def bursty(seed: int = 0, n_bursts: int = 6, floor: float = 0.15) -> TrafficShape:
    """Baseline load with ``n_bursts`` seeded square bursts to peak. The
    burst placement is drawn once at construction, so the shape is a pure
    function afterward (same seed -> same curve)."""
    rng = random.Random(seed ^ 0x5EED)
    bursts = sorted(
        (rng.uniform(0.05, 0.90), rng.uniform(0.03, 0.08))
        for _ in range(n_bursts)
    )

    def fn(phase: float) -> float:
        for start, width in bursts:
            if start <= phase < start + width:
                return 1.0
        return floor

    return TrafficShape("bursty", fn)


def shape_by_name(name: str, seed: int = 0) -> TrafficShape:
    """Resolve a shape name; raises ValueError on unknown names so a
    caller fails loudly, not with a silent steady run."""
    shapes = {
        "diurnal": TrafficShape("diurnal", _diurnal),
        "ramp": TrafficShape("ramp", _ramp),
        "flash_crowd": TrafficShape("flash_crowd", _flash_crowd),
        "bursty": bursty(seed),
        "steady": steady(),
    }
    try:
        return shapes[name]
    except KeyError:
        raise ValueError(
            f"unknown traffic shape {name!r}; known: {sorted(shapes)}"
        ) from None


class TenantPopulation:
    """A seeded synthetic tenant base with Zipf-weighted request volume.

    Each tenant owns a stable base feature row (drawn once from the seeded
    RNG) plus per-request jitter on the float features: tenant-level
    repetition exercises the score cache the way real traffic does, while
    jitter keeps the cache from absorbing *everything*.

    ``fields`` is the serving payload's canonical field list and
    ``int_fields`` the subset that must stay integral (one-hot / count
    columns) — passed in by the caller so this module never imports the
    serving layer.
    """

    def __init__(
        self,
        fields: Sequence[str],
        int_fields: Sequence[str] = (),
        *,
        n_tenants: int = 16,
        seed: int = 0,
        jitter: float = 0.05,
        base_rows: Sequence[dict] | None = None,
    ):
        if n_tenants < 1:
            raise ValueError(f"n_tenants must be >= 1, got {n_tenants}")
        self.fields = list(fields)
        self.int_fields = frozenset(int_fields)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        # Zipf-ish volume weights: tenant k gets weight 1/(k+1).
        self._weights = [1.0 / (k + 1.0) for k in range(n_tenants)]
        total = sum(self._weights)
        self._cum = []
        acc = 0.0
        for w in self._weights:
            acc += w / total
            self._cum.append(acc)
        if base_rows is not None:
            # Caller-supplied rows (e.g. real validated serving payloads, so
            # every generated request clears the input schema) — cycled to
            # fill the population.
            if not base_rows:
                raise ValueError("base_rows must be non-empty when given")
            self._base_rows = [
                dict(base_rows[k % len(base_rows)]) for k in range(n_tenants)
            ]
        else:
            self._base_rows = [
                {
                    f: (self._rng.randint(0, 1) if f in self.int_fields
                        else round(self._rng.uniform(0.0, 10.0), 4))
                    for f in self.fields
                }
                for _ in range(n_tenants)
            ]

    def __len__(self) -> int:
        return len(self._base_rows)

    def pick(self, rng: random.Random) -> int:
        u = rng.random()
        for tenant, cum in enumerate(self._cum):
            if u <= cum:
                return tenant
        return len(self._cum) - 1

    def payload(self, tenant: int, rng: random.Random) -> dict:
        """One request row for ``tenant``: the stable base with jittered
        floats. Zero jitter -> byte-identical repeats (pure cache traffic)."""
        base = self._base_rows[tenant]
        if self.jitter <= 0.0:
            return dict(base)
        out = {}
        for f, v in base.items():
            if f in self.int_fields:
                out[f] = v
            else:
                out[f] = round(v * (1.0 + rng.uniform(-self.jitter, self.jitter)), 6)
        return out


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop request: fire at ``t`` seconds after run start."""

    t: float
    kind: str
    tenant: int
    payload: dict


class TrafficGenerator:
    """Seeded open-loop arrival schedule over a `TrafficShape`.

    The run is divided into ``tick_s`` ticks; each tick's arrival count is
    Poisson with mean ``target_rps(t) * tick_s`` and arrivals land uniformly
    inside the tick. The whole schedule is materialized up front (pure
    function of the seed), so the client harness only has to sleep-and-fire.
    """

    def __init__(
        self,
        shape: TrafficShape,
        *,
        base_rps: float,
        peak_rps: float,
        duration_s: float,
        tenants: TenantPopulation,
        seed: int = 0,
        tick_s: float = 0.25,
        mix: dict | None = None,
        bulk_rows: int = 64,
    ):
        if peak_rps < base_rps:
            raise ValueError(
                f"peak_rps ({peak_rps}) must be >= base_rps ({base_rps})"
            )
        if duration_s <= 0 or tick_s <= 0:
            raise ValueError("duration_s and tick_s must be > 0")
        self.shape = shape
        self.base_rps = float(base_rps)
        self.peak_rps = float(peak_rps)
        self.duration_s = float(duration_s)
        self.tick_s = float(tick_s)
        self.tenants = tenants
        self.seed = int(seed)
        self.bulk_rows = int(bulk_rows)
        mix = dict(mix or {KIND_SINGLE: 0.85, KIND_SHAP: 0.10, KIND_BULK: 0.05})
        unknown = set(mix) - set(KINDS)
        if unknown:
            raise ValueError(f"unknown request kinds in mix: {sorted(unknown)}")
        total = sum(mix.values())
        if total <= 0:
            raise ValueError(f"mix must have positive mass, got {mix}")
        self.mix = {k: mix.get(k, 0.0) / total for k in KINDS}

    def target_rps(self, t: float) -> float:
        """Instantaneous open-loop target at ``t`` seconds into the run."""
        phase = t / self.duration_s
        return self.base_rps + (self.peak_rps - self.base_rps) * self.shape.at(
            phase
        )

    def ticks(self) -> Iterator[tuple[float, float]]:
        """(tick start time, target RPS) pairs across the run — what a
        dashboard or test plots against observed throughput."""
        t = 0.0
        while t < self.duration_s:
            yield t, self.target_rps(t)
            t += self.tick_s

    def _poisson(self, rng: random.Random, mean: float) -> int:
        # Knuth for small means (ticks are sub-second, mean is small); the
        # normal approximation guards pathological tick/rate combinations.
        if mean <= 0.0:
            return 0
        if mean > 64.0:
            return max(0, int(round(rng.gauss(mean, math.sqrt(mean)))))
        limit = math.exp(-mean)
        k, p = 0, 1.0
        while p > limit:
            k += 1
            p *= rng.random()
        return k - 1

    def _kind(self, rng: random.Random) -> str:
        u = rng.random()
        acc = 0.0
        for kind in KINDS:
            acc += self.mix[kind]
            if u <= acc:
                return kind
        return KIND_SINGLE

    def schedule(self) -> list[Arrival]:
        """Materialize the full arrival schedule, sorted by fire time."""
        rng = random.Random(self.seed)
        arrivals: list[Arrival] = []
        for t0, rps in self.ticks():
            for _ in range(self._poisson(rng, rps * self.tick_s)):
                at = t0 + rng.random() * self.tick_s
                if at >= self.duration_s:
                    continue
                tenant = self.tenants.pick(rng)
                arrivals.append(
                    Arrival(
                        t=at,
                        kind=self._kind(rng),
                        tenant=tenant,
                        payload=self.tenants.payload(tenant, rng),
                    )
                )
        arrivals.sort(key=lambda a: a.t)
        return arrivals

    def summary(self) -> dict:
        """Shape metadata for bench records / TREND rows."""
        sched = self.schedule()
        kinds = {k: 0 for k in KINDS}
        for a in sched:
            kinds[a.kind] += 1
        return {
            "shape": self.shape.name,
            "base_rps": self.base_rps,
            "peak_rps": self.peak_rps,
            "duration_s": self.duration_s,
            "seed": self.seed,
            "arrivals": len(sched),
            "kinds": kinds,
            "tenants": len(self.tenants),
        }
