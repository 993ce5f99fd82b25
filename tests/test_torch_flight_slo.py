"""The port's flight recorder and SLO engine against the JAX package's, on
the CPU.

One request stream, made from a seed with numpy and driven by an injected
clock, goes into both packages' `FlightRecorder` (with phase breakdowns
through `collect_phases`/`add_phase`) and, as latency and status
observations, into both registries under `SLOEngine` with the serving
defaults (`default_objectives` of each package's `ServeConfig`). Held
equal: the recent, error and slowest lists with their phase breakdowns,
the recorder's stats, each evaluation's burn rates and fast-burn flags,
and the ``cobalt_slo_*`` gauges' exposition text. The port's
`ServeConfig` carries the reference's flight and SLO defaults.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import cobalt_smart_lender_ai_tpu.telemetry as jax_telemetry
import cobalt_smart_lender_ai_tpu_torch.telemetry as port_telemetry
from cobalt_smart_lender_ai_tpu.config import ServeConfig as JaxServeConfig
from cobalt_smart_lender_ai_tpu.telemetry.flight import PHASES as JAX_PHASES
from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.telemetry.flight import PHASES

SEEDS = (0, 1, 2)
ROUTES = ("/predict", "/predict", "/predict", "/predict_bulk_csv", "/feature_importance_bulk")
FLIGHT_FIELDS = ("flight_capacity", "flight_slow_threshold_ms", "flight_top_k")
SLO_FIELDS = (
    "slo_enabled", "slo_p99_ms", "slo_p999_ms", "slo_availability_target",
    "slo_windows_s", "slo_fast_burn_threshold",
)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _stream(seed: int, n: int = 400) -> list[dict]:
    """Seeded requests: route, status, wall seconds and phase seconds."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dur = float(rng.lognormal(-5.5, 1.3))
        phases = {
            "validate": dur * 0.02,
            "queue_wait": dur * float(rng.uniform(0, 0.4)),
            "dispatch": dur * float(rng.uniform(0.2, 0.5)),
            "serialize": dur * 0.01 if rng.random() < 0.9 else 0.0,
        }
        status = int(rng.choice([200, 200, 200, 200, 422, 500, 429, 503]))
        out.append(
            dict(rid=f"req-{seed}-{i}", route=ROUTES[int(rng.integers(len(ROUTES)))],
                 status=status, dur=dur, phases=phases, dt=float(rng.uniform(0.01, 3.0)))
        )
    return out


def _flight(telemetry, seed: int) -> dict:
    clock = FakeClock()
    rec = telemetry.FlightRecorder(capacity=64, slow_threshold_s=0.01, top_k=8, clock=clock)
    for i, r in enumerate(_stream(seed)):
        clock.t += r["dt"]
        with telemetry.collect_phases() as acc:
            for name, sec in r["phases"].items():
                telemetry.add_phase(name, sec)
        rec.record(
            request_id=r["rid"], trace_id=i + 1, route=r["route"], method="POST",
            status=r["status"], duration_s=r["dur"],
            code=None if r["status"] < 400 else "error", phases=acc.phases,
        )
    return {
        "recent": rec.records(50),
        "recent_dispatch": rec.records(20, "dispatch"),
        "recent_serialize": rec.records(1000, "serialize"),
        "errors": rec.errors(30),
        "slowest": rec.slowest(),
        "slowest_queue": rec.slowest(5, "queue_wait"),
        "stats": rec.stats(),
    }


@pytest.mark.parametrize("seed", SEEDS)
def test_flight_recorder_lists_equal_the_references(seed):
    port, ref = _flight(port_telemetry, seed), _flight(jax_telemetry, seed)
    assert port == ref
    assert port["slowest"] and all("dispatch" in r["phases_ms"] for r in port["slowest"])


def _slo(telemetry, cfg, seed: int, windows=(60.0, 3600.0)) -> tuple[list[dict], str]:
    clock = FakeClock()
    reg = telemetry.MetricsRegistry()
    lat = reg.histogram(
        "cobalt_request_latency_seconds",
        "request wall time by route and final HTTP status",
        ("route", "status"),
    )
    engine = telemetry.SLOEngine(
        reg, telemetry.default_objectives(cfg), clock=clock, windows_s=windows,
        fast_burn_threshold=cfg.slo_fast_burn_threshold, cache_s=0.0,
    )
    engine.register_gauges()
    reports = []
    for i, r in enumerate(_stream(seed)):
        clock.t += r["dt"] / 4
        lat.labels(route=r["route"], status=str(r["status"])).observe(r["dur"])
        if i % 40 == 39:
            reports.append(engine.evaluate(force=True))
    slo_text = "".join(
        line + "\n" for line in reg.render().splitlines() if "cobalt_slo_" in line
    )
    return reports, slo_text


@pytest.mark.parametrize("windows", [(60.0, 3600.0), (5.0, 30.0)], ids=["default", "short"])
@pytest.mark.parametrize("seed", SEEDS)
def test_slo_burn_rates_and_gauges_equal_the_references(seed, windows):
    port_reports, port_text = _slo(port_telemetry, ServeConfig(), seed, windows)
    ref_reports, ref_text = _slo(jax_telemetry, JaxServeConfig(), seed, windows)
    assert port_reports == ref_reports
    assert port_text == ref_text and "cobalt_slo_burn_rate" in port_text
    burns = [w["burn_rate"] for rep in port_reports for o in rep["objectives"] for w in o["windows"]]
    assert any(b and b > 0 for b in burns)


def test_serve_config_carries_the_reference_defaults():
    port, ref = ServeConfig(), JaxServeConfig()
    for field in FLIGHT_FIELDS + SLO_FIELDS:
        assert getattr(port, field) == getattr(ref, field), field
    assert PHASES == JAX_PHASES
    assert port_telemetry.META_ROUTES == jax_telemetry.META_ROUTES


def test_default_objectives_follow_the_config():
    cfg = dataclasses.replace(ServeConfig(), slo_p99_ms=25.0, slo_availability_target=0.99)
    ref = dataclasses.replace(JaxServeConfig(), slo_p99_ms=25.0, slo_availability_target=0.99)
    assert port_telemetry.default_objectives(cfg) == tuple(
        port_telemetry.Objective(**dataclasses.asdict(o)) for o in jax_telemetry.default_objectives(ref)
    )


def test_phases_outside_a_request_are_dropped():
    port_telemetry.add_phase("dispatch", 1.0)  # no accumulator in scope: nothing to do
    with port_telemetry.collect_phases() as acc:
        port_telemetry.add_phase("dispatch", 0.25)
        port_telemetry.add_phase("dispatch", 0.5)
    assert acc.phases == {"dispatch": 0.75}
