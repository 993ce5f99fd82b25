"""The port's load control against the JAX package's.

The same small forest (trained and saved by the JAX package) is served by a
port `ReplicaSet` on the CPU and by the reference's, on manual clocks. The
autoscaler's signal read is replaced by a scripted classification in both,
so the same script must give the same decisions:

- the reference's control-loop cases: scale-up on a fast burn (the new
  replica takes traffic), the cooldown turning a burn into a brownout
  rung, the stable-idle scale-down and the floor, no retire while a rung
  is engaged, a retire never darkening the fleet;
- one script through every path — scale-up, cooldown brownout, rung 3's
  retune of the batchers' knobs, release before retire, stable-idle
  scale-down, the floor — gives the same tick summaries tick for tick,
  the same batcher knobs after each tick and the same journal events
  (component, kind, replica, payload, cause);
- the queue-wait signal read from the fleet history, on scripted series;
- the ladder, the brownout gate, the admission rescale and the token
  bucket, as the reference's;
- ``POST /admin/autoscaler`` and the ``/readyz`` ``autoscaler`` block over
  HTTP: the same codes and bodies, 422s included;
- `reliability.traffic`: the same schedules, arrival for arrival, and
  summaries for the five named shapes and three seeds, and the same tenant
  payloads.

The port alone: a resize under 6 hammering threads loses no request; a
scale-up builds on the fleet's device; a failed build is logged and
retried; a retired replica is freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import random
import threading
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import ServeConfig as JaxServeConfig
from cobalt_smart_lender_ai_tpu.data import schema as jax_schema
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.models.gbdt import GBDTClassifier as JaxClassifier
import cobalt_smart_lender_ai_tpu.reliability.admission as jax_adm
import cobalt_smart_lender_ai_tpu.reliability.traffic as jax_traffic
from cobalt_smart_lender_ai_tpu.serve.http_asyncio import make_async_server as jax_make_server
import cobalt_smart_lender_ai_tpu.serve.autoscaler as jax_auto
from cobalt_smart_lender_ai_tpu.serve.replicas import ReplicaSet as JaxReplicaSet
from cobalt_smart_lender_ai_tpu.serve.service import ScorerService as JaxScorerService
import cobalt_smart_lender_ai_tpu.telemetry.timeseries as jax_ts
from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.io import ObjectStore
import cobalt_smart_lender_ai_tpu_torch.reliability as port_rel
import cobalt_smart_lender_ai_tpu_torch.reliability.admission as port_adm
from cobalt_smart_lender_ai_tpu_torch.reliability.errors import RequestShed
import cobalt_smart_lender_ai_tpu_torch.reliability.traffic as port_traffic
import cobalt_smart_lender_ai_tpu_torch.serve.autoscaler as port_auto
from cobalt_smart_lender_ai_tpu_torch.serve import service as port_service
from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server
from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
import cobalt_smart_lender_ai_tpu_torch.telemetry.timeseries as port_ts

KEY = "models/gbdt/model_tree"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ManualClock:
    """Time passes only when the test says so."""

    def __init__(self, start: float = 100.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, s: float) -> None:
        self.now += s


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """A small forest trained by the JAX package on the 20 serving features,
    saved by its artifact writer; both fleets restore it."""
    rng = np.random.default_rng(47)
    F = len(jax_schema.SERVING_FEATURES)
    X = rng.normal(size=(1024, F)).astype(np.float32)
    X[:, 12:] = rng.integers(0, 2, size=(1024, F - 12))
    y = X[:, 0] - 0.6 * X[:, 2] + 0.4 * X[:, 13] + 0.3 * rng.normal(size=1024) > 0
    model = JaxClassifier(n_estimators=8, max_depth=3, n_bins=32)
    model.fit(X, y.astype(np.int32))
    root = tmp_path_factory.mktemp("torch_autoscaler") / "lake"
    JaxArtifact(
        forest=model.forest, bin_spec=model.bin_spec, feature_names=tuple(jax_schema.SERVING_FEATURES)
    ).save(JaxStore(str(root)), KEY)
    return str(root)


#: Both packages' fields (the reference tests' `_cfg`): no score cache, a
#: snappy supervisor that never ticks on its own, the autoscaler on with
#: small cooldowns the manual clock steps over.
FLEET = dict(
    replicas=2,
    microbatch_enabled=False,
    score_cache_size=0,
    supervisor_probe_interval_s=3600.0,
    supervisor_probe_deadline_s=0.3,
    supervisor_probe_failures=1,
    supervisor_drain_timeout_s=1.0,
    replica_close_timeout_s=2.0,
    autoscaler_enabled=True,
    autoscaler_interval_s=3600.0,  # the loop never ticks on its own
    autoscaler_min_replicas=1,
    autoscaler_max_replicas=4,
    autoscaler_scale_up_cooldown_s=5.0,
    autoscaler_scale_down_cooldown_s=15.0,
    autoscaler_stable_ticks=3,
)


def _port_fleet(root: str, clock=None, **kw) -> ReplicaSet:
    return ReplicaSet.from_store(ObjectStore(root), ServeConfig(**{**FLEET, **kw}), device="cpu",
                                 clock=clock or ManualClock())


def _jax_fleet(root: str, clock=None, **kw):
    cfg = JaxServeConfig(**{**FLEET, **kw}, precompile_batch_buckets=(), prewarm_all_buckets=False)
    return JaxReplicaSet.from_store(JaxStore(root), cfg, clock=clock or ManualClock())


@contextlib.contextmanager
def _pair(root: str, **kw):
    """(port fleet, its clock, JAX fleet, its clock)."""
    pc, jc = ManualClock(), ManualClock()
    port = _port_fleet(root, pc, **kw)
    try:
        ref = _jax_fleet(root, jc, **kw)
    except BaseException:
        port.close()
        raise
    try:
        yield port, pc, ref, jc
    finally:
        port.close()
        ref.close()


def _drive(scaler, **kw) -> None:
    """Replace the signal read with a scripted classification; the replica
    count stays live, so a resize sees its own effect."""
    fleet = scaler.fleet

    def fake_signals():
        sig = {"fast_burn": False, "queue_wait_p95_ms": None, "util": 0.0, "queue_depth": 0,
               "in_flight": 0, "replicas": len(fleet.replicas)}
        sig.update(kw)
        return sig

    scaler._signals = fake_signals


def _payload(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        n: int(rng.integers(0, 2)) if n in schema.SERVING_INT_FEATURES else float(np.round(rng.normal(), 3))
        for n in schema.SERVING_FEATURES
    }


def _events(fleet) -> list[tuple]:
    """The fleet journal's events but for their ids and wall times."""
    return [(e["component"], e["kind"], e["replica"], e["payload"], e["cause"], e["cause_id"] is not None)
            for e in fleet.journal.events()]


def _knobs(fleet) -> list[tuple]:
    return [(r.batcher._max_wait_s, r.batcher._max_rows) for r in fleet.replicas if r.batcher is not None]


# -- the reference's control-loop cases, on both fleets --------------------------------------


def test_scale_up_on_fast_burn(store_root):
    with _pair(store_root) as (port, _, ref, _):
        for fleet in (port, ref):
            assert fleet.autoscaler is not None and not fleet.autoscaler.running
            _drive(fleet.autoscaler, fast_burn=True)
        got, want = port.autoscaler.tick(), ref.autoscaler.tick()
        assert got == want and "scale_up" in got["actions"]
        assert len(port.replicas) == len(ref.replicas) == 3
        assert int(port.autoscaler._m_resizes.labels(direction="up").value) == 1
        assert port.replicas[2].device == torch.device("cpu")  # the fleet's device
        for i in range(12):  # the admitted replica takes traffic through the router
            assert 0.0 <= port.predict_single(_payload(i))["prob_default"] <= 1.0
        assert int(port._m_routed.labels(replica="2").value) > 0
        assert port._g_state.labels(replica="2").value is not None


def test_cooldown_prevents_flapping_and_engages_brownout(store_root):
    with _pair(store_root) as (port, pc, ref, jc):
        out = []
        for fleet, clock in ((port, pc), (ref, jc)):
            scaler = fleet.autoscaler
            _drive(scaler, fast_burn=True)
            first, second = scaler.tick(), scaler.tick()  # inside the cooldown: a rung
            n_mid = len(fleet.replicas)
            clock.advance(5.1)
            out.append((first, second, n_mid, scaler.tick(), len(fleet.replicas)))
        assert out[0] == out[1]
        first, second, n_mid, third, n_end = out[0]
        assert "scale_up" in first["actions"] and "scale_up" not in second["actions"]
        assert f"brownout:{port_auto.BROWNOUT_RUNGS[1]}" in second["actions"]
        assert n_mid == 3 and "scale_up" in third["actions"] and n_end == 4


def test_scale_down_needs_stable_idle_and_stops_at_floor(store_root):
    with _pair(store_root, replicas=3) as (port, pc, ref, jc):
        out = []
        for fleet, clock in ((port, pc), (ref, jc)):
            scaler = fleet.autoscaler
            _drive(scaler)  # idle
            ticks = [scaler.tick() for _ in range(3)]  # stable_ticks met on the third
            ticks += [scaler.tick() for _ in range(5)]  # the scale-down cooldown holds
            clock.advance(15.1)
            ticks.append(scaler.tick())  # the next tail replica retires
            clock.advance(15.1)
            ticks += [scaler.tick() for _ in range(6)]  # the floor
            out.append(([t["actions"] for t in ticks], len(fleet.replicas)))
        assert out[0] == out[1]
        actions, n = out[0]
        assert [a for a in actions if "scale_down" in a] == [["scale_down"]] * 2
        assert actions[2] == ["scale_down"] and actions[8] == ["scale_down"] and n == 1


def test_remove_replica_never_darkens_the_fleet(store_root):
    for fleet in (_port_fleet(store_root), _jax_fleet(store_root)):
        try:
            fleet.quarantine_replica(1, reason="drill")  # the tail is being healed
            with pytest.raises(Exception) as tail:
                fleet.remove_replica()
            fleet.readmit_replica(1)
            fleet.quarantine_replica(0, reason="drill")  # the tail is the last routable one
            with pytest.raises(Exception) as last:
                fleet.remove_replica()
            assert type(tail.value).__name__ == type(last.value).__name__ == "ValidationError"
            assert "being healed" in str(tail.value) and "one routable" in str(last.value)
        finally:
            fleet.close()


def test_ladder_releases_fully_before_any_retire(store_root):
    with _pair(store_root, autoscaler_max_replicas=2) as (port, pc, ref, jc):
        out = []
        for fleet, clock in ((port, pc), (ref, jc)):
            scaler = fleet.autoscaler
            _drive(scaler, fast_burn=True)
            ticks = [scaler.tick(), scaler.tick()]  # at the ceiling: rungs, not replicas
            level = fleet.brownout.level
            _drive(scaler)
            clock.advance(20.0)  # every cooldown long past
            ticks += [scaler.tick() for _ in range(5)]
            out.append(([t["actions"] for t in ticks], level, fleet.brownout.level, len(fleet.replicas)))
        assert out[0] == out[1]
        actions, level, after, n = out[0]
        assert level == 2 and after == 0 and n == 1
        assert actions[2] == [f"brownout_release:{port_auto.BROWNOUT_RUNGS[1]}"]
        assert actions[3] == [f"brownout_release:{port_auto.BROWNOUT_RUNGS[0]}"]
        assert actions[4:6] == [[], []] and actions[6] == ["scale_down"]


# -- one script through every path, tick for tick -----------------------------------------------

#: (signals, clock step before the tick, brownout engages by hand before it)
SCRIPT = (
    ({"fast_burn": True}, 0.0, 0),  # scale up 2 -> 3, retune busy
    ({"fast_burn": True}, 0.0, 0),  # the cooldown: rung 1
    ({"queue_wait_p95_ms": 25.0}, 0.0, 0),  # busy without burn: no rung, no replica
    ({"fast_burn": True}, 5.1, 0),  # past the cooldown: scale up 3 -> 4 (the ceiling)
    ({"fast_burn": True}, 0.0, 0),  # rung 2
    ({"fast_burn": True}, 10.0, 0),  # at the ceiling: rung 3
    ({"util": 0.5}, 0.0, 0),  # neither busy nor idle: release to rung 2, retune idle
    ({}, 0.0, 2),  # an operator at rung 4; idle releases to 3: rung 3 retunes busy
    ({}, 0.0, 0),  # release to 2: retune idle
    ({}, 0.0, 0),  # release to 1
    ({}, 0.0, 0),  # release to 0
    ({}, 0.0, 0),  # idle 1
    ({"queue_depth": 3}, 0.0, 0),  # not idle: the count restarts
    ({}, 0.0, 0),  # idle 1
    ({}, 0.0, 0),  # idle 2
    ({}, 20.0, 0),  # idle 3, cooled: retire 4 -> 3
    ({}, 15.1, 0),  # idle 1 after the retire
    ({}, 0.0, 0),
    ({}, 0.0, 0),  # idle 3: retire 3 -> 2
    ({}, 15.1, 0),
    ({}, 0.0, 0),
    ({}, 0.0, 0),  # the floor (min 2): no retire
    ({}, 30.0, 0),
)


def _run_script(fleet, clock) -> tuple[list, list]:
    scaler = fleet.autoscaler
    ticks, knobs = [], []
    for signals, step, engage in SCRIPT:
        clock.advance(step)
        for _ in range(engage):
            fleet.brownout.engage("operator")
        _drive(scaler, **signals)
        ticks.append(scaler.tick())
        knobs.append(_knobs(fleet))
    return ticks, knobs


def test_scripted_ticks_are_the_references(store_root):
    kw = dict(microbatch_enabled=True, autoscaler_min_replicas=2, brownout_max_level=5)
    with _pair(store_root, **kw) as (port, pc, ref, jc):
        got, want = _run_script(port, pc), _run_script(ref, jc)
        assert got == want
        assert _events(port) == _events(ref)
        ticks, knobs = got
        actions = [t["actions"] for t in ticks]
        assert actions[0] == ["scale_up", "retune:busy"] and actions[3] == ["scale_up"]
        assert actions[5] == ["brownout:wide_batch"] and actions[6] == ["brownout_release:no_shap", "retune:idle"]
        assert actions[7] == ["brownout_release:wide_batch", "retune:busy"]  # rung 3's retune
        assert actions[8] == ["brownout_release:no_shap", "retune:idle"]
        assert actions[15] == ["scale_down"] and actions[18] == ["scale_down"]
        assert all(a == [] for a in actions[19:]) and len(port.replicas) == 2
        busy, idle = (0.005, 256), (0.002, 64)
        assert knobs[0] == [busy] * 3 and knobs[6] == [idle] * 4 and knobs[7] == [busy] * 4
        assert knobs[-1] == [idle] * 2
        evs = port.journal.events(component="autoscaler")
        kinds = [(e["kind"], e["payload"].get("direction") or e["payload"].get("profile")) for e in evs]
        assert kinds.count(("resize", "up")) == 2 and kinds.count(("resize", "down")) == 2
        assert ("retune", "busy") in kinds and ("retune", "idle") in kinds
        assert all(e["cause"] for e in evs)
        retune = next(e for e in evs if e["kind"] == "retune")
        assert retune["payload"] == {"profile": "busy", "max_wait_ms": 5.0, "max_rows": 256, "replicas": 3}
        text = port.registry.render()
        for sample in ('cobalt_autoscaler_resizes_total{direction="up"} 2',
                       'cobalt_autoscaler_resizes_total{direction="down"} 2',
                       'cobalt_autoscaler_retunes_total{profile="busy"} 2',
                       'cobalt_autoscaler_brownouts_total{direction="engage"} 3',
                       'cobalt_autoscaler_brownouts_total{direction="release"} 5',
                       f"cobalt_autoscaler_ticks_total {len(SCRIPT)}"):
            assert sample in text, sample
        assert port.autoscaler.status() == ref.autoscaler.status()


def test_retune_on_the_port_widens_live_batches(store_root):
    """After a busy retune, queued single rows coalesce past the idle 64-row
    cap into one 128- or 256-row bucket, scored as the plain version."""
    fleet = _port_fleet(store_root, microbatch_enabled=True, replicas=2)
    try:
        _drive(fleet.autoscaler, fast_burn=True)
        fleet.autoscaler._retune(busy=True, summary={"actions": []})
        rep = fleet.replicas[0]
        assert (rep.batcher._max_wait_s, rep.batcher._max_rows) == (0.005, 256)
        before = rep.batcher.batches
        answers = []
        with rep.batcher.pause():
            threads = [threading.Thread(target=lambda i=i: answers.append(rep.predict_single(_payload(i))))
                       for i in range(150)]
            for t in threads:
                t.start()
            while rep.batcher.queue_depth() < 150:
                time.sleep(0.01)
        for t in threads:
            t.join(timeout=60)
        assert len(answers) == 150 and rep.batcher.batches == before + 1
        assert rep.batcher.max_batch_rows == 150
        assert all(a["shap_values"] is not None for a in answers)
    finally:
        fleet.close()


def test_queue_wait_signal_reads_the_fleet_history(store_root):
    """The worst replica's latest ``coalesce_wait:p95`` within four
    sampling intervals, from scripted series, in both packages."""
    wait = "cobalt_microbatch_coalesce_wait_seconds"
    with _pair(store_root, history_interval_s=2.0) as (port, _, ref, _):
        out = []
        for fleet, ts in ((port, port_ts), (ref, jax_ts)):
            clock = ManualClock(0.0)
            state = {"t": 0}

            def scrape():
                k = state["t"]
                buckets = {0.001: 2.0 * k, 0.01: 4.0 * k, 0.1: 5.0 * k, float("inf"): 5.0 * k}
                samples = {}
                for r, scale in (("0", 1.0), ("1", 3.0)):
                    for le, c in buckets.items():
                        tag = "+Inf" if le == float("inf") else f"{le:g}"
                        samples[f"{wait}_bucket|le={tag}|replica={r}"] = c * scale
                    samples[f"{wait}_count|replica={r}"] = buckets[float("inf")] * scale
                return {wait: {"type": "histogram", "samples": samples}}

            fleet.history = ts.TimeSeriesStore(scrape=scrape, clock=clock, tiers=((1.0, 64),))
            got = [fleet.autoscaler._queue_wait_p95_ms()]  # no points yet
            for k in range(3):
                state["t"], clock.now = k, float(k)
                fleet.history.sample_once()
            got.append(fleet.autoscaler._queue_wait_p95_ms())
            clock.now = 100.0  # past the window: nothing recent
            got.append(fleet.autoscaler._queue_wait_p95_ms())
            fleet.history = None
            got.append(fleet.autoscaler._queue_wait_p95_ms())
            out.append(got)
        assert out[0] == out[1]
        assert out[0][0] is None and out[0][2] is None and out[0][3] is None
        # rank 0.95 x 5 of the last window's 5 lands in (0.01, 0.1]: 10 + 90 x 0.75 ms
        assert out[0][1] == pytest.approx(77.5)


# -- the ladder, the gate and admission ------------------------------------------------------------


def test_brownout_rungs_walk_in_declared_order():
    assert port_auto.BROWNOUT_RUNGS == jax_auto.BROWNOUT_RUNGS
    for name in ("LEVEL_HEALTHY", "LEVEL_NO_CANARY", "LEVEL_NO_SHAP", "LEVEL_WIDE_BATCH",
                 "LEVEL_SHED_BULK", "LEVEL_SHED_ALL"):
        assert getattr(port_auto, name) == getattr(jax_auto, name)
    out = []
    for auto in (port_auto, jax_auto):
        ladder = auto.BrownoutLadder()
        walk = []
        while (step := ladder.engage("test")) is not None:
            walk.append(step)
        while (step := ladder.release("test")) is not None:
            walk.append(step)
        out.append((walk, ladder.snapshot()))
    assert out[0] == out[1]
    walk, snap = out[0]
    assert [port_auto.BROWNOUT_RUNGS[s[1]] for s in walk[:5]] == list(port_auto.BROWNOUT_RUNGS[1:])
    assert [port_auto.BROWNOUT_RUNGS[s[0]] for s in walk[5:]] == list(reversed(port_auto.BROWNOUT_RUNGS[1:]))
    assert snap["engaged_total"] == snap["released_total"] == 5


def test_brownout_max_level_caps_the_ladder():
    for auto in (port_auto, jax_auto):
        ladder = auto.BrownoutLadder(max_level=3)
        for _ in range(10):
            ladder.engage("test")
        assert ladder.level == 3


def test_brownout_gate_sheds_bulk_before_single():
    ladder = port_auto.BrownoutLadder()
    ladder.level = 4
    with pytest.raises(RequestShed):
        port_auto.brownout_gate(ladder, "bulk")
    port_auto.brownout_gate(ladder, "single")
    ladder.level = 5
    with pytest.raises(RequestShed) as exc:
        port_auto.brownout_gate(ladder, "single")
    jladder = jax_auto.BrownoutLadder()
    jladder.level = 5
    with pytest.raises(Exception) as jexc:
        jax_auto.brownout_gate(jladder, "single")
    assert str(exc.value) == str(jexc.value) and exc.value.body() == jexc.value.body()
    port_auto.brownout_gate(None, "bulk")


def test_brownout_shap_shed_degrades_without_persisting(store_root):
    fleet = _port_fleet(store_root, brownout_max_level=5)
    try:
        healthy = fleet.predict_single(_payload())
        assert healthy["shap_values"] is not None and "degraded" not in healthy
        fleet.brownout.level = port_auto.LEVEL_NO_SHAP
        resp = fleet.predict_single(_payload())
        assert resp["degraded"] is True and resp["shap_values"] is None and resp["base_value"] is None
        assert all(rep._model.shap_error is None for rep in fleet.replicas)
        fleet.brownout.level = 0
        recovered = fleet.predict_single(_payload())
        assert recovered["shap_values"] is not None and "degraded" not in recovered
        assert fleet.ready()[0]
    finally:
        fleet.close()


def test_brownout_shed_rungs_429_the_scoring_plane(store_root):
    fleet = _port_fleet(store_root, brownout_max_level=5)
    try:
        row = _payload()
        csv_bytes = (",".join(row) + "\n" + ",".join(str(v) for v in row.values()) + "\n").encode()
        fleet.brownout.level = 4
        with pytest.raises(RequestShed):
            fleet.predict_bulk_csv(csv_bytes)
        with pytest.raises(RequestShed):
            fleet.feature_importance_bulk({"data": [row]})
        fleet.predict_single(row)
        fleet.brownout.level = 5
        with pytest.raises(RequestShed):
            fleet.predict_single(row)
        fleet.brownout.level = 0
        assert fleet.predict_single(row)["prob_default"] >= 0.0
    finally:
        fleet.close()


def test_token_bucket_resize_refills_then_clamps():
    out = []
    for adm in (port_adm, jax_adm):
        clock = ManualClock(100.0)
        bucket = adm.TokenBucket(rate_rps=10.0, burst=10, clock=clock)
        got = [bucket.try_acquire() for _ in range(11)]
        clock.advance(0.5)  # 5 tokens at the old rate
        bucket.resize(rate_rps=20.0, burst=4)  # refilled, then clamped to 4
        got += [bucket.try_acquire() for _ in range(5)]
        clock.advance(0.2)  # the new rate: 4 tokens
        got += [bucket.try_acquire() for _ in range(5)]
        with pytest.raises(ValueError):
            bucket.resize(rate_rps=0.0, burst=4)
        out.append(got)
    assert out[0] == out[1] == [True] * 10 + [False] + ([True] * 4 + [False]) * 2


def test_admission_rescale_multiplies_base_capacity():
    for adm in (port_adm, jax_adm):
        ctl = adm.AdmissionController(max_in_flight=4, rate_rps=10.0, burst=10)
        assert ctl.rescale(3) == {"units": 3, "max_in_flight": 12, "rate_rps": 30.0}
        assert ctl.stats()["max_in_flight"] == 12 and ctl.stats()["scale_units"] == 3
        ctl.rescale(0)
        assert ctl.max_in_flight == 4
        free = adm.AdmissionController(max_in_flight=None, rate_rps=None)
        free.rescale(5)
        assert free.max_in_flight is None


def test_fleet_resize_recomputes_admission(store_root):
    with _pair(store_root) as (port, _, ref, _):
        out = []
        for fleet in (port, ref):
            base = fleet.admission._base_max_in_flight
            got = [fleet.admission.max_in_flight == base * 2]
            assert fleet.autoscaler._scale_up()
            got.append(fleet.admission.max_in_flight == base * 3)
            fleet.remove_replica()
            got.append(fleet.admission.max_in_flight == base * 2)
            out.append((got, fleet.admission.stats()))
        assert out[0] == out[1] and out[0][0] == [True] * 3


# -- the port alone: traffic under a resize, the device, failures, freeing ------------------------


def test_resize_mid_traffic_loses_zero_requests(store_root):
    fleet = _port_fleet(store_root, microbatch_enabled=True)
    errors: list[BaseException] = []
    served = [0]
    done = threading.Event()

    def hammer(seed: int):
        payload = _payload(seed)
        while not done.is_set():
            try:
                resp = fleet.predict_single(payload)
                assert 0.0 <= resp["prob_default"] <= 1.0
                served[0] += 1
            except BaseException as exc:  # noqa: BLE001 - the assertion
                errors.append(exc)
                return

    threads = [threading.Thread(target=hammer, args=(s,), daemon=True) for s in range(6)]
    try:
        for t in threads:
            t.start()
        scaler = fleet.autoscaler
        for _ in range(2):  # 2 -> 4 under load
            assert scaler._scale_up()
        for _ in range(3):  # 4 -> 1 under load, each drained before its pop
            assert fleet.remove_replica()["status"] == "retired"
        assert len(fleet.replicas) == 1
    finally:
        done.set()
        for t in threads:
            t.join(timeout=10.0)
        fleet.close()
    assert errors == [] and served[0] > 0


def test_scale_up_failure_is_logged_and_retried(store_root, monkeypatch):
    fleet = _port_fleet(store_root)
    try:
        real = port_service.ScorerService._smoke_check
        calls = {"n": 0}

        def failing(self, candidate):
            calls["n"] += 1
            if calls["n"] == 1:
                raise ValueError("smoke row scored nan, expected [0, 1]")
            return real(self, candidate)

        monkeypatch.setattr(port_service.ScorerService, "_smoke_check", failing)
        _drive(fleet.autoscaler, fast_burn=True)
        first = fleet.autoscaler.tick()
        assert "scale_up" not in first["actions"] and len(fleet.replicas) == 2
        assert first["actions"] == ["brownout:no_canary"]  # no batchers: nothing to retune
        assert fleet.journal.events(component="autoscaler", kind="resize") == []
        second = fleet.autoscaler.tick()  # no scale-up happened: no cooldown holds it
        assert "scale_up" in second["actions"] and len(fleet.replicas) == 3
    finally:
        fleet.close()


def test_retired_replica_is_freed_and_the_scaler_holds_none(store_root):
    fleet = _port_fleet(store_root)
    try:
        _drive(fleet.autoscaler, fast_burn=True)
        fleet.autoscaler.tick()
        tail = weakref.ref(fleet.replicas[-1])
        _drive(fleet.autoscaler)
        fleet.autoscaler.force(2)
        for t in threading.enumerate():
            if t.name.startswith("replica-retire-"):
                t.join(timeout=30)
        gc.collect()
        assert tail() is None
        state = fleet.autoscaler.__dict__
        assert not any(isinstance(v, ScorerService) for v in state.values())
        assert json.dumps(fleet.autoscaler.status())  # numbers and strings only
    finally:
        fleet.close()


# -- the operator plane over HTTP -----------------------------------------------------------------

#: (path, body) in order ("tick" ticks by hand); the force walks 2 -> 3.
ADMIN_SCRIPT = (
    ("/readyz", None),
    ("/admin/autoscaler", {"action": "pause"}),
    ("tick", None),
    ("/admin/autoscaler", {"action": "status"}),
    ("/admin/autoscaler", {"action": "force", "replicas": 3}),
    ("/admin/autoscaler", {"action": "force", "replicas": 99}),
    ("/admin/autoscaler", {"action": "force", "replicas": "three"}),
    ("/admin/autoscaler", {"action": "resume"}),
    ("/admin/autoscaler", {"action": "explode"}),
    ("/admin/autoscaler", {}),
    ("/readyz", None),
)


def _http(base: str, path: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method="GET" if body is None else "POST")
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _admin_drill(fleet, make_server) -> list:
    server = make_server(fleet, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    out = []
    try:
        for path, body in ADMIN_SCRIPT:
            if path == "tick":
                out.append((path, None, fleet.autoscaler.tick()))
                continue
            status, got = _http(base, path, body)
            if path == "/readyz":
                got = {"autoscaler": got["autoscaler"], "brownout": got["brownout"],
                       "replicas": got["replicas"]}
            out.append((path, status, got))
    finally:
        server.close()
    return out


def test_admin_autoscaler_and_readyz_blocks_over_http_are_the_references(store_root):
    with _pair(store_root) as (port, _, ref, _):
        got = _admin_drill(port, make_async_server)
        want = _admin_drill(ref, jax_make_server)
    assert got == want
    assert [s for _, s, _ in got] == [200, 200, None, 200, 200, 422, 422, 200, 422, 200, 200]
    assert got[2][2] == {"status": "paused"}  # a paused loop does nothing
    ready0, ready1 = got[0][2], got[-1][2]
    assert ready0["autoscaler"]["enabled"] is True and ready0["autoscaler"]["running"] is True
    assert set(ready0["autoscaler"]) == {"enabled", "running", "paused", "replicas", "min_replicas",
                                         "max_replicas", "idle_ticks", "brownout", "last_signals"}
    assert ready1["replicas"] == 3 and ready1["autoscaler"]["replicas"] == 3
    assert got[3][2]["paused"] is True
    assert got[4][2] == {"status": "ok", "replicas": 3, "target": 3, "steps": ["up"]}
    assert got[5][2]["detail"] == "replicas must be in [1, 4], got 99"
    assert got[8][2]["error"] == "invalid_input" and "unknown autoscaler action" in got[8][2]["detail"]


def test_admin_autoscaler_422_without_one_is_the_references(store_root):
    out = {}
    for side, svc, make in (
        ("port", ScorerService.from_store(ObjectStore(store_root), ServeConfig(), device="cpu"),
         make_async_server),
        ("jax", JaxScorerService.from_store(JaxStore(store_root), JaxServeConfig(prewarm_all_buckets=False)),
         jax_make_server),
        ("port_fleet", _port_fleet(store_root, autoscaler_enabled=False), make_async_server),
        ("jax_fleet", _jax_fleet(store_root, autoscaler_enabled=False), jax_make_server),
    ):
        server = make(svc, "127.0.0.1", 0)
        try:
            out[side] = _http(f"http://127.0.0.1:{server.port}", "/admin/autoscaler", {"action": "status"})
        finally:
            server.close()
            svc.close()
    assert out["port"][0] == out["jax"][0] == 422
    assert out["port"][1]["error"] == out["jax"][1]["error"] == "invalid_input"
    assert out["port_fleet"] == out["jax_fleet"]
    assert out["port_fleet"][1]["detail"] == (
        "autoscaler is not enabled on this fleet (ServeConfig.autoscaler_enabled)")


# -- the traffic generator -------------------------------------------------------------------------

SHAPES = ("diurnal", "ramp", "flash_crowd", "bursty", "steady")


def _tenants(traffic, **kw):
    return traffic.TenantPopulation(["a", "b", "c"], ["b"], n_tenants=8, seed=3, **kw)


def _arrivals(sched) -> list[tuple]:
    return [dataclasses.astuple(a) for a in sched]


@pytest.mark.parametrize("shape", SHAPES)
def test_schedules_are_the_references(shape):
    for seed in (0, 1, 7):
        out = []
        for traffic in (port_traffic, jax_traffic):
            gen = traffic.TrafficGenerator(
                traffic.shape_by_name(shape, seed), base_rps=5.0, peak_rps=80.0, duration_s=10.0,
                tenants=_tenants(traffic), seed=seed,
            )
            out.append((_arrivals(gen.schedule()), gen.summary(), list(gen.ticks())))
        assert out[0] == out[1], (shape, seed)
        arrivals, summary, _ = out[0]
        assert summary["arrivals"] == len(arrivals) > 0 and summary["shape"] == shape
        assert all(a[0] <= b[0] for a, b in zip(arrivals, arrivals[1:]))
        assert all(0.0 <= a[0] < 10.0 and a[1] in port_traffic.KINDS for a in arrivals)


def test_schedule_is_a_pure_function_of_the_seed():
    def gen(seed):
        return port_traffic.TrafficGenerator(port_traffic.shape_by_name("flash_crowd"), base_rps=5.0,
                                             peak_rps=80.0, duration_s=10.0,
                                             tenants=_tenants(port_traffic), seed=seed)

    assert gen(7).schedule() == gen(7).schedule() != gen(8).schedule()
    mixed = port_traffic.TrafficGenerator(port_traffic.steady(), base_rps=400.0, peak_rps=400.0,
                                          duration_s=2.0, tenants=_tenants(port_traffic), seed=1,
                                          mix={"single": 1.0, "bulk": 1.0, "shap": 2.0}, tick_s=1.0)
    jmixed = jax_traffic.TrafficGenerator(jax_traffic.steady(), base_rps=400.0, peak_rps=400.0,
                                          duration_s=2.0, tenants=_tenants(jax_traffic), seed=1,
                                          mix={"single": 1.0, "bulk": 1.0, "shap": 2.0}, tick_s=1.0)
    assert mixed.mix == jmixed.mix  # a mean over 64 takes the normal approximation
    assert _arrivals(mixed.schedule()) == _arrivals(jmixed.schedule()) and mixed.summary() == jmixed.summary()


def test_flash_crowd_shape_spikes_and_decays():
    shape = port_traffic.shape_by_name("flash_crowd")
    jshape = jax_traffic.shape_by_name("flash_crowd")
    phases = [i / 50 for i in range(51)] + [-1.0, 2.0]
    assert [shape.at(p) for p in phases] == [jshape.at(p) for p in phases]
    assert shape.at(0.1) == pytest.approx(0.05) and shape.at(0.4) == 1.0 and shape.at(0.99) < 0.15
    gen = port_traffic.TrafficGenerator(shape, base_rps=10.0, peak_rps=100.0, duration_s=100.0,
                                        tenants=_tenants(port_traffic))
    assert gen.target_rps(10.0) == pytest.approx(14.5) and gen.target_rps(40.0) == pytest.approx(100.0)


def test_shapes_compose_and_unknown_names_fail_loudly():
    combo = (port_traffic.steady(1.0) + port_traffic.bursty(seed=1)).scaled(0.5)
    jcombo = (jax_traffic.steady(1.0) + jax_traffic.bursty(seed=1)).scaled(0.5)
    assert combo.name == jcombo.name == "steady+bursty*0.5"
    assert [combo.at(i / 40) for i in range(41)] == [jcombo.at(i / 40) for i in range(41)]
    for traffic in (port_traffic, jax_traffic):
        with pytest.raises(ValueError, match="tsunami"):
            traffic.shape_by_name("tsunami")
        for kw in (dict(base_rps=10.0, peak_rps=5.0, duration_s=1.0),
                   dict(base_rps=1.0, peak_rps=2.0, duration_s=1.0, mix={"telepathy": 1.0}),
                   dict(base_rps=1.0, peak_rps=2.0, duration_s=0.0),
                   dict(base_rps=1.0, peak_rps=2.0, duration_s=1.0, mix={"single": 0.0})):
            with pytest.raises(ValueError):
                traffic.TrafficGenerator(traffic.steady(), tenants=_tenants(traffic), **kw)
        with pytest.raises(ValueError):
            traffic.TenantPopulation(["a"], n_tenants=0)
        with pytest.raises(ValueError):
            traffic.TenantPopulation(["a"], base_rows=[])


def test_tenant_populations_are_the_references():
    rows = [_payload(i) for i in range(5)]
    for kw in ({}, {"jitter": 0.0}, {"base_rows": rows}, {"base_rows": rows, "n_tenants": 12, "jitter": 0.2}):
        pops = [traffic.TenantPopulation(list(schema.SERVING_FEATURES), sorted(schema.SERVING_INT_FEATURES),
                                         seed=5, **kw) for traffic in (port_traffic, jax_traffic)]
        assert len(pops[0]) == len(pops[1])
        got = []
        for pop in pops:
            rng = random.Random(11)
            got.append([(t := pop.pick(rng), pop.payload(t, rng)) for _ in range(200)])
        assert got[0] == got[1], kw
    pop = _tenants(port_traffic)
    rng = random.Random(0)
    picks = [pop.pick(rng) for _ in range(4000)]
    assert picks.count(0) > picks.count(7) * 2  # a hot head, a cold tail
    row = pop.payload(2, random.Random(1))
    assert set(row) == {"a", "b", "c"} and row["b"] in (0, 1)
    real = port_traffic.TenantPopulation(["a", "b"], base_rows=[{"a": 1.0, "b": 2.0}], jitter=0.0, n_tenants=3)
    assert real.payload(2, random.Random(2)) == {"a": 1.0, "b": 2.0}
    assert port_rel.TrafficGenerator is port_traffic.TrafficGenerator
    assert port_rel.shape_by_name is port_traffic.shape_by_name
