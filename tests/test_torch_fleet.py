"""The port's serving fleet against the JAX package's.

The same small forest (trained and saved by the JAX package) is served by
a port `ReplicaSet` on the CPU and by the reference's `ReplicaSet`, on
manual clocks (time passes only when a test moves it). The same scripts go
through both:

- `replica_internal`'s table and `ReplicaHealth`'s EWMA walk on the same
  outcome sequences: states, transitions and ``error_ewma`` bit for bit;
- the hedge decision table (`_hedge_target`);
- the router's picks on the same scripted loads: round-robin when idle, a
  loaded replica avoided, a stalled replica drained around, the error
  penalty, quarantined replicas skipped and the fail-open;
- manual quarantine and readmit over HTTP: status codes and bodies, the
  typed 422 on a single service;
- the chaos drills (a killed worker, an error storm, a hung dispatch): the
  same transitions in the journal, hedges and routed counts, and no
  untyped 500;
- the brownout rungs 1, 2, 4 and 5: the same responses, sheds and journal
  steps.

The port alone: its fleet's probabilities are the sigmoid of the JAX
package's margins; `resolve_replica_devices` with a patched card count;
``replicas=1`` is the plain service; a heal frees the old replica; the
probe without a batcher is one margin-only launch; `close` stays bounded
with a wedged replica; the fleet reload is all-or-nothing; and a kill plus
an error storm under concurrent HTTP clients, healed by manual ticks,
answers no untyped 500.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import threading
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
from cobalt_smart_lender_ai_tpu.models.gbdt import predict_margin as jax_predict_margin
import cobalt_smart_lender_ai_tpu.reliability as jax_rel
from cobalt_smart_lender_ai_tpu.reliability.deadline import Deadline as JaxDeadline
from cobalt_smart_lender_ai_tpu.serve.http_asyncio import make_async_server as jax_make_server
from cobalt_smart_lender_ai_tpu.serve.replicas import ReplicaSet as JaxReplicaSet
from cobalt_smart_lender_ai_tpu.serve.service import ScorerService as JaxScorerService
import cobalt_smart_lender_ai_tpu.serve.supervisor as jax_sup
import cobalt_smart_lender_ai_tpu_torch.reliability as port_rel
from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.reliability.deadline import Deadline
from cobalt_smart_lender_ai_tpu_torch.serve import supervisor as port_sup
from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server
from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet, resolve_replica_devices
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
from cobalt_smart_lender_ai_tpu_torch.telemetry import MetricsRegistry, default_program_registry

KEY = "models/gbdt/model_tree"
TOL_PROB = 1e-6
TOL_SHAP = 1e-5


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
    rng = np.random.default_rng(41)
    F = len(jax_schema.SERVING_FEATURES)
    X = rng.normal(size=(1024, F)).astype(np.float32)
    X[:, 12:] = rng.integers(0, 2, size=(1024, F - 12))
    y = X[:, 0] - 0.6 * X[:, 2] + 0.4 * X[:, 13] + 0.3 * rng.normal(size=1024) > 0
    model = JaxClassifier(n_estimators=6, max_depth=3, n_bins=32)
    model.fit(X, y.astype(np.int32))
    root = tmp_path_factory.mktemp("torch_fleet") / "lake"
    JaxArtifact(
        forest=model.forest, bin_spec=model.bin_spec, feature_names=tuple(jax_schema.SERVING_FEATURES)
    ).save(JaxStore(str(root)), KEY)
    return str(root)


#: Both packages' fleet fields: no score cache (every request reaches a
#: replica), snappy supervisor knobs, a probe loop that never ticks on its
#: own (tests tick by hand).
FLEET = dict(
    replicas=3,
    microbatch_enabled=False,
    score_cache_size=0,
    supervisor_probe_interval_s=3600.0,
    supervisor_probe_deadline_s=0.3,
    supervisor_probe_failures=1,
    supervisor_drain_timeout_s=1.0,
    replica_close_timeout_s=2.0,
)


def _port_fleet(root: str, clock, **kw):
    return ReplicaSet.from_store(ObjectStore(root), ServeConfig(**{**FLEET, **kw}), device="cpu",
                                 clock=clock)


def _jax_fleet(root: str, clock, **kw):
    cfg = JaxServeConfig(**{**FLEET, **kw}, precompile_batch_buckets=(), prewarm_all_buckets=False,
                         history_enabled=False)
    return JaxReplicaSet.from_store(JaxStore(root), cfg, clock=clock)


@contextlib.contextmanager
def _pair(root: str, **kw):
    """(port fleet, JAX fleet), each on its own manual clock."""
    port = _port_fleet(root, ManualClock(), **kw)
    try:
        ref = _jax_fleet(root, ManualClock(), **kw)
    except BaseException:
        port.close()
        raise
    try:
        yield port, ref
    finally:
        port.close()
        ref.close()


def _payload(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        n: int(rng.integers(0, 2)) if n in schema.SERVING_INT_FEATURES else float(np.round(rng.normal(), 3))
        for n in schema.SERVING_FEATURES
    }


def _routed(fleet) -> list[int]:
    return [int(fleet._m_routed.labels(replica=str(i)).value) for i in range(len(fleet.replicas))]


def _hedges(fleet) -> dict:
    return {o: int(fleet._m_hedges.labels(outcome=o).value) for o in ("rescued", "failed")}


def _health(fleet) -> list[tuple]:
    return [(h.state, h.error_ewma, h.outcomes, h.manual) for h in fleet.replica_health]


def _transitions(fleet) -> list[tuple]:
    return [
        (e["replica"], e["payload"]["from"], e["payload"]["to"])
        for e in fleet.journal.events(component="supervisor", kind="transition")
    ]


# -- the state machine ----------------------------------------------------------------


def test_replica_internal_table_is_the_references():
    pairs = [
        (port_rel.WorkerDead("w"), jax_rel.WorkerDead("w")),
        (RuntimeError("boom"), RuntimeError("boom")),
        (port_rel.ChaosError("x"), jax_rel.ChaosError("x")),
        (port_rel.ValidationError("x"), jax_rel.ValidationError("x")),
        (port_rel.DeadlineExceeded("x"), jax_rel.DeadlineExceeded("x")),
        (port_rel.RequestShed("x"), jax_rel.RequestShed("x")),
        (port_rel.CircuitOpenError("x"), jax_rel.CircuitOpenError("x")),
        (port_rel.WorkerKilled("x"), jax_rel.WorkerKilled("x")),
        (KeyboardInterrupt(), KeyboardInterrupt()),
    ]
    got = [port_sup.replica_internal(p) for p, _ in pairs]
    assert got == [jax_sup.replica_internal(r) for _, r in pairs]
    assert got == [True, True, True, False, False, False, False, False, False]
    assert port_sup.STATE_CODES == jax_sup.STATE_CODES


OUTCOMES = {
    "storm": ([False] * 7, True),
    "storm_without_supervisor": ([False] * 50, False),
    "degrade_then_recover": ([False, False, False] + [True] * 12, True),
    "flaky": ([False, True, False, False, True, True, False, True, True, True, False, False,
               False, False, False, False], True),
}


@pytest.mark.parametrize("name", sorted(OUTCOMES))
def test_ewma_walk_is_the_references(name):
    seq, allow = OUTCOMES[name]
    clocks = ManualClock(), ManualClock()
    port = port_sup.ReplicaHealth(0, clock=clocks[0])
    ref = jax_sup.ReplicaHealth(0, clock=clocks[1])
    for ok in seq:
        for c in clocks:
            c.advance(0.25)
        assert port.record_outcome(ok, allow_quarantine=allow) == ref.record_outcome(
            ok, allow_quarantine=allow
        )
        assert (port.state, port.error_ewma, port.routable) == (ref.state, ref.error_ewma, ref.routable)
        assert port.snapshot() == ref.snapshot()
    if name == "storm":
        assert port.state == port_sup.QUARANTINED and port.quarantined_at == clocks[0].now - 0.5
    if name == "storm_without_supervisor":
        assert port.state == port_sup.DEGRADED and port.routable
    if name == "degrade_then_recover":
        assert port.state == port_sup.HEALTHY and port.error_ewma == 0.0


# -- the router and the hedge ------------------------------------------------------------


@pytest.fixture(scope="module")
def fleets(store_root):
    with _pair(store_root) as pair:
        yield pair


def test_hedge_decision_table_is_the_references(fleets):
    port, ref = fleets
    for mod, fleet, dl in ((port_rel, port, Deadline), (jax_rel, ref, JaxDeadline)):
        fleet._table = [
            fleet._hedge_target(RuntimeError("x"), None, 0),
            fleet._hedge_target(RuntimeError("x"), dl(5.0), 0),
            fleet._hedge_target(mod.WorkerDead("x"), None, 2),
            fleet._hedge_target(mod.ValidationError("x"), None, 0),
            fleet._hedge_target(mod.DeadlineExceeded("x"), None, 0),
            fleet._hedge_target(mod.RequestShed("x"), None, 0),
            fleet._hedge_target(RuntimeError("x"), dl(0.0), 0),
            fleet._hedge_target(RuntimeError("x"), None, None),
        ]
    assert port._table == ref._table == [(0,), (0,), (2,), None, None, None, None, None]


def _script_picks(fleet) -> list:
    """The router's picks under scripted loads; each pick released after."""
    out = []

    def picks(n: int) -> list[int]:
        got = []
        for _ in range(n):  # sequential requests: each returns before the next
            got.append(fleet._pick())
            with fleet._route_lock:
                fleet._inflight[got[-1]] -= 1
        return got

    fleet._rr = 0
    out.append(picks(6))  # idle: round-robin
    fleet._inflight[1] += 5  # a loaded replica is avoided
    out.append(picks(6))
    fleet._inflight[1] -= 5
    stalled = fleet._pick()  # a stalled request keeps its replica busy
    out.append((stalled, picks(6)))
    with fleet._route_lock:
        fleet._inflight[stalled] -= 1
    fleet.replica_health[2].error_ewma = 0.5  # the error penalty (8 load units)
    fleet._inflight[0] += 7
    out.append(picks(4))
    fleet._inflight[0] -= 7
    fleet.replica_health[2].error_ewma = 0.0
    fleet.replica_health[0].state = port_sup.QUARANTINED  # skipped
    out.append(picks(4))
    fleet.replica_health[1].state = port_sup.RESTARTING
    fleet.replica_health[2].state = port_sup.QUARANTINED  # none routable: fail open
    fleet._inflight[2] += 1
    out.append(picks(3))
    fleet._inflight[2] -= 1
    out.append([fleet._pick(exclude=(0, 1)) for _ in range(2)])
    with fleet._route_lock:
        fleet._inflight[2] -= 2
    fleet._rr = 0
    for h in fleet.replica_health:
        h.state = port_sup.HEALTHY
    return out


def test_router_picks_are_the_references(fleets):
    port, ref = fleets
    got = _script_picks(port)
    assert got == _script_picks(ref)
    assert got[0] == [0, 1, 2, 0, 1, 2] and 1 not in got[1]
    assert got[2][0] not in got[2][1] and got[3] == [1] * 4 and 0 not in got[4]
    assert 2 not in got[5] and got[6] == [2, 2]
    assert port._inflight == [0, 0, 0]


def test_sequential_traffic_routes_and_hedges_as_the_references(fleets):
    """Idle round-robin, a replica failing instantly (hedged, then shed by
    its penalty), a manual quarantine (no traffic) and a readmit (traffic
    again): the routed counts, hedges and health equal the reference's."""
    port, ref = fleets
    out = {}
    for side, fleet in (("port", port), ("jax", ref)):
        fleet._rr = 0
        base = _routed(fleet)
        steps = []
        for i in range(6):
            fleet.predict_single(_payload(i))
        steps.append(_routed(fleet))
        real = fleet.replicas[0].predict_single

        def _boom(payload, deadline=None):
            raise RuntimeError("injected storm")

        fleet.replicas[0].predict_single = _boom
        fleet._rr = 0
        for i in range(12):
            assert 0.0 <= fleet.predict_single(_payload(i))["prob_default"] <= 1.0
        fleet.replicas[0].predict_single = real
        steps.append((_routed(fleet), _hedges(fleet), _health(fleet)))
        fleet.quarantine_replica(1, reason="drill")
        for i in range(4):
            fleet.predict_single(_payload(i))
        steps.append(_routed(fleet))
        fleet.readmit_replica(1)
        for i in range(3):
            fleet.predict_single(_payload(i))
        steps.append((_routed(fleet), _health(fleet), _transitions(fleet)))
        out[side] = (base, steps)
    assert out["port"] == out["jax"]
    (_, steps) = out["port"]
    assert steps[1][1]["rescued"] >= 1 and steps[3][0][1] > steps[2][1]


def test_fleet_probabilities_are_the_sigmoid_of_the_jax_margins(fleets, store_root):
    port, ref = fleets
    payloads = [_payload(100 + i) for i in range(12)]
    rows = np.stack([port.replicas[0]._model.rows_array([r])[0] for r in payloads])
    art = JaxArtifact.load(JaxStore(store_root), KEY)
    margins = np.array(jax_predict_margin(art.forest, rows), np.float32)
    want = torch.sigmoid(torch.from_numpy(margins)).numpy()
    host = 1.0 / (1.0 + np.exp(-margins.astype(np.float64)))
    got = np.array([port.predict_single(p)["prob_default"] for p in payloads], np.float32)
    assert np.array_equal(got, want)
    assert np.abs(got - host).max() <= TOL_PROB
    refs = [ref.predict_single(p) for p in payloads]
    for p, r in zip(payloads, refs):
        mine = port.predict_single(p)
        assert abs(mine["prob_default"] - r["prob_default"]) <= TOL_PROB
        np.testing.assert_allclose(mine["shap_values"], r["shap_values"], rtol=0, atol=TOL_SHAP)
    X = np.random.default_rng(5).normal(size=(300, rows.shape[1])).astype(np.float32)
    bulk = port.predict_proba(X)
    jm = np.array(jax_predict_margin(art.forest, X), np.float32)
    assert np.array_equal(bulk, torch.sigmoid(torch.from_numpy(jm)).numpy())


def _resize(fleet, make_replica, rel) -> list:
    """Grow the fleet by one at runtime, route to it, retire tails down to
    one replica, and try a retire with a quarantined tail."""
    out = []
    i = fleet.add_replica(make_replica(fleet))
    fleet._rr = 0
    for k in range(8):
        fleet.predict_single(_payload(k))
    out.append((i, len(fleet.replicas), _routed(fleet)))
    for _ in range(3):
        try:
            out.append(fleet.remove_replica(drain_timeout_s=1.0))
        except rel.ValidationError as exc:
            out.append(("refused", str(exc)))
    fleet.add_replica(make_replica(fleet))
    fleet.quarantine_replica(1)
    try:
        fleet.remove_replica()
    except rel.ValidationError as exc:
        out.append(("refused", str(exc)))
    out.append([(e["payload"], e["cause"]) for e in fleet.journal.events(component="admission")])
    out.append(_transitions(fleet))
    return out


def test_runtime_resize_is_the_references(store_root):
    with _pair(store_root, replicas=2) as (port, ref):
        got = _resize(port, lambda f: ScorerService(
            f.artifact, f.config, device="cpu", store=f._store, clock=f._clock), port_rel)
        want = _resize(ref, lambda f: JaxScorerService(
            f.artifact, f.config, store=f._store, clock=f._clock), jax_rel)
    assert got == want
    assert got[0][:2] == (2, 3) and got[0][2][2] > 0
    assert [r["status"] if isinstance(r, dict) else r[0] for r in got[1:4]] == ["retired", "retired",
                                                                                 "refused"]
    assert got[4][0] == "refused" and "being healed" in got[4][1]


# -- the admin plane over HTTP -----------------------------------------------------------


def _http(base: str, path: str, body: dict | None = None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


ADMIN_SCRIPT = [
    ("/admin/quarantine", {"replica": 1, "reason": "drill"}),
    ("/admin/quarantine", {"replica": 1}),  # idempotent
    ("/admin/quarantine", {"replica": 2}),
    ("/admin/quarantine", {"replica": 0}),  # the last routable one: refused
    ("/admin/readmit", {"replica": 1}),
    ("/admin/readmit", {"replica": 1}),  # healthy: nothing to readmit
    ("/admin/quarantine", {"replica": 99}),
    ("/admin/quarantine", {"replica": "one"}),
    ("/admin/readmit", {}),
    ("/admin/autoscaler", {"action": "status"}),
]


def _admin_drill(fleet, make_server) -> list:
    server = make_server(fleet, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    out = []
    try:
        for path, body in ADMIN_SCRIPT:
            status, got, _ = _http(base, path, body)
            out.append((path, status, got))
            if path == "/admin/quarantine" and status == 200 and body.get("replica") == 2:
                _, ready, _ = _http(base, "/readyz")
                out.append((ready["router"]["routable"], ready["supervisor"]["states"],
                            [p["supervisor"] for p in ready["per_replica"]]))
        for i in range(6):  # replica 2 still quarantined: no traffic
            assert _http(base, "/predict", _payload(i))[0] == 200
        out.append(_routed(fleet)[2])
    finally:
        server.close()
    return out


def test_admin_quarantine_and_readmit_over_http_are_the_references(store_root):
    with _pair(store_root) as (port, ref):
        got = _admin_drill(port, make_async_server)
        want = _admin_drill(ref, jax_make_server)
        # the autoscaler's 422 on a fleet without one, detail included
        assert got[-2][:2] == want[-2][:2] == ("/admin/autoscaler", 422)
        assert got[-2][2] == want[-2][2] and got[-2][2]["error"] == "invalid_input"
        assert got == want
        statuses = [g[1] for g in got if isinstance(g, tuple) and isinstance(g[0], str)]
        assert statuses == [200, 200, 200, 422, 200, 422, 422, 422, 422, 422]
        assert got[-1] == 0


def test_admin_routes_on_a_single_service_are_typed_422(store_root):
    port = ScorerService.from_store(ObjectStore(store_root), ServeConfig(), device="cpu")
    ref = JaxScorerService.from_store(JaxStore(store_root), JaxServeConfig(prewarm_all_buckets=False))
    out = {}
    for side, svc, make in (("port", port, make_async_server), ("jax", ref, jax_make_server)):
        server = make(svc, "127.0.0.1", 0)
        base = f"http://127.0.0.1:{server.port}"
        try:
            out[side] = [_http(base, path, {"replica": 0})[:2] for path in
                         ("/admin/quarantine", "/admin/readmit", "/admin/autoscaler")]
        finally:
            server.close()
            svc.close()
    assert out["port"] == out["jax"]
    assert [s for s, _ in out["port"]] == [422, 422, 422]


# -- chaos drills ---------------------------------------------------------------------------


def _wait_alive(batcher) -> None:
    """Bounded wait for a restarted worker: a scored probe row."""
    fut = batcher.submit({n: 0.0 for n in schema.SERVING_FEATURES}, None)
    fut.result(timeout=30)


def _drills(fleet, rel) -> dict:
    """Kill replica 1's worker, then an error storm on replica 2 with the
    others loaded, then heal by hand. Sequential: the script routes alike
    on both packages."""
    out = {}
    plan = rel.ChaosPlan(seed=3, registry=MetricsRegistry()).inject(fleet)
    try:
        plan.kill_worker(replica=1)
        fleet._rr = 1
        resp = fleet.predict_single(_payload(1))
        _wait_alive(fleet.replicas[1].batcher)
        out["kill"] = (0.0 <= resp["prob_default"] <= 1.0, _hedges(fleet), _routed(fleet),
                       _health(fleet), fleet.replicas[1].batcher.stats()["worker_restarts"])
        plan.error_storm(replica=2, rate=1.0)
        with fleet._route_lock:
            fleet._inflight[0] += 100
            fleet._inflight[1] += 100
        old = fleet.replicas[2]
        for i in range(6):
            fleet.predict_single(_payload(10 + i))
        with fleet._route_lock:
            fleet._inflight[0] -= 100
            fleet._inflight[1] -= 100
        out["storm"] = (_hedges(fleet), _routed(fleet), _health(fleet), dict(plan.events))
        tick1 = fleet.supervisor.tick()
        out["heal"] = (tick1, _health(fleet), fleet.replicas[2] is not old,
                       fleet.supervisor._m_rebuilds.labels(replica="2", outcome="ok").value)
        del old
        out["tick2"] = fleet.supervisor.tick()
        out["transitions"] = _transitions(fleet)
        out["journal"] = [(e["component"], e["kind"], e["replica"])
                          for e in fleet.events(component="supervisor")]
        out["chaos_events"] = [e["payload"]["fault"] for e in fleet.events(component="chaos")]
    finally:
        plan.release()
    return out


def test_chaos_drills_are_the_references(store_root):
    kw = dict(microbatch_enabled=True, microbatch_max_wait_ms=1.0)
    with _pair(store_root, **kw) as (port, ref):
        got = _drills(port, port_rel)
        want = _drills(ref, jax_rel)
    assert got == want
    assert got["kill"][0] and got["kill"][1] == {"rescued": 1, "failed": 0} and got["kill"][4] == 1
    assert got["storm"][2][2][0] == port_sup.QUARANTINED and got["storm"][3]["error"] == 5
    assert got["heal"][0]["healed"] == 1 and got["heal"][2] and got["heal"][3] == 1
    assert all(h[0] == port_sup.HEALTHY for h in got["heal"][1])
    assert got["transitions"] == [(2, "healthy", "degraded"), (2, "degraded", "quarantined"),
                                  (2, "quarantined", "restarting"), (2, "restarting", "healthy")]
    assert got["tick2"] == {"probed": 3, "quarantined": 0, "healed": 0, "revived": 0}


def _hang_drill(fleet, rel) -> dict:
    """A hung dispatch on replica 1: a caller with a deadline gets a typed
    504 (no hedge), a second request queues behind the hang, and the next
    tick's queue-age watchdog quarantines; the tick after heals."""
    plan = rel.ChaosPlan(seed=4, registry=MetricsRegistry()).inject(fleet)
    plan.hang_dispatch(replica=1, hang_s=60.0)
    out = {}
    try:
        fleet._rr = 1
        dl = (Deadline if rel is port_rel else JaxDeadline)(0.25)
        try:
            fleet.predict_single(_payload(2), deadline=dl)
            out["caller"] = "200"
        except rel.DeadlineExceeded as exc:
            out["caller"] = (exc.status, exc.code)
        queued = fleet.replicas[1].batcher.submit({n: 0.0 for n in schema.SERVING_FEATURES}, None)
        with pytest.raises(Exception):  # still behind the hang after a bounded wait
            queued.result(timeout=0.3)
        out["tick1"] = fleet.supervisor.tick()
        out["reason"] = fleet.replica_health[1].reason.startswith("queue head stalled")
        out["tick2"] = fleet.supervisor.tick()
        out["hedges"] = _hedges(fleet)
        out["transitions"] = _transitions(fleet)
    finally:
        plan.release()
    return out


def test_hang_drill_is_the_references(store_root):
    kw = dict(microbatch_enabled=True, microbatch_max_wait_ms=1.0, supervisor_queue_age_limit_s=0.2)
    with _pair(store_root, **kw) as (port, ref):
        got = _hang_drill(port, port_rel)
        want = _hang_drill(ref, jax_rel)
    assert got == want
    assert got["caller"] == (504, "deadline_exceeded") and got["reason"]
    assert got["tick1"]["quarantined"] == 1 and got["tick2"]["healed"] == 1
    assert got["hedges"] == {"rescued": 0, "failed": 0}


# -- the brownout ladder ----------------------------------------------------------------------


class _Taps:
    """A stand-in canary: counts the facade's taps."""

    def __init__(self):
        self.n = 0

    def tap(self, row, prob, latency_s):
        self.n += 1


def _csv(n: int) -> bytes:
    rows = [",".join(schema.SERVING_FEATURES)]
    for i in range(n):
        p = _payload(300 + i)
        rows.append(",".join(str(p[f]) for f in schema.SERVING_FEATURES))
    return ("\n".join(rows) + "\n").encode()


def _ladder(fleet, rel, respond) -> list:
    taps = fleet.canary = _Taps()
    out = []
    for level in range(6):
        if level:
            fleet.brownout.engage("drill")
        if level == 3:
            continue
        before = taps.n
        resp = {}
        for kind, call in (("single", lambda: fleet.predict_single(_payload(7))),
                           ("bulk", lambda: fleet.predict_bulk_csv(_csv(3)))):
            try:
                resp[kind] = respond(call())
            except rel.RequestShed as exc:
                resp[kind] = ("shed", exc.retry_after_s, str(exc))
        out.append((level, fleet.brownout.rung, taps.n - before, resp))
    while fleet.brownout.release("drill"):
        pass
    out.append(respond(fleet.predict_single(_payload(7))))
    out.append([(e["payload"]["direction"], e["payload"]["level"])
                for e in fleet.journal.events(component="autoscaler", kind="brownout")])
    fleet.canary = None
    return out


def _shape(resp: dict) -> dict:
    """A response's keys and flags, its probabilities and its SHAP width."""
    if "predictions" in resp:
        return {"predictions": [r["prob_default"] for r in resp["predictions"]]}
    out = {k: v for k, v in resp.items() if k not in ("shap_values", "input_row")}
    out["shap"] = None if resp["shap_values"] is None else len(resp["shap_values"])
    return out


def _close(a, b) -> bool:
    """Equal structures, floats within the probability tolerance."""
    if isinstance(a, float) and isinstance(b, float):
        return abs(a - b) <= TOL_PROB
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    return a == b


def test_brownout_rungs_are_the_references(store_root):
    with _pair(store_root, brownout_max_level=5) as (port, ref):
        progs = default_program_registry()
        before = {r["name"]: r["dispatches"] for r in progs.table()}
        got = _ladder(port, port_rel, _shape)
        after = {r["name"]: r["dispatches"] for r in progs.table()}
        want = _ladder(ref, jax_rel, _shape)
    assert _close(got, want), (got, want)
    levels = {row[0]: row for row in got[:5]}
    assert levels[0][2] == 1 and levels[1][2] == 0  # rung 1: no canary tap
    assert levels[2][3]["single"]["degraded"] is True and levels[2][3]["single"]["shap"] is None
    assert levels[4][3]["bulk"][0] == "shed" and levels[4][3]["single"]["shap"] is None
    assert levels[5][3]["single"][0] == "shed"
    assert "degraded" not in got[5] and got[5]["shap"] == 20
    assert got[6] == [("engage", i) for i in range(1, 6)] + [("release", i) for i in range(4, -1, -1)]
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    # rungs 2 and 4 score single rows margin-only: the SHAP program moved
    # only at levels 0 and 1 and after the release
    assert moved.get("score_forest_plain/f32/1/shap") == 3
    assert moved.get("score_forest_plain/f32/1/margin") == 2


def test_brownout_gate_answers_429_with_retry_after_over_http(store_root):
    fleet = _port_fleet(store_root, ManualClock(), brownout_max_level=5)
    server = make_async_server(fleet, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    try:
        for _ in range(4):
            fleet.brownout.engage("drill")
        req = urllib.request.Request(base + "/predict_bulk_csv", data=_csv(2),
                                     headers={"Content-Type": "text/csv"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 429 and ei.value.headers["Retry-After"] == "1"
        assert json.loads(ei.value.read())["error"] == "shed"
        assert _http(base, "/predict", _payload(1))[0] == 200
        fleet.brownout.engage("drill")
        status, body, headers = _http(base, "/predict", _payload(1))
        assert status == 429 and body["error"] == "shed" and headers["Retry-After"] == "1"
        ready = _http(base, "/readyz")[1]
        assert ready["brownout"]["level"] == 5 and ready["brownout"]["rung"] == "shed_all"
    finally:
        server.close()
        fleet.close()


# -- the port alone ----------------------------------------------------------------------------


def test_resolve_replica_devices(monkeypatch):
    assert resolve_replica_devices(3, True, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_replica_devices(4, True) == [torch.device("cuda", 0)] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    pinned = resolve_replica_devices(6, True)
    assert [d.index for d in pinned] == [0, 1, 2, 3, 0, 1]
    assert resolve_replica_devices(3, False) == [torch.device("cuda", 0)] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_replica_devices(2, True)


def test_pinned_publication_labels_each_replica_with_its_own_programs():
    """A fleet with a replica per card publishes each replica's program rows
    under its ``replica`` label, filtered to the programs of its device."""
    from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import ProgramRegistry

    programs, reg = ProgramRegistry(), MetricsRegistry()
    programs.register("score_forest/f32/1/shap", kind="kernel", meta={"device": "cuda:0"})
    for i in (0, 1):
        programs.publish(reg, replica=str(i), device=f"cuda:{i}")
    programs.register("score_forest/f32/8/shap", kind="kernel", meta={"device": "cuda:1"})
    programs.register("score_forest/f32/8/shap", kind="kernel").record_dispatch(0.5)
    text = reg.render()
    assert 'cobalt_program_dispatches_total{program="score_forest/f32/1/shap",replica="0"} 0' in text
    assert 'cobalt_program_dispatches_total{program="score_forest/f32/8/shap",replica="1"} 1' in text
    assert 'program="score_forest/f32/1/shap",replica="1"' not in text
    assert 'program="score_forest/f32/8/shap",replica="0"' not in text


def test_one_replica_is_the_plain_service(store_root):
    svc = ReplicaSet.from_store(ObjectStore(store_root), ServeConfig(replicas=1), device="cpu")
    try:
        assert type(svc) is ScorerService and svc.brownout is None
    finally:
        svc.close()


def test_fleet_families_and_readyz(store_root):
    fleet = _port_fleet(store_root, ManualClock())
    try:
        fleet.predict_single(_payload(0))
        text = fleet.registry.render()
        for family in ("cobalt_replica_count", "cobalt_replica_in_flight", "cobalt_replica_routed_total",
                       "cobalt_replica_queue_depth", "cobalt_replica_hedges_total",
                       "cobalt_supervisor_state", "cobalt_supervisor_error_ewma",
                       "cobalt_supervisor_ticks_total", "cobalt_brownout_level",
                       "cobalt_program_dispatches_total", "cobalt_request_latency_seconds"):
            assert family in text, family
        assert 'replica="2"' in text
        ok, ready = fleet.ready()
        assert ok and ready["replicas"] == 3 and ready["replica_devices"] == ["cpu"] * 3
        assert ready["router"]["policy"] == "least_loaded" and len(ready["per_replica"]) == 3
        assert ready["autoscaler"] == {"enabled": False}
        # the reference's default: a fleet history over the merged registries
        assert type(fleet.history).__name__ == "TimeSeriesStore"
        assert fleet.history.tiers() == [{"width_s": w, "capacity": c}
                                         for w, c in JaxServeConfig().history_tiers]
    finally:
        fleet.close()


def test_heal_frees_the_old_replica_and_probes_margin_only(store_root):
    """Without a batcher the probe is one margin-only launch at bucket 1;
    a healed replica's predecessor is closed and collected."""
    fleet = _port_fleet(store_root, ManualClock(), replicas=2)
    try:
        def margin1() -> int:
            rows = {r["name"]: r["dispatches"] for r in default_program_registry().table()}
            return rows.get("score_forest_plain/f32/1/margin", 0)

        before = margin1()
        assert fleet.supervisor.tick()["probed"] == 2
        assert margin1() - before == 2
        old = weakref.ref(fleet.replicas[1])
        fleet.quarantine_replica(1)
        fleet.replica_health[1].manual = False  # an automatic quarantine heals
        assert fleet.supervisor.tick()["healed"] == 1
        for t in threading.enumerate():
            if t.name == "replica-reaper-1":
                t.join(timeout=30)
        gc.collect()
        assert old() is None
        want = fleet.replicas[0].predict_single(_payload(3))["prob_default"]
        assert fleet.replicas[1].predict_single(_payload(3))["prob_default"] == want
    finally:
        fleet.close()


def test_close_is_bounded_with_a_wedged_replica(store_root):
    fleet = _port_fleet(store_root, ManualClock(), replicas=2, microbatch_enabled=True,
                        microbatch_max_wait_ms=1.0, replica_close_timeout_s=0.5)
    hung, wake = threading.Event(), threading.Event()

    def wedge(_seconds: float) -> None:
        hung.set()
        wake.wait(timeout=60)

    plan = port_rel.ChaosPlan(seed=5, sleep=wedge, registry=MetricsRegistry()).inject(fleet)
    plan.hang_dispatch(replica=1, hang_s=60.0)
    try:
        fleet.replicas[1].batcher.submit({n: 0.0 for n in schema.SERVING_FEATURES}, None)
        assert hung.wait(timeout=30)
        done = threading.Event()
        closer = threading.Thread(target=lambda: (fleet.close(), done.set()))
        closer.start()
        assert done.wait(timeout=10)  # bounded by the 0.5 s timeout, not the hang
    finally:
        wake.set()
        plan.release()


def _zeroed(root: str) -> None:
    art = GBDTArtifact.load(ObjectStore(root), KEY, "cpu")
    art = dataclasses.replace(art, forest=dataclasses.replace(
        art.forest, leaf_value=torch.zeros_like(art.forest.leaf_value)))
    art.save(ObjectStore(root), KEY)


def test_fleet_reload_is_all_or_nothing(store_root, tmp_path):
    import shutil

    root = str(tmp_path / "lake")
    shutil.copytree(store_root, root)
    fleet = _port_fleet(root, ManualClock(), replicas=2)
    try:
        baseline = [rep.predict_single(_payload(4))["prob_default"] for rep in fleet.replicas]
        _zeroed(root)

        def boom(store, key):
            raise RuntimeError("injected candidate failure")

        real = fleet.replicas[1]._build_candidate
        fleet.replicas[1]._build_candidate = boom
        result = fleet.reload_from_store()
        assert result["status"] == "rolled_back" and "injected candidate failure" in result["error"]
        assert [rep.predict_single(_payload(4))["prob_default"] for rep in fleet.replicas] == baseline
        fleet.replicas[1]._build_candidate = real
        assert fleet.reload_from_store()["status"] == "ok"
        assert [rep.predict_single(_payload(4))["prob_default"] for rep in fleet.replicas] == [0.5, 0.5]
        ObjectStore(root).put_bytes("models/poison.npz", b"\x00junk")
        result = fleet.reload_from_store(model_key="models/poison")
        assert result["status"] == "rolled_back" and result["replicas"] == 2
        assert fleet.predict_single(_payload(4))["prob_default"] == 0.5
        kinds = [(e["component"], e["kind"]) for e in fleet.events(component="reload")]
        assert kinds[0] == ("reload", "rollback") and kinds[-1] == ("reload", "rollback")
        assert fleet.ready()[1]["last_reload"]["status"] == "rolled_back"
    finally:
        fleet.close()


def test_kill_and_storm_under_concurrent_http_answer_no_untyped_500(store_root):
    """The deterministic counterpart of the reference's live heal: a fixed
    number of requests per client thread while replica 1's worker is killed
    and its dispatches error, then the manual ticks heal the fleet."""
    fleet = _port_fleet(store_root, ManualClock(), microbatch_enabled=True, microbatch_max_wait_ms=1.0)
    plan = port_rel.ChaosPlan(seed=6, registry=MetricsRegistry()).inject(fleet)
    plan.kill_worker(replica=1)
    plan.error_storm(replica=1, rate=1.0)
    server = make_async_server(fleet, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    results: list = []
    lock = threading.Lock()

    def client(seed: int) -> None:
        for i in range(15):
            got = _http(base, "/predict", _payload(seed * 100 + i))
            with lock:
                results.append(got[:2])

    try:
        assert fleet.supervisor.running
        threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert len(results) == 60
        for status, body in results:
            if status != 200:
                assert "error" in body, body
                assert status != 500 or body["error"] == "worker_dead", body
        for _ in range(3):
            fleet.supervisor.tick()
        assert all(h.state == port_sup.HEALTHY for h in fleet.replica_health), _health(fleet)
        assert fleet.replicas[1].batcher._chaos is None  # healing cleared the chaos
        assert _hedges(fleet)["rescued"] >= 1 and plan.events["kill"] == 1
    finally:
        plan.release()
        server.close()
        fleet.close()
