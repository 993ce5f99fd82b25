"""The port's ``tools.incident_report`` against the reference's tool.

- The reference's own cases (``tests/test_events.py``' incident-report
  tests) on the port's journal: a chaos kill's chain renders with its
  suspected trigger and time to healthy and passes ``--require-cause``;
  ``--window`` keeps the heal tail; an orphan resize exits 4; an unreadable
  record exits 2.
- The same records go through both tools (the reference's as a
  subprocess): the markdown is equal byte for byte, with and without
  ``--window``, from a bench record and from shipped segments.
- A CPU fleet's chaos kill and error storm, quarantined and healed by the
  supervisor, passes ``--require-cause`` from the journal it shipped.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from cobalt_smart_lender_ai_tpu_torch import reliability as rel
from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet
from cobalt_smart_lender_ai_tpu_torch.telemetry import MetricsRegistry
from cobalt_smart_lender_ai_tpu_torch.telemetry.events import EventJournal
from cobalt_smart_lender_ai_tpu_torch.tools import incident_report

ROOT = Path(__file__).resolve().parent.parent
REF_TOOL = ROOT / "tools" / "incident_report.py"


class _Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _journal(capacity: int = 8, **kw) -> tuple[EventJournal, _Clock]:
    clock = _Clock()
    return EventJournal(capacity=capacity, clock=clock, mono=clock, **kw), clock


def _bench_doc(journal: EventJournal) -> dict:
    return {
        "bench": "serve_chaos",
        "load": {"requests": 10, "errors": 0, "untyped_errors": 0, "p99_ms": 4.2},
        "events": {"journal": journal.events(), "stats": journal.stats()},
    }


def _run_port(*args: str, capsys=None) -> tuple[int, str, str]:
    code = incident_report.main(list(args))
    out, err = capsys.readouterr() if capsys is not None else ("", "")
    return code, out, err


def _run_ref(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, str(REF_TOOL), *args], capture_output=True, text=True,
                          cwd=ROOT, timeout=300)


def _heal_chain(j: EventJournal, clock: _Clock) -> None:
    """The reference test's kill -> probe failure -> quarantine -> rebuild
    -> swap -> healthy chain, with a brownout step of its own."""
    j.emit("chaos", "inject", replica=1, payload={"fault": "kill"}, cause={"plan": "chaos"})
    clock.advance(0.5)
    pf = j.emit("supervisor", "probe_failure", replica=1, payload={"consecutive": 1})
    q = j.emit("supervisor", "transition", replica=1,
               payload={"from": "healthy", "to": "quarantined"}, cause={"reason": "probe"}, cause_id=pf)
    clock.advance(1.0)
    rb = j.emit("supervisor", "rebuild", replica=1, payload={"outcome": "ok"}, cause_id=q)
    sw = j.emit("supervisor", "swap", replica=1, cause_id=rb)
    j.emit("supervisor", "transition", replica=1,
           payload={"from": "restarting", "to": "healthy"}, cause_id=sw)


def test_renders_chain_and_passes_gate(tmp_path, capsys):
    j, clock = _journal(capacity=32)
    _heal_chain(j, clock)
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps(_bench_doc(j)))
    out = tmp_path / "incident.md"
    code, _, err = _run_port("--bench", str(bench), "--require-cause", "--out", str(out), capsys=capsys)
    assert code == 0, err
    report = out.read_text()
    assert "time to healthy: **1.000s**" in report
    assert "suspected trigger: `chaos.inject`" in report
    assert "orphans (no cause, no cause_id): 0" in report
    assert "require-cause: OK" in err
    # --window keeps only the heal tail
    code, stdout, _ = _run_port("--bench", str(bench), "--window", "0.6:", capsys=capsys)
    assert code == 0
    assert "chaos.inject" not in stdout.split("## Incidents")[1]


def test_require_cause_orphan_exits_4(tmp_path, capsys):
    j, _ = _journal(capacity=8)
    j.emit("autoscaler", "resize", payload={"direction": "up", "to": 2})
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps(_bench_doc(j)))
    code, _, err = _run_port("--bench", str(bench), "--require-cause", capsys=capsys)
    assert code == 4 and "orphan" in err
    # without the gate the same input renders fine
    assert _run_port("--bench", str(bench), capsys=capsys)[0] == 0


def test_unreadable_input_exits_2(tmp_path, capsys):
    assert _run_port("--bench", str(tmp_path / "nope.json"), capsys=capsys)[0] == 2
    empty = tmp_path / "empty.json"
    empty.write_text("{}")
    assert _run_port("--bench", str(empty), capsys=capsys)[0] == 2
    broken = tmp_path / "broken.json"
    broken.write_text("{not json")
    assert _run_port("--bench", str(broken), capsys=capsys)[0] == 2
    with pytest.raises(SystemExit):
        incident_report.main([])  # needs --bench and/or --store


def _rich_journal() -> EventJournal:
    """Every section of the report: a heal chain, an orphan and a caused
    resize, a brownout with a snapshot, canary and reload incidents, and
    routine churn."""
    j, clock = _journal(capacity=64)
    _heal_chain(j, clock)
    clock.advance(0.25)
    up = j.emit("autoscaler", "resize", payload={"direction": "up", "from": 2, "to": 3},
                cause={"queue_wait_p95_s": 0.12, "window_s": 2.0, "signals": {"a": 1}})
    j.emit("autoscaler", "resize", payload={"direction": "down", "from": 3, "to": 2})
    clock.advance(2.0)
    j.emit("autoscaler", "brownout", payload={"level": 2, "direction": "engage"}, cause_id=up)
    j.emit("canary", "reject", payload={"version": "v3", "reason": "auc"}, cause={"auc_drop": 0.02})
    rb = j.emit("reload", "rollback", payload={"key": "models/poison"}, cause={"error": "bad npz"})
    j.emit("breaker", "open", payload={"failures": 3}, cause_id=rb)
    j.emit("reload", "publish", payload={"key": "models/gbdt/model_tree"})
    return j


@pytest.mark.parametrize("window", [None, "0.6:", ":2.0", "1.6:3.9"])
def test_markdown_is_the_references_byte_for_byte(tmp_path, capsys, window):
    bench = tmp_path / "bench.json"
    bench.write_text(json.dumps(_bench_doc(_rich_journal()) | {
        "supervisor": {"quarantines": 1, "rebuilds_ok": 1, "heal_s": 1.0, "all_healthy": True},
        "autoscaler": {"resizes_up": 1, "resizes_down": 1, "brownout_engaged": 1,
                       "brownout_released": 0, "max_level_seen": 2},
    }))
    extra = [] if window is None else ["--window", window]
    port_out, ref_out = tmp_path / "port.md", tmp_path / "ref.md"
    code, _, _ = _run_port("--bench", str(bench), "--out", str(port_out), *extra, capsys=capsys)
    ref = _run_ref("--bench", str(bench), "--out", str(ref_out), *extra)
    assert ref.returncode == code == 0, ref.stderr
    assert port_out.read_bytes() == ref_out.read_bytes()
    # The gate's verdict and the stdout report agree too.
    code, stdout, _ = _run_port("--bench", str(bench), "--require-cause", *extra, capsys=capsys)
    ref = _run_ref("--bench", str(bench), "--require-cause", *extra)
    assert code == ref.returncode and stdout == ref.stdout


def test_shipped_segments_read_alike(tmp_path, capsys):
    store = ObjectStore(str(tmp_path / "lake"))
    j, clock = _journal(capacity=32, store=store, ship_interval_s=3600.0)
    j.start()
    _heal_chain(j, clock)
    j.stop()
    port_out, ref_out = tmp_path / "port.md", tmp_path / "ref.md"
    code, _, _ = _run_port("--store", store.uri, "--require-cause", "--out", str(port_out), capsys=capsys)
    ref = _run_ref("--store", store.uri, "--require-cause", "--out", str(ref_out))
    assert code == ref.returncode == 0, ref.stderr
    assert port_out.read_bytes() == ref_out.read_bytes()
    assert "time to healthy: **1.000s**" in port_out.read_text()


# -- a CPU fleet's chaos, quarantine and heal ------------------------------------------------


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """A small forest on the 20 serving features, fitted and saved by the port."""
    from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig
    from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier

    rng = np.random.default_rng(41)
    F = len(schema.SERVING_FEATURES)
    X = rng.normal(size=(1024, F)).astype(np.float32)
    X[:, 12:] = rng.integers(0, 2, size=(1024, F - 12))
    y = (X[:, 0] - 0.6 * X[:, 2] + 0.3 * rng.normal(size=1024) > 0).astype(np.float32)
    model = GBDTClassifier(GBDTConfig(n_estimators=6, max_depth=3, n_bins=32), device="cpu").fit(X, y)
    root = tmp_path_factory.mktemp("incident") / "lake"
    GBDTArtifact(forest=model.forest, feature_names=tuple(schema.SERVING_FEATURES),
                 bin_edges=model.bin_spec.edges.numpy()).save(ObjectStore(str(root)), "models/gbdt/model_tree")
    return str(root)


def _payload(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {n: int(rng.integers(0, 2)) if n in schema.SERVING_INT_FEATURES else float(np.round(rng.normal(), 3))
            for n in schema.SERVING_FEATURES}


def test_cpu_fleet_chaos_heal_passes_require_cause(store_root, tmp_path, capsys):
    cfg = ServeConfig(replicas=3, microbatch_enabled=True, microbatch_max_wait_ms=1.0, score_cache_size=0,
                      supervisor_probe_interval_s=3600.0, supervisor_probe_deadline_s=0.3,
                      supervisor_probe_failures=1, supervisor_drain_timeout_s=1.0,
                      replica_close_timeout_s=2.0)
    fleet = ReplicaSet.from_store(ObjectStore(store_root), cfg, device="cpu")
    plan = rel.ChaosPlan(seed=3, registry=MetricsRegistry()).inject(fleet)
    try:
        plan.kill_worker(replica=1)
        fleet._rr = 1
        fleet.predict_single(_payload(1))
        fleet.replicas[1].batcher.submit({n: 0.0 for n in schema.SERVING_FEATURES}, None).result(timeout=30)
        # The storm's replica takes the traffic: the others look loaded.
        plan.error_storm(replica=2, rate=1.0)
        with fleet._route_lock:
            fleet._inflight[0] += 100
            fleet._inflight[1] += 100
        for i in range(6):
            fleet.predict_single(_payload(10 + i))
        with fleet._route_lock:
            fleet._inflight[0] -= 100
            fleet._inflight[1] -= 100
        fleet.supervisor.tick()
        fleet.supervisor.tick()
        events = fleet.events(limit=1000)
    finally:
        plan.release()
        fleet.close()
        for t in threading.enumerate():
            if t.name.startswith("replica-reaper"):
                t.join(timeout=30)
    transitions = [e["payload"].get("to") for e in events
                   if (e["component"], e["kind"]) == ("supervisor", "transition")]
    assert "quarantined" in transitions and "healthy" in transitions
    bench = tmp_path / "fleet.json"
    bench.write_text(json.dumps({"events": {"journal": events}}))
    out = tmp_path / "fleet.md"
    code, _, err = _run_port("--bench", str(bench), "--require-cause", "--out", str(out), capsys=capsys)
    assert code == 0, err
    report = out.read_text()
    assert "time to healthy: **" in report and "orphans (no cause, no cause_id): 0" in report
    ref_out = tmp_path / "ref.md"
    ref = _run_ref("--bench", str(bench), "--require-cause", "--out", str(ref_out))
    assert ref.returncode == 0 and ref_out.read_bytes() == out.read_bytes()
