"""The port's control-plane journal (`telemetry/events.py`) against the JAX
package's.

The same scripted emits go through both `EventJournal`s on the same fake
clock and give the same events, apart from the ids (each package mints its
own process-wide sequence): ids keep their relative order, and ``cause_id``
links point at the same positions. Also equal: the taxonomy and its
rejection, the ring's bound and drop counts, the filters, ``chain``,
`merge_events`, the ``cobalt_events_*`` exposition, the shipped segments
(read back by either package's `load_events`, a torn segment skipped, a
failed ship re-shipped, the tail shipped at ``stop``), ``event_id`` on log
lines written inside `event_context` (and only in its thread), the trace
export's journal instants and ``journal_event_count``, and the ``GET
/events`` bodies of both HTTP servers: 200 with filters, 422 for a
component or kind outside the taxonomy or a bad ``since``/``limit``, 404
with no journal. Exact equality throughout: the journal holds no float
arithmetic beyond the injected clock's values.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from cobalt_smart_lender_ai_tpu.config import ServeConfig as JaxServeConfig
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.reliability.faults import FaultInjectingStore as JaxFaultStore
from cobalt_smart_lender_ai_tpu.reliability.faults import FaultSpec as JaxFaultSpec
from cobalt_smart_lender_ai_tpu.serve.http_asyncio import make_async_server as jax_make_server
from cobalt_smart_lender_ai_tpu.serve.service import ScorerService as JaxScorerService
from cobalt_smart_lender_ai_tpu.telemetry import MetricsRegistry as JaxRegistry
from cobalt_smart_lender_ai_tpu.telemetry import events as jax_events
from cobalt_smart_lender_ai_tpu.telemetry.logging import get_logger as jax_get_logger
from cobalt_smart_lender_ai_tpu.telemetry.traceexport import chrome_trace as jax_chrome_trace
from cobalt_smart_lender_ai_tpu.telemetry.tracing import Tracer as JaxTracer
from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.io import ObjectStore
from cobalt_smart_lender_ai_tpu_torch.reliability import FaultInjectingStore, FaultSpec, InjectedFault
from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
from cobalt_smart_lender_ai_tpu_torch.telemetry import MetricsRegistry
from cobalt_smart_lender_ai_tpu_torch.telemetry import events
from cobalt_smart_lender_ai_tpu_torch.telemetry.logging import get_logger
from cobalt_smart_lender_ai_tpu_torch.telemetry.traceexport import chrome_trace
from cobalt_smart_lender_ai_tpu_torch.telemetry.tracing import Tracer

COMMITTED = str(Path(__file__).resolve().parent.parent / "artifacts")
SIDES = {"port": events, "jax": jax_events}


class _Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _journal(mod, capacity: int = 8, **kw):
    clock = _Clock()
    return mod.EventJournal(capacity=capacity, clock=clock, mono=clock, **kw), clock


#: One scripted run: (component, kind, keyword args, seconds to advance
#: after). ``cause_id`` values are indices into the script's returned ids;
#: ``"ctx"`` emits inside `event_context` of that index's id.
SCRIPT = (
    ("reload", "publish", {"model": "models/gbdt/v1", "payload": {"status": "ok"}}, 1.0),
    ("breaker", "open", {"payload": {"from": "closed", "to": "open"},
                         "cause": {"consecutive_failures": 3}}, 0.5),
    ("breaker", "half_open", {"cause_id": 1}, 0.25),
    ("canary", "reject", {"model": "v3", "payload": {"reasons": ["score_delta:0.3>0.25"]},
                          "cause": {"gate": {"eligible": False}}}, 2.0),
    ("canary", "promote", {"model": "v2", "ctx": 0, "cause": {"forced": True}}, 0.0),
    ("canary", "rollback", {"model": "v1", "cause": "slo fast burn", "replica": 0}, 1.5),
    ("reload", "rollback", {"model": "poison", "ctx": 5, "cause": {"error": "boom"}}, 0.0),
    ("breaker", "close", {"cause_id": 2}, 3.0),
    ("chaos", "inject", {"replica": "r1"}, 1.0),
    ("admission", "rescale", {"payload": {"to": 8}}, 0.0),
)


def _run_script(mod, journal, clock, script=SCRIPT) -> list[int]:
    ids: list[int] = []
    for component, kind, kw, dt in script:
        kw = dict(kw)
        if "cause_id" in kw:
            kw["cause_id"] = ids[kw["cause_id"]]
        ctx = kw.pop("ctx", None)
        if ctx is not None:
            with mod.event_context(ids[ctx]):
                ids.append(journal.emit(component, kind, **kw))
        else:
            ids.append(journal.emit(component, kind, **kw))
        clock.advance(dt)
    return ids


def _positional(evs: list[dict], ids: list[int]) -> list[dict]:
    """Events with ids replaced by their position in the script."""
    pos = {eid: i for i, eid in enumerate(ids)}
    out = []
    for e in evs:
        e = dict(e)
        e["event_id"] = pos[e["event_id"]]
        if e.get("cause_id") is not None:
            e["cause_id"] = pos.get(e["cause_id"], "outside")
        out.append(e)
    return out


def _scripted(capacity: int = 16, **kw) -> dict:
    out = {}
    for side, mod in SIDES.items():
        j, clock = _journal(mod, capacity=capacity, **kw)
        out[side] = (j, clock, _run_script(mod, j, clock))
    return out


def test_taxonomy_and_rejection_are_the_references():
    assert events.EVENT_KINDS == jax_events.EVENT_KINDS
    for component, kind in (("supervisor", "no_such_kind"), ("no_such_component", "transition"),
                            ("canary", "publish"), ("reload", "promote")):
        for mod in SIDES.values():
            j, _ = _journal(mod)
            with pytest.raises(ValueError, match=f"unknown event type {component}.{kind}"):
                j.emit(component, kind)
            assert j.stats()["emitted"] == 0


def test_scripted_emits_give_the_references_events():
    runs = _scripted()
    got = {}
    for side, (j, _, ids) in runs.items():
        assert ids == sorted(ids) and len(set(ids)) == len(ids)
        got[side] = _positional(j.events(), ids)
    assert got["port"] == got["jax"]
    # the ambient context stamped the cause, an explicit cause_id won
    assert [e["cause_id"] for e in got["port"]] == [None, None, 1, None, 0, None, 5, 2, None, None]
    stats = {side: j.stats() for side, (j, _, _) in runs.items()}
    for s in stats.values():
        s.pop("last_event_id")
    assert stats["port"] == stats["jax"]


@pytest.mark.parametrize("capacity", [1, 3, 7, 10, 32])
def test_ring_bounds_and_drop_counts_are_the_references(capacity):
    runs = _scripted(capacity=capacity)
    (pj, _, pids), (jj, _, jids) = runs["port"], runs["jax"]
    assert _positional(pj.events(), pids) == _positional(jj.events(), jids)
    for key in ("depth", "capacity", "emitted", "dropped"):
        assert pj.stats()[key] == jj.stats()[key], key
    assert pj.stats()["dropped"] == max(0, len(SCRIPT) - capacity)


FILTERS = (
    {},
    {"component": "breaker"},
    {"kind": "rollback"},
    {"component": "canary", "kind": "promote"},
    {"since": 1003.0},
    {"since_id": 3},
    {"limit": 2},
    {"limit": 0},
    {"component": "reload", "limit": 1},
    {"since": 1001.5, "kind": "half_open"},
)


@pytest.mark.parametrize("query", FILTERS, ids=lambda q: ",".join(f"{k}={v}" for k, v in q.items()) or "all")
def test_filters_are_the_references(query):
    runs = _scripted()
    got = {}
    for side, (j, _, ids) in runs.items():
        q = dict(query)
        if "since_id" in q:
            q["since_id"] = ids[q["since_id"]]
        got[side] = _positional(j.events(**q), ids)
    assert got["port"] == got["jax"]


def test_chain_and_merge_are_the_references():
    runs = _scripted()
    for index in range(len(SCRIPT)):
        got = {side: _positional(j.chain(ids[index]), ids) for side, (j, _, ids) in runs.items()}
        assert got["port"] == got["jax"], index
    assert [e["event_id"] for e in _positional(runs["port"][0].chain(runs["port"][2][7]),
                                               runs["port"][2])] == [1, 2, 7]
    merged = {}
    for side, mod in SIDES.items():
        a, _ = _journal(mod)
        b, _ = _journal(mod)
        ids = [a.emit("chaos", "inject"), b.emit("reload", "publish"), a.emit("breaker", "open"),
               b.emit("canary", "reject")]
        merged[side] = [
            [_positional([e], ids)[0] for e in mod.merge_events([a, b], **q)]
            for q in ({}, {"limit": 1}, {"component": "breaker"}, {"kind": "publish"})
        ]
    assert merged["port"] == merged["jax"]
    assert [e["event_id"] for e in merged["port"][0]] == [0, 1, 2, 3]


def test_events_families_are_the_references():
    text = {}
    for side, (mod, reg) in {"port": (events, MetricsRegistry()),
                             "jax": (jax_events, JaxRegistry())}.items():
        j, clock = _journal(mod, capacity=4, registry=reg)
        _run_script(mod, j, clock)
        text[side] = reg.render()
    assert text["port"] == text["jax"]
    assert 'cobalt_events_total{component="breaker",kind="open"} 1' in text["port"]
    assert "cobalt_events_dropped_total 6" in text["port"]
    assert "cobalt_events_ring_depth 4" in text["port"]


def _stores(tmp_path, **faults) -> dict:
    """A store per package; with ``faults`` (FaultSpec keyword dicts by
    operation), each wrapped in its package's `FaultInjectingStore`."""
    port, jax = ObjectStore(str(tmp_path / "port")), JaxStore(str(tmp_path / "jax"))
    if not faults:
        return {"port": port, "jax": jax}
    return {
        "port": FaultInjectingStore(port, seed=0, faults={k: FaultSpec(**v) for k, v in faults.items()}),
        "jax": JaxFaultStore(jax, seed=0, faults={k: JaxFaultSpec(**v) for k, v in faults.items()}),
    }


def test_shipped_segments_round_trip_across_packages(tmp_path):
    """Ship, wrap the ring past shipped events (not drops), ship again: the
    segments' keys and JSON documents are the reference's (ids aside), and
    each package's `load_events` reads the other's store."""
    stores = _stores(tmp_path)
    shipped = {}
    for side, mod in SIDES.items():
        j, clock = _journal(mod, capacity=4, store=stores[side], ship_interval_s=0)
        ids = [j.emit("chaos", "inject", payload={"n": n}) for n in range(3)]
        key1 = j.ship()
        assert j.ship() is None
        ids += [j.emit("breaker", "open", payload={"n": n}) for n in range(3, 8)]
        assert j.stats()["dropped"] == 1
        key2 = j.ship()
        docs = [stores[side].get_json(k) for k in (key1, key2)]
        for doc in docs:
            doc["events"] = _positional(doc["events"], ids)
            doc["from_id"] = ids.index(doc["from_id"]) if doc["from_id"] else 0
            doc["to_id"] = ids.index(doc["to_id"])
        shipped[side] = (key1, key2, docs, ids, j.stats()["shipping"]["segments"])
    assert shipped["port"][:2] == shipped["jax"][:2] == (
        "telemetry/events/segment-00000001.json", "telemetry/events/segment-00000002.json")
    assert shipped["port"][2] == shipped["jax"][2]
    assert shipped["port"][4] == shipped["jax"][4] == 2
    for reader, mod in SIDES.items():
        for writer in SIDES:
            ids = shipped[writer][3]
            root = tmp_path / writer
            store = ObjectStore(str(root)) if reader == "port" else JaxStore(str(root))
            loaded = mod.load_events(store)
            assert [e["event_id"] for e in loaded] == sorted(set(ids) - {ids[3]}), (reader, writer)


def test_failed_ship_reships_the_same_events(tmp_path):
    stores = _stores(tmp_path, put={"fail_after": 0, "max_faults": 1})
    got = {}
    for side, mod in SIDES.items():
        j, _ = _journal(mod, capacity=8, store=stores[side], ship_interval_s=0)
        ids = [j.emit("reload", "publish", payload={"n": n}) for n in range(2)]
        with pytest.raises(Exception) as exc:
            j.ship()
        assert type(exc.value).__name__ == "InjectedFault"
        assert j.stats()["shipping"]["shipped_until_id"] == 0
        assert j.ship() is not None
        got[side] = _positional(mod.load_events(stores[side]), ids)
    assert got["port"] == got["jax"] and len(got["port"]) == 2
    assert isinstance(InjectedFault("x"), Exception)


def test_torn_segment_is_skipped_as_the_reference_skips_it(tmp_path):
    stores = _stores(tmp_path)
    got = {}
    for side, mod in SIDES.items():
        j, _ = _journal(mod, capacity=8, store=stores[side], ship_interval_s=0)
        j.emit("breaker", "open")
        torn = j.ship()
        j.emit("breaker", "close")
        j.ship()
        stores[side].put_bytes(torn, b'{"schema": 1, "seq": 1, "events": [')
        got[side] = [e["kind"] for e in mod.load_events(stores[side])]
    assert got["port"] == got["jax"] == ["close"]


def test_stop_ships_the_tail(tmp_path):
    stores = _stores(tmp_path)
    got = {}
    for side, mod in SIDES.items():
        j, _ = _journal(mod, capacity=8, store=stores[side], ship_interval_s=3600.0)
        j.start()
        j.emit("reload", "publish", payload={"status": "ok"})  # shipped at once: the first
        j.emit("reload", "rollback", cause={"error": "boom"})  # inside the interval
        assert [e["kind"] for e in mod.load_events(stores[side])] == ["publish"]
        j.stop()
        got[side] = [(e["component"], e["kind"], e["cause"]) for e in mod.load_events(stores[side])]
    assert got["port"] == got["jax"] == [("reload", "publish", None),
                                         ("reload", "rollback", {"error": "boom"})]


def _log_lines(caplog, logger, mod) -> list[dict]:
    seen = []

    def other_thread():
        logger.info("other_thread")

    with caplog.at_level(logging.INFO, logger=logger.stdlib.name):
        caplog.clear()
        with mod.event_context(77):
            logger.info("inside_context")
            t = threading.Thread(target=other_thread)
            t.start()
            t.join()
            logger.info("explicit", event_id=5)
        logger.info("outside_context")
        for rec in caplog.records:
            line = json.loads(rec.getMessage())
            seen.append({k: line.get(k) for k in ("event", "event_id")})
    return seen


def test_log_lines_carry_the_event_id_as_the_references_do(caplog):
    port = _log_lines(caplog, get_logger("test.torch_events"), events)
    ref = _log_lines(caplog, jax_get_logger("test.torch_events_ref"), jax_events)
    assert sorted(port, key=str) == sorted(ref, key=str)
    by_event = {line["event"]: line["event_id"] for line in port}
    # contextvars do not cross threads: the other thread's line has none
    assert by_event == {"inside_context": 77, "other_thread": None, "explicit": 5,
                        "outside_context": None}


def _instants(doc: dict) -> list[dict]:
    out = []
    for e in doc["traceEvents"]:
        if e.get("cat") == "event":
            e = dict(e)
            e.pop("pid")
            out.append(e)
    return out


def test_trace_export_journal_instants_are_the_references():
    docs = {}
    for side, (mod, export, tracer) in {"port": (events, chrome_trace, Tracer()),
                                        "jax": (jax_events, jax_chrome_trace, JaxTracer())}.items():
        j, clock = _journal(mod, capacity=16)
        ids = _run_script(mod, j, clock)
        doc = export(tracer, counters={}, journal=j)
        json.dumps(doc)
        for e in doc["traceEvents"]:
            args = e.get("args", {})
            args["event_id"] = ids.index(args["event_id"])
            if args.get("cause_id") is not None:
                args["cause_id"] = ids.index(args["cause_id"])
        docs[side] = (_instants(doc), doc["otherData"]["journal_event_count"])
        assert export(tracer, counters={})["otherData"]["journal_event_count"] == 0
    assert docs["port"] == docs["jax"]
    assert docs["port"][1] == len(SCRIPT)
    assert {e["ph"] for e in docs["port"][0]} == {"i"}


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


EVENTS_QUERIES = (
    "",
    "?component=breaker",
    "?kind=rollback",
    "?component=canary&kind=promote",
    "?since=1003",
    "?limit=2",
    "?component=nope",
    "?kind=nope",
    "?component=canary&kind=open",
    "?since=abc",
    "?since=inf",
    "?limit=0",
    "?limit=1001",
    "?limit=x",
)


def test_events_route_answers_as_the_references():
    """Both servers on the committed model, their journals fed the same
    script on the same clock: each query's status and body (ids aside) is
    the reference's; with no journal both answer 404."""
    clock = _Clock()
    services = {
        "port": ScorerService.from_store(
            ObjectStore(COMMITTED), ServeConfig(microbatch_enabled=False, score_cache_size=0),
            device="cpu"),
        "jax": JaxScorerService.from_store(
            JaxStore(COMMITTED),
            JaxServeConfig(precompile_batch_buckets=(), prewarm_all_buckets=False,
                           microbatch_enabled=False, score_cache_size=0)),
    }
    servers = {"port": make_async_server(services["port"], "127.0.0.1", 0),
               "jax": jax_make_server(services["jax"], "127.0.0.1", 0)}
    answers = {}
    try:
        for side, svc in services.items():
            mod = SIDES[side]
            clock.t = 1000.0
            j = mod.EventJournal(capacity=16, clock=clock, mono=clock)
            svc.journal = j
            ids = _run_script(mod, j, clock)
            base = f"http://127.0.0.1:{servers[side].port}"
            out = []
            for q in EVENTS_QUERIES:
                status, body = _get(base + "/events" + q)
                if status == 200:
                    body["events"] = _positional(body["events"], ids)
                    body["stats"].pop("last_event_id")
                out.append((status, body))
            svc.journal = None
            out.append(_get(base + "/events"))
            svc.journal = j
            answers[side] = out
    finally:
        for server in servers.values():
            server.close()
        for svc in services.values():
            svc.close()
    assert answers["port"] == answers["jax"]
    statuses = [status for status, _ in answers["port"]]
    assert statuses == [200] * 6 + [422] * 8 + [404]
    assert answers["port"][1][1]["count"] == 3
    assert answers["port"][6][1]["error"] == "invalid_input"
    assert answers["port"][-1][1] == {"detail": "events disabled", "error": "events_disabled"}
