"""The port's request-path hardening against the JAX package's.

The same scripted sequences, on fake clocks (time passes only when a script
advances it), go through the port's `reliability` modules and the
reference's, and give the same decisions:

- admission (`TokenBucket`, `AdmissionController`): every admit or shed, its
  ``Retry-After`` value, header and body, and the counters;
- the circuit breaker: every call's outcome, the state after it, the walk
  of ``transitions`` and the counters;
- `FaultInjectingStore` with one seed: faults, corruptions and delays on the
  same calls, with the same counters.

Over HTTP, both services answer a shed request 429 with the same body and
``Retry-After``, on the in-flight cap and on the rate gate.

The micro-batcher's watchdog (the port's repair): a worker killed by a
`BaseException` fails its batch and every queued request with a typed 500
``worker_dead`` and restarts; ``ensure_worker`` revives a dead thread. A log
line written inside `predict_raw` carries a minted ``request_id``, and the
serve CLI's ``--no-microbatch``, ``--score-cache-size`` and
``--flight-slow-ms`` reach `ServeConfig` with the reference's defaults. A
deterministic chaos soak (a fixed number of requests per thread while an
operator reloads good and poisoned artifacts through a faulting store)
answers no untyped 500 and no 429 without ``Retry-After``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import cobalt_smart_lender_ai_tpu.reliability as jax_rel
from cobalt_smart_lender_ai_tpu.config import ReliabilityConfig as JaxReliabilityConfig
from cobalt_smart_lender_ai_tpu.config import ServeConfig as JaxServeConfig
from cobalt_smart_lender_ai_tpu.data import schema as jax_schema
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.models.gbdt import GBDTClassifier as JaxClassifier
from cobalt_smart_lender_ai_tpu.serve.http_asyncio import make_async_server as jax_make_server
from cobalt_smart_lender_ai_tpu.serve.service import ScorerService as JaxScorerService
import cobalt_smart_lender_ai_tpu_torch.reliability as port_rel
from cobalt_smart_lender_ai_tpu_torch.config import ReliabilityConfig, ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.data.features import FeaturePlan
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.serve import __main__ as cli
from cobalt_smart_lender_ai_tpu_torch.serve import service as service_mod
from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
from cobalt_smart_lender_ai_tpu_torch.telemetry import get_logger

KEY = "models/gbdt/model_tree"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ManualClock:
    """Time passes only when the test says so."""

    def __init__(self, start: float = 0.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, s: float) -> None:
        self.now += s


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """A small forest trained by the JAX package on the 20 serving features,
    saved by its artifact writer; both services restore it."""
    rng = np.random.default_rng(31)
    F = len(jax_schema.SERVING_FEATURES)
    X = rng.normal(size=(1024, F)).astype(np.float32)
    X[:, 12:] = rng.integers(0, 2, size=(1024, F - 12))
    y = X[:, 0] - 0.6 * X[:, 2] + 0.4 * X[:, 13] + 0.3 * rng.normal(size=1024) > 0
    model = JaxClassifier(n_estimators=8, max_depth=3, n_bins=32)
    model.fit(X, y.astype(np.int32))
    root = tmp_path_factory.mktemp("torch_hardening") / "lake"
    JaxArtifact(
        forest=model.forest, bin_spec=model.bin_spec, feature_names=tuple(jax_schema.SERVING_FEATURES)
    ).save(JaxStore(str(root)), KEY)
    return str(root)


def _payload(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    alias = {v: k for k, v in schema.SERVING_FIELD_ALIASES.items()}
    return {
        alias.get(n, n): int(rng.integers(0, 2)) if n in schema.SERVING_INT_FEATURES
        else float(np.round(rng.normal(), 3))
        for n in schema.SERVING_FEATURES
    }


def _request(url: str, data: bytes | None = None, content_type: str = "application/json"):
    """(status, JSON body, headers) of one GET (no data) or POST."""
    req = urllib.request.Request(url, data=data)
    if data is not None:
        req.add_header("Content-Type", content_type)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


@contextlib.contextmanager
def _serving(service, make_server):
    server = make_server(service, "127.0.0.1", 0)
    try:
        yield f"http://127.0.0.1:{server.port}"
    finally:
        server.close()
        service.close()


def _port_service(root: str, clock=None, **rel) -> ScorerService:
    """The port's service on the CPU with these reliability limits; the
    cache is off so every request reaches admission and scoring."""
    cfg = ServeConfig(score_cache_size=0, reliability=ReliabilityConfig(**rel))
    kw = {} if clock is None else {"clock": clock}
    return ScorerService.from_store(ObjectStore(root), cfg, device="cpu", **kw)


def _ref_service(root: str, clock=None, **rel) -> JaxScorerService:
    """The JAX package's service with the same limits."""
    cfg = JaxServeConfig(
        precompile_batch_buckets=(),
        prewarm_all_buckets=False,
        score_cache_size=0,
        reliability=JaxReliabilityConfig(**rel),
    )
    kw = {} if clock is None else {"clock": clock}
    return JaxScorerService.from_store(JaxStore(root), cfg, **kw)


SIDES = {"port": (_port_service, make_async_server), "ref": (_ref_service, jax_make_server)}


# -- admission: the same scripted sequences, the same decisions -----------------------


def _attempt(adm, mod, held: list) -> tuple:
    """One admission attempt, held open on success."""
    cm = adm.admit()
    try:
        cm.__enter__()
    except mod.RequestShed as e:
        return ("shed", e.status, e.code, e.retry_after_s, e.headers(), e.body())
    held.append(cm)
    return ("admitted",)


def _release(held: list) -> None:
    held.pop(0).__exit__(None, None, None)


def _admission_script(name: str, mod) -> list:
    clk = ManualClock()
    out: list = []
    held: list = []
    if name == "token_bucket":
        tb = mod.TokenBucket(rate_rps=2.0, burst=2, clock=clk)
        out += [tb.try_acquire(), tb.try_acquire(), tb.try_acquire(), tb.retry_after_s()]
        clk.advance(0.5)
        out += [tb.try_acquire(), tb.retry_after_s(2.0)]
        clk.advance(100.0)
        out += [tb.try_acquire(), tb.try_acquire(), tb.try_acquire()]
        tb.resize(4.0, 3)
        clk.advance(0.3)
        out += [tb.try_acquire(), tb.retry_after_s(), tb._tokens]
    elif name == "rate_shed":
        adm = mod.AdmissionController(rate_rps=1.0, burst=1, clock=clk)
        for step in (0.0, 0.0, 0.25, 0.75, 0.0, 1.7):
            clk.advance(step)
            out.append(_attempt(adm, mod, held))
            if held:
                _release(held)
        out.append(adm.stats())
    elif name == "capacity_shed":
        adm = mod.AdmissionController(max_in_flight=2, shed_retry_after_s=3.0, clock=clk)
        out += [_attempt(adm, mod, held) for _ in range(3)]
        out.append(adm.stats())
        _release(held)
        out += [_attempt(adm, mod, held), _attempt(adm, mod, held)]
        while held:
            _release(held)
        out.append(adm.stats())
    elif name == "both_gates":
        adm = mod.AdmissionController(
            rate_rps=2.0, burst=3, max_in_flight=2, shed_retry_after_s=0.4, clock=clk
        )
        for i in range(10):
            clk.advance(0.2)
            out.append(_attempt(adm, mod, held))
            if i % 3 == 2 and held:
                _release(held)
        out.append(adm.stats())
        out.append(adm.rescale(3))
        out += [_attempt(adm, mod, held) for _ in range(3)]
        out.append(adm.stats())
    return out


@pytest.mark.parametrize("script", ["token_bucket", "rate_shed", "capacity_shed", "both_gates"])
def test_admission_decisions_match_the_reference(script):
    port = _admission_script(script, port_rel)
    ref = _admission_script(script, jax_rel)
    assert port == ref
    assert any(o[0] == "shed" for o in port if isinstance(o, tuple)) or script == "token_bucket"


# -- the circuit breaker ---------------------------------------------------------------


def _breaker_script(name: str, mod) -> dict:
    clk = ManualClock()
    seen: list = []
    threshold, reset = {"trip": (3, 10.0), "streak": (3, 30.0), "probe": (1, 5.0),
                        "probe_limit": (1, 1.0)}[name]
    brk = mod.CircuitBreaker(failure_threshold=threshold, reset_timeout_s=reset, clock=clk)
    brk.on_transition = lambda old, new: seen.append((old, new))
    trace: list = []

    def boom():
        raise mod.InjectedFault("store down")

    def call(fn, advance: float = 0.0):
        clk.advance(advance)
        try:
            trace.append(("ok", brk.call(fn)))
        except mod.CircuitOpenError as e:
            trace.append(("open", e.status, e.code, e.retry_after_s, e.headers(), e.body()))
        except mod.InjectedFault as e:
            trace.append(("fault", str(e)))
        trace.append(brk.state)

    if name == "trip":
        for _ in range(3):
            call(boom)
        call(lambda: "never", 4.0)
        call(lambda: "probe", 6.0)
    elif name == "streak":
        for fn in (boom, boom, lambda: "ok", boom, boom, boom, lambda: "never"):
            call(fn, 1.0)
    elif name == "probe":
        call(boom)
        call(boom, 5.0)
        call(lambda: "still open", 4.9)
        call(lambda: "up", 0.1)
    elif name == "probe_limit":
        call(boom)

        def probe():
            call(lambda: "second")  # rejected while the first probe flies
            return "first"

        call(probe, 1.0)
    return {
        "trace": trace,
        "transitions": brk.transitions,
        "observed": seen,
        "fast_failures": brk.fast_failures,
        "opened_count": brk.opened_count,
        "consecutive_failures": brk.consecutive_failures,
    }


@pytest.mark.parametrize("script", ["trip", "streak", "probe", "probe_limit"])
def test_breaker_walks_match_the_reference(script):
    port = _breaker_script(script, port_rel)
    assert port == _breaker_script(script, jax_rel)
    assert port["transitions"]


# -- fault injection -------------------------------------------------------------------


def _fault_script(name: str, mod, store_cls, root) -> dict:
    inner = store_cls(str(root))
    for i in range(4):
        inner.put_bytes(f"k{i}", bytes([i + 1]) * 8)
    slept: list = []
    specs = {
        "rate": {"put": mod.FaultSpec(rate=0.5)},
        "fail_after_budget": {"exists": mod.FaultSpec(fail_after=2, max_faults=3)},
        "corrupt": {"get": mod.FaultSpec(corrupt_rate=0.5)},
        "mixed": {
            "get": mod.FaultSpec(rate=0.3, corrupt_rate=0.3, delay_s=0.002, delay_jitter_s=0.004),
            "list": mod.FaultSpec(fail_after=1),
        },
    }[name]
    store = mod.FaultInjectingStore(inner, seed=7, faults=specs, sleep=slept.append)
    outcomes = []
    ops = {
        "rate": lambda i: store.put_bytes(f"p{i}", b"v"),
        "fail_after_budget": lambda i: store.exists("k0"),
        "corrupt": lambda i: store.get_bytes(f"k{i % 4}"),
        "mixed": lambda i: store.get_bytes(f"k{i % 4}") if i % 5 else sorted(store.list("k")),
    }[name]
    for i in range(30):
        try:
            outcomes.append(("ok", ops(i)))
        except mod.InjectedFault as e:
            outcomes.append(("fault", str(e)))
    return {
        "outcomes": outcomes,
        "slept": slept,
        "calls": dict(store.calls),
        "injected": dict(store.injected),
        "delays": dict(store.delays),
        "delayed_s": store.delayed_s,
    }


@pytest.mark.parametrize("script", ["rate", "fail_after_budget", "corrupt", "mixed"])
def test_fault_store_injects_on_the_references_calls(tmp_path, script):
    port = _fault_script(script, port_rel, ObjectStore, tmp_path / "port")
    ref = _fault_script(script, jax_rel, JaxStore, tmp_path / "ref")
    assert port == ref
    assert sum(port["injected"].values()) > 0


# -- 429 over HTTP ------------------------------------------------------------------


def test_capacity_shed_is_the_references_429(store_root):
    """The only slot held: both servers answer /predict 429 ``shed`` with
    the same body and ``Retry-After``; released, the same request scores."""
    body = json.dumps(_payload(1)).encode()
    answers = {}
    for side, (build, make) in SIDES.items():
        svc = build(store_root, max_in_flight=1, shed_retry_after_s=2.5)
        with _serving(svc, make) as url:
            slot = svc.admission.admit()
            slot.__enter__()
            try:
                shed = _request(url + "/predict", body)
                bulk = _request(url + "/feature_importance_bulk", b'{"data": [1]}')
            finally:
                slot.__exit__(None, None, None)
            ok = _request(url + "/predict", body)
            ready = _request(url + "/readyz")[1]
        answers[side] = (shed, bulk, ok, ready["admission"])
    for side in ("port", "ref"):
        (status, resp, headers), bulk, ok, adm = answers[side]
        assert status == 429 and headers["Retry-After"] == "3", side
        assert bulk[0] == 429 and bulk[2]["Retry-After"] == "3", side
        assert ok[0] == 200, side
    (p_shed, p_bulk, p_ok, p_adm), (r_shed, r_bulk, r_ok, r_adm) = answers["port"], answers["ref"]
    assert p_shed[1] == r_shed[1] == {
        "detail": "server at capacity (1 requests in flight)", "error": "shed"
    }
    assert p_bulk[1] == r_bulk[1]
    assert abs(p_ok[1]["prob_default"] - r_ok[1]["prob_default"]) <= 1e-6
    assert p_adm == r_adm and p_adm["shed_capacity"] == 2


def test_rate_shed_is_the_references_429(store_root):
    """On a fake clock, a burst of 2 at 1 request/s: the third request is
    shed with ``Retry-After: 1`` by both, and admitted once a second has
    passed."""
    answers = {}
    for side, (build, make) in SIDES.items():
        clk = ManualClock(100.0)
        svc = build(store_root, clock=clk, rate_limit_rps=1.0, rate_limit_burst=2)
        statuses = []
        with _serving(svc, make) as url:
            for i, step in enumerate((0.0, 0.0, 0.0, 0.5, 0.5, 0.0)):
                clk.advance(step)
                status, resp, headers = _request(url + "/predict", json.dumps(_payload(i)).encode())
                statuses.append((status, resp.get("error"), headers.get("Retry-After")))
            ready = _request(url + "/readyz")[1]
        answers[side] = (statuses, ready["admission"])
    assert answers["port"] == answers["ref"]
    statuses, adm = answers["port"]
    assert [s[0] for s in statuses] == [200, 200, 429, 429, 200, 429]
    assert statuses[2] == (429, "shed", "1") and adm["shed_rate"] == 3


# -- the watchdog ------------------------------------------------------------------


class _Killed(BaseException):
    """Kills the micro-batch worker: not an `Exception`, so the per-batch
    containment does not catch it."""


def _kill_next_batch(batcher) -> list:
    """Make the worker die once, before its next launch; returns the sizes
    of the batches it died holding."""
    real = batcher._dispatch
    died: list = []

    def dispatch(batch):
        if not died:
            died.append(len(batch))
            raise _Killed("worker killed before the launch")
        return real(batch)

    batcher._dispatch = dispatch
    return died


def test_worker_death_resolves_futures_typed_and_restarts(store_root):
    """A killed worker fails every request of its batch with the typed 500
    ``worker_dead`` (none left hanging), counts one restart, and the
    replacement scores the next request."""
    svc = ScorerService.from_store(
        ObjectStore(store_root), ServeConfig(microbatch_max_wait_ms=1.0), device="cpu"
    )
    try:
        died = _kill_next_batch(svc.batcher)
        row = {name: 0.0 for name in svc.feature_names}
        with svc.batcher.pause():  # three rows into the doomed batch
            futs = [svc.batcher.submit(row, None) for _ in range(3)]
        for fut in futs:
            with pytest.raises(port_rel.WorkerDead) as ei:
                fut.result(timeout=10.0)
            assert ei.value.status == 500
            assert ei.value.body()["error"] == "worker_dead"
            assert "_Killed" in ei.value.detail
        assert died == [3]
        deadline = time.monotonic() + 10.0
        while not svc.batcher.worker_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        stats = svc.batcher.stats()
        assert stats["worker_alive"] is True and stats["worker_restarts"] == 1
        resp = svc.predict_single(_payload(2))
        assert 0.0 <= resp["prob_default"] <= 1.0
        ok, ready = svc.ready()
        assert ok and ready["microbatch"]["worker_restarts"] == 1
        fams = {f.name: f for f in svc.registry.families()}
        assert fams["cobalt_microbatch_worker_restarts_total"].value == 1
        assert fams["cobalt_microbatch_worker_dead_total"].value == 3
    finally:
        svc.close()


def test_worker_death_answers_typed_500s_over_http(store_root):
    """Over HTTP the stranded requests answer 500 with the typed body, then
    the service serves again: no request waits out its deadline."""
    svc = ScorerService.from_store(
        ObjectStore(store_root), ServeConfig(score_cache_size=0), device="cpu"
    )
    _kill_next_batch(svc.batcher)
    with _serving(svc, make_async_server) as url:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=4) as pool:
            with svc.batcher.pause():
                futs = [pool.submit(_request, url + "/predict", json.dumps(_payload(10 + i)).encode())
                        for i in range(4)]
                while svc.batcher.queue_depth() < 4:
                    time.sleep(0.005)
            answers = [f.result(timeout=30) for f in futs]
        after = _request(url + "/predict", json.dumps(_payload(20)).encode())
        ready = _request(url + "/readyz")[1]
    assert [a[0] for a in answers] == [500] * 4
    assert all(a[1]["error"] == "worker_dead" for a in answers)
    assert after[0] == 200 and ready["microbatch"]["worker_restarts"] == 1


def test_ensure_worker_revives_a_dead_thread(store_root):
    svc = ScorerService.from_store(
        ObjectStore(store_root), ServeConfig(microbatch_max_wait_ms=1.0), device="cpu"
    )
    try:
        assert svc.batcher.ensure_worker() is False  # alive: nothing to do
        dead = threading.Thread(target=lambda: None)
        dead.start()
        dead.join()
        svc.batcher._thread = dead
        assert svc.batcher.worker_alive() is False
        assert svc.batcher.ensure_worker() is True
        assert svc.batcher.worker_alive() is True
        assert 0.0 <= svc.predict_single(_payload(3))["prob_default"] <= 1.0
        assert svc.batcher.stats()["worker_restarts"] == 1
    finally:
        svc.close()


def test_submit_to_a_dead_worker_restarts_it(store_root):
    """`submit` checks the worker first: the request queued behind a dead
    thread fails typed, and the new one is scored by the replacement."""
    svc = ScorerService.from_store(
        ObjectStore(store_root), ServeConfig(microbatch_max_wait_ms=1.0), device="cpu"
    )
    try:
        row = {name: 0.0 for name in svc.feature_names}
        dead = threading.Thread(target=lambda: None)
        dead.start()
        dead.join()
        with svc.batcher.pause():
            stranded = svc.batcher.submit(row, None)
            svc.batcher._thread = dead
            fresh = svc.batcher.submit(row, None)
        with pytest.raises(port_rel.WorkerDead):
            stranded.result(timeout=10.0)
        assert 0.0 <= fresh.result(timeout=10.0)[0] <= 1.0
    finally:
        svc.close()


# -- predict_raw's request id ------------------------------------------------------------


def test_predict_raw_logs_under_a_minted_request_id(store_root, monkeypatch, caplog):
    """An in-process `predict_raw` call mints a request id: a log line written
    inside it carries one, as the reference's does."""
    art = GBDTArtifact.load(ObjectStore(store_root), KEY, "cpu")
    art.plan = FeaturePlan(
        numeric_names=(), categorical_vocab={}, label_vocab={}, medians={}, log_cols=(),
        tree_feature_names=tuple(art.feature_names), nn_feature_names=(),
    )
    svc = ScorerService(art, ServeConfig(microbatch_enabled=False), device="cpu")
    log = get_logger("cobalt.test.raw")

    def transform(plan, rows, **kw):
        log.info("raw_row_transformed", rows=len(rows))
        return torch.zeros((len(rows), len(plan.tree_feature_names)))

    monkeypatch.setattr(service_mod, "transform_raw_rows", transform)
    with caplog.at_level(logging.INFO, logger="cobalt.test.raw"):
        resp = svc.predict_raw({"loan_amnt": 1000.0})
    records = [json.loads(r.getMessage()) for r in caplog.records if r.name == "cobalt.test.raw"]
    assert len(records) == 1 and records[0].get("request_id")
    assert 0.0 <= resp["prob_default"] <= 1.0


# -- the CLI -------------------------------------------------------------------------


def test_cli_flags_reach_the_serve_config(store_root):
    defaults = cli.parse_args(["--store", store_root])
    assert (defaults.no_microbatch, defaults.score_cache_size, defaults.flight_slow_ms) == (
        False,
        JaxServeConfig.score_cache_size,
        JaxServeConfig.flight_slow_threshold_ms,
    )
    args = cli.parse_args([
        "--store", store_root, "--model-key", KEY, "--device", "cpu", "--no-microbatch",
        "--score-cache-size", "7", "--flight-slow-ms", "12.5",
    ])
    svc = cli.build_service(args)
    try:
        cfg = svc.config
        assert (cfg.microbatch_enabled, cfg.score_cache_size, cfg.flight_slow_threshold_ms) == (
            False, 7, 12.5
        )
        assert svc.batcher is None and svc.flight.slow_threshold_s == 0.0125
    finally:
        svc.close()


def test_reliability_defaults_are_the_references():
    port, ref = ReliabilityConfig(), JaxReliabilityConfig()
    for field in ("rate_limit_rps", "rate_limit_burst", "max_in_flight", "shed_retry_after_s",
                  "breaker_failure_threshold", "breaker_reset_s", "breaker_half_open_max"):
        assert getattr(port, field) == getattr(ref, field), field
    assert ServeConfig().score_cache_size == JaxServeConfig().score_cache_size == 2048
    assert ServeConfig().reliability == port


# -- a deterministic chaos soak ---------------------------------------------------------


def test_chaos_soak_answers_only_typed_errors(store_root, tmp_path):
    """Six client threads send a fixed cycle of valid and invalid requests
    (60 each) while an operator reloads a zeroed model, a poisoned artifact
    and the original through a store that drops 40% of reads: every answer
    is in the taxonomy, every 500 is typed, every 429 carries
    ``Retry-After``; at least one reload swaps and one rolls back; then, the
    faults off, the breaker walks open -> half_open -> closed and the
    service scores."""
    src = JaxStore(store_root)
    root = str(tmp_path / "lake")
    art = JaxArtifact.load(src, KEY)
    art.save(JaxStore(root), KEY)
    zero = dataclasses.replace(
        art, forest=dataclasses.replace(art.forest, leaf_value=art.forest.leaf_value * 0.0)
    )
    zero.save(JaxStore(root), "models/gbdt/v2")
    inner = ObjectStore(root)
    inner.put_bytes("models/poison.npz", b"\x00poisoned artifact bytes")
    flaky = port_rel.FaultInjectingStore(inner, seed=11, faults={})
    cfg = ServeConfig(
        max_bulk_rows=64,
        reliability=ReliabilityConfig(
            request_deadline_s=10.0, max_in_flight=4, breaker_failure_threshold=3,
            breaker_reset_s=0.2,
        ),
    )
    svc = ScorerService.from_store(flaky, cfg, device="cpu")
    flaky.faults["get"] = port_rel.FaultSpec(rate=0.4)
    names = list(schema.SERVING_FEATURES)
    csv8 = ("\n".join([",".join(f'"{n}"' for n in names)] + [",".join(["1.0"] * 20)] * 8)).encode()
    csv100 = ("\n".join([",".join(f'"{n}"' for n in names)] + [",".join(["1.0"] * 20)] * 100)).encode()
    cycle = [
        ("/predict", None, "application/json"),
        ("/predict", b"{}", "application/json"),  # 422
        ("/predict_bulk_csv", csv8, "text/csv"),
        ("/predict_bulk_csv", csv100, "text/csv"),  # 413
        ("/feature_importance_bulk", b'{"data": [{"a": 1}]}', "application/json"),
        ("/feature_importance_bulk", b'{"data": []}', "application/json"),  # 400
        ("/readyz", None, ""),
    ]
    results: list = []
    lock = threading.Lock()

    def client(t: int) -> None:
        for i in range(60):
            path, data, ct = cycle[(t + i) % len(cycle)]
            if path == "/predict" and data is None:
                data = json.dumps(_payload(1000 * t + i)).encode()
            got = _request(base + path, data, ct)
            with lock:
                results.append((path, *got))

    with _serving(svc, make_async_server) as base:
        threads = [threading.Thread(target=client, args=(t,), daemon=True) for t in range(6)]
        for t in threads:
            t.start()
        reloads = []
        for key in ["models/gbdt/v2", "models/poison", KEY] * 4:
            status, body, _ = _request(base + "/admin/reload", json.dumps({"model_key": key}).encode())
            reloads.append((status, body.get("error"), body.get("status")))
            if status == 503:
                time.sleep(0.25)
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        # Every slot held: the next request is shed with Retry-After.
        slots = [svc.admission.admit() for _ in range(4)]
        for cm in slots:
            cm.__enter__()
        shed = _request(base + "/predict", json.dumps(_payload(1)).encode())
        for cm in slots:
            cm.__exit__(None, None, None)
        # Faults off: reload until the breaker has closed and a swap succeeds.
        del flaky.faults["get"]
        for _ in range(50):
            status, body, _ = _request(base + "/admin/reload", json.dumps({"model_key": KEY}).encode())
            if status == 200 and svc.store_breaker.state == "closed":
                break
            time.sleep(0.05)
        # A forced outage: open -> 503 -> half_open -> closed.
        flaky.faults["get"] = port_rel.FaultSpec(fail_after=0)
        mark = len(svc.store_breaker.transitions)
        outage = [_request(base + "/admin/reload", b"{}") for _ in range(4)]
        time.sleep(0.25)
        del flaky.faults["get"]
        healed = _request(base + "/admin/reload", b"{}")
        final = _request(base + "/predict", json.dumps(_payload(2)).encode())
    assert len(results) == 360
    allowed = {200, 400, 413, 422, 429, 500, 503, 504}
    for path, status, body, headers in results:
        assert status in allowed, (path, status, body)
        if status >= 500:
            assert "error" in body, (path, body)
        if status == 429:
            assert "Retry-After" in headers and body["error"] == "shed", (path, headers)
    assert {200, 413, 422} <= {r[1] for r in results}
    assert (200, None, "ok") in reloads and (500, "reload_failed", "rolled_back") in reloads
    assert shed[0] == 429 and int(shed[2]["Retry-After"]) >= 1
    assert [o[0] for o in outage] == [500, 500, 500, 503]
    assert outage[3][1]["error"] == "circuit_open" and "Retry-After" in outage[3][2]
    assert healed[0] == 200 and svc.store_breaker.transitions[mark:] == [
        "open", "half_open", "closed"
    ]
    assert final[0] == 200 and 0.0 <= final[1]["prob_default"] <= 1.0
