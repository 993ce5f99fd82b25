"""The port's ``telemetry.trend`` and ``tools.perf_sentinel`` against the
reference's ``telemetry/trend.py`` and ``tools/perf_sentinel.py``.

- `extract_metrics` over every committed ``BENCH_*.json``, a JAX run
  ledger and the reference tests' shapes equals the JAX `extract_metrics`;
  over a run ledger of the port it gives the ``ledger.<kind>.*`` metrics
  (``warm_dispatch_seconds`` once its measured families hold seconds).
- `policy_for` of every metric name met, `check` of the committed
  ``TREND.json`` and of trend documents built to pass, regress, lack a
  baseline or be empty, and `render_trend_html` of those documents, equal
  the reference's; the constants are the reference's.
- The port's ``perf_sentinel`` exits as the reference's, step for step, on
  the same files in ``tmp_path`` (ingest, check, ``--strict-missing``,
  render), and the trend files the two write are equal. Its ``--trend``
  defaults to ``TREND_torch.json``; run as a module it imports no torch.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import perf_sentinel as ref_sentinel  # noqa: E402  (the reference's CLI)

from cobalt_smart_lender_ai_tpu.telemetry import RunLedger as JaxRunLedger  # noqa: E402
from cobalt_smart_lender_ai_tpu.telemetry import trend as ref_trend  # noqa: E402
from cobalt_smart_lender_ai_tpu_torch.telemetry import MetricsRegistry, RunLedger, trend  # noqa: E402
from cobalt_smart_lender_ai_tpu_torch.tools import perf_sentinel  # noqa: E402

BENCH_FILES = sorted(ROOT.glob("BENCH_*.json"))
SHAPES = [
    {"metric": "rows_per_sec_per_chip", "value": 123.0},
    {"cmd": "x", "rc": 1, "parsed": None},
    {"bench": "serve_throughput", "clients": 4, "results": {"batcher_on": {"qps": 100.0, "p99.9_ms": 9.0}}},
    {"bench": "search_halving_vs_exhaustive", "compile": {"cache_misses": 4},
     "runs": {"halving": {"dispatch_seconds": 2.5}}},
    {"bench": "serve_traffic", "traffic": {"shape": "flash"}, "load": {"qps": 9.0, "errors": 0}},
    {"bench": "score_kernels", "results": {"f32": {"64": {"fused": {"dispatch_seconds": 1e-4}}}}},
    {"totally": "unknown"},
    [1, 2],
]


def test_constants_are_the_references():
    assert trend.TREND_SCHEMA == ref_trend.TREND_SCHEMA == 1
    assert trend.BASELINE_WINDOW == ref_trend.BASELINE_WINDOW == 5
    assert trend.__all__ == ref_trend.__all__
    assert perf_sentinel.EXIT_REGRESSION == 1 and perf_sentinel.EXIT_MISSING_BASELINE == 3


@pytest.mark.parametrize("path", BENCH_FILES, ids=lambda p: p.name)
def test_extract_metrics_of_committed_bench_records(path):
    record = json.loads(path.read_text())
    got = trend.extract_metrics(record)
    assert got == ref_trend.extract_metrics(record)
    for name in got:
        assert trend.policy_for(name) == ref_trend.policy_for(name)


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_extract_metrics_of_known_shapes(i):
    assert trend.extract_metrics(SHAPES[i]) == ref_trend.extract_metrics(SHAPES[i])


def test_extract_metrics_of_run_ledgers():
    jax_doc = JaxRunLedger("pipeline", meta={"rows": 10}).finalize()
    assert trend.extract_metrics(jax_doc) == ref_trend.extract_metrics(jax_doc)
    assert "ledger.pipeline.wall_seconds" in trend.extract_metrics(jax_doc)
    doc = RunLedger("parity").finalize(registry=MetricsRegistry())  # nothing measured yet
    assert doc["dispatch_attribution"]["measured_seconds"] == 0.0
    assert "ledger.parity.warm_dispatch_seconds" not in trend.extract_metrics(doc)
    doc["dispatch_attribution"]["measured_seconds"] = 0.25  # as a run that dispatched
    got = trend.extract_metrics(doc)
    assert got == ref_trend.extract_metrics(doc)
    assert got["ledger.parity.warm_dispatch_seconds"] == 0.25
    assert {"ledger.parity.wall_seconds", "ledger.parity.compile_cache_misses"} <= set(got)
    assert trend.policy_for("ledger.parity.warm_dispatch_seconds")["limit"] == 1.25


def _trend_with(lib, rows):
    doc = lib.new_trend()
    for metrics in rows:
        lib.append_row(doc, source="test", metrics=metrics)
    return doc


DOCS = {
    "pass": [{"serve.b.qps": v} for v in (100, 90, 110, 95, 105, 71.0)],
    "regression": [{"serve.b.qps": v, "x.p999_ms": 5.0} for v in (100, 90, 110, 95, 105, 69.0)],
    "slack": [{"s.cache_misses": v} for v in (3, 3, 4, 7)],
    "missing": [{"serve.b.qps": 10.0}],
    "tracked": [{"cv_auc": 0.9}, {"cv_auc": 0.1}],
    "empty": [],
}


@pytest.mark.parametrize("name", DOCS)
def test_check_and_render_are_the_references(name):
    ours, ref = _trend_with(trend, DOCS[name]), _trend_with(ref_trend, DOCS[name])
    assert ours == ref
    assert trend.check(ours) == ref_trend.check(ref)
    assert trend.render_trend_html(ours) == ref_trend.render_trend_html(ref)


def test_committed_trend_gates_as_the_reference():
    doc = trend.load_trend(str(ROOT / "TREND.json"))
    assert doc == ref_trend.load_trend(str(ROOT / "TREND.json"))
    assert trend.check(doc) == ref_trend.check(doc)
    assert trend.render_trend_html(doc) == ref_trend.render_trend_html(doc)


def _run(main, argv, capsys) -> tuple[int, str]:
    code = main(argv)
    return code, capsys.readouterr().out


def test_perf_sentinel_exits_as_the_reference(tmp_path, capsys):
    record = {"bench": "serve_throughput", "results": {"batcher_on": {"qps": 100.0, "p99.9_ms": 10.0}}}
    src = tmp_path / "bench.json"
    trends = {"port": str(tmp_path / "port.json"), "ref": str(tmp_path / "ref.json")}
    mains = {"port": perf_sentinel.main, "ref": ref_sentinel.main}

    def step(*argv) -> int:
        codes, outs = {}, {}
        for side in ("port", "ref"):
            codes[side], outs[side] = _run(mains[side], ["--trend", trends[side], *argv], capsys)
        assert codes["port"] == codes["ref"], argv
        if argv[0] == "check":
            assert json.loads(outs["port"]) == json.loads(outs["ref"])
        return codes["port"]

    assert step("check") == 3  # empty
    src.write_text(json.dumps(record))
    assert step("ingest", "--no-stamp", str(src)) == 0
    assert step("check") == 3  # no baseline yet
    assert step("ingest", "--no-stamp", str(src)) == 0
    assert step("check") == 0
    record["results"]["batcher_on"]["p99.9_ms"] = 11.0
    record["results"]["extra"] = {"qps": 5.0}  # a new gated metric, no baseline
    src.write_text(json.dumps(record))
    step("ingest", "--no-stamp", str(src))
    assert step("check") == 0
    assert step("check", "--strict-missing") == 3
    record["results"]["batcher_on"] = {"qps": 10.0, "p99.9_ms": 200.0}
    src.write_text(json.dumps(record) + "\n" + json.dumps(record))  # two lines, two rows
    step("ingest", "--no-stamp", str(src))
    assert step("check") == 1
    for side in ("port", "ref"):
        _run(mains[side], ["--trend", trends[side], "render", "--out", str(tmp_path / f"{side}.html")],
             capsys)
    assert (tmp_path / "port.html").read_text() == (tmp_path / "ref.html").read_text()
    assert "<svg" in (tmp_path / "port.html").read_text()
    assert Path(trends["port"]).read_text() == Path(trends["ref"]).read_text()


def test_perf_sentinel_defaults_to_its_own_trend_and_imports_no_torch(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    bench = ROOT / "BENCH_SERVE_r01.json"
    code = (
        "import runpy, sys\n"
        f"for argv in (['ingest', {str(bench)!r}], ['check']):\n"
        "    sys.argv = ['perf_sentinel', *argv]\n"
        "    try:\n"
        "        runpy.run_module('cobalt_smart_lender_ai_tpu_torch.tools.perf_sentinel', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        print('exit', e.code)\n"
        "print('torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    lines = out.stdout.strip().splitlines()
    assert [lines[0], lines[-2], lines[-1]] == ["exit 0", "exit 3", "False"], out.stderr
    assert json.loads("\n".join(lines[1:-2]))["status"] == "missing_baseline"
    assert (tmp_path / "TREND_torch.json").exists() and not (tmp_path / "TREND.json").exists()
