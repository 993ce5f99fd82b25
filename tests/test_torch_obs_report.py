"""The port's ``tools.obs_report`` against the reference's renderer.

On the same ledger files the port's `render_report` and `render_diff` give
the reference's markdown byte for byte: a ledger the port's `RunLedger`
writes after a portfolio sweep on the CPU, and hand-built ledgers that
reach every section (stages with the ingest split, the program table with
and without roofline, the compile block, halving rungs, final metrics).
``main`` prints the same text, writes the same ``--out`` file, and returns
the reference's exit codes under ``--min-attribution``.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest

from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.scenario import PortfolioScorer, ScenarioGrid, feature_delta
from cobalt_smart_lender_ai_tpu_torch.telemetry import RunLedger
from cobalt_smart_lender_ai_tpu_torch.tools import obs_report
from tools import obs_report as ref_report

ROOT = Path(__file__).resolve().parent.parent


def _ledger(ratio, **extra) -> dict:
    doc = {
        "schema": 1,
        "kind": "pipeline",
        "created_unix": 1.0,
        "wall_seconds": 12.3456789,
        "fingerprint": "abc123",
        "meta": {"rows": 2000, "device": "cuda:0", "resume": False},
        "env": {"python": "3.12.1", "torch": "2.6", "backend": "cuda", "device_count": 1,
                "devices": [{"kind": "NVIDIA H100 80GB HBM3"}]},
        "stages": {"host_frontier": 20.5, "device_ingest": 0.52, "rfe": 124.9, "search": 243.98, "eval": 0.0},
        "programs": [
            {"name": "gradient_histogram/F20xB255", "dispatches": 2100, "dispatch_seconds": 1.8919,
             "compiles": 1, "compile_seconds": 41.2, "flops": 2.5e9,
             "achieved_flops_per_second": 1.3e12, "roofline_utilization": 0.0193},
            {"name": "score_forest/f32/2048/shap", "dispatches": 500, "dispatch_seconds": 1.7,
             "compiles": 0, "compile_seconds": 0.0, "flops": 650.0,
             "achieved_flops_per_second": 999.4, "roofline_utilization": None},
            {"name": "ingest.fill[1000,104]"},
        ],
        "program_totals": {"dispatch_seconds": 3.5919},
        "dispatch_attribution": {"measured_seconds": 4.0, "attributed_seconds": 3.5919, "ratio": ratio},
        "compile": {"builds": 2, "build_seconds": 41.2},
        "search_halving": {"rungs": [{"budget": 75, "live": 4, "pruned": 2},
                                     {"budget_trees": 150, "live": 2, "pruned": 1}],
                           "pruned_candidates": 3},
        "final_metrics": {"test_auc": 0.965635, "rows": 460000, "note": "quick"},
    }
    doc.update(extra)
    return doc


@pytest.fixture(scope="module")
def portfolio_ledger(tmp_path_factory) -> Path:
    """A ledger the port writes after a small SHAP sweep of the committed
    model on the CPU."""
    root = tmp_path_factory.mktemp("obs_report")
    store = ObjectStore(str(root / "lake"))
    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), "models/gbdt/model_tree", "cpu")
    rng = np.random.default_rng(3)
    X = rng.normal(size=(96, len(art.feature_names))).astype(np.float32) * 1000
    ledger = RunLedger("portfolio", meta={"run_id": "obs", "device": "cpu"})
    report = PortfolioScorer(art, store, chunk_rows=64, device="cpu").run(
        X, ScenarioGrid([feature_delta("installment", [25.0])]), run_id="obs", ledger=ledger)
    ledger.fingerprint = report["fingerprint"]
    path = root / "portfolio.json"
    ledger.write(str(path))
    return path


def _write(tmp_path: Path, name: str, doc: dict) -> Path:
    path = tmp_path / name
    path.write_text(json.dumps(doc, indent=2))
    return path


def test_a_port_ledger_renders_as_the_reference_renders_it(portfolio_ledger):
    doc = json.loads(portfolio_ledger.read_text())
    text = obs_report.render_report(doc)
    assert text == ref_report.render_report(doc)
    assert "score_forest_plain/f32/64/shap" in text and "## Dispatch attribution" in text
    assert doc["dispatch_attribution"]["ratio"] is not None


@pytest.mark.parametrize("ratio", [None, 0.5, 0.9012])
def test_every_section_renders_as_the_references(ratio):
    doc = _ledger(ratio)
    assert obs_report.render_report(doc) == ref_report.render_report(doc)
    bare = {"schema": 1}
    assert obs_report.render_report(bare) == ref_report.render_report(bare)
    no_programs = _ledger(ratio, programs=[], stages={"score": 0.0}, meta={}, search_halving={})
    assert obs_report.render_report(no_programs) == ref_report.render_report(no_programs)


def test_diffs_render_as_the_references(portfolio_ledger):
    a = _ledger(0.9)
    b = copy.deepcopy(a)
    b["fingerprint"] = "def456"
    b["stages"]["search"] = 200.0
    b["stages"]["new"] = 1.0
    b["programs"] = b["programs"][:1] + [{"name": "only_in_b", "dispatch_seconds": 0.25}]
    b["final_metrics"]["test_auc"] = 0.9661
    port = json.loads(portfolio_ledger.read_text())
    for x, y in ((a, b), (b, a), (a, a), (a, port), (port, port)):
        assert obs_report.render_diff(x, y) == ref_report.render_diff(x, y)


@pytest.mark.parametrize("ratio, gate", [(None, 0.8), (0.5, 0.8), (0.9, 0.8), (0.8, 0.8), (0.9, None)])
def test_main_prints_writes_and_gates_as_the_references(tmp_path, capsys, ratio, gate):
    path = _write(tmp_path, "run.json", _ledger(ratio))
    other = _write(tmp_path, "b.json", _ledger(0.3, fingerprint="zzz"))
    for argv in ([str(path)], [str(path), str(other)]):
        argv = argv + ([] if gate is None else ["--min-attribution", str(gate)])
        rc = obs_report.main(argv)
        ours = capsys.readouterr()
        assert rc == ref_report.main(argv)
        want = capsys.readouterr()
        assert (ours.out, ours.err) == (want.out, want.err)
    assert rc == (1 if ratio is not None and gate is not None and ratio < gate else 0)
    obs_report.main([str(path), "--out", str(tmp_path / "ours.md")])
    ref_report.main([str(path), "--out", str(tmp_path / "ref.md")])
    assert (tmp_path / "ours.md").read_bytes() == (tmp_path / "ref.md").read_bytes()


def test_main_refuses_what_is_not_a_ledger(tmp_path):
    path = _write(tmp_path, "x.json", {"kind": "pipeline"})
    with pytest.raises(ValueError, match="not a run ledger"):
        obs_report.main([str(path)])
