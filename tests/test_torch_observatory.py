"""The port's kernel cost table, device telemetry and run ledger, on the CPU.

- Programs on the CPU: a fit and a scoring pass through the port's kernel
  entries record every call of the plain version on its ``*_plain``
  program (wall seconds, the kernel's own FLOP and byte counts for the
  call's shapes); kernel programs dispatch exactly as often as the
  ``.launches`` counters rise (never, here), and no CPU row has a
  roofline. A call that raises records nothing and raises as before.
- The ``cobalt_program_*`` families carry the reference's names, types and
  label names; the H100 is the only device with peaks.
- `device_info`, the memory and RSS gauges and the `DeviceSampler` on the
  CPU: one device row without memory stats, a NaN gauge, sampled series as
  Perfetto counter tracks; a child forked while the sampler runs samples
  without waiting on the parent's locks.
- A port `RunLedger` has the reference's top-level keys for the same calls,
  reports torch's environment and none of JAX's, round-trips through
  `load_ledger`, and renders and diffs through the reference's
  ``tools/obs_report.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import signal
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import cobalt_smart_lender_ai_tpu.telemetry.metrics as jax_metrics
import cobalt_smart_lender_ai_tpu.telemetry.programs as jax_programs
import cobalt_smart_lender_ai_tpu.telemetry.runledger as jax_runledger
from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier
from cobalt_smart_lender_ai_tpu_torch.ops.histogram import (
    gradient_histogram_channels,
    histogram_cost,
)
from cobalt_smart_lender_ai_tpu_torch.ops.score import fused_score, pack_forest, score_cost
from cobalt_smart_lender_ai_tpu_torch.telemetry import (
    DeviceSampler,
    MetricsRegistry,
    RunLedger,
    Tracer,
    chrome_trace,
    default_device_sampler,
    device_info,
    host_rss_bytes,
    install_device_metrics,
    load_ledger,
    parse_exposition,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import (
    ProgramRegistry,
    peak_bytes_estimate,
    peak_flops_estimate,
    set_default_program_registry,
)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def fresh_programs():
    reg = ProgramRegistry()
    prev = set_default_program_registry(reg)
    yield reg
    set_default_program_registry(prev)


@pytest.fixture(scope="module")
def model():
    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), "models/gbdt/model_tree", "cpu")
    return pack_forest(art.forest, len(art.feature_names)), len(art.feature_names)


def _rows(n: int, F: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(n, F)).astype(np.float32))


@pytest.mark.parametrize(
    "n_estimators,max_depth,hist_subtract", [(3, 2, True), (4, 3, False), (2, 4, True)]
)
def test_fit_records_every_histogram_call_on_its_plain_program(
    fresh_programs, n_estimators, max_depth, hist_subtract
):
    rng = np.random.default_rng(n_estimators)
    X = rng.normal(size=(600, 5)).astype(np.float32)
    y = (X[:, 0] + 0.5 * rng.normal(size=600) > 0).astype(np.float32)
    cfg = GBDTConfig(
        n_estimators=n_estimators, max_depth=max_depth, n_bins=32, hist_subtract=hist_subtract
    )
    launches = gradient_histogram_channels.launches
    GBDTClassifier(cfg, device="cpu").fit(X, y)
    rows = fresh_programs.table()
    kernel = [r for r in rows if r["kind"] == "kernel"]
    assert sum(r["dispatches"] for r in kernel) == gradient_histogram_channels.launches - launches == 0
    (plain,) = rows
    assert plain["name"] == "gradient_histogram_plain/F5xB32" and plain["kind"] == "plain"
    assert plain["dispatches"] == n_estimators * max_depth  # one per tree level, as on the card
    assert plain["dispatch_seconds"] > 0 and plain["rows"] == 600 * plain["dispatches"]
    assert plain["device"] == "cpu" and plain["roofline_utilization"] is None
    assert plain["bound_seconds"] is None and plain["compiles"] == 0
    # Every row counted active: the shape-only bound, whatever the level.
    assert plain["flops"] == histogram_cost(600, 5, 1, 32, 1)[0] == 3 * 600 * 5
    assert plain["cost_basis"].startswith("shape-only")


@pytest.mark.parametrize(
    "calls", [((1, True), (64, True)), ((50, True), (64, True), (3, False)), ((300, False),)]
)
def test_scoring_records_each_call_on_its_bucket(fresh_programs, model, calls):
    pack, F = model
    launches = fused_score.launches
    for i, (n, with_shap) in enumerate(calls):
        fused_score(pack, _rows(n, F, i), n_features=F, with_shap=with_shap)
    table = {r["name"]: r for r in fresh_programs.table()}
    expect: dict[str, list[int]] = {}
    for n, with_shap in calls:
        bucket = 1 << max(0, n - 1).bit_length()
        expect.setdefault(f"score_forest_plain/f32/{bucket}/{'shap' if with_shap else 'margin'}", []).append(n)
    assert sorted(table) == sorted(expect)
    assert fused_score.launches == launches
    for name, ns in expect.items():
        row = table[name]
        assert row["dispatches"] == len(ns) and row["rows"] == sum(ns)
        costs = [score_cost(n, pack.n_trees, pack.depth, F, "f32", "shap" in name) for n in ns]
        assert row["flops"] == pytest.approx(np.mean([c[0] for c in costs]))
        assert row["bytes_accessed"] == pytest.approx(np.mean([c[1] for c in costs]))
        assert row["kind"] == "plain" and row["roofline_utilization"] is None


def test_a_call_that_raises_records_nothing(fresh_programs):
    bins = torch.zeros((10, 3), dtype=torch.uint8)
    node = torch.zeros(10, dtype=torch.int32)
    g = torch.ones(9)  # one row short: the plain version raises
    with pytest.raises(RuntimeError):
        gradient_histogram_channels(bins, node, g, g, g, n_nodes=1, n_bins=4)
    assert fresh_programs.table() == []


def test_score_cost_counts_the_records_bytes(model):
    pack, F = model
    for n, with_shap in ((1, True), (64, True), (4096, False)):
        flops, nbytes = score_cost(n, pack.n_trees, pack.depth, F, pack.precision, with_shap)
        tensors = [pack.feature, pack.thr_q, pack.missing_left, pack.leaf_q]
        if with_shap:
            tensors += [pack.path_feature, pack.slot, pack.r_play]
        forest = sum(t.numel() * t.element_size() for t in tensors)
        assert nbytes == forest + n * F * 4 + 2 * n * 4 + (n * F * 4 if with_shap else 0)
        assert flops >= n * pack.n_trees * (pack.depth + 1)


def _families(text: str, parse) -> dict[str, tuple[str, frozenset]]:
    """{family: (type, label names)} of a rendered registry."""
    out = {}
    for name, fam in parse(text).items():
        labels = set()
        for key in fam["samples"]:
            labels |= {part.split("=", 1)[0] for part in key.split("|")[1:]}
        out[name] = (fam["type"], frozenset(labels))
    return out


def test_program_families_are_the_references(fresh_programs):
    port_metrics = MetricsRegistry()
    fresh_programs.register("score_forest/f32/64/shap", kind="kernel").record_dispatch(
        0.001, rows=64, flops=1e9, nbytes=1e6
    )
    fresh_programs.publish(port_metrics)
    ref_programs = jax_programs.ProgramRegistry()
    ref_metrics = jax_metrics.MetricsRegistry()
    ref_programs.register("score_forest/f32/64/shap", kind="serve").record_dispatch(0.001)
    ref_programs.publish(ref_metrics)
    port = _families(port_metrics.render(), parse_exposition)
    assert port == _families(ref_metrics.render(), jax_metrics.parse_exposition)
    samples = parse_exposition(port_metrics.render())
    assert samples["cobalt_program_flops"]["samples"]["cobalt_program_flops|program=score_forest/f32/64/shap"] == 1e9


def test_only_the_h100_has_peaks():
    assert peak_flops_estimate("NVIDIA H100 80GB HBM3") == 67e12
    assert peak_bytes_estimate("NVIDIA H100 80GB HBM3") == 3.35e12
    for kind in ("cpu", "NVIDIA A100-SXM4-80GB", "TPU v5 lite", None, ""):
        assert peak_flops_estimate(kind) is None and peak_bytes_estimate(kind) is None


def test_roofline_from_the_counts_on_a_known_card(fresh_programs):
    prog = fresh_programs.register(
        "gradient_histogram/F20xB255", kind="kernel", meta={"device_kind": "NVIDIA H100 80GB HBM3"}
    )
    flops, nbytes = histogram_cost(1_000_000, 20, 8, 255, 1)
    prog.record_dispatch(0.004, count=2, flops=2 * flops, nbytes=2 * nbytes)
    (row,) = fresh_programs.table()
    bound = max(flops / 67e12, nbytes / 3.35e12)
    assert row["bound_seconds"] == pytest.approx(bound)
    assert row["roofline_utilization"] == pytest.approx(bound * 2 / 0.004)
    assert row["achieved_flops_per_second"] == pytest.approx(flops * 2 / 0.004)


def test_device_rows_and_gauges_on_the_cpu():
    assert device_info() == [{"id": 0, "kind": "cpu", "platform": "cpu", "str": "cpu"}]
    reg = MetricsRegistry()
    install_device_metrics(reg)
    fams = parse_exposition(reg.render())
    (mem,) = fams["cobalt_device_mem_bytes"]["samples"].items()
    assert mem[0] == "cobalt_device_mem_bytes|device=cpu" and math.isnan(mem[1])
    (rss,) = fams["cobalt_host_rss_bytes"]["samples"].values()
    assert rss == pytest.approx(host_rss_bytes(), rel=0.5) and rss > 0


def test_sampler_series_become_counter_tracks():
    clock = iter(float(t) for t in range(100, 200))
    sampler = DeviceSampler(clock=lambda: next(clock))
    depth = iter(range(10))
    sampler.add_series("microbatch_queue_depth", lambda: next(depth))
    sampler.add_series("broken", lambda: 1 / 0)  # skipped, never raised
    for _ in range(3):
        sampler.sample_once()
    series = sampler.series()
    assert series["microbatch_queue_depth"] == [(100.0, 0.0), (101.0, 1.0), (102.0, 2.0)]
    assert "broken" not in series and len(series["host_rss_bytes"]) == 3
    doc = chrome_trace(Tracer(), counters=series)
    tracks = [e for e in doc["traceEvents"] if e["ph"] == "C"]
    assert len(tracks) == 6 and doc["otherData"]["counter_event_count"] == 6


def test_a_forked_child_samples_without_the_parents_locks():
    sampler = default_device_sampler()
    interval, sampler.interval_s = sampler.interval_s, 0.01
    sampler.start()
    try:
        time.sleep(0.05)
        with sampler._lock:  # held in the parent across the fork
            pid = os.fork()
            if pid == 0:
                signal.alarm(10)  # a child stuck on an inherited lock dies
                ok = default_device_sampler()._thread is None
                default_device_sampler().sample_once()
                os._exit(0 if ok else 3)
        _, status = os.waitpid(pid, 0)
    finally:
        sampler.stop()
        sampler.interval_s = interval
    assert os.WIFEXITED(status) and os.WEXITSTATUS(status) == 0


def _fill(ledger) -> None:
    ledger.add_stages({"host_frontier": 0.5, "device_ingest": 1.25, "rfe": 2.0, "search": 7.5})
    ledger.add_stage("eval", 0.125)
    ledger.set("final_metrics", {"test_auc": 0.95, "cv_auc": 0.94, "n_selected": 20})
    ledger.set("search_halving", {"rungs": [{"budget": 75, "live": 4, "pruned": 2}],
                                  "pruned_candidates": 3})
    ledger.set("stages_run", {"run": ["clean", "engineer", "rfe", "search", "eval"], "skipped": []})


def _obs_report():
    spec = importlib.util.spec_from_file_location("obs_report", ROOT / "tools" / "obs_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ledger_has_the_reference_keys_and_torch_env(tmp_path, fresh_programs):
    fresh_programs.register("gradient_histogram/F20xB255", kind="kernel").record_dispatch(
        0.5, count=10, flops=10.0, nbytes=20.0
    )
    port = RunLedger("pipeline", fingerprint="abc", meta={"quick": True})
    _fill(port)
    doc = port.write(str(tmp_path / "ledger.json"), registry=MetricsRegistry())
    ref = jax_runledger.RunLedger("pipeline", fingerprint="abc", meta={"quick": True})
    _fill(ref)
    assert list(doc) == list(ref.finalize(registry=jax_metrics.MetricsRegistry()))
    env = doc["env"]
    assert env["torch"] == torch.__version__ and env["cuda"] == torch.version.cuda
    assert env["devices"] == device_info() and env["backend"] == "cpu"
    assert not {"jax", "xla_flags", "jax_platforms"} & set(env)
    assert doc["program_totals"]["dispatches"] == 10
    assert set(doc["compile"]) == {"kernel_builds", "kernel_build_seconds", "kernels_loaded",
                                   *ref.finalize(registry=jax_metrics.MetricsRegistry())["compile"]}
    assert load_ledger(str(tmp_path / "ledger.json")) == json.loads(json.dumps(doc, default=str))
    (tmp_path / "not.json").write_text("{}")
    with pytest.raises(ValueError):
        load_ledger(str(tmp_path / "not.json"))


def test_obs_report_renders_and_diffs_the_ports_ledger(tmp_path, fresh_programs, capsys):
    prog = fresh_programs.register("gradient_histogram/F20xB255", kind="kernel")
    paths = []
    for i, seconds in enumerate((0.5, 0.75)):
        prog.record_dispatch(seconds, count=100, flops=1e6, nbytes=2e6)
        ledger = RunLedger("pipeline", fingerprint="abc", meta={"run": i})
        _fill(ledger)
        paths.append(str(tmp_path / f"ledger{i}.json"))
        ledger.write(paths[-1], registry=MetricsRegistry())
    obs = _obs_report()
    assert obs.main([paths[0], "--out", str(tmp_path / "report.md")]) == 0
    report = (tmp_path / "report.md").read_text()
    assert "`gradient_histogram/F20xB255`" in report and "## Stages" in report
    assert "Ingest host residual" in report and "## Search rungs" in report
    assert obs.main([paths[0], paths[1]]) == 0
    diff = capsys.readouterr().out
    assert "# Run diff" in diff and "gradient_histogram/F20xB255" in diff
