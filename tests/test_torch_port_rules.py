"""Rules the PyTorch port keeps.

- The port package and ``chip_smoke.py`` import neither JAX (nor flax or
  optax) nor anything of the JAX package (``cobalt_smart_lender_ai_tpu``),
  nor pandas or msgpack (the card's machine has neither); importing the
  port's serving stack, its data layer, its training protocol, its
  telemetry, its challenger models, its portfolio path or its mesh
  (``parallel``: the mesh, the sharded fit, the partitioners and the
  multi-process runtime) in a fresh interpreter leaves
  ``jax``, ``flax``, ``msgpack`` and ``pandas`` unloaded; importing the
  operator's layer (the UI, the build cache, the incident report and the
  artifact trainer) leaves ``requests``, ``streamlit`` and ``matplotlib``
  unloaded too.
- Its entry points run on the CUDA device unless the caller asks for the
  CPU: with CUDA unavailable, the default-device service constructors
  (``--canary`` and ``--replicas`` serving included), the retrain CLI, the
  challenger models and `MLPArtifact.from_bytes`, the portfolio scorer
  (`PortfolioScorer`, ``from_registry`` and ``tools.score_portfolio``),
  `GBDTClassifier`, `split_mask`, `GBDTArtifact.load`/``from_bytes``,
  `rfe_select`, `randomized_search`, `run_pipeline`, the mesh's device
  list (`make_mesh`, `make_partitioner`, `MeshPartitioner`) and the serving and
  training CLIs, the host path's `engineer_features`, ``tools.train_artifact``
  and `debug.profile_trace`, raise instead of
  running on the CPU, and ``chip_smoke.py``
  exits non-zero without printing a result.
- The training CLI (``python -m cobalt_smart_lender_ai_tpu_torch.pipeline``)
  runs the quick protocol on the CPU when asked, and publishes the artifact,
  its features and ``metrics.json``; ``--resume`` on its store restores
  every stage up to the search and refits; ``--pandas-ingest`` takes the
  host path.
"""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu_torch import pipeline
from cobalt_smart_lender_ai_tpu_torch.config import DataConfig, PipelineConfig, RFEConfig, TuneConfig
from cobalt_smart_lender_ai_tpu_torch.data.clean import clean_raw_frame
from cobalt_smart_lender_ai_tpu_torch.data.features import engineer_features, prepare_cleaned_frame
from cobalt_smart_lender_ai_tpu_torch.data.split import split_mask
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier
from cobalt_smart_lender_ai_tpu_torch.parallel.rfe import rfe_select
from cobalt_smart_lender_ai_tpu_torch.parallel.tune import randomized_search
from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.serve import __main__ as cli
from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService, resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "cobalt_smart_lender_ai_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    mods: set[str] = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mods.add(node.module)
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "msgpack", "cobalt_smart_lender_ai_tpu", "pandas")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_files_import_no_jax_and_no_reference_package(path):
    bad = sorted(m for m in _imported_modules(path) if _forbidden(m))
    assert not bad, f"{path.name} imports {bad}"
    text = path.read_text()
    assert "import jax" not in text and "import pandas" not in text
    assert "cobalt_smart_lender_ai_tpu." not in text.replace("cobalt_smart_lender_ai_tpu_torch", "")


def _loaded_after_import(modules: tuple[str, ...], extra: tuple[str, ...] = ()) -> str:
    """Modules of JAX, the JAX package or pandas (and of ``extra``) that a
    fresh interpreter holds after importing the port's ``modules``."""
    banned = ("jax", "jaxlib", "flax", "optax", "msgpack", "cobalt_smart_lender_ai_tpu", "pandas", *extra)
    code = (
        "import sys\n"
        + "".join(f"import cobalt_smart_lender_ai_tpu_torch.{m}\n" for m in modules)
        + f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {banned!r})\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_importing_the_serving_stack_leaves_jax_unloaded():
    modules = ("serve.__main__", "serve.http_asyncio", "convert", "models.gbdt", "ops.metrics")
    assert _loaded_after_import(modules) == "[]"


def test_importing_the_data_layer_leaves_jax_and_pandas_unloaded():
    modules = ("data.device_pipeline", "data.synthetic", "data.split", "io.artifacts")
    assert _loaded_after_import(modules) == "[]"


def test_importing_the_training_protocol_leaves_jax_and_pandas_unloaded():
    modules = ("config", "parallel.tune", "parallel.rfe", "parallel.budget", "pipeline",
               "reliability", "io.frames", "io.plots")
    assert _loaded_after_import(modules) == "[]"


def test_importing_the_reader_registry_and_bootstrap_leaves_jax_and_pandas_unloaded():
    modules = ("native", "io.registry", "data.bootstrap", "data.clean", "data.features", "data")
    assert _loaded_after_import(modules) == "[]"


def test_importing_the_training_loop_leaves_jax_and_pandas_unloaded():
    modules = ("telemetry.events", "telemetry.drift", "io.model_registry", "serve.canary",
               "tools", "tools.retrain", "tools.registry_gc")
    assert _loaded_after_import(modules) == "[]"


def test_importing_the_fleet_leaves_jax_and_pandas_unloaded():
    modules = ("reliability.chaos", "serve.supervisor", "serve.autoscaler", "serve.replicas")
    assert _loaded_after_import(modules) == "[]"


def test_importing_the_load_control_leaves_jax_and_pandas_unloaded():
    modules = ("telemetry.aggregate", "telemetry.timeseries", "reliability.traffic",
               "serve.autoscaler", "serve.http_asyncio")
    assert _loaded_after_import(modules) == "[]"


def test_importing_the_challengers_leaves_jax_msgpack_and_pandas_unloaded():
    modules = ("models", "models.train_loop", "models.nn", "models.linear", "models.ft_transformer",
               "models.tabnet", "io.flax_msgpack", "debug", "convert", "tools.retrain")
    assert _loaded_after_import(modules) == "[]"


def test_importing_the_portfolio_path_leaves_jax_and_pandas_unloaded():
    modules = ("scenario", "scenario.grid", "scenario.report", "scenario.engine",
               "tools.score_portfolio", "tools.obs_report", "serve.service", "serve.replicas")
    assert _loaded_after_import(modules) == "[]"


def test_importing_the_mesh_leaves_jax_and_pandas_unloaded():
    modules = ("parallel", "parallel.mesh", "parallel.sharded", "parallel.partitioner",
               "parallel.distributed", "device", "ops.histogram")
    assert _loaded_after_import(modules) == "[]"


def test_the_mesh_defaults_to_the_cards_and_raises_without_one(no_cuda):
    from cobalt_smart_lender_ai_tpu_torch.device import mesh_devices
    from cobalt_smart_lender_ai_tpu_torch.parallel import make_mesh, make_partitioner
    from cobalt_smart_lender_ai_tpu_torch.parallel.partitioner import MeshPartitioner

    with pytest.raises(RuntimeError, match="cuda"):
        mesh_devices()
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        make_partitioner(4)
    with pytest.raises(RuntimeError, match="cuda"):
        MeshPartitioner()
    assert mesh_devices("cpu") == [torch.device("cpu")]


def test_portfolio_scoring_defaults_to_cuda_and_raises_without_it(no_cuda, tmp_path):
    from cobalt_smart_lender_ai_tpu_torch.scenario import PortfolioScorer
    from cobalt_smart_lender_ai_tpu_torch.tools import score_portfolio

    store = ObjectStore(str(ROOT / "artifacts"))
    art = GBDTArtifact.load(store, "models/gbdt/model_tree", device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        PortfolioScorer(art, ObjectStore(str(tmp_path)))
    with pytest.raises(RuntimeError, match="cuda"):
        PortfolioScorer.from_registry(ObjectStore(str(tmp_path)))
    assert score_portfolio.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        score_portfolio.main(["--store", str(ROOT / "artifacts"), "--model-key", "models/gbdt/model_tree"])
    assert PortfolioScorer(art, ObjectStore(str(tmp_path)), device="cpu").kernel == "plain"


def test_importing_the_telemetry_leaves_jax_and_pandas_unloaded():
    modules = ("telemetry", "telemetry.metrics", "telemetry.tracing", "telemetry.logging",
               "telemetry.traceexport", "telemetry.programs", "telemetry.devices",
               "telemetry.runledger", "telemetry.flight", "telemetry.slo")
    assert _loaded_after_import(modules) == "[]"


def test_importing_the_operator_layer_leaves_jax_pandas_requests_streamlit_matplotlib_unloaded():
    modules = ("ui", "ui.core", "ui.app", "compilecache", "version", "debug",
               "tools.incident_report", "tools.train_artifact", "serve.__main__")
    assert _loaded_after_import(modules, ("requests", "streamlit", "matplotlib")) == "[]"


def test_train_artifact_defaults_to_cuda_and_raises_without_it(no_cuda, tmp_path):
    from cobalt_smart_lender_ai_tpu_torch.debug import profile_trace
    from cobalt_smart_lender_ai_tpu_torch.tools import train_artifact

    assert train_artifact.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        train_artifact.main(["--rows", "500", "--out", str(tmp_path / "lake")])
    with pytest.raises(RuntimeError, match="cuda"):
        train_artifact.train_artifact(500)
    with pytest.raises(RuntimeError, match="cuda"):
        with profile_trace(str(tmp_path / "trace")):
            pass
    assert not (tmp_path / "lake").exists()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ScorerService.from_store(ObjectStore(str(ROOT / "artifacts")))
    with pytest.raises(RuntimeError, match="cuda"):
        split_mask(10, 0.2, 22)
    assert split_mask(10, 0.2, 22, device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    store = ObjectStore(str(ROOT / "artifacts"))
    with pytest.raises(RuntimeError, match="cuda"):
        GBDTArtifact.load(store, "models/gbdt/model_tree")
    with pytest.raises(RuntimeError, match="cuda"):
        GBDTArtifact.from_bytes(store.get_bytes("models/gbdt/model_tree.npz"))
    art = GBDTArtifact.load(store, "models/gbdt/model_tree", device="cpu")
    assert art.forest.device == torch.device("cpu")


def test_challengers_default_to_cuda_and_raise_without_it(no_cuda):
    from cobalt_smart_lender_ai_tpu_torch.io import MLPArtifact
    from cobalt_smart_lender_ai_tpu_torch.models import (
        FTTransformerClassifier,
        LogisticRegression,
        MLPClassifier,
        TabNetClassifier,
    )

    for make in (MLPClassifier, LogisticRegression, TabNetClassifier,
                 lambda: FTTransformerClassifier((3,))):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    with pytest.raises(RuntimeError, match="cuda"):
        MLPArtifact.from_bytes(b"")
    assert MLPClassifier(device="cpu").device == torch.device("cpu")


def test_training_protocol_defaults_to_cuda_and_raises_without_it(no_cuda):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        rfe_select(X, y, RFEConfig(n_select=2))
    with pytest.raises(RuntimeError, match="cuda"):
        randomized_search(X, y, tune=TuneConfig(n_iter=1, cv_folds=2))
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.run_pipeline(PipelineConfig(), raw=synthetic_lendingclub_frame(50, seed=1))
    host = PipelineConfig(data=DataConfig(device_pipeline=False))
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.run_pipeline(host, raw=synthetic_lendingclub_frame(50, seed=1))
    prepared = prepare_cleaned_frame(clean_raw_frame(synthetic_lendingclub_frame(50, seed=1))[0])
    with pytest.raises(RuntimeError, match="cuda"):
        engineer_features(prepared)
    tree, _, _ = engineer_features(prepared, device="cpu")
    assert tree.X.device == torch.device("cpu")
    assert pipeline.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.main(["--synthetic-rows", "50", "--quick"])


def test_training_cli_runs_the_quick_protocol_on_the_cpu_when_asked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # the suite shares its cores with other workers
    out = subprocess.run(
        [sys.executable, "-m", "cobalt_smart_lender_ai_tpu_torch.pipeline",
         "--store", str(tmp_path), "--synthetic-rows", "3000", "--quick", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    summary = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    assert summary["n_selected"] == 20 and 0.9 < summary["test_auc"] <= 1.0
    assert set(summary["best_params"]) == {"n_estimators", "max_depth", "learning_rate", "subsample"}
    assert list(summary["timings"]) == ["host_frontier", "device_ingest", "rfe", "search", "eval"]
    store = ObjectStore(str(tmp_path))
    key = PipelineConfig().serve.model_key
    assert len(store.get_json(key + ".features.json")) == 20
    assert set(store.get_json(key + ".metrics.json")) == {"auc", "classification_report", "best_params"}
    assert GBDTArtifact.load(store, key, "cpu").plan is not None
    assert summary["stages_run"] == ("clean", "engineer", "rfe", "search", "eval")
    # --resume on that store: every stage up to the search restored, one refit.
    resumed = pipeline.main(["--store", str(tmp_path), "--quick", "--device", "cpu", "--resume"])
    assert resumed.stages_skipped == ("clean", "engineer", "rfe", "search")
    assert list(resumed.timings) == ["restore", "refit", "eval"]
    assert resumed.best_params == summary["best_params"]
    assert resumed.test_auc == pytest.approx(summary["test_auc"], abs=1e-4)


def test_training_cli_rejects_what_is_not_ported(tmp_path, monkeypatch):
    """The cases that raised as not ported run as the reference's do: no raw
    table and no store is the reference's ``ValueError``; ``--pandas-ingest``
    takes the host path (``data.device_pipeline=False``), whose stages are
    ``clean`` and ``engineer``, and needs a raw table as the device ingest
    does; ``--resume`` on a store without manifests reads the raw table from
    the store's ``raw_key`` (absent here, so a ``FileNotFoundError`` naming
    it)."""
    with pytest.raises(ValueError, match="provide a raw frame or an object store"):
        pipeline.main(["--device", "cpu"])
    with pytest.raises(ValueError, match="provide a raw frame or an object store"):
        pipeline.main(["--device", "cpu", "--pandas-ingest"])
    seen = {}

    def host_path_run(cfg, **kw):
        seen["device_pipeline"] = cfg.data.device_pipeline
        raise RuntimeError("stop before training")

    with monkeypatch.context() as m:
        m.setattr(pipeline, "run_pipeline", host_path_run)
        with pytest.raises(RuntimeError, match="stop before training"):
            pipeline.main(["--device", "cpu", "--synthetic-rows", "50", "--pandas-ingest"])
    assert seen == {"device_pipeline": False}
    assert pipeline.parse_args(["--pandas-ingest"]).pandas_ingest
    with pytest.raises(FileNotFoundError, match="raw.csv"):
        pipeline.main(["--device", "cpu", "--store", str(tmp_path), "--resume", "--quick"])
    assert pipeline.parse_args(["--resume", "--no-halving"]).resume


def test_new_port_modules_are_checked():
    names = {p.relative_to(PORT).as_posix() for p in PORT_FILES if p.is_relative_to(PORT)}
    assert {"ops/histogram.py", "ops/binning.py", "ops/metrics.py", "device.py",
            "data/device_pipeline.py", "data/frame.py", "data/synthetic.py",
            "data/split.py", "data/clean.py", "data/features.py", "config.py",
            "parallel/tune.py", "parallel/rfe.py", "pipeline.py",
            "reliability/checkpoint.py", "reliability/retry.py", "reliability/stores.py",
            "parallel/budget.py", "io/plots.py", "io/frames.py", "io/store.py",
            "telemetry/__init__.py", "telemetry/metrics.py", "telemetry/tracing.py",
            "telemetry/logging.py", "telemetry/traceexport.py", "telemetry/programs.py",
            "telemetry/devices.py", "telemetry/runledger.py", "telemetry/flight.py",
            "telemetry/slo.py", "reliability/admission.py", "reliability/breaker.py",
            "reliability/faults.py", "native/__init__.py", "io/registry.py",
            "data/bootstrap.py", "telemetry/events.py", "telemetry/drift.py",
            "io/model_registry.py", "serve/canary.py", "tools/__init__.py",
            "tools/retrain.py", "tools/registry_gc.py", "reliability/chaos.py",
            "serve/supervisor.py", "serve/autoscaler.py", "serve/replicas.py",
            "telemetry/aggregate.py", "telemetry/timeseries.py", "reliability/traffic.py",
            "scenario/__init__.py", "scenario/grid.py", "scenario/report.py", "scenario/engine.py",
            "tools/score_portfolio.py", "tools/obs_report.py", "compilecache.py", "version.py",
            "ui/__init__.py", "ui/core.py", "ui/app.py", "tools/incident_report.py",
            "tools/train_artifact.py"} <= names


def test_no_port_module_imports_pandas():
    """The card's machine has no pandas: no port file names it in an import,
    and the native reader's C++ source includes only the standard library."""
    for path in PORT_FILES:
        mods = _imported_modules(path)
        assert not [m for m in mods if m.split(".")[0] == "pandas"], path.name
    source = (PORT / "native" / "csv_reader.cc").read_text()
    includes = [line.split()[1] for line in source.splitlines() if line.startswith("#include")]
    assert includes and all(inc.startswith("<") for inc in includes), includes
    assert "cobalt_smart_lender_ai_tpu." not in source and "Python.h" not in source


def test_classifier_defaults_to_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="cuda"):
        GBDTClassifier()
    with pytest.raises(RuntimeError, match="cuda"):
        GBDTClassifier(n_estimators=2, device="cuda")


def test_classifier_fits_on_the_cpu_when_asked(no_cuda):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    model = GBDTClassifier(n_estimators=3, max_depth=2, n_bins=16, device="cpu").fit(X, y)
    assert model.forest.device == torch.device("cpu") and model.forest.n_trees == 3
    assert (model.predict(X).numpy() == y).mean() > 0.9


def test_cli_defaults_to_cuda_and_raises_without_it(no_cuda):
    args = cli.parse_args(["--store", str(ROOT / "artifacts")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        cli.build_service(args)


def test_canary_serving_defaults_to_cuda_and_raises_without_it(no_cuda):
    args = cli.parse_args(["--store", str(ROOT / "artifacts"), "--canary"])
    assert args.device == "cuda" and args.canary
    with pytest.raises(RuntimeError, match="cuda"):
        cli.build_service(args)


def test_cli_canary_flags_reach_the_serve_config():
    args = cli.parse_args(["--store", str(ROOT / "artifacts"), "--device", "cpu", "--canary",
                           "--model-name", "gbdt_b", "--canary-sample-rate", "0.25"])
    svc = cli.build_service(args)
    try:
        cfg = svc.config
        assert (cfg.canary_enabled, cfg.model_name, cfg.canary_sample_rate) == (True, "gbdt_b", 0.25)
        # a store without a model registry serves its model key, canary idle
        assert svc.canary is not None and not svc.canary.status()["loaded"]
        assert svc.model_info["version"] == "unversioned"
    finally:
        svc.close()
    plain = cli.parse_args(["--store", str(ROOT / "artifacts")])
    assert not plain.canary and plain.model_name == "gbdt" and plain.canary_sample_rate == 1.0


def test_cli_fleet_flags_reach_the_serve_config():
    plain = cli.parse_args(["--store", str(ROOT / "artifacts")])
    assert (plain.replicas, plain.no_replica_devices) == (1, False)
    assert (ServeConfig.replicas, ServeConfig.replica_devices) == (1, True)
    args = cli.parse_args(["--store", str(ROOT / "artifacts"), "--device", "cpu", "--replicas", "2",
                           "--no-replica-devices", "--no-microbatch"])
    fleet = cli.build_service(args)
    try:
        assert isinstance(fleet, ReplicaSet) and len(fleet.replicas) == 2
        assert (fleet.config.replicas, fleet.config.replica_devices) == (2, False)
        ready, payload = fleet.ready()
        assert ready and payload["replica_devices"] == ["cpu", "cpu"]
        assert all(p["kernel"] == "plain" for p in payload["per_replica"])
    finally:
        fleet.close()


def test_fleet_cli_defaults_to_cuda_and_raises_without_it(no_cuda):
    args = cli.parse_args(["--store", str(ROOT / "artifacts"), "--replicas", "2"])
    assert args.device == "cuda" and args.replicas == 2
    with pytest.raises(RuntimeError, match="cuda"):
        cli.build_service(args)
    with pytest.raises(RuntimeError, match="cuda"):
        ReplicaSet.from_store(ObjectStore(str(ROOT / "artifacts")), ServeConfig(replicas=4))


def test_cli_builds_a_cpu_service_when_asked():
    args = cli.parse_args(["--store", str(ROOT / "artifacts"), "--device", "cpu"])
    svc = cli.build_service(args)
    try:
        ready, payload = svc.ready()
        assert ready and payload["device"] == "cpu" and payload["kernel"] == "plain"
    finally:
        svc.close()


def test_cli_rejects_unported_precisions(capsys):
    """The three precisions the reference serves start; any other is refused
    before anything is loaded."""
    for precision in ("f64", "fp8"):
        with pytest.raises(SystemExit):
            cli.parse_args(["--store", str(ROOT / "artifacts"), "--forest-precision", precision])
        assert "invalid choice" in capsys.readouterr().err
    args = cli.parse_args(
        ["--store", str(ROOT / "artifacts"), "--device", "cpu", "--forest-precision", "bf16"]
    )
    svc = cli.build_service(args)
    try:
        _, payload = svc.ready()
        assert payload["precision"] == "bf16" and payload["quant_table"] != "f32"
    finally:
        svc.close()


def _run_chip_smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, wherever this runs
    return subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )


def test_chip_smoke_fails_without_a_gpu():
    out = _run_chip_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_chip_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
