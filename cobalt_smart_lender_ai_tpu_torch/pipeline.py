"""The training protocol end to end, from raw loans to a published model:
the reference trainer's composition (clean, engineer, split, RFE, search,
fit, persist), as the reference package's device-ingest path runs it.

    raw table -> tokenize (host) -> ingest (device: clean, engineer, bin)
    -> leakage drop -> hashed split (seed 22) -> scale_pos_weight
    -> RFE to 20 features -> randomized search (20 x 3 CV) and refit
    -> held-out eval -> <key>.npz + <key>.features.json + <key>.metrics.json
       (+ the confusion-matrix and feature-importance PNGs)

Every fit runs through the histogram kernel on the card (``device="cpu"``
runs the plain versions). The artifact carries its `FeaturePlan`, so
`ScorerService.predict_raw` scores raw rows with it.

With a store, the reference's resilience comes along: the store is wrapped
in a `ResilientStore` (retries, reads verified against their content
pointers), the ingest saves the cleaned, tree and nn tables as CSV
(``save_intermediate``), and after each stage a manifest pins the stage's
outputs and the fingerprint of the configuration it depends on
(`reliability.checkpoint`). A run with ``resume=True`` (CLI ``--resume``)
restores every leading stage whose manifest still validates: the
engineered table from its CSV, RFE's selection and the search's best
parameters (then only the refit runs). Without a raw table the raw one is
read from the store's ``data.raw_key``.

    python -m cobalt_smart_lender_ai_tpu_torch.pipeline --store artifacts \\
        --synthetic-rows 100000 [--seed S] [--quick] [--no-halving] [--resume] \\
        [--pandas-ingest] [--ingest-shards N] [--device cuda|cpu] \\
        [--ledger-out run.json] [--trace-out trace.json]

The host path (``data.device_pipeline=False``, CLI ``--pandas-ingest``)
cleans on the host (`data.clean.clean_raw_frame`), then prepares and
engineers (`data.features`: strings on the host, numerics on the device);
its timings are ``clean`` and ``engineer``. The reference's path takes
pandas; the port's runs the same rules on its `RawFrame` without it. A
resume whose ``clean`` manifest validates under a stale ``engineer`` one
restores the cleaned table and takes the host path from there, with no raw
table.

Telemetry, as the reference records it: the whole run is a
``pipeline.run`` span with a ``pipeline.<stage>`` child per stage, and
each stage observes ``cobalt_pipeline_stage_seconds{stage}`` on the
process-wide registry. ``--ledger-out`` writes the run ledger (stages,
final metrics, the halving report, the stages run, the kernel and ingest
program table and the metrics snapshot) and ``--trace-out`` the spans as
Perfetto JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from datetime import datetime
from typing import Any, Sequence

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.compilecache import bootstrap_compile_cache
from cobalt_smart_lender_ai_tpu_torch.config import PipelineConfig, RFEConfig, TuneConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.data.clean import clean_raw_frame
from cobalt_smart_lender_ai_tpu_torch.data.device_pipeline import (
    run_device_ingest,
    tokenize_raw_frame,
)
from cobalt_smart_lender_ai_tpu_torch.data.features import (
    FeatureFrame,
    drop_training_leakage,
    engineer_features,
    prepare_cleaned_frame,
)
from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame
from cobalt_smart_lender_ai_tpu_torch.data.split import train_test_split_hashed
from cobalt_smart_lender_ai_tpu_torch.device import mesh_devices, resolve_device
from cobalt_smart_lender_ai_tpu_torch.io import (
    GBDTArtifact,
    ObjectStore,
    plan_from_json,
    plan_to_json,
    save_metrics,
)
from cobalt_smart_lender_ai_tpu_torch.io.frames import frame_to_csv
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier, gain_importances
from cobalt_smart_lender_ai_tpu_torch.ops.histogram import gradient_histogram_channels
from cobalt_smart_lender_ai_tpu_torch.ops.metrics import (
    binary_classification_report,
    confusion_matrix,
    roc_auc,
)
from cobalt_smart_lender_ai_tpu_torch.parallel.mesh import Mesh, make_mesh
from cobalt_smart_lender_ai_tpu_torch.parallel.partitioner import make_partitioner
from cobalt_smart_lender_ai_tpu_torch.parallel.rfe import rfe_select
from cobalt_smart_lender_ai_tpu_torch.parallel.tune import SearchResult, randomized_search
from cobalt_smart_lender_ai_tpu_torch.reliability import (
    PipelineCheckpoint,
    ResilientStore,
    config_fingerprint,
    policy_from_config,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry import (
    RunLedger,
    default_registry,
    default_tracer,
    install_device_metrics,
    install_program_metrics,
    log_buckets,
    record_span,
    render_chrome_trace,
    span,
)

__all__ = [
    "STAGES",
    "PipelineResult",
    "feature_table",
    "main",
    "quick_config",
    "run_pipeline",
    "stage_fingerprints",
    "table_features",
]

logger = logging.getLogger("cobalt_smart_lender_ai_tpu_torch.pipeline")

#: Stage wall times on the process-wide registry. Stages run seconds to
#: minutes, so the bounds run well past the latency defaults.
_STAGE_SECONDS = default_registry().histogram(
    "cobalt_pipeline_stage_seconds",
    "wall time per pipeline stage (clean/engineer/rfe/search/refit/eval)",
    ("stage",),
    buckets=log_buckets(1e-2, 7200.0, per_decade=2),
)


@dataclasses.dataclass
class PipelineResult:
    """What the reference trainer logs and persists."""

    selected_features: tuple[str, ...]
    best_params: dict[str, Any]
    cv_auc: float
    test_auc: float
    metrics: dict[str, Any]
    artifact: GBDTArtifact
    search: SearchResult
    scale_pos_weight: float
    #: Wall seconds per stage (``host_frontier``, ``device_ingest``, ``rfe``,
    #: ``search``, ``eval``; ``clean`` and ``engineer`` on the host path; on
    #: resume ``restore`` and ``refit``), each ending with the device
    #: synchronised.
    timings: dict[str, float]
    #: Histogram kernel launches per stage (none on the CPU, where the plain
    #: version runs).
    hist_launches: dict[str, int]
    #: The stages that computed in this run, and those restored from a
    #: valid checkpoint manifest.
    stages_run: tuple[str, ...] = ()
    stages_skipped: tuple[str, ...] = ()
    #: The intermediate tables written in this run: ``{"seconds": wall
    #: seconds of writing them and pinning them in the stage manifests,
    #: "bytes": {key: size}}`` (empty when none).
    intermediates: dict[str, Any] = dataclasses.field(default_factory=dict)


def quick_config() -> PipelineConfig:
    """The reference CLI's ``--quick`` profile: RFE in steps of 20 with a
    20-tree depth-3 selector, and a 4 x 2 search in ``"auto"`` chunks, so
    successive halving engages wherever a chunk is shorter than the fit.
    Rows and width are not cut."""
    return PipelineConfig(
        rfe=RFEConfig(n_select=20, step=20, n_estimators=20, max_depth=3),
        tune=TuneConfig(
            n_iter=4,
            cv_folds=2,
            chunk_trees="auto",
            param_space={
                "n_estimators": (150, 300),
                "max_depth": (3,),
                "learning_rate": (0.05, 0.1),
                "subsample": (0.8,),
            },
        ),
    )


#: The checkpointed stages, in order.
STAGES = ("clean", "engineer", "rfe", "search")


def stage_fingerprints(cfg: PipelineConfig, mesh: Mesh | None = None) -> dict[str, str]:
    """Each checkpointed stage's fingerprint: of the configuration it
    depends on, and only that. RFE and the search also take the dp size of
    the resolved ``mesh`` (None: one device): dp > 1 turns sibling
    subtraction off and shards the row sample, so it changes the splits;
    the hp axis and the `MeshConfig` that resolved to the mesh do not (an
    hp-only mesh gives one device's bits), so a checkpoint resumes on any
    mesh of the same dp size."""
    dp = {"dp": mesh.shape[mesh.axis_dp] if mesh is not None else 1}
    return {
        "clean": config_fingerprint("clean", cfg.data),
        "engineer": config_fingerprint("engineer", cfg.data),
        "rfe": config_fingerprint("rfe", cfg.data, cfg.rfe, dp),
        "search": config_fingerprint("search", cfg.data, cfg.rfe, cfg.gbdt, cfg.tune, dp),
    }


def feature_table(ff: FeatureFrame) -> RawFrame:
    """A feature frame as the stored table: its float32 columns, then the
    label (the reference's ``FeatureFrame.to_pandas``)."""
    X = ff.X.cpu().numpy()
    cols = {name: X[:, j] for j, name in enumerate(ff.feature_names)}
    if ff.y is not None:
        cols[schema.LABEL_COL] = ff.y.cpu().numpy()
    return RawFrame(cols)


def table_features(frame: RawFrame, device: torch.device) -> FeatureFrame:
    """The inverse of `feature_table`: the label column popped, the rest as
    float32 features on ``device``."""
    names = [n for n in frame.columns if n != schema.LABEL_COL]
    X = np.stack([frame[n].astype(np.float32) for n in names], axis=1)
    y = frame[schema.LABEL_COL].astype(np.float32)
    return FeatureFrame(tuple(names), torch.from_numpy(X).to(device), torch.from_numpy(y).to(device))


def _save_plots(store: ObjectStore, key: str, y_test, y_pred, est, selected) -> None:
    """The reference trainer's confusion-matrix and feature-importance
    PNGs next to the model. matplotlib is optional: without it (the card's
    machine has none) the run logs the reference's warning and goes on."""
    try:
        from cobalt_smart_lender_ai_tpu_torch.io.plots import (
            render_confusion_matrix,
            render_feature_importance,
        )

        cm = confusion_matrix(y_test, y_pred).cpu().numpy()
        gains, _ = gain_importances(est.forest.to("cpu"), len(selected))
        store.put_bytes(key + ".confusion_matrix.png", render_confusion_matrix(cm))
        store.put_bytes(
            key + ".feature_importance.png",
            render_feature_importance(selected, gains.numpy()),
        )
    except Exception as exc:
        logger.warning("plot artifacts skipped (%s)", exc)


def _raw_table(raw, store: ObjectStore | None, cfg: PipelineConfig):
    """The raw table given, else the store's ``data.raw_key``."""
    if raw is not None:
        return raw
    if store is None:
        raise ValueError("provide a raw frame or an object store")
    return store.load_frame(cfg.data.raw_key)


def _persist(
    store: ObjectStore,
    ckpt: PipelineCheckpoint | None,
    stage: str,
    fingerprint: str,
    tables: dict[str, RawFrame],
    written: dict[str, Any],
    extra: dict[str, Any] | None = None,
) -> None:
    """Write a stage's tables as CSV under their keys (what
    ``store.save_frame`` writes) and, with checkpoints, the stage's manifest
    pinning them; adds the wall seconds and ``{key: size}`` to ``written``'s
    ``"seconds"`` and ``"bytes"``."""
    t0 = time.perf_counter()
    sizes = written.setdefault("bytes", {})
    for key, table in tables.items():
        data = frame_to_csv(table)
        store.put_bytes(key, data)
        sizes[key] = len(data)
        del data
    if ckpt is not None:
        ckpt.write(stage, fingerprint=fingerprint, outputs=list(tables), extra=extra)
    written["seconds"] = written.get("seconds", 0.0) + time.perf_counter() - t0


def run_pipeline(
    config: PipelineConfig | None = None,
    raw=None,
    store: ObjectStore | None = None,
    resume: bool | None = None,
    *,
    device: torch.device | str = "cuda",
    today: datetime | None = None,
) -> PipelineResult:
    """Train and publish from the raw table ``raw`` (a `RawFrame`, or any
    frame `tokenize_raw_frame` reads; None reads ``config.data.raw_key``
    from ``store``) on ``device`` (``cuda`` unless the caller asks for
    ``cpu``). ``today`` is the snapshot date of the date -> age features
    (default: the day of the run); pinning it makes a retrain on the same
    table reproducible. With a ``store``, the artifact, its features,
    ``metrics.json`` and the plots are written under
    ``config.serve.model_key``, and each stage is checkpointed; with
    ``resume=True`` (default ``config.reliability.resume``) the stages
    whose manifests validate are restored instead of run.

    The whole run executes under a ``pipeline.run`` span; each stage
    records a child span and a ``cobalt_pipeline_stage_seconds{stage}``
    observation of its `PipelineResult.timings` seconds."""
    with span("pipeline.run", resume=bool(resume)):
        return _run_pipeline(config, raw, store, resume, device, today)


def _run_pipeline(
    config: PipelineConfig | None,
    raw,
    store: ObjectStore | None,
    resume: bool | None,
    device: torch.device | str,
    today: datetime | None,
) -> PipelineResult:
    cfg = config or PipelineConfig()
    # Every run shares the kernel-build cache (COBALT_COMPILE_CACHE=0 opts
    # out) and feeds the cobalt_compile_* telemetry. Idempotent: an entry
    # point that already bootstrapped with its own config wins.
    bootstrap_compile_cache(cfg.compile_cache)
    dev = resolve_device(device)
    rel = cfg.reliability
    resume = rel.resume if resume is None else resume
    timings: dict[str, float] = {}
    launches: dict[str, int] = {}
    stages_run: list[str] = []
    stages_skipped: list[str] = []
    intermediates: dict[str, Any] = {}
    counted = gradient_histogram_channels.launches

    def tick(name: str, t0: float) -> float:
        nonlocal counted
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.monotonic()  # the tracer's clock
        timings[name] = t - t0
        _STAGE_SECONDS.labels(stage=name).observe(t - t0)
        record_span(f"pipeline.{name}", t0, t)
        launches[name] = gradient_histogram_channels.launches - counted
        counted = gradient_histogram_channels.launches
        logger.info("%s done in %.2fs", name, timings[name])
        return t

    if store is not None and rel.wrap_store and not isinstance(store, ResilientStore):
        store = ResilientStore(store, policy_from_config(rel), verify_reads=rel.verify_reads)
    ckpt = (
        PipelineCheckpoint(store, rel.checkpoint_prefix)
        if store is not None and rel.checkpoints
        else None
    )
    # RFE and the search run over the (hp, dp) mesh of the visible devices
    # (`MeshConfig`; one device: the single-device path).
    mesh = make_mesh(cfg.mesh, devices=mesh_devices(dev))
    fp = stage_fingerprints(cfg, mesh)
    fp_clean, fp_engineer, fp_rfe, fp_search = (fp[s] for s in STAGES)
    # A stage is skipped only if every stage upstream of it was.
    can_resume = bool(resume) and ckpt is not None
    skip_clean = can_resume and ckpt.valid("clean", fp_clean)
    skip_engineer = skip_clean and ckpt.valid("engineer", fp_engineer)
    skip_rfe = skip_engineer and ckpt.valid("rfe", fp_rfe)
    skip_search = skip_rfe and ckpt.valid("search", fp_search)

    keep = store is not None and cfg.save_intermediate  # the intermediate tables
    t = time.monotonic()
    if skip_engineer:
        plan = plan_from_json(ckpt.load("engineer")["extra"]["plan"])
        tree_ff = table_features(store.load_frame(cfg.data.tree_key), dev)
        stages_skipped += ["clean", "engineer"]
        logger.info(
            "resume: restored the engineered table (%d rows x %d features) from %s",
            tree_ff.n_rows, tree_ff.n_features, cfg.data.tree_key,
        )
        t = tick("restore", t)
    elif cfg.data.device_pipeline and not skip_clean:
        raw = _raw_table(raw, store, cfg)
        tok = tokenize_raw_frame(raw, today=today)
        t = tick("host_frontier", t)
        ingest = run_device_ingest(
            tok,
            device=dev,
            partitioner=make_partitioner(cfg.data.ingest_shards, device=dev),
            n_bins=cfg.gbdt.n_bins,
            null_col_threshold=cfg.data.null_col_threshold,
            row_null_allowance=cfg.data.row_null_allowance,
            keep_cleaned=keep,
        )
        del tok
        tree_ff, plan = ingest.tree, ingest.plan
        logger.info(
            "device ingest: %d rows, dropped %d null-heavy cols, %d dupes, %d tree features",
            ingest.report.n_rows_out,
            len(ingest.report.dropped_null_columns),
            ingest.report.n_duplicates_removed,
            tree_ff.n_features,
        )
        if keep:
            _persist(store, ckpt, "clean", fp_clean,
                     {cfg.data.cleaned_key: ingest.cleaned}, intermediates)
            _persist(store, ckpt, "engineer", fp_engineer,
                     {cfg.data.tree_key: feature_table(tree_ff),
                      cfg.data.nn_key: feature_table(ingest.nn)},
                     intermediates, extra={"plan": plan_to_json(plan)})
        del ingest
        stages_run += ["clean", "engineer"]
        t = tick("device_ingest", t)
    else:
        # The host path: clean on the host (or restore the cleaned table),
        # then prepare (host) and engineer (numerics on the device).
        if skip_clean:
            cleaned = store.load_frame(cfg.data.cleaned_key)
            stages_skipped.append("clean")
            logger.info("resume: restored the cleaned table from %s", cfg.data.cleaned_key)
        else:
            raw = _raw_table(raw, store, cfg)
            cleaned, report = clean_raw_frame(raw, null_col_threshold=cfg.data.null_col_threshold)
            del raw
            logger.info(
                "cleaned: %d rows, dropped %d null-heavy cols, %d dupes",
                report.n_rows_out,
                len(report.dropped_null_columns),
                report.n_duplicates_removed,
            )
            if keep:
                _persist(store, ckpt, "clean", fp_clean, {cfg.data.cleaned_key: cleaned},
                         intermediates)
            stages_run.append("clean")
            t = tick("clean", t)
        prepared = prepare_cleaned_frame(
            cleaned, today=today, row_null_allowance=cfg.data.row_null_allowance
        )
        del cleaned
        tree_ff, nn_ff, plan = engineer_features(prepared, device=dev)
        del prepared
        if keep:
            _persist(store, ckpt, "engineer", fp_engineer,
                     {cfg.data.tree_key: feature_table(tree_ff),
                      cfg.data.nn_key: feature_table(nn_ff)},
                     intermediates, extra={"plan": plan_to_json(plan)})
        del nn_ff
        stages_run.append("engineer")
        t = tick("engineer", t)

    # The hashed split is stateless: recomputed on every run, resumed or not.
    ff = drop_training_leakage(tree_ff)
    del tree_ff
    X_train, X_test, y_train, y_test = train_test_split_hashed(
        ff.X, ff.y, test_fraction=cfg.data.test_fraction, seed=cfg.data.split_seed
    )
    n_pos = float(y_train.sum())
    spw = (float(X_train.shape[0]) - n_pos) / max(n_pos, 1.0)
    logger.info(
        "split: %d train / %d test, scale_pos_weight=%.3f",
        X_train.shape[0], X_test.shape[0], spw,
    )

    support = None
    if skip_rfe:
        extra = ckpt.load("rfe")["extra"]
        if extra.get("feature_names") == list(ff.feature_names):
            support = np.zeros(len(ff.feature_names), dtype=bool)
            support[np.asarray(extra["support_idx"], dtype=int)] = True
            selected = tuple(extra["selected"])
            stages_skipped.append("rfe")
            logger.info("resume: restored the RFE selection (%d features)", len(selected))
        else:  # the engineered columns drifted from under the manifest
            skip_rfe = skip_search = False
    if support is None:
        rfe = rfe_select(
            X_train, y_train, dataclasses.replace(cfg.rfe, scale_pos_weight=spw), device=dev,
            mesh=mesh,
        )
        support = rfe.support_
        selected = tuple(n for n, keep in zip(ff.feature_names, support) if keep)
        logger.info("RFE selected %d features: %s", len(selected), selected)
        if ckpt is not None:
            ckpt.write(
                "rfe",
                fingerprint=fp_rfe,
                extra={
                    "support_idx": np.flatnonzero(support).tolist(),
                    "selected": list(selected),
                    "feature_names": list(ff.feature_names),
                    "scale_pos_weight": spw,
                },
            )
        stages_run.append("rfe")
        t = tick("rfe", t)

    # The search and the final model see the selected columns only.
    sel_idx = torch.from_numpy(np.flatnonzero(support)).to(dev)
    Xtr_sel = X_train.index_select(1, sel_idx)
    Xte_sel = X_test.index_select(1, sel_idx)
    del X_train, X_test, ff
    base = cfg.gbdt.replace(scale_pos_weight=spw)
    if skip_search:
        # The search is checkpointed as its best params; the final model is
        # the refit that `randomized_search` itself makes after CV.
        extra = ckpt.load("search")["extra"]
        best_params = dict(extra["best_params"])
        est = GBDTClassifier(base.replace(**best_params), device=dev).fit(Xtr_sel, y_train)
        search = SearchResult(
            best_params_=best_params,
            best_score_=float(extra["cv_auc"]),
            best_estimator_=est,
            cv_results_={},
        )
        stages_skipped.append("search")
        logger.info("resume: restored best params %s, refit only", best_params)
        t = tick("refit", t)
    else:
        search = randomized_search(Xtr_sel, y_train, base, cfg.tune, device=dev, mesh=mesh)
        if ckpt is not None:
            ckpt.write(
                "search",
                fingerprint=fp_search,
                extra={"best_params": search.best_params_, "cv_auc": float(search.best_score_)},
            )
        stages_run.append("search")
        t = tick("search", t)
    logger.info("search best CV AUC %.4f with %s", search.best_score_, search.best_params_)

    est = search.best_estimator_
    test_auc = float(roc_auc(y_test, est.predict_margin(Xte_sel)))
    y_pred = est.predict(Xte_sel)
    metrics = {
        # The reference trainer's metrics.json schema.
        "auc": test_auc,
        "classification_report": binary_classification_report(y_test, y_pred),
        "best_params": search.best_params_,
    }
    logger.info("test ROC-AUC %.4f", test_auc)
    stages_run.append("eval")
    t = tick("eval", t)

    artifact = GBDTArtifact(
        forest=est.forest,
        feature_names=selected,
        bin_edges=est.bin_spec.edges.cpu().numpy(),
        plan=plan,
        config={
            "best_params": search.best_params_,
            "scale_pos_weight": spw,
            "split_seed": cfg.data.split_seed,
        },
        metrics=metrics,
    )
    if store is not None:
        key = cfg.serve.model_key
        artifact.save(store, key)
        save_metrics(store, key + ".metrics.json", metrics)
        _save_plots(store, key, y_test, y_pred, est, selected)
        logger.info("artifact persisted at %s", key)

    return PipelineResult(
        selected_features=selected,
        best_params=search.best_params_,
        cv_auc=float(search.best_score_),
        test_auc=test_auc,
        metrics=metrics,
        artifact=artifact,
        search=search,
        scale_pos_weight=spw,
        timings=timings,
        hist_launches=launches,
        stages_run=tuple(stages_run),
        stages_skipped=tuple(stages_skipped),
        intermediates=intermediates,
    )


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--store", default=None, help="object-store root (a local directory)")
    parser.add_argument(
        "--synthetic-rows",
        type=int,
        default=0,
        help="train on a synthetic raw LendingClub table of this many loans",
    )
    parser.add_argument("--seed", type=int, default=0, help="seed of the synthetic table")
    parser.add_argument(
        "--quick",
        action="store_true",
        help="the reference's slim profile: RFE in steps of 20 with a 20-tree "
        "depth-3 selector and a 4 x 2 search in 'auto' chunks (successive "
        "halving wherever a chunk is shorter than the fit)",
    )
    parser.add_argument(
        "--no-halving",
        action="store_true",
        help="exhaustive search (every candidate trained to its full "
        "n_estimators) instead of the successive-halving scheduler",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="cuda (the default; the CUDA kernels) or cpu (their plain versions)",
    )
    parser.add_argument(
        "--resume",
        action="store_true",
        help="skip the stages whose checkpoint manifests still validate (restart "
        "from the last good stage instead of the raw data)",
    )
    parser.add_argument(
        "--pandas-ingest",
        action="store_true",
        help="clean, prepare and engineer on the host path instead of the device "
        "ingest (the reference's pandas path; here it runs without pandas, its "
        "numerics on the device)",
    )
    parser.add_argument(
        "--ingest-shards",
        type=int,
        default=1,
        help="row shards for the device ingest's feature-assembly / binning "
        "programs: 1 = one device, -1 = every visible device (clamped to the host)",
    )
    parser.add_argument(
        "--ledger-out",
        default=None,
        help="write a run ledger (JSON: config fingerprint, env/devices, stage "
        "durations, search rungs, kernel cost table) to this path; render it "
        "with the reference's tools/obs_report.py",
    )
    parser.add_argument(
        "--trace-out",
        default=None,
        help="write the run's stage spans as Chrome Trace Event / Perfetto JSON "
        "to this path (open in ui.perfetto.dev)",
    )
    return parser.parse_args(argv)


def main(argv: Sequence[str] | None = None) -> PipelineResult:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s [%(levelname)s] %(message)s")
    bootstrap_compile_cache()
    dev = resolve_device(args.device)
    cfg = quick_config() if args.quick else PipelineConfig()
    if args.no_halving:
        cfg = dataclasses.replace(cfg, tune=dataclasses.replace(cfg.tune, halving_enabled=False))
    if args.pandas_ingest or args.ingest_shards != 1:
        cfg = dataclasses.replace(
            cfg,
            data=dataclasses.replace(
                cfg.data, device_pipeline=not args.pandas_ingest, ingest_shards=args.ingest_shards
            ),
        )
    raw = None
    if args.synthetic_rows:
        from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame

        raw = synthetic_lendingclub_frame(args.synthetic_rows, seed=args.seed)
    store = ObjectStore(args.store) if args.store else None
    ledger = None
    if args.ledger_out:
        # The kernel and device families on the process registry up front,
        # so the ledger's metrics snapshot carries them too.
        install_program_metrics()
        install_device_metrics()
        ledger = RunLedger(
            "pipeline",
            fingerprint=stage_fingerprints(cfg, make_mesh(cfg.mesh, devices=mesh_devices(dev)))[
                "search"
            ],
            meta={
                "quick": bool(args.quick),
                "halving": not args.no_halving,
                "synthetic_rows": int(args.synthetic_rows),
                "seed": int(args.seed),
                "resume": bool(args.resume),
                "pandas_ingest": bool(args.pandas_ingest),
                "store": args.store,
                "device": str(dev),
            },
        )
    result = run_pipeline(cfg, raw=raw, store=store, resume=args.resume, device=dev)
    if ledger is not None:
        ledger.add_stages(result.timings)
        ledger.set(
            "final_metrics",
            {
                "test_auc": result.test_auc,
                "cv_auc": result.cv_auc,
                "best_params": result.best_params,
                "n_selected": len(result.selected_features),
            },
        )
        halving_report = result.search.cv_results_.get("halving")
        if halving_report is not None:
            ledger.set("search_halving", halving_report)
        ledger.set(
            "stages_run",
            {"run": list(result.stages_run), "skipped": list(result.stages_skipped)},
        )
        ledger.write(args.ledger_out)
        logger.info("run ledger written to %s", args.ledger_out)
    if args.trace_out:
        with open(args.trace_out, "w") as fh:
            fh.write(render_chrome_trace(default_tracer()))
        logger.info("perfetto trace written to %s", args.trace_out)
    print(
        {
            "test_auc": result.test_auc,
            "cv_auc": result.cv_auc,
            "best_params": result.best_params,
            "n_selected": len(result.selected_features),
            "timings": result.timings,
            "hist_launches": result.hist_launches,
            "stages_run": result.stages_run,
            "stages_skipped": result.stages_skipped,
        }
    )
    return result


if __name__ == "__main__":
    main()
