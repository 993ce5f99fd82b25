"""Configuration: the GBDT hyperparameters (`GBDTConfig`), the training
protocol's (`DataConfig`, `RFEConfig`, `TuneConfig`, `ReliabilityConfig`,
`PipelineConfig`) and the subset of the reference `ServeConfig` that the
port's scoring service reads. Each keeps the reference's field names and
defaults for the fields the port reads."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Where the protocol's tables live in the object store, how the raw
    table is cleaned, and how the engineered table is split into training
    and held-out rows (the reference trainer's 80/20 split, seed 22)."""

    raw_key: str = "dataset/1-raw/raw.csv"
    cleaned_key: str = "dataset/2-intermediate/cleaned_01.csv"
    tree_key: str = "dataset/2-intermediate/cleaned_02_tree.csv"
    nn_key: str = "dataset/2-intermediate/cleaned_02_nn.csv"
    test_fraction: float = 0.2
    split_seed: int = 22
    #: Drop a cleaned column more than this percentage missing.
    null_col_threshold: float = 70.0
    #: Drop a prepared row missing more than this many live columns.
    row_null_allowance: int = 20


def _check_chunk_trees(ct: Any) -> None:
    if ct == "auto":
        return
    if ct is not None and (isinstance(ct, bool) or not isinstance(ct, int) or ct <= 0):
        raise ValueError(f"chunk_trees must be None, 'auto' or a positive int, got {ct!r}")


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    """Histogram-GBDT hyperparameters, with the reference's fields and
    defaults (XGBClassifier's, as the reference training script uses them)."""

    n_estimators: int = 100
    max_depth: int = 6
    learning_rate: float = 0.3
    subsample: float = 1.0
    colsample_bytree: float = 1.0
    gamma: float = 0.0  # min split gain
    reg_lambda: float = 1.0
    min_child_weight: float = 1.0
    n_bins: int = 255  # quantile bins per feature; bin 0 reserved for missing
    scale_pos_weight: float = 1.0
    seed: int = 42
    #: Boosting rounds per chunk of the fit (margins carried between chunks,
    #: bit-identical to one chunk: `models.gbdt.fit_binned_chunked`). None
    #: fits in one chunk; ``"auto"`` derives the chunk from the workload's
    #: shape against the reference's dispatch budget
    #: (`parallel.budget.resolve_chunk_trees`).
    chunk_trees: int | str | None = None
    #: Sibling-subtraction histograms: left children built, right = parent -
    #: left.
    hist_subtract: bool = True

    def __post_init__(self):
        _check_chunk_trees(self.chunk_trees)

    def replace(self, **kw: Any) -> "GBDTConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving contract: bind address, model key, batching and request bounds."""

    host: str = "0.0.0.0"
    port: int = 8000
    model_key: str = "models/gbdt/model_tree"
    #: Bulk scoring pads each chunk to a power-of-two row bucket and chunks
    #: anything larger than ``max_batch_rows``.
    max_batch_rows: int = 4096
    #: Bulk-CSV request bounds: payloads over either limit are rejected with a
    #: typed ``PayloadTooLarge`` (HTTP 413) before parse / score. ``None``
    #: disables a bound.
    max_bulk_rows: int | None = 100_000
    max_bulk_bytes: int | None = 16 * 1024 * 1024
    #: Micro-batching: concurrent ``/predict`` callers are coalesced into one
    #: padded bucket launch. The batcher waits ``microbatch_max_wait_ms`` after
    #: the first arrival for more rows, or dispatches once
    #: ``microbatch_max_rows`` are queued.
    microbatch_enabled: bool = True
    microbatch_max_wait_ms: float = 2.0
    microbatch_max_rows: int = 64
    #: Packed forest representation: ``"f32"`` (bit-exact), ``"bf16"`` or
    #: ``"int8"`` (dequantized inside the scoring kernel; gated at startup
    #: against ``ops.score.PRECISION_TOLERANCES``).
    forest_precision: str = "f32"
    #: When the SHAP kernel cannot take the model's shape (see
    #: `ops.score.shap_supported`), serve probabilities with
    #: ``"shap_values": null`` and a ``degraded`` flag instead of refusing to
    #: start. A kernel that fails to build or launch is never degraded: it
    #: fails startup or the request.
    degrade_shap: bool = True
    #: Per-request wall-clock budget, checked at cooperative checkpoints
    #: (``DeadlineExceeded`` -> HTTP 504). ``None`` disables deadlines.
    request_deadline_s: float | None = 30.0
    #: Flight recorder (telemetry.flight, served at ``GET /debug/*``):
    #: ring capacity, the always-capture slow threshold, and the size of
    #: the top-K-by-latency board.
    flight_capacity: int = 256
    flight_slow_threshold_ms: float = 100.0
    flight_top_k: int = 32
    #: SLO engine (telemetry.slo, served at ``GET /slo`` and as
    #: ``cobalt_slo_*`` gauges). Latency thresholds are snapped down to the
    #: nearest histogram bucket bound at evaluation (reported per
    #: objective); availability counts HTTP 5xx as bad.
    slo_enabled: bool = True
    slo_p99_ms: float = 10.0
    slo_p999_ms: float = 100.0
    slo_availability_target: float = 0.999
    slo_windows_s: tuple[float, ...] = (60.0, 3600.0)
    slo_fast_burn_threshold: float = 14.4


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """The randomized search: ``RandomizedSearchCV(n_iter=20,
    cv=StratifiedKFold(3))`` over the reference trainer's literal grid."""

    n_iter: int = 20
    cv_folds: int = 3
    seed: int = 22
    #: Boosting rounds per chunk of every CV job (margins carried between
    #: chunks; the scores do not change). ``"auto"`` derives it per depth
    #: from the reference's dispatch budget (`parallel.budget`). None = one
    #: chunk, so successive halving cannot engage.
    chunk_trees: int | str | None = None
    #: Successive halving over the chunked schedule
    #: (`parallel.tune.successive_halving_search`): at each rung of
    #: `halving_ladder` every live candidate is scored on its carried
    #: margins and the bottom ``1 - 1/halving_eta`` are pruned. Engages only
    #: when some depth chunks and the ladder has ``halving_min_rungs`` rungs;
    #: otherwise, and always when False, the exhaustive search runs.
    halving_enabled: bool = True
    halving_eta: int = 2
    halving_min_rungs: int = 2
    param_space: Mapping[str, Sequence[Any]] = dataclasses.field(
        default_factory=lambda: {
            "n_estimators": (100, 200, 300),
            "max_depth": (3, 5, 7, 9),
            "learning_rate": (0.01, 0.05, 0.1),
            "subsample": (0.8, 1.0),
            "colsample_bytree": (0.5, 0.8, 1.0),
            "gamma": (0.0, 1.0, 5.0),
        }
    )


@dataclasses.dataclass(frozen=True)
class RFEConfig:
    """Recursive feature elimination to exactly ``n_select`` features: the
    reference trainer's ``RFE(XGBClassifier(...), n_features_to_select=20,
    step=1)``, with a lighter selector GBDT."""

    n_select: int = 20
    step: int = 1
    n_estimators: int = 50
    max_depth: int = 6
    scale_pos_weight: float = 1.0
    seed: int = 42
    #: Boosting rounds per chunk of each selector refit (None, ``"auto"`` or
    #: an int; bit-identical to one chunk).
    chunk_trees: int | str | None = None

    def __post_init__(self):
        _check_chunk_trees(self.chunk_trees)


@dataclasses.dataclass(frozen=True)
class ReliabilityConfig:
    """The store's retry policy and the pipeline's stage checkpoints (the
    fields of the reference's ``ReliabilityConfig`` that the pipeline
    reads)."""

    #: Retry policy for store I/O (`reliability.retry.RetryPolicy`).
    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    backoff_multiplier: float = 2.0
    jitter: float = 0.1
    deadline_s: float | None = None
    #: Wrap the pipeline's store in a `ResilientStore` (retries and reads
    #: verified against their content pointers).
    wrap_store: bool = True
    verify_reads: bool = True
    #: Write a manifest after each stage, so a crashed run can resume.
    checkpoints: bool = True
    checkpoint_prefix: str = "checkpoints/"
    #: Restore the stages whose manifests still validate.
    resume: bool = False


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Everything `pipeline.run_pipeline` reads."""

    #: Write the cleaned, tree and nn tables to the store (with a store).
    save_intermediate: bool = True
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    gbdt: GBDTConfig = dataclasses.field(default_factory=GBDTConfig)
    tune: TuneConfig = dataclasses.field(default_factory=TuneConfig)
    rfe: RFEConfig = dataclasses.field(default_factory=RFEConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    reliability: ReliabilityConfig = dataclasses.field(default_factory=ReliabilityConfig)
