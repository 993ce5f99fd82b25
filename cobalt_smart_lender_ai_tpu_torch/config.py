"""Configuration: the GBDT hyperparameters (`GBDTConfig`), the challengers'
(`MLPConfig`, `FTTransformerConfig`), the training protocol's
(`DataConfig`, `RFEConfig`, `TuneConfig`, `ReliabilityConfig`, `MeshConfig`,
`PipelineConfig`), the kernel-build cache's (`CompileCacheConfig`) and the subset of the reference `ServeConfig` that the
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
    #: Clean, prepare and engineer on the device (`data.device_pipeline`);
    #: False runs the host path (`data.clean.clean_raw_frame`,
    #: `data.features.prepare_cleaned_frame` and `engineer_features`), as the
    #: CLI's ``--pandas-ingest`` does.
    device_pipeline: bool = True
    #: Row shards of the device ingest's row-wise programs (feature assembly,
    #: bin transform): 1 = one device, -1 = every visible device, N is
    #: clamped to the visible devices (`parallel.partitioner.make_partitioner`).
    ingest_shards: int = 1


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
class MLPConfig:
    """The MLP challenger: the reference's Keras Sequential 128/32/16/1
    network (`notebooks/04_model_training.ipynb` cell 39)."""

    hidden_sizes: Sequence[int] = (128, 32, 16)
    l2: float = 1e-4
    learning_rate: float = 1e-3
    lr_decay_rate: float = 0.9
    lr_decay_steps: int = 1000
    weight_decay: float = 1e-4
    batch_size: int = 1024
    epochs: int = 30
    early_stop_patience: int = 5
    early_stop_metric: str = "val_auc"
    #: None balances the classes (``n_neg / n_pos``).
    positive_class_weight: float | None = None
    #: Epochs between two host reads of the loss history (the results are
    #: the same for any value).
    epochs_per_dispatch: int = 8
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class FTTransformerConfig:
    """FT-Transformer on numeric and label-coded categorical columns."""

    d_token: int = 64
    n_blocks: int = 3
    n_heads: int = 8
    ffn_mult: int = 2
    dropout: float = 0.1
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    batch_size: int = 1024
    epochs: int = 20
    #: Rows per validation and scoring chunk: attention holds a (rows,
    #: heads, tokens, tokens) tensor.
    eval_batch_rows: int = 16384
    #: Epochs between two host reads of the loss history (the results are
    #: the same for any value).
    epochs_per_dispatch: int = 2
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (`parallel.mesh.make_mesh`). ``dp`` shards the row
    axis (each shard sums its rows' histograms and leaf sums, reduced
    across shards); ``hp`` shards the (candidate, fold) job axis of the
    search."""

    dp: int = -1  # -1 => all remaining devices
    hp: int = 1
    axis_dp: str = "dp"
    axis_hp: str = "hp"


@dataclasses.dataclass(frozen=True)
class ReliabilityConfig:
    """The store's retry policy, the pipeline's stage checkpoints, and the
    serving SHAP degrade, request deadline, admission and circuit-breaker
    limits: the reference's ``ReliabilityConfig``, field for field."""

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
    #: When the SHAP kernel cannot take the model's shape (see
    #: `ops.score.shap_supported`), serve probabilities with
    #: ``"shap_values": null`` and a ``degraded`` flag instead of refusing to
    #: start. A kernel that fails to build or launch is never degraded: it
    #: fails startup or the request.
    degrade_shap: bool = True
    #: Per-request wall-clock budget, checked at cooperative checkpoints
    #: (``DeadlineExceeded`` -> HTTP 504). ``None`` disables deadlines.
    request_deadline_s: float | None = 30.0
    #: Token-bucket admission rate for scoring requests (requests/second,
    #: sustained). ``None`` disables rate limiting.
    rate_limit_rps: float | None = None
    #: Burst capacity of the admission token bucket.
    rate_limit_burst: int = 16
    #: Cap on concurrently executing scoring requests; excess load is shed as
    #: HTTP 429 with ``Retry-After``. ``None`` disables the cap.
    max_in_flight: int | None = 64
    #: ``Retry-After`` (seconds) of a request shed at the in-flight cap (the
    #: rate limiter computes its own from the bucket's deficit).
    shed_retry_after_s: float = 1.0
    #: Circuit breaker over the service's store restores (startup, hot
    #: reload): consecutive failures to trip open, seconds until a half-open
    #: probe, and how many probes may fly at once.
    breaker_failure_threshold: int = 5
    breaker_reset_s: float = 30.0
    breaker_half_open_max: int = 1


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
    #: Row shards of bulk scoring (`parallel.partitioner`): each bulk chunk
    #: of ``bulk_shards * bucket`` rows is split row-wise over the shards,
    #: one scoring launch each. 0/1 = one device; -1 = every visible device;
    #: N is clamped to the visible device count. Single-row scoring and the
    #: micro-batcher stay on one device.
    bulk_shards: int = 1
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
    #: Flight recorder (telemetry.flight, served at ``GET /debug/*``):
    #: ring capacity, the always-capture slow threshold, and the size of
    #: the top-K-by-latency board.
    flight_capacity: int = 256
    flight_slow_threshold_ms: float = 100.0
    flight_top_k: int = 32
    #: Event journal (telemetry.events, served at ``GET /events``): bounded
    #: ring of typed control-plane events (reloads, breaker trips, canary
    #: promotions, rejections and rollbacks) with causal links.
    #: ``events_ship_interval_s`` only matters when a durable store is
    #: attached; <= 0 disables shipping.
    events_capacity: int = 512
    events_ship_interval_s: float = 30.0
    #: Telemetry history (telemetry.timeseries, served at ``GET /history``
    #: and ``GET /dashboard``): a sampler scrapes the service's registry
    #: (a fleet's: every registry, merged) every ``history_interval_s`` into
    #: tiered downsampled rings of (bucket width s, capacity) — counter
    #: rates, per-window histogram quantiles, gauges — all bounded memory.
    #: Its thread starts with the HTTP server, never in bare construction.
    history_enabled: bool = True
    history_interval_s: float = 10.0
    history_tiers: tuple[tuple[float, int], ...] = (
        (10.0, 360),
        (60.0, 720),
        (600.0, 1008),
    )
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
    #: Continuous-training loop (io.model_registry + serve.canary). Opt-in:
    #: a store without a model registry has nothing to canary. When
    #: enabled, `ScorerService.from_store` serves the registry's ``latest``
    #: channel for ``model_name``, loads any published ``canary`` beside
    #: the champion, and shadow-scores a slice of single-row traffic
    #: through it (the canary's result is never returned to the caller).
    canary_enabled: bool = False
    model_name: str = "gbdt"
    registry_prefix: str = "registry"
    #: Fraction of validated single-row requests shadow-scored through the
    #: canary (deterministic stride sampling, no RNG on the request path).
    canary_sample_rate: float = 1.0
    #: The gate judges the most recent ``canary_window`` shadowed requests
    #: and needs ``canary_min_samples`` of them.
    canary_window: int = 2048
    canary_min_samples: int = 50
    #: Promotion gate thresholds: rank correlation of canary vs champion
    #: scores (labels do not exist at serve time; a label-shuffled
    #: candidate scores ~0), mean absolute score delta, mean shadow over
    #: mean champion dispatch seconds, and canary failures over sampled
    #: requests.
    canary_min_score_corr: float = 0.5
    canary_max_score_delta: float = 0.25
    canary_max_latency_ratio: float = 5.0
    canary_max_error_ratio: float = 0.05
    #: After a promotion, an SLO fast burn within this many seconds demotes
    #: ``latest`` back to ``previous``.
    promotion_guard_window_s: float = 300.0
    #: Drift (telemetry.drift, ``GET /drift``): per-feature PSI of the live
    #: shadow-tap sketch against the training snapshot in the registry
    #: provenance; over ``drift_psi_alert`` on any feature (with at least
    #: ``drift_min_samples`` live rows) raises the alarm and fires the
    #: canary controller's ``on_drift`` hook once.
    drift_bins: int = 10
    drift_psi_alert: float = 0.25
    drift_min_samples: int = 100
    #: Content-hash score cache for repeated single-row payloads: an LRU of
    #: this many entries keyed by the canonicalized feature vector's bytes,
    #: emptied on every hot reload. 0 disables.
    score_cache_size: int = 2048
    #: Shared-nothing `ScorerService` replicas behind the least-loaded router
    #: (`serve.replicas.ReplicaSet`): each owns its pack, micro-batcher and
    #: registry. 1 = the plain single-service path.
    replicas: int = 1
    #: Place replica i on ``cuda:(i % cards)`` when the host has several
    #: cards; on one card (or the CPU) every replica shares the device.
    replica_devices: bool = True
    #: Fleet supervision (`serve.supervisor`): a per-replica error-rate EWMA
    #: walks healthy -> degraded -> quarantined; a quarantined replica is
    #: drained, rebuilt from the served artifact (warmed and smoke-checked as
    #: a reload candidate) and readmitted. The probe loop starts with the
    #: HTTP server.
    supervisor_enabled: bool = True
    #: Probe-loop cadence and each smoke probe's wall-clock budget (the
    #: zeros row through the replica's own batcher).
    supervisor_probe_interval_s: float = 1.0
    supervisor_probe_deadline_s: float = 2.0
    #: Consecutive failed probes before a replica is quarantined.
    supervisor_probe_failures: int = 2
    #: EWMA smoothing and state thresholds over replica-internal failures
    #: (typed 422/429/504 never count). With alpha 0.2, 2 failures in a row
    #: degrade and 5 quarantine.
    supervisor_ewma_alpha: float = 0.2
    supervisor_degraded_ewma: float = 0.3
    supervisor_quarantine_ewma: float = 0.6
    supervisor_recover_ewma: float = 0.1
    #: Queue-age watchdog: a queue head older than this means a wedged worker.
    supervisor_queue_age_limit_s: float = 5.0
    #: Bounded wait for a quarantined replica's in-flight requests.
    supervisor_drain_timeout_s: float = 5.0
    #: Hedged failover: a single row that fails replica-internally is retried
    #: once on another replica inside the caller's deadline.
    hedge_enabled: bool = True
    #: `ReplicaSet.close` closes the replicas together, bounded by this.
    replica_close_timeout_s: float = 5.0
    #: Brownout ladder (`serve.autoscaler.BrownoutLadder`): drop canary taps
    #: -> serve without SHAP -> widen coalescing -> shed bulk -> shed all.
    #: ``brownout_max_level`` caps how far it may go (2 never sheds).
    brownout_enabled: bool = True
    brownout_max_level: int = 3
    #: The fleet's load control (`serve.autoscaler.FleetAutoscaler`): a loop
    #: off the request path that reads SLO burn, the fleet history's
    #: per-replica queue-wait p95, admission utilization and queue depth,
    #: and acts: scale up (a new replica built from the served artifact,
    #: warmed and smoke-checked), retune coalescing, step the brownout
    #: ladder, or retire the tail replica. Opt-in; its thread starts with
    #: the HTTP server.
    autoscaler_enabled: bool = False
    autoscaler_interval_s: float = 1.0
    #: Fleet size bounds (`remove_replica` also never retires the last
    #: routable replica).
    autoscaler_min_replicas: int = 1
    autoscaler_max_replicas: int = 4
    #: Hysteresis: react fast to overload, retire slowly — no scale-up
    #: within the scale-up cooldown of the last one; a retire needs
    #: ``autoscaler_stable_ticks`` idle evaluations in a row and the
    #: scale-down cooldown past both the last retire and the last scale-up.
    autoscaler_scale_up_cooldown_s: float = 5.0
    autoscaler_scale_down_cooldown_s: float = 15.0
    autoscaler_stable_ticks: int = 3
    #: Busy: SLO fast burn, queue-wait p95 at or over the high mark, or
    #: admission utilization at or over its high fraction. Idle: every
    #: signal at or under its low mark and nothing queued.
    autoscaler_queue_wait_high_ms: float = 20.0
    autoscaler_queue_wait_low_ms: float = 2.0
    autoscaler_util_high: float = 0.75
    autoscaler_util_low: float = 0.25
    #: Load-dependent coalescing, published under the batcher's pause gate:
    #: busy (or brownout rung 3) widens the window and the batch; idle
    #: restores ``microbatch_max_wait_ms`` / ``microbatch_max_rows``.
    autoscaler_retune_enabled: bool = True
    autoscaler_busy_wait_ms: float = 5.0
    autoscaler_busy_max_rows: int = 256
    #: Admission (rate limit, in-flight cap) and the store's circuit breaker.
    reliability: ReliabilityConfig = dataclasses.field(default_factory=ReliabilityConfig)


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
    #: Sibling subtraction in the selector's refits (as
    #: GBDTConfig.hist_subtract); a dp mesh of more than one shard runs
    #: direct histograms whatever it says, so False makes a one-device run
    #: split for split the dp run's.
    hist_subtract: bool = True

    def __post_init__(self):
        _check_chunk_trees(self.chunk_trees)


@dataclasses.dataclass(frozen=True)
class CompileCacheConfig:
    """The kernel-build cache (`compilecache.bootstrap_compile_cache`): where
    the nvcc libraries (`ops._build`) and the g++ reader (`native`) are kept
    between processes. The port's counterpart of the reference's persistent
    XLA compile cache, on by default for every entry point. Opt out per
    process with ``COBALT_COMPILE_CACHE=0``: the libraries then build into a
    directory private to the process, so every process compiles.
    """

    enabled: bool = True
    #: Cache directory; ``None`` keeps the package's ``_build/``.
    cache_dir: str | None = None
    #: Keep in the shared directory only libraries whose build took at least
    #: this long (``COBALT_COMPILE_CACHE_MIN_SECS`` overrides). 0.0, not the
    #: reference's 5 s: the g++ reader builds in a few seconds and an nvcc
    #: library may too, so a 5 s floor would rebuild them in every process.
    min_compile_time_secs: float = 0.0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Everything `pipeline.run_pipeline` reads."""

    #: Write the cleaned, tree and nn tables to the store (with a store).
    save_intermediate: bool = True
    compile_cache: CompileCacheConfig = dataclasses.field(default_factory=CompileCacheConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    gbdt: GBDTConfig = dataclasses.field(default_factory=GBDTConfig)
    mlp: MLPConfig = dataclasses.field(default_factory=MLPConfig)
    ft: FTTransformerConfig = dataclasses.field(default_factory=FTTransformerConfig)
    tune: TuneConfig = dataclasses.field(default_factory=TuneConfig)
    rfe: RFEConfig = dataclasses.field(default_factory=RFEConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    reliability: ReliabilityConfig = dataclasses.field(default_factory=ReliabilityConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
