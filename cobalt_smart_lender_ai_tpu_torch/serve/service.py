"""The scoring service: restored model, micro-batcher and endpoint handlers.

`ScorerService` restores a `GBDTArtifact`, packs its forest on the serving
device (`_CompiledModel`) and answers the reference API's endpoints as plain
methods returning JSON-shaped dicts; `serve.http_asyncio` is the HTTP shell.

Every scoring call is ONE launch of the fused scoring kernel
(`ops.score.fused_score`): concurrent ``/predict`` callers are coalesced by
the `MicroBatcher` into a power-of-two row bucket scored with SHAP, and
``/predict_bulk_csv`` chunks its rows into buckets scored without;
`ScorerService.shap_bulk`, the offline batch-explain entry point, chunks
them the same way into buckets scored with SHAP. With
``ServeConfig.bulk_shards`` > 1 the bulk chunks go through a
`parallel.partitioner.MeshPartitioner`: ``bucket * n_shards`` rows a
chunk, one launch a shard (the reference's mesh-sharded bulk dispatch). On
``device="cuda"`` the kernel runs or the request fails; only an explicit
``device="cpu"`` runs the plain PyTorch versions.

A SHAP launch that fails at run time does not fail its requests: the same
rows are scored again by the margin-only launch (``walk_kernel`` on the
card), and each answers with ``"shap_values": null`` and ``"degraded":
true``; only a failing margin launch fails them.

Past the happy path, as the reference: the HTTP adapter gates scoring
routes through `ScorerService.admission` (shed -> 429 + ``Retry-After``);
store restores run under `store_breaker` (open -> 503); `reload_from_store`
builds a candidate model off to the side (packed, warmed and smoke-scored
on the service's device) and publishes it under the batcher's pause gate,
or rolls back; repeated single-row payloads are answered from a
content-hash LRU score cache with no launch, emptied on every swap; and a
micro-batch worker that dies fails its queued requests with a typed 500
``worker_dead`` and is restarted.

Telemetry, with the reference's family names, types and labels: each
service owns a `MetricsRegistry` (or uses the one passed as ``registry=``)
holding the request, micro-batch and bulk families, ``cobalt_model_info``,
``cobalt_shap_degraded_total``, the kernel (``cobalt_program_*``), device
and SLO families; ``/readyz``'s micro-batch counters read the registry's
cells. Each request's phases (``validate``, ``queue_wait``, ``dispatch``,
``serialize``) feed ``cobalt_request_phase_seconds`` and the flight
recorder; a ``dispatch`` phase ends when the scores are on the host, so it
holds the card's work. The service's `history` (`telemetry.timeseries`)
samples that registry into tiered rings for ``GET /history`` and
``/dashboard`` once the HTTP server starts it.

The control plane, as the reference's: every reload publish and rollback,
every breaker transition and every canary promotion, rejection and
rollback is one typed event in the service's `EventJournal` (``GET
/events``), and a log line written inside an event's context carries its
``event_id``. With ``ServeConfig.canary_enabled`` the service serves the
model registry's ``latest`` channel and shadow-scores single-row traffic
through the ``canary`` channel's model (`serve.canary`): each shadow row is
one margin-only launch at bucket 1 on the worker of the canary controller,
never part of the caller's response. Responses then carry
``model_version``.

On the card each service owns a CUDA stream (`ScorerService.stream`): its
warm-ups, micro-batches, direct and raw-row launches, bulk chunks, smoke
checks and reload candidates all launch on it, and their results reach the
host from it. So a fleet's replicas never queue behind one another's
launches on the default stream, and each launch's CUDA-event pair (its
program's seconds) spans its own stream's work only.

Behind a `serve.replicas.ReplicaSet` the service is one replica: it reads
the fleet's brownout ladder (`serve.autoscaler`; rung 1 skips the canary
tap, rung 2 launches margin-only and answers ``degraded: true``), and its
micro-batcher runs a chaos checkpoint (`reliability.chaos`) before each
batch's launch when a plan is injected.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import csv
import functools
import io as _io
import math
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.data.device_pipeline import transform_raw_rows
from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import gain_importances
from cobalt_smart_lender_ai_tpu_torch.parallel.partitioner import make_partitioner
from cobalt_smart_lender_ai_tpu_torch.ops.score import (
    fused_score,
    fused_supported,
    pack_forest,
    shap_fits,
    shap_supported,
)
from cobalt_smart_lender_ai_tpu_torch.reliability.admission import admission_from_config
from cobalt_smart_lender_ai_tpu_torch.reliability.breaker import (
    CircuitBreaker,
    breaker_from_config,
)
from cobalt_smart_lender_ai_tpu_torch.reliability.deadline import (
    Deadline,
    await_under_deadline,
    start_deadline,
)
from cobalt_smart_lender_ai_tpu_torch.reliability.errors import (
    CircuitOpenError,
    PayloadTooLarge,
    PromotionRejected,
    RollbackFailed,
    ValidationError,
    WorkerDead,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry import (
    EventJournal,
    FlightRecorder,
    MetricsRegistry,
    SLOEngine,
    TimeSeriesStore,
    add_phase,
    current_request_id,
    default_device_sampler,
    default_objectives,
    default_tracer,
    event_context,
    get_logger,
    install_device_metrics,
    install_program_metrics,
    request_context,
)

_LOG = get_logger("cobalt.serve")

__all__ = [
    "BROWNOUT_SHAP_SHED",
    "SINGLE_INPUT_FIELDS",
    "MicroBatcher",
    "ScorerService",
    "ValidationError",
    "resolve_device",
    "validate_single_input",
]

#: The serving request schema: Python-identifier field names -> canonical
#: (aliased) feature names.
SINGLE_INPUT_FIELDS: dict[str, str] = {
    **{n: n for n in schema.SERVING_FEATURES if " " not in n},
    **schema.SERVING_FIELD_ALIASES,
}
_INT_FIELDS = frozenset(
    field
    for field, canonical in SINGLE_INPUT_FIELDS.items()
    if canonical in schema.SERVING_INT_FEATURES
)

#: Bulk bucket launched once at startup beside the micro-batch buckets, so
#: the margin-only path is built and checked before the first request.
_WARM_BULK_ROWS = 256

#: Rows-per-batch histogram bounds: 1 .. 1024.
_BATCH_ROW_BUCKETS = tuple(float(1 << i) for i in range(11))

#: The SHAP-degrade reason when the brownout ladder's rung 2 sheds SHAP under
#: load: transient by construction, never recorded as the model's
#: ``shap_error``.
BROWNOUT_SHAP_SHED = "brownout: SHAP shed under load"

#: Cells pandas' CSV reader reads as missing by default; the bulk route keeps
#: its response shape without depending on pandas.
_NA_CELLS = frozenset(
    {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
     "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
     "nan", "null"}
)


def validate_single_input(payload: Mapping[str, Any]) -> dict[str, float]:
    """Validate one request body against the 20-field schema, accepting both
    field names and aliases. Returns {canonical feature name: value}."""
    if not isinstance(payload, Mapping):
        raise ValidationError("body must be a JSON object")
    alias_to_field = {v: k for k, v in SINGLE_INPUT_FIELDS.items()}
    row: dict[str, float] = {}
    seen = set()
    for key, value in payload.items():
        field = key if key in SINGLE_INPUT_FIELDS else alias_to_field.get(key)
        if field is None:
            continue  # unknown keys are ignored, as pydantic does
        canonical = SINGLE_INPUT_FIELDS[field]
        if field in seen:
            raise ValidationError(f"duplicate field {key!r}")
        seen.add(field)
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValidationError(f"field {key!r} must be a number")
        if field in _INT_FIELDS and not float(value).is_integer():
            raise ValidationError(f"field {key!r} must be an integer")
        if isinstance(value, float) and not math.isfinite(value):
            raise ValidationError(f"field {key!r} must be finite")
        row[canonical] = float(value)
    missing = [SINGLE_INPUT_FIELDS[f] for f in SINGLE_INPUT_FIELDS if f not in seen]
    if missing:
        raise ValidationError(f"missing fields: {sorted(missing)}")
    return row


class _CompiledModel:
    """One restored artifact packed for the fused kernel on ``device``: the
    pack, the scoring callables, the warmed buckets and the gains.

    The pack is built at ``config.forest_precision`` with the publish gate
    on: a bf16 or int8 forest outside `PRECISION_TOLERANCES` raises here
    and never serves (the gate scores its probe rows with two launches, the
    quantized pack's and its f32 reference's). Construction then launches
    every micro-batch bucket (with SHAP) and one bulk bucket (without) once
    on an all-zeros batch: the kernel is built and checked at startup, and
    a model whose smoke scores are not finite never serves.

    With a ``stream`` (a card service's own), the pack is built, warmed and
    scored on it: `on_stream` makes it current."""

    def __init__(
        self,
        artifact: GBDTArtifact,
        config: ServeConfig,
        device: torch.device,
        stream: torch.cuda.Stream | None = None,
    ):
        self.artifact = artifact
        self.config = config
        self.device = device
        self.stream = stream
        self.feature_names = list(artifact.feature_names)
        self.n_features = len(self.feature_names)
        self._feature_index = {n: i for i, n in enumerate(self.feature_names)}
        # Where the bulk path's rows go (``ServeConfig.bulk_shards``): one
        # device, or the shards of a dp mesh, each chunk then holding
        # ``bucket * n_shards`` rows. Single rows and micro-batches stay on
        # ``device``.
        self.bulk_part = make_partitioner(config.bulk_shards, device=device)
        self.bulk_fns: dict[tuple[int, bool], Callable] = {}
        caller = torch.cuda.current_stream(device) if stream is not None else None
        if stream is not None:
            # The artifact's forest was uploaded on the caller's stream (a
            # restore, or a fleet's shared artifact): this stream reads it
            # only after that upload.
            stream.wait_stream(caller)
        with self.on_stream():
            self._build(artifact, config, device)
        if stream is not None:
            # Only the build reads the artifact's tensors on this stream (the
            # kernel reads the pack, made here): the caller's stream, whose
            # pool holds the artifact's blocks, waits for those reads, so
            # the allocator cannot hand the blocks out early. Unlike
            # `record_stream`, this leaves no pending free behind, so the
            # allocator's counts drop as soon as the artifact is released.
            caller.wait_stream(stream)

    def on_stream(self):
        """The model's stream made current (a no-op without one)."""
        return torch.cuda.stream(self.stream)

    def _build(self, artifact: GBDTArtifact, config: ServeConfig, device: torch.device) -> None:
        forest = artifact.forest.to(device)
        depth = forest.depth
        if not fused_supported(depth):
            raise ValueError(f"the scoring kernel does not take depth {depth}")
        self.pack = pack_forest(forest, self.n_features, config.forest_precision, check=True)
        self.shap_error: str | None = None
        err = None
        if not shap_supported(depth, self.n_features, self.pack.precision):
            err = (
                f"the SHAP kernel does not take depth {depth} with "
                f"{self.n_features} features"
            )
        elif not shap_fits(self.pack):
            err = "the SHAP kernel's fixed-point totals do not hold this forest's phis"
        if err is not None:
            if not config.degrade_shap:
                raise ValueError(err)
            self.shap_error = err
        self.kernel = "score_forest" if device.type == "cuda" else "plain"
        # Score-cache keys are prefixed with the scoring identity (kernel,
        # precision, quantization table), so a reload that changes any of
        # them can never alias an old entry.
        self.cache_salt = f"{self.kernel}:{self.pack.precision}:{self.pack.table_hash}|".encode()
        self.margin_fn = functools.partial(
            fused_score, self.pack, n_features=self.n_features, with_shap=False
        )
        self.shap_fn = (
            None
            if self.shap_error
            else functools.partial(fused_score, self.pack, n_features=self.n_features)
        )
        self.warm_buckets: dict[str, list[int]] = {"shap": [], "margin": []}
        if config.microbatch_enabled:
            cap = self.bucket_of(max(1, config.microbatch_max_rows))
            for i in range(cap.bit_length()):
                self._warm(1 << i, with_shap=self.shap_fn is not None)
        self._warm(self.bucket_of(_WARM_BULK_ROWS), with_shap=False)
        total_gain, _ = gain_importances(forest, self.n_features)
        self.gain = total_gain.cpu().numpy()

    def _warm(self, bucket: int, with_shap: bool) -> None:
        prob, _, _ = self.score(np.zeros((bucket, self.n_features), np.float32), with_shap)
        if not np.isfinite(prob).all():
            raise ValueError("the model scores the all-zeros row to a non-finite value")
        self.warm_buckets["shap" if with_shap else "margin"].append(bucket)

    def bucket_of(self, n: int) -> int:
        """Smallest power of two >= n, capped at max_batch_rows (larger
        requests are chunked)."""
        return min(1 << max(0, n - 1).bit_length(), self.config.max_batch_rows)

    def rows_array(self, rows: Sequence[Mapping[str, float]]) -> np.ndarray:
        """(len(rows), F) float32 matrix from validated request rows; absent
        features are NaN (scored as missing)."""
        x = np.full((len(rows), self.n_features), np.nan, dtype=np.float32)
        index = self._feature_index
        for r, row in enumerate(rows):
            for name, value in row.items():
                i = index.get(name)
                if i is not None:
                    x[r, i] = value
        return x

    def score(
        self, batch: np.ndarray, with_shap: bool
    ) -> tuple[np.ndarray, np.ndarray | None, float | None]:
        """ONE kernel launch over a padded (bucket, F) batch ->
        ``(prob, phis | None, base | None)`` as host arrays. The upload,
        the launch and the copies back run on the model's stream, so the
        host reads only what that launch wrote."""
        with self.on_stream():
            X = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(self.device)
            if with_shap:
                _, prob, phis, base = self.shap_fn(X)
                return prob.cpu().numpy(), phis.cpu().numpy(), float(base)
            _, prob = self.margin_fn(X)
            return prob.cpu().numpy(), None, None

    def score_explained(
        self, batch: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray | None, float | None, str | None]:
        """The /predict scoring of a padded batch: ``(prob, phis, base,
        shap_error)``. With SHAP when the model has it; when the SHAP launch
        raises, the margin-only launch scores the same rows and the error is
        returned instead of phis (degraded). Raises only if that launch fails
        too."""
        if self.shap_fn is None:
            return self.score(batch, with_shap=False)[0], None, None, self.shap_error
        try:
            return (*self.score(batch, with_shap=True), None)
        except Exception as exc:
            error = f"{type(exc).__name__}: {exc}"
        return self.score(batch, with_shap=False)[0], None, None, error

    def _bulk_chunks(self, X: np.ndarray, deadline: Deadline | None):
        """The bulk path's chunking, the reference's: yield ``(start, n,
        bucket, chunk)`` for chunks of ``max_batch_rows * n_shards`` rows,
        each zero-padded to ``bucket * n_shards`` rows, ``bucket`` the
        power-of-two cover of the rows per shard; the deadline (when given)
        is checked before each chunk, the cooperative cancellation point
        between dispatches. With one shard a chunk is ``max_batch_rows``
        rows padded to its power-of-two bucket."""
        N = X.shape[0]
        shards = self.bulk_part.n_shards
        step = self.config.max_batch_rows * shards
        for start in range(0, N, step):
            if deadline is not None:
                deadline.check(f"bulk scoring, row {start}/{N}")
            chunk = X[start : start + step]
            n = chunk.shape[0]
            bucket = self.bucket_of(-(-n // shards))
            total = bucket * shards
            if n < total:
                chunk = np.concatenate([chunk, np.zeros((total - n, X.shape[1]), np.float32)])
            yield start, n, bucket, chunk

    def score_bulk(
        self, chunk: np.ndarray, bucket: int, with_shap: bool, outputs: Sequence[int]
    ) -> list:
        """ONE bulk dispatch over a padded chunk of ``bucket * n_shards``
        rows through `bulk_part`, and the ``outputs`` of ``(margin, prob,
        phis, base)`` it names (by index) on the host. One launch on one
        device (the launch `score` makes), or one per shard, each on its
        shard's stream; the upload and the copies back run on the model's
        stream."""
        key = (bucket, with_shap)
        fn = self.bulk_fns.get(key)
        if fn is None:
            fn = self.bulk_fns.setdefault(key, self.bulk_part.compile_fused(
                self.pack, self.n_features, bucket * self.bulk_part.n_shards, with_shap=with_shap
            ))
        with self.on_stream():
            X = torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(self.device)
            out = fn(X)
            return [float(out[i]) if i == 3 else out[i].cpu().numpy() for i in outputs]

    def predict_margin_bulk(
        self,
        X: np.ndarray,
        deadline: Deadline | None = None,
        observe: Callable[[int, float], None] | None = None,
    ) -> np.ndarray:
        """Raw forest margins for an (N, F) float array: one margin-only
        dispatch per `_bulk_chunks` chunk; ``observe`` as in
        `predict_proba`."""
        X = np.asarray(X, dtype=np.float32)
        out = np.empty((X.shape[0],), dtype=np.float32)
        for start, n, bucket, chunk in self._bulk_chunks(X, deadline):
            t0 = time.perf_counter()
            out[start : start + n] = self.score_bulk(chunk, bucket, False, (0,))[0][:n]
            if observe is not None:
                observe(n, time.perf_counter() - t0)
        return out

    def predict_proba(
        self,
        X: np.ndarray,
        deadline: Deadline | None = None,
        observe: Callable[[int, float], None] | None = None,
    ) -> np.ndarray:
        """P(default) for an (N, F) float array: one margin-only dispatch per
        `_bulk_chunks` chunk (`score_bulk`). ``observe(rows, seconds)`` gets
        each chunk's rows and seconds, the scores on the host."""
        X = np.asarray(X, dtype=np.float32)
        out = np.empty((X.shape[0],), dtype=np.float32)
        for start, n, bucket, chunk in self._bulk_chunks(X, deadline):
            t0 = time.perf_counter()
            out[start : start + n] = self.score_bulk(chunk, bucket, False, (1,))[0][:n]
            if observe is not None:
                observe(n, time.perf_counter() - t0)
        return out

    def shap_bulk(
        self,
        X: np.ndarray,
        deadline: Deadline | None = None,
        observe: Callable[[int, float], None] | None = None,
    ) -> tuple[np.ndarray, float] | None:
        """Bulk SHAP: ``((N, F) contributions, base_value)``, or None while
        SHAP is degraded (no partial attributions). One SHAP dispatch per
        `_bulk_chunks` chunk through `score_bulk`, on the model's stream;
        ``observe`` as in `predict_proba`."""
        if self.shap_fn is None:
            return None
        X = np.asarray(X, dtype=np.float32)
        phis = np.empty((X.shape[0], self.n_features), dtype=np.float32)
        base = 0.0
        for start, n, bucket, chunk in self._bulk_chunks(X, deadline):
            t0 = time.perf_counter()
            chunk_phis, base = self.score_bulk(chunk, bucket, True, (2, 3))
            phis[start : start + n] = chunk_phis[:n]
            if observe is not None:
                observe(n, time.perf_counter() - t0)
        return phis, base


class MicroBatcher:
    """Dynamic micro-batching for the single-row scoring path.

    Concurrent `predict_single` callers enqueue their validated row and a
    future; one worker thread waits ``max_wait_s`` after the first arrival
    for more rows (or until ``max_rows`` are queued), pads the batch to its
    power-of-two bucket, runs ONE fused launch with SHAP, and resolves each
    future with its own row. A request whose deadline expires while queued
    resolves to `DeadlineExceeded` without taking a batch slot; one that
    expires during the launch resolves to it afterwards. A batch whose SHAP
    launch fails is scored margin-only and answered degraded
    (`_CompiledModel.score_explained`, counted in ``degraded_batches``); a
    batch whose margin launch fails too fails its requests; the worker keeps
    running. A worker killed by anything else (a `BaseException`) fails the
    batch in its hand and every queued request with a typed `WorkerDead`
    500 and starts its replacement; `submit` also checks the worker
    (`ensure_worker`), so no request waits on a dead one.

    The counters live in the service's registry (``cobalt_microbatch_*``);
    `stats()` and ``/readyz`` read the same cells. Each request's
    ``queue_wait`` and ``dispatch`` seconds, measured on the worker, ride
    its future back to the request's own context (the worker has none)."""

    def __init__(self, service: "ScorerService", *, max_wait_s: float, max_rows: int):
        self._service = service
        self._max_wait_s = max(0.0, float(max_wait_s))
        self._max_rows = max(1, int(max_rows))
        self._cond = threading.Condition()
        # (row, deadline, future, enqueued_at, request_id): the id is taken
        # at submit, since the worker thread has no request context.
        self._queue: list[tuple] = []
        self._dispatch_lock = threading.Lock()
        self._paused = 0
        self._closed = False
        self._scratch: np.ndarray | None = None  # worker-only padding buffer
        # The chaos checkpoint (`reliability.chaos.ChaosPlan.inject` sets it);
        # None in production, read once per loop iteration.
        self._chaos = None
        # Replaces a dead worker exactly once, when the dying thread and a
        # submitter race `ensure_worker`.
        self._worker_lock = threading.Lock()
        #: Batches whose SHAP launch failed (written by the worker only).
        self.degraded_batches = 0
        reg = service.registry
        self._m_batches = reg.counter(
            "cobalt_microbatch_batches_total",
            "coalesced device dispatches run by the micro-batch scheduler",
        )
        self._m_rows = reg.counter(
            "cobalt_microbatch_rows_total",
            "request rows scored through coalesced micro-batches",
        )
        self._m_batch_rows = reg.histogram(
            "cobalt_microbatch_batch_rows",
            "distribution of coalesced batch sizes (rows per dispatch)",
            buckets=_BATCH_ROW_BUCKETS,
        )
        self._m_coalesce_wait = reg.histogram(
            "cobalt_microbatch_coalesce_wait_seconds",
            "time a request spent queued before its batch dispatched",
        )
        self._m_expired = reg.counter(
            "cobalt_microbatch_expired_total",
            "requests resolved 504 by the batcher, by where the deadline "
            "was detected (queued: before a batch slot; scored: after the "
            "un-interruptible dispatch)",
            ("where",),
        )
        self._m_max_batch = reg.gauge(
            "cobalt_microbatch_max_batch_rows",
            "largest batch coalesced so far (high-water mark)",
        )
        self._m_worker_restarts = reg.counter(
            "cobalt_microbatch_worker_restarts_total",
            "times the watchdog replaced a dead micro-batch worker thread",
        )
        self._m_worker_dead = reg.counter(
            "cobalt_microbatch_worker_dead_total",
            "queued requests failed with typed worker_dead 500s when the "
            "worker thread died",
        )
        reg.gauge(
            "cobalt_microbatch_worker_alive",
            "1 while the micro-batch worker thread is running",
        ).set_function(lambda: float(self.worker_alive()))
        reg.gauge(
            "cobalt_microbatch_queue_depth",
            "requests currently waiting for a batch slot",
        ).set_function(self.queue_depth)
        # Queue depth as a sampled series too: when the device sampler
        # runs, GET /debug/trace draws it as a Perfetto counter track.
        default_device_sampler().add_series("microbatch_queue_depth", self.queue_depth)
        self._start_worker()

    def _start_worker(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True, name="microbatcher")
        self._thread.start()

    @property
    def batches(self) -> int:
        return int(self._m_batches.value)

    @property
    def coalesced_rows(self) -> int:
        return int(self._m_rows.value)

    @property
    def max_batch_rows(self) -> int:
        return int(self._m_max_batch.value)

    @property
    def expired_in_queue(self) -> int:
        return int(self._m_expired.labels(where="queued").value)

    @property
    def closed(self) -> bool:
        return self._closed

    def submit(self, row: Mapping[str, float], deadline: Deadline | None) -> Future:
        """Enqueue one validated row; the future resolves to ``(prob,
        shap_row | None, base | None, shap_error | None, phases)`` (this
        request's ``queue_wait`` and ``dispatch`` seconds) or raises the
        request's error."""
        fut: Future = Future()
        entry = (row, deadline, fut, time.monotonic(), current_request_id())
        self.ensure_worker()  # a dead worker would strand this entry
        with self._cond:
            if self._closed:
                raise RuntimeError("micro-batcher is closed")
            self._queue.append(entry)
            self._cond.notify_all()
        return fut

    def submit_async(self, row: Mapping[str, float], deadline: Deadline | None):
        """Awaitable `submit`, for callers on a running event loop."""
        afut = asyncio.wrap_future(self.submit(row, deadline))
        # A loop-scheduled 504 abandons this future; the worker still resolves
        # it, so retrieve its exception to keep the abandonment silent.
        afut.add_done_callback(lambda f: f.cancelled() or f.exception())
        return afut

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def oldest_queued_age(self) -> float:
        """Seconds the queue head has waited (0.0 when empty): the
        supervisor's queue-age watchdog. A live worker takes the head within
        one coalescing window, so an old head means a wedged worker."""
        with self._cond:
            if not self._queue:
                return 0.0
            return max(0.0, time.monotonic() - self._queue[0][3])

    def worker_alive(self) -> bool:
        """True while the worker thread is running (False after `close`)."""
        return self._thread.is_alive()

    def ensure_worker(self) -> bool:
        """Watchdog: if the worker thread has died, fail every queued future
        with a typed `WorkerDead` 500 and start a replacement. True when it
        restarted the worker."""
        if self._closed or self._thread.is_alive():
            return False
        with self._worker_lock:
            if self._closed or self._thread.is_alive():
                return False
            with self._cond:
                orphans = list(self._queue)
                self._queue.clear()
            self._fail_orphans(orphans, "micro-batch worker died with request queued")
            self._m_worker_restarts.inc()
            _LOG.error(
                "microbatch_worker_dead",
                orphaned=len(orphans),
                restarted=True,
                detected="watchdog",
            )
            self._start_worker()
            return True

    def _fail_orphans(self, orphans: list, detail: str) -> None:
        for entry in orphans:
            if not entry[2].done():
                self._m_worker_dead.inc()
                entry[2].set_exception(WorkerDead(detail))

    @contextlib.contextmanager
    def pause(self):
        """Hold dispatch: requests keep queueing, no batch is collected until
        release (tests use it to pin coalescing)."""
        with self._cond:
            self._paused += 1
        try:
            with self._dispatch_lock:
                yield
        finally:
            with self._cond:
                self._paused -= 1
                self._cond.notify_all()

    def close(self) -> None:
        """Stop the worker after draining the queued requests."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=10.0)
        default_device_sampler().remove_series("microbatch_queue_depth")

    def stats(self) -> dict:
        b = self.batches
        return {
            "batches": b,
            "coalesced_rows": self.coalesced_rows,
            "avg_batch_rows": round(self.coalesced_rows / b, 3) if b else 0.0,
            "max_batch_rows": self.max_batch_rows,
            "expired_in_queue": self.expired_in_queue,
            "degraded_batches": self.degraded_batches,
            "queued": self.queue_depth(),
            "worker_alive": self.worker_alive(),
            "worker_restarts": int(self._m_worker_restarts.value),
        }

    def _collect(self) -> list | None:
        """Block for the first arrival, then hold the window open until
        ``max_rows`` are queued or ``max_wait_s`` elapses. None means closed
        and drained."""
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait()
            if not self._queue:
                return None
            if self._max_wait_s > 0.0 and not self._closed:
                tick_end = time.monotonic() + self._max_wait_s
                while len(self._queue) < self._max_rows and not self._closed:
                    remaining = tick_end - time.monotonic()
                    if remaining <= 0.0:
                        break
                    self._cond.wait(timeout=remaining)
            while self._paused and not self._closed:
                self._cond.wait()
            batch = self._queue[: self._max_rows]
            del self._queue[: self._max_rows]
            return batch

    def _run(self) -> None:
        batch: list = []
        try:
            while True:
                batch = self._collect()
                if batch is None:
                    return
                chaos = self._chaos
                with self._dispatch_lock:
                    try:
                        if chaos is not None:
                            # `ChaosError` fails this batch as any dispatch
                            # error does; `WorkerKilled` (a BaseException)
                            # ends the thread. Both before the launch.
                            chaos.on_dispatch()
                        self._dispatch(batch)
                    except Exception as exc:  # fail this batch, keep serving
                        for entry in batch:
                            if not entry[2].done():
                                entry[2].set_exception(exc)
                batch = []
        except BaseException as exc:
            # Dying with `batch` in hand and the queue intact: strand no
            # future, then let the exception end this thread.
            self._on_worker_death(exc, batch)
            raise

    def _on_worker_death(self, exc: BaseException, batch: list) -> None:
        """On the dying worker's own unwind: fail the in-hand batch and
        everything queued with typed `WorkerDead` 500s, then start the
        replacement (unless `close` stopped the worker)."""
        with self._worker_lock:
            with self._cond:
                orphans = batch + self._queue
                self._queue.clear()
            self._fail_orphans(
                orphans,
                f"micro-batch worker died with request queued ({type(exc).__name__}: {exc})",
            )
            self._m_worker_restarts.inc()
            _LOG.error(
                "microbatch_worker_dead",
                error=f"{type(exc).__name__}: {exc}",
                orphaned=len(orphans),
                restarted=not self._closed,
                detected="unwind",
            )
            if not self._closed:
                self._start_worker()

    def _dispatch(self, batch: list) -> None:
        model = self._service._model
        now = time.monotonic()
        live = []
        for row, dl, fut, enq, rid in batch:
            if dl is not None and dl.expired():
                self._m_expired.labels(where="queued").inc()
                if not fut.done():
                    fut.set_exception(dl.exceeded("queued for micro-batch"))
            else:
                live.append((row, dl, fut, enq, rid))
        if not live:
            return
        n = len(live)
        for entry in live:
            self._m_coalesce_wait.observe(now - entry[3])
        bucket = model.bucket_of(n)
        tracer = default_tracer()
        # The span carries the submitters' request ids: the only link from a
        # batch on this worker thread back to the requests it scored.
        with tracer.span(
            "serve.microbatch_dispatch",
            rows=n,
            bucket=bucket,
            request_ids=[e[4] for e in live if e[4]],
        ):
            scratch = self._scratch
            if scratch is None or scratch.shape[0] < bucket or scratch.shape[1] != model.n_features:
                scratch = self._scratch = np.zeros((bucket, model.n_features), np.float32)
            buf = scratch[:bucket]
            buf[:n] = model.rows_array([e[0] for e in live])
            buf[n:] = 0.0
            shed = self._service._shed_shap()
            with tracer.span("serve.dispatch", rows=n, bucket=bucket) as d_sp:
                if shed:  # brownout rung 2: the margin-only launch
                    probs, phis, base = model.score(buf, with_shap=False)
                    shap_error = BROWNOUT_SHAP_SHED
                else:
                    probs, phis, base, shap_error = model.score_explained(buf)
        dispatch_s = d_sp.duration_s or 0.0
        if phis is None and model.shap_fn is not None and not shed:
            self.degraded_batches += 1
        self._m_batches.inc()
        self._m_rows.inc(n)
        self._m_batch_rows.observe(n)
        self._m_max_batch.set_max(n)
        for i, (_, dl, fut, enq, _) in enumerate(live):
            if fut.done():
                continue
            if dl is not None and dl.expired():
                self._m_expired.labels(where="scored").inc()
                fut.set_exception(dl.exceeded("micro-batch scored"))
                continue
            fut.set_result(
                (
                    float(probs[i]),
                    None if phis is None else phis[i].tolist(),
                    base,
                    shap_error,
                    {"queue_wait": max(0.0, now - enq), "dispatch": dispatch_s},
                )
            )


def _in_executor(func: Callable, *args, **kwargs):
    """Run a blocking callable on the running loop's default executor."""
    loop = asyncio.get_running_loop()
    return loop.run_in_executor(None, functools.partial(func, *args, **kwargs))


def _parse_csv(data: bytes) -> tuple[list[str], list[list[Any]]]:
    """Header and typed columns of a CSV body, typed as pandas' reader types
    them: a column of integers with no missing cell stays int, a numeric
    column is float (missing cells NaN), anything else is str (missing NaN)."""
    try:
        text = data.decode("utf-8-sig")
    except UnicodeDecodeError:
        raise ValidationError("bulk CSV is not UTF-8") from None
    lines = [r for r in csv.reader(_io.StringIO(text)) if r]
    if not lines:
        raise ValidationError("bulk CSV is empty")
    header, body = lines[0], lines[1:]
    cells: list[list[str]] = [[] for _ in header]
    for r in body:
        if len(r) > len(header):
            raise ValidationError(
                f"bulk CSV row has {len(r)} fields, the header {len(header)}"
            )
        for j, col in enumerate(cells):
            col.append(r[j].strip() if j < len(r) else "")
    return header, [_type_column(c) for c in cells]


def _type_column(cells: list[str]) -> list[Any]:
    present = [c for c in cells if c not in _NA_CELLS]
    if len(present) == len(cells):
        try:
            return [int(c) for c in cells]
        except ValueError:
            pass
    try:
        return [math.nan if c in _NA_CELLS else float(c) for c in cells]
    except ValueError:
        return [math.nan if c in _NA_CELLS else c for c in cells]


def _registry_store(store: ObjectStore, cfg: ServeConfig) -> ObjectStore:
    """The store handle registry and channel operations go through: wrapped
    in `ResilientStore` (retries and verified ``.ptr.json`` reads) per the
    reliability config, as `pipeline.run_pipeline` wraps its store."""
    from cobalt_smart_lender_ai_tpu_torch.reliability import ResilientStore, policy_from_config

    rel = cfg.reliability
    if not rel.wrap_store or isinstance(store, ResilientStore):
        return store
    return ResilientStore(store, policy_from_config(rel), verify_reads=rel.verify_reads)


def _resolve_latest_channel(store: ObjectStore, cfg: ServeConfig) -> str | None:
    """Best-effort ``latest``-channel lookup at startup: a store without a
    model registry resolves to None and ``model_key`` is served."""
    from cobalt_smart_lender_ai_tpu_torch.io.model_registry import ModelRegistry

    try:
        return ModelRegistry(_registry_store(store, cfg), prefix=cfg.registry_prefix).resolve(
            cfg.model_name, "latest"
        )
    except Exception:
        return None


class ScorerService:
    """Restored model + fused scorer behind the reference API's endpoints,
    plus `admission` (the adapter gates scoring routes through it),
    `store_breaker` (guards every store restore) and `reload_from_store`
    (hot swap or rollback). Concurrent single-row scoring is coalesced by
    `batcher` (a `MicroBatcher`) when ``ServeConfig.microbatch_enabled``."""

    def __init__(
        self,
        artifact: GBDTArtifact,
        config: ServeConfig | None = None,
        *,
        device: torch.device | str = "cuda",
        store: ObjectStore | None = None,
        clock: Callable[[], float] = time.monotonic,
        breaker: CircuitBreaker | None = None,
        registry: MetricsRegistry | None = None,
    ):
        self.config = config or ServeConfig()
        self.device = resolve_device(device)
        self._clock = clock
        self._store = store
        self._model_key = self.config.model_key
        # A fresh registry per service by default: two services in one
        # process never share counts. Pass ``registry=default_registry()``
        # to scrape them with the process-wide families on one page.
        self.registry = registry if registry is not None else MetricsRegistry()
        rel = self.config.reliability
        self.store_breaker = breaker or breaker_from_config(rel, clock=clock)
        self.admission = admission_from_config(rel, clock=clock)
        # Content-hash score cache: canonicalized row bytes -> (prob, phis,
        # base) of a full response, LRU-bounded, emptied on every swap.
        self._score_cache: collections.OrderedDict[bytes, tuple] = collections.OrderedDict()
        self._score_cache_lock = threading.Lock()
        self._init_metrics()
        self.flight = FlightRecorder(
            capacity=self.config.flight_capacity,
            slow_threshold_s=self.config.flight_slow_threshold_ms / 1000.0,
            top_k=self.config.flight_top_k,
        )
        # The control-plane journal (GET /events): every reload, breaker and
        # canary action this service takes. Durable shipping is attached by
        # the HTTP server (`start_history`) when a store is bound.
        self.journal = EventJournal(
            capacity=self.config.events_capacity,
            ship_interval_s=self.config.events_ship_interval_s,
            registry=self.registry,
        )
        self.store_breaker.on_transition = self._journal_breaker_transition
        self.slo: SLOEngine | None = None
        if self.config.slo_enabled:
            self.slo = SLOEngine(
                self.registry,
                default_objectives(self.config),
                clock=clock,
                windows_s=self.config.slo_windows_s,
                fast_burn_threshold=self.config.slo_fast_burn_threshold,
            )
            self.slo.register_gauges()
        # Telemetry history (GET /history, /dashboard): tiered rings over this
        # service's registry. Built here so the server can serve it; its
        # sampler thread starts with the HTTP server (`start_history`), so a
        # bare in-process service never runs it.
        self.history: TimeSeriesStore | None = None
        if self.config.history_enabled:
            self.history = TimeSeriesStore(
                registry=self.registry,
                interval_s=self.config.history_interval_s,
                tiers=self.config.history_tiers,
            )
        # One reload at a time; requests read `_model` once and never take it.
        self._swap_lock = threading.Lock()
        self._last_reload: dict | None = None
        # The continuous-training loop (serve.canary), attached by
        # `enable_canary`; None keeps the service as it is without one.
        self.canary = None
        # The brownout ladder (`serve.autoscaler`): a `ReplicaSet` gives each
        # replica the fleet's; a bare service keeps None and no rung applies.
        self.brownout = None
        self._model_identity: dict | None = None
        #: The stream every launch of this service goes on (the card only).
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._model = _CompiledModel(artifact, self.config, self.device, self.stream)
        self._model_info_labels = (
            "unversioned", "direct", "none", self._model.pack.precision, self._model.kernel
        )
        self._m_model_info.labels(*self._model_info_labels).set(1.0)
        #: Direct-path requests whose SHAP launch failed at run time.
        self.degraded_direct = 0
        self.batcher: MicroBatcher | None = None
        if self.config.microbatch_enabled:
            self.batcher = MicroBatcher(
                self,
                max_wait_s=self.config.microbatch_max_wait_ms / 1000.0,
                max_rows=min(self.config.microbatch_max_rows, self.config.max_batch_rows),
            )

    @classmethod
    def from_store(
        cls,
        store: ObjectStore,
        config: ServeConfig | None = None,
        *,
        device: torch.device | str = "cuda",
        clock: Callable[[], float] = time.monotonic,
        registry: MetricsRegistry | None = None,
        enable_canary: bool | None = None,
    ) -> "ScorerService":
        """Startup restore of ``config.model_key`` from ``store``, under the
        circuit breaker; the store is kept for `reload_from_store`. The
        device is resolved first, so ``cuda`` without CUDA fails before any
        load.

        With ``canary_enabled`` the model registry's ``latest`` channel (when
        one exists for ``model_name``) overrides ``model_key``, and any
        published ``canary`` is loaded beside the champion for shadow
        scoring. ``enable_canary=False`` keeps the channel resolution but
        attaches no controller."""
        cfg = config or ServeConfig()
        dev = resolve_device(device)
        brk = breaker_from_config(cfg.reliability, clock=clock)
        key = cfg.model_key
        if cfg.canary_enabled:
            key = _resolve_latest_channel(store, cfg) or key
        artifact = brk.call(lambda: GBDTArtifact.load(store, key, dev))
        svc = cls(
            artifact, cfg, device=dev, store=store, clock=clock, breaker=brk, registry=registry
        )
        svc._model_key = key
        if cfg.canary_enabled and enable_canary is not False:
            svc.enable_canary()
        return svc

    # -- hot model swap ---------------------------------------------------------

    def _smoke_check(self, candidate: _CompiledModel) -> None:
        """A candidate must keep the serving feature contract, and its
        margin launch must score the all-zeros row to a probability in
        [0, 1] (a NaN or inf leaf fails here)."""
        current = self._model
        if tuple(candidate.feature_names) != tuple(current.feature_names):
            raise ValueError(
                "feature contract changed: serving "
                f"{len(current.feature_names)} features, candidate has "
                f"{len(candidate.feature_names)} (first difference: "
                f"{sorted(set(candidate.feature_names) ^ set(current.feature_names))[:4]})"
            )
        with candidate.on_stream():
            x = torch.zeros((1, candidate.n_features), dtype=torch.float32, device=self.device)
            prob = float(candidate.margin_fn(x)[1][0])
        if not (math.isfinite(prob) and 0.0 <= prob <= 1.0):
            raise ValueError(f"smoke row scored {prob!r}, expected [0, 1]")

    def reload_from_store(
        self, store: ObjectStore | None = None, model_key: str | None = None
    ) -> dict:
        """Hot model swap: restore ``model_key`` (default: the key being
        served) under the breaker, pack and warm it on this service's device,
        smoke-check it, and publish it. On any failure the previous model
        keeps serving and the result is ``{"status": "rolled_back", ...}``
        (also ``/readyz``'s ``last_reload``). An open circuit raises
        `CircuitOpenError` (503) without recording a rollback."""
        store = store if store is not None else self._store
        if store is None:
            raise RuntimeError(
                "no store bound: construct the service with from_store() or "
                "pass store= explicitly"
            )
        key = model_key or self._model_key
        with self._swap_lock:
            try:
                candidate = self._build_candidate(store, key)
            except CircuitOpenError:
                raise
            except Exception as exc:
                return self._record_rollback(key, exc)
            return self._publish_candidate(candidate, key)

    def _build_candidate(self, store: ObjectStore, key: str) -> _CompiledModel:
        """Restore, pack, warm and smoke-check a candidate off to the side;
        a launch that fails on the card raises here (rollback), never falls
        back to the plain version."""
        artifact = self.store_breaker.call(lambda: GBDTArtifact.load(store, key, self.device))
        candidate = _CompiledModel(artifact, self.config, self.device, self.stream)
        self._smoke_check(candidate)
        return candidate

    def _publish_candidate(self, candidate: _CompiledModel, key: str) -> dict:
        """Publish under the batcher's pause gate: the in-flight batch drains
        against the old model and the next one snapshots the candidate, so
        no batch mixes models. The score cache empties in the same step."""
        gate = self.batcher.pause() if self.batcher is not None else contextlib.nullcontext()
        with gate, self._score_cache_lock:
            self._model = candidate
            self._score_cache.clear()
        self._model_key = key
        self._last_reload = {"status": "ok", "model_key": key, "n_features": candidate.n_features}
        self._m_reloads.labels(status="ok").inc()
        eid = self.journal.emit("reload", "publish", model=key, payload=dict(self._last_reload))
        with event_context(eid):
            _LOG.info("model_reload", **self._last_reload)
        return self._last_reload

    def _record_rollback(self, key: str, exc: Exception) -> dict:
        self._last_reload = {
            "status": "rolled_back",
            "model_key": key,
            "error": f"{type(exc).__name__}: {exc}",
        }
        self._m_reloads.labels(status="rolled_back").inc()
        eid = self.journal.emit(
            "reload",
            "rollback",
            model=key,
            payload=dict(self._last_reload),
            cause={"error": self._last_reload["error"]},
        )
        with event_context(eid):
            _LOG.warning("model_reload", **self._last_reload)
        return self._last_reload

    def close(self) -> None:
        """Stop the canary's worker and the micro-batch worker (queued
        requests drain first; requests arriving afterwards score on their
        own launch), the history sampler, then the journal, which ships its
        tail when a store is attached."""
        if self.canary is not None:
            self.canary.close()
        if self.batcher is not None:
            self.batcher.close()
        if self.history is not None:
            self.history.stop()
        self.journal.stop()

    # -- the control-plane journal ----------------------------------------------

    def start_history(self) -> None:
        """Start the history sampler, attach the bound store to the journal
        and start shipping (idempotent). The HTTP server calls it when its
        socket opens: only a served process samples its history and ships
        its control-plane record."""
        if self.history is not None:
            self.history.start()
        if self._store is not None:
            if self.journal._store is None:
                self.journal.attach_store(self._store)
            self.journal.start()

    def _journal_breaker_transition(self, old: str, new: str) -> None:
        """Breaker state flips -> journal events. Called inside the
        breaker's lock; the journal takes only its own lock and calls
        nothing back."""
        kind = {"closed": "close", "half_open": "half_open", "open": "open"}
        brk = self.store_breaker
        self.journal.emit(
            "breaker",
            kind.get(new, "open"),
            payload={"breaker": brk.name, "from": old, "to": new},
            cause={
                "consecutive_failures": brk.consecutive_failures,
                "opened_count": brk.opened_count,
            },
        )

    def events(
        self,
        *,
        component: str | None = None,
        kind: str | None = None,
        since: float | None = None,
        limit: int | None = None,
    ) -> list[dict]:
        """Filtered journal snapshot: the ``GET /events`` body."""
        return self.journal.events(component=component, kind=kind, since=since, limit=limit)

    # -- the continuous-training loop (serve.canary) ----------------------------

    @property
    def model_info(self) -> dict:
        """Identity of the serving model: `/readyz`'s ``model`` block and
        the ``model_version`` of scoring responses."""
        if self._model_identity is not None:
            return self._model_identity
        return {"version": "unversioned", "channel": "direct", "provenance_md5": None}

    def set_model_info(self, *, version: str, channel: str, provenance_md5: str | None) -> None:
        """Move the ``cobalt_model_info`` gauge to a new identity; the old
        label combination drops to 0, so joins never see two live models."""
        self._model_identity = {
            "version": version,
            "channel": channel,
            "provenance_md5": provenance_md5,
        }
        new_labels = (
            version,
            channel,
            provenance_md5 or "none",
            self._model.pack.precision,
            self._model.kernel,
        )
        self._m_model_info.labels(*self._model_info_labels).set(0.0)
        self._m_model_info.labels(*new_labels).set(1.0)
        self._model_info_labels = new_labels

    def enable_canary(self, on_drift=None) -> "ScorerService":
        """Attach the continuous-training controller (idempotent): stamp the
        serving model's identity from the registry's ``latest`` channel and
        load any published ``canary`` for shadow scoring. A store without a
        registry has nothing to canary yet; that is no error."""
        if self.canary is not None:
            return self
        if self._store is None:
            raise RuntimeError(
                "no store bound: construct the service with from_store() or "
                "pass store= explicitly"
            )
        from cobalt_smart_lender_ai_tpu_torch.serve.canary import CanaryController

        self.canary = CanaryController(
            self,
            _registry_store(self._store, self.config),
            config=self.config,
            clock=self._clock,
            on_drift=on_drift,
        )
        try:
            self.canary.sync_identity()
            self.canary.refresh()
        except Exception as exc:
            _LOG.warning("canary_enable_degraded", error=str(exc))
        return self

    def promote_canary(self, *, force: bool = False) -> dict:
        """``POST /admin/promote``: the gate, the swap, the channel flip."""
        if self.canary is None:
            raise PromotionRejected(
                "canary evaluation is not enabled on this service",
                report={"eligible": False, "reasons": ["canary_not_enabled"]},
            )
        return self.canary.promote(force=force)

    def rollback_model(self, *, reason: str = "manual") -> dict:
        """``POST /admin/rollback``: demote ``latest`` back to ``previous``."""
        if self.canary is None:
            raise RollbackFailed("canary evaluation is not enabled on this service")
        return self.canary.rollback(reason=reason, trigger="manual")

    def drift_report(self) -> dict:
        """``GET /drift``: per-feature PSI against the training snapshot."""
        if self.canary is None:
            return {"status": "disabled"}
        return self.canary.drift_report()

    def _canary_tap(self, row: Mapping[str, float], prob: float, latency_s: float | None) -> None:
        """Hand a scored row to the canary's shadow queue (O(1), never
        raises). Brownout rung 1 skips the tap: advisory bookkeeping is the
        first thing shed under load."""
        if self.canary is None:
            return
        bo = self.brownout
        if bo is not None and bo.level >= 1:
            return
        self.canary.tap(row, prob, latency_s)

    def _shed_shap(self) -> bool:
        """Brownout rung 2 with ``degrade_shap``: score margin-only and
        answer degraded."""
        bo = self.brownout
        return bo is not None and bo.level >= 2 and self.config.degrade_shap

    @property
    def feature_names(self) -> list[str]:
        return self._model.feature_names

    @property
    def artifact(self) -> GBDTArtifact:
        """The served model's artifact."""
        return self._model.artifact

    # -- telemetry --------------------------------------------------------------

    def _init_metrics(self) -> None:
        """Register the service-level families, with the reference's names,
        types and label names, then the kernel and device families. The
        admission controller and breaker keep their own counters; their
        families read them when scraped."""
        reg = self.registry
        self._m_latency = reg.histogram(
            "cobalt_request_latency_seconds",
            "request wall time by route and final HTTP status",
            ("route", "status"),
        )
        self._m_phase = reg.histogram(
            "cobalt_request_phase_seconds",
            "request wall time attributed to each serving phase "
            "(validate / queue_wait / dispatch / shap / serialize)",
            ("phase",),
        )
        self._m_errors = reg.counter(
            "cobalt_request_errors_total",
            "non-2xx responses by route and typed error code",
            ("route", "code"),
        )
        self._m_shap_degraded = reg.counter(
            "cobalt_shap_degraded_total",
            "scorable requests answered without SHAP attributions",
        )
        self._m_reloads = reg.counter(
            "cobalt_model_reloads_total",
            "hot model swap attempts by outcome (ok / rolled_back)",
            ("status",),
        )
        adm = self.admission
        reg.gauge(
            "cobalt_admission_in_flight",
            "scoring requests currently holding an admission slot",
        ).set_function(lambda: adm.in_flight)
        reg.counter(
            "cobalt_admission_admitted_total",
            "scoring requests admitted past both admission gates",
        ).set_function(lambda: adm.admitted)
        shed = reg.counter(
            "cobalt_admission_shed_total",
            "requests shed 429 at the door, by which gate refused them",
            ("gate",),
        )
        shed.labels(gate="rate").set_function(lambda: adm.shed_rate)
        shed.labels(gate="capacity").set_function(lambda: adm.shed_capacity)
        brk = self.store_breaker
        reg.gauge(
            "cobalt_breaker_state",
            "store circuit breaker state (0=closed, 1=half_open, 2=open)",
        ).set_function(lambda: {"closed": 0, "half_open": 1, "open": 2}.get(brk.state, -1))
        trans = reg.counter(
            "cobalt_breaker_transitions_total",
            "store circuit breaker transitions into each state",
            ("state",),
        )
        for state in ("closed", "half_open", "open"):
            trans.labels(state=state).set_function(lambda s=state: brk.transitions.count(s))
        reg.counter(
            "cobalt_breaker_fast_failures_total",
            "store calls rejected while the circuit was open",
        ).set_function(lambda: brk.fast_failures)
        self._m_cache_hits = reg.counter(
            "cobalt_score_cache_hits_total",
            "single-row requests answered from the content-hash score cache",
        )
        self._m_cache_misses = reg.counter(
            "cobalt_score_cache_misses_total",
            "score-cache lookups that fell through to a device dispatch",
        )
        reg.gauge(
            "cobalt_score_cache_entries",
            "entries currently held by the content-hash score cache",
        ).set_function(lambda: len(self._score_cache))
        self._m_bulk_rows = reg.counter(
            "cobalt_bulk_rows_total",
            "rows scored through the bulk scoring path",
        )
        self._m_bulk_dispatches = reg.counter(
            "cobalt_bulk_dispatches_total",
            "device dispatches issued by the bulk scoring path",
        )
        self._m_bulk_dispatch_s = reg.histogram(
            "cobalt_bulk_dispatch_seconds",
            "wall time of one (possibly mesh-sharded) bulk dispatch, scores on the host",
        )
        reg.gauge(
            "cobalt_bulk_shards",
            "row shards per bulk dispatch (1 = single device)",
        ).set_function(lambda: self._model.bulk_part.n_shards)
        self._m_model_info = reg.gauge(
            "cobalt_model_info",
            "1 for the model version currently serving (identity labels)",
            ("version", "channel", "provenance_md5", "precision", "kernel"),
        )
        install_program_metrics(reg)
        install_device_metrics(reg)

    def observe_request(
        self,
        route: str,
        status: int,
        duration_s: float,
        code: str | None = None,
        trace_id: int | str | None = None,
    ) -> None:
        """Record one finished HTTP request (the server's middleware calls
        this with the route template, never a raw path). ``trace_id``
        becomes the latency bucket's OpenMetrics exemplar."""
        self._m_latency.labels(route=route, status=str(status)).observe(
            max(0.0, duration_s),
            exemplar=None if trace_id is None else str(trace_id),
        )
        if status >= 400:
            self._m_errors.labels(route=route, code=code or "error").inc()
        # The post-promotion guard: O(1) when no guard window is open.
        if self.canary is not None:
            self.canary.maybe_auto_rollback()

    def _observe_phase(self, name: str, duration_s: float) -> None:
        """One phase's seconds into the phase histogram and the flight
        record of the request in scope (nothing outside one)."""
        duration_s = max(0.0, duration_s)
        self._m_phase.labels(phase=name).observe(duration_s)
        add_phase(name, duration_s)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time one serving phase: a ``serve.<name>`` span plus
        `_observe_phase`, recorded even when the block raises."""
        try:
            with default_tracer().span(f"serve.{name}") as sp:
                yield sp
        finally:
            self._observe_phase(name, sp.duration_s or 0.0)

    def _observe_bulk_dispatch(self, rows: int, seconds: float) -> None:
        self._m_bulk_rows.inc(rows)
        self._m_bulk_dispatches.inc()
        self._m_bulk_dispatch_s.observe(max(0.0, seconds))

    @staticmethod
    def _ingress_request_id():
        """Mint a request id for in-process callers that bring none: the id
        taken at `MicroBatcher.submit` joins a batch span to its requests."""
        if current_request_id() is None:
            return request_context()
        return contextlib.nullcontext(current_request_id())

    def _new_deadline(self) -> Deadline | None:
        return start_deadline(self.config.request_deadline_s, self._clock)

    # -- health / readiness ----------------------------------------------------

    def health(self) -> dict:
        """``GET /healthz`` — the process is up."""
        return {"status": "ok"}

    def ready(self) -> tuple[bool, dict]:
        """``GET /readyz`` — the model is packed on its device and every
        warmed bucket scored. ``precision`` and ``quant_table`` (the pack's
        table hash, "f32" at f32) name the forest being served. A SHAP path
        the kernel cannot take is reported as degraded; probabilities still
        serve. The breaker's state, the admission and score-cache counters
        and the last reload's outcome are reported beside them."""
        model = self._model
        payload = {
            "status": "ok",
            "model_key": self._model_key,
            "n_features": model.n_features,
            "device": str(model.device),
            "kernel": model.kernel,
            "precision": model.pack.precision,
            "quant_table": model.pack.table_hash,
            "warm_buckets": model.warm_buckets,
            "shap": "ok" if model.shap_fn is not None else "degraded",
            "degraded": model.shap_fn is None,
            "launches": fused_score.launches,
            "degraded_direct": self.degraded_direct,
            # The bulk path's mesh shape and the buckets it has dispatched.
            "bulk": {
                **model.bulk_part.describe(),
                "compiled_buckets": sorted({b for b, _ in model.bulk_fns}),
            },
            "breaker": self.store_breaker.state,
            "admission": self.admission.stats(),
            "score_cache": {
                "size": self.config.score_cache_size,
                "entries": len(self._score_cache),
                "hits": int(self._m_cache_hits.value),
                "misses": int(self._m_cache_misses.value),
            },
            "microbatch": (
                {"enabled": False}
                if self.batcher is None
                else {
                    "enabled": True,
                    "max_wait_ms": self.batcher._max_wait_s * 1000.0,
                    "max_rows": self.batcher._max_rows,
                    **self.batcher.stats(),
                }
            ),
        }
        if model.shap_error is not None:
            payload["shap_error"] = model.shap_error
        payload["events"] = self.journal.stats()
        if self._last_reload is not None:
            payload["last_reload"] = self._last_reload
        payload["model"] = self.model_info
        if self.canary is not None:
            self.canary.maybe_auto_rollback()
            payload["canary"] = self.canary.status()
        return True, payload

    # -- /predict -----------------------------------------------------------------

    def _response(self, row: Mapping[str, float], result: tuple) -> dict:
        prob, phis_row, base, shap_error = result[:4]
        resp = {
            "prob_default": prob,
            "features": list(self._model.feature_names),
            "input_row": dict(row),
        }
        if phis_row is not None:
            resp["shap_values"] = phis_row
            resp["base_value"] = base
        else:
            resp["shap_values"] = None
            resp["base_value"] = None
            resp["degraded"] = True
            self._m_shap_degraded.inc()
        if self._model_identity is not None:
            resp["model_version"] = self._model_identity["version"]
        return resp

    def _cache_response(
        self, resp: dict, key: bytes | None, model: _CompiledModel | None
    ) -> dict:
        """Cache a full (non-degraded) response under ``key``, unless a swap
        has published another model since ``model`` was read: checked under
        the lock the swap publishes under, so no entry outlives its model."""
        if key is None or resp["shap_values"] is None:
            return resp
        with self._score_cache_lock:
            if model is self._model:
                cache = self._score_cache
                cache[key] = (resp["prob_default"], resp["shap_values"], resp["base_value"])
                cache.move_to_end(key)
                while len(cache) > self.config.score_cache_size:
                    cache.popitem(last=False)
        return resp

    def _finish_batched(self, row: Mapping[str, float], result: tuple, key, model) -> dict:
        """A batcher-scored request's response; the phases measured on the
        worker are recorded here, in the request's own context."""
        for name, seconds in result[4].items():
            self._observe_phase(name, seconds)
        resp = self._cache_response(self._response(row, result), key, model)
        self._canary_tap(row, result[0], result[4].get("dispatch"))
        return resp

    def _predict_validate(
        self, payload: Mapping[str, Any], dl: Deadline | None
    ) -> tuple[dict[str, float], dict | None, bytes | None, _CompiledModel | None]:
        """Validation, the first deadline checkpoint and the score-cache
        probe: ``(row, cached response | None, cache key, model read)``.

        The key is the canonicalized (1, F) float32 row's bytes behind the
        model's salt, so payloads that validate to the same features (any
        key order, aliases, int or float spelling) share one entry. A hit
        launches nothing."""
        with self.phase("validate"):
            row = validate_single_input(payload)
            if dl is not None:
                dl.check("input validated")
        if self.config.score_cache_size <= 0:
            return row, None, None, None
        model = self._model
        key = model.cache_salt + model.rows_array([row]).tobytes()
        with self._score_cache_lock:
            cached = self._score_cache.get(key)
            if cached is not None:
                self._score_cache.move_to_end(key)
        if cached is None:
            self._m_cache_misses.inc()
            return row, None, key, model
        self._m_cache_hits.inc()
        prob, phis_row, base = cached
        resp = {
            "prob_default": prob,
            "features": list(model.feature_names),
            "input_row": dict(row),
            "shap_values": list(phis_row),
            "base_value": base,
        }
        if self._model_identity is not None:
            resp["model_version"] = self._model_identity["version"]
        # The canary has no cache: a hit still shadow-scores, so the window
        # keeps filling under cache-friendly load.
        self._canary_tap(row, prob, None)
        return row, resp, key, model

    def _predict_direct(
        self, row: Mapping[str, float], dl: Deadline | None, key, cache_model
    ) -> dict:
        """The un-coalesced path: this request's own (1, F) launch."""
        model = self._model
        shed = self._shed_shap()
        with self.phase("dispatch") as dispatch_sp:
            if shed:  # brownout rung 2: the margin-only launch
                probs, phis, base = model.score(model.rows_array([row]), with_shap=False)
                shap_error = BROWNOUT_SHAP_SHED
            else:
                probs, phis, base, shap_error = model.score_explained(model.rows_array([row]))
        if phis is None and model.shap_fn is not None and not shed:
            self.degraded_direct += 1
        if dl is not None:
            dl.check("scored")
        resp = self._response(
            row,
            (float(probs[0]), None if phis is None else phis[0].tolist(), base, shap_error),
        )
        resp = self._cache_response(resp, key, cache_model)
        self._canary_tap(row, resp["prob_default"], dispatch_sp.duration_s)
        return resp

    def predict_single(
        self, payload: Mapping[str, Any], *, deadline: Deadline | None = None
    ) -> dict:
        """``POST /predict``: probability + per-row SHAP. With the
        micro-batcher the request is coalesced with concurrent callers into
        one padded bucket launch."""
        with self._ingress_request_id():
            dl = deadline if deadline is not None else self._new_deadline()
            row, cached, key, model = self._predict_validate(payload, dl)
            if cached is not None:
                return cached
            batcher = self.batcher
            fut = None
            if batcher is not None and not batcher.closed:
                with contextlib.suppress(RuntimeError):  # closed in the gap
                    fut = batcher.submit(row, dl)
            if fut is None:
                return self._predict_direct(row, dl, key, model)
            if dl is None:
                return self._finish_batched(row, fut.result(), key, model)
            try:
                result = fut.result(timeout=max(0.0, dl.remaining()))
            except (FutureTimeout, TimeoutError):
                raise dl.exceeded("queued for micro-batch") from None
            return self._finish_batched(row, result, key, model)

    async def predict_single_async(
        self, payload: Mapping[str, Any], *, deadline: Deadline | None = None
    ) -> dict:
        """Awaitable `predict_single`: the request coroutine suspends on the
        batcher's future under a loop-scheduled deadline."""
        with self._ingress_request_id():
            dl = deadline if deadline is not None else self._new_deadline()
            row, cached, key, model = self._predict_validate(payload, dl)
            if cached is not None:
                return cached
            batcher = self.batcher
            afut = None
            if batcher is not None and not batcher.closed:
                with contextlib.suppress(RuntimeError):
                    afut = batcher.submit_async(row, dl)
            if afut is None:
                return await _in_executor(self._predict_direct, row, dl, key, model)
            result = await await_under_deadline(afut, dl, "queued for micro-batch")
            return self._finish_batched(row, result, key, model)

    def predict_raw(
        self, payload: Mapping[str, Any], *, deadline: Deadline | None = None
    ) -> dict:
        """Score one RAW LendingClub row (``term`` as ``" 36 months"``,
        ``int_rate`` as ``"13.56%"``, categorical strings, missing cells absent
        or null) through the artifact's `FeaturePlan` and the ingest's own
        transform (`data.device_pipeline.transform_raw_rows`), then one
        margin-only launch (``walk_kernel`` on the card). No train/serve
        skew: the row gets the bits its batch row got at training time on
        this device. Unknown categories score as all-zero one-hot blocks and
        missing numerics as NaN (the GBDT's learned missing direction). A
        service method with no HTTP route, as in the reference; a request id
        is minted when the caller brings none."""
        with self._ingress_request_id():
            dl = deadline if deadline is not None else self._new_deadline()
            model = self._model
            plan = model.artifact.plan
            if plan is None:
                raise ValidationError(
                    "raw-row scoring requires an artifact that carries its "
                    "feature plan; this model was saved without one"
                )
            if not isinstance(payload, Mapping):
                raise ValidationError("body must be a JSON object")
            with model.on_stream():
                with self.phase("validate"):
                    feats = transform_raw_rows(plan, [dict(payload)], device=self.device)
                    if dl is not None:
                        dl.check("raw row transformed")
                name_pos = {n: i for i, n in enumerate(plan.tree_feature_names)}
                unknown = [n for n in model.feature_names if n not in name_pos]
                if unknown:
                    raise ValidationError(
                        "feature plan does not produce serving features "
                        f"{unknown[:4]}; retrain with the device pipeline"
                    )
                idx = torch.tensor([name_pos[n] for n in model.feature_names], device=self.device)
                x = feats.index_select(1, idx).contiguous()
                with self.phase("dispatch"):
                    _, prob = model.margin_fn(x)
                    prob = float(prob[0])
                row = x[0].cpu().tolist()
            resp = {
                "prob_default": prob,
                "features": list(model.feature_names),
                "engineered_row": dict(zip(model.feature_names, row)),
            }
            if self._model_identity is not None:
                resp["model_version"] = self._model_identity["version"]
            return resp

    # -- bulk -----------------------------------------------------------------------

    def predict_proba(self, X: np.ndarray, deadline: Deadline | None = None) -> np.ndarray:
        """Bulk P(default) for an (N, F) float array; each chunk's launch
        feeds the ``cobalt_bulk_*`` families."""
        X = np.asarray(X, dtype=np.float32)
        with default_tracer().span("serve.bulk_score", rows=int(X.shape[0])):
            return self._model.predict_proba(X, deadline, self._observe_bulk_dispatch)

    def shap_bulk(
        self, X: np.ndarray, deadline: Deadline | None = None
    ) -> tuple[np.ndarray, float] | None:
        """Bulk SHAP contributions ``((N, F) phis, base)``, or None while
        SHAP is degraded: the offline batch-explain entry point. Each
        chunk's launch feeds the ``cobalt_bulk_*`` families."""
        X = np.asarray(X, dtype=np.float32)
        with default_tracer().span("serve.bulk_shap", rows=int(X.shape[0])):
            return self._model.shap_bulk(X, deadline, self._observe_bulk_dispatch)

    def predict_bulk_csv(self, csv_bytes: bytes, *, deadline: Deadline | None = None) -> dict:
        """``POST /predict_bulk_csv``: CSV in, records with an appended
        ``prob_default`` column out; missing and non-finite values are the
        string "null". Payloads over ``max_bulk_bytes`` / ``max_bulk_rows``
        are rejected (413) before parse / score."""
        dl = deadline if deadline is not None else self._new_deadline()
        cfg = self.config
        if cfg.max_bulk_bytes is not None and len(csv_bytes) > cfg.max_bulk_bytes:
            raise PayloadTooLarge(
                f"bulk CSV is {len(csv_bytes)} bytes; the limit is "
                f"max_bulk_bytes={cfg.max_bulk_bytes}"
            )
        model = self._model
        header, columns = _parse_csv(csv_bytes)
        n_rows = len(columns[0]) if columns else 0
        if cfg.max_bulk_rows is not None and n_rows > cfg.max_bulk_rows:
            raise PayloadTooLarge(
                f"bulk CSV has {n_rows} rows; the limit is max_bulk_rows={cfg.max_bulk_rows}"
            )
        if dl is not None:
            dl.check("CSV parsed")
        by_name = dict(zip(header, columns))
        missing = [n for n in model.feature_names if n not in by_name]
        if missing:
            raise ValidationError(f"csv missing feature columns: {missing}")
        # A non-numeric feature column raises ValueError here: HTTP 500.
        X = np.array([by_name[n] for n in model.feature_names], dtype=np.float32).T
        X = X.reshape(n_rows, len(model.feature_names))
        prob = self.predict_proba(X, dl)
        records = []
        for i in range(n_rows):
            rec = {name: _json_cell(col[i]) for name, col in by_name.items()}
            rec["prob_default"] = _json_cell(float(prob[i]))
            records.append(rec)
        return {"predictions": records}

    async def predict_bulk_csv_async(
        self, csv_bytes: bytes, *, deadline: Deadline | None = None
    ) -> dict:
        """Awaitable `predict_bulk_csv` on the loop's default executor."""
        return await _in_executor(self.predict_bulk_csv, csv_bytes, deadline=deadline)

    def feature_importance_bulk(
        self, payload: Mapping[str, Any], *, deadline: Deadline | None = None
    ) -> dict:
        """``POST /feature_importance_bulk``: the top-10 total-gain
        importances. The scores are static booster gains; the posted rows
        are only checked for presence."""
        dl = deadline if deadline is not None else self._new_deadline()
        if not isinstance(payload, Mapping) or not payload.get("data"):
            raise ValidationError("No data provided.")
        if dl is not None:
            dl.check("input validated")
        model = self._model
        order = np.argsort(-model.gain)[:10]
        return {
            "top_features": [
                {"feature": model.feature_names[i], "importance": float(model.gain[i])}
                for i in order
                if model.gain[i] > 0
            ]
        }

    async def feature_importance_bulk_async(
        self, payload: Mapping[str, Any], *, deadline: Deadline | None = None
    ) -> dict:
        return self.feature_importance_bulk(payload, deadline=deadline)


def _json_cell(v: Any) -> Any:
    """Missing and non-finite floats serialize as the string "null"."""
    if isinstance(v, float) and not math.isfinite(v):
        return "null"
    return v
