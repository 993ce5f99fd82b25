"""The scoring service: restored model, micro-batcher and endpoint handlers.

`ScorerService` restores a `GBDTArtifact`, packs its forest on the serving
device (`_CompiledModel`) and answers the reference API's endpoints as plain
methods returning JSON-shaped dicts; `serve.http_asyncio` is the HTTP shell.

Every scoring call is ONE launch of the fused scoring kernel
(`ops.score.fused_score`): concurrent ``/predict`` callers are coalesced by
the `MicroBatcher` into a power-of-two row bucket scored with SHAP, and
``/predict_bulk_csv`` chunks its rows into buckets scored without. On
``device="cuda"`` the kernel runs or the request fails; only an explicit
``device="cpu"`` runs the plain PyTorch versions.

A SHAP launch that fails at run time does not fail its requests: the same
rows are scored again by the margin-only launch (``walk_kernel`` on the
card), and each answers with ``"shap_values": null`` and ``"degraded":
true``; only a failing margin launch fails them.
"""

from __future__ import annotations

import asyncio
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
from cobalt_smart_lender_ai_tpu_torch.ops.score import (
    fused_score,
    fused_supported,
    pack_forest,
    shap_supported,
)
from cobalt_smart_lender_ai_tpu_torch.reliability.deadline import (
    Deadline,
    await_under_deadline,
    start_deadline,
)
from cobalt_smart_lender_ai_tpu_torch.reliability.errors import (
    PayloadTooLarge,
    ValidationError,
)

__all__ = [
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
    a model whose smoke scores are not finite never serves."""

    def __init__(self, artifact: GBDTArtifact, config: ServeConfig, device: torch.device):
        self.artifact = artifact
        self.config = config
        self.device = device
        self.feature_names = list(artifact.feature_names)
        self.n_features = len(self.feature_names)
        self._feature_index = {n: i for i, n in enumerate(self.feature_names)}
        forest = artifact.forest.to(device)
        depth = forest.depth
        if not fused_supported(depth):
            raise ValueError(f"the scoring kernel does not take depth {depth}")
        self.pack = pack_forest(forest, self.n_features, config.forest_precision, check=True)
        self.shap_error: str | None = None
        if not shap_supported(depth, self.n_features, self.pack.precision):
            err = (
                f"the SHAP kernel does not take depth {depth} with "
                f"{self.n_features} features"
            )
            if not config.degrade_shap:
                raise ValueError(err)
            self.shap_error = err
        self.kernel = "score_forest" if device.type == "cuda" else "plain"
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
        ``(prob, phis | None, base | None)`` as host arrays."""
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

    def predict_proba(self, X: np.ndarray, deadline: Deadline | None = None) -> np.ndarray:
        """P(default) for an (N, F) float array: chunks of ``max_batch_rows``
        rows, each zero-padded to its power-of-two bucket and scored by one
        margin-only launch. The deadline is checked before each chunk."""
        X = np.asarray(X, dtype=np.float32)
        N = X.shape[0]
        out = np.empty((N,), dtype=np.float32)
        step = self.config.max_batch_rows
        scratch: np.ndarray | None = None
        for start in range(0, N, step):
            if deadline is not None:
                deadline.check(f"bulk scoring, row {start}/{N}")
            chunk = X[start : start + step]
            n = chunk.shape[0]
            bucket = self.bucket_of(n)
            if n < bucket:
                if scratch is None:
                    scratch = np.zeros((bucket, X.shape[1]), np.float32)
                padded = scratch[:bucket]
                padded[:n] = chunk
                padded[n:] = 0.0
                chunk = padded
            out[start : start + n] = self.score(chunk, with_shap=False)[0][:n]
        return out


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
    running."""

    def __init__(self, service: "ScorerService", *, max_wait_s: float, max_rows: int):
        self._service = service
        self._max_wait_s = max(0.0, float(max_wait_s))
        self._max_rows = max(1, int(max_rows))
        self._cond = threading.Condition()
        self._queue: list[tuple] = []  # (row, deadline, future, enqueued_at)
        self._dispatch_lock = threading.Lock()
        self._paused = 0
        self._closed = False
        self._scratch: np.ndarray | None = None  # worker-only padding buffer
        # Written by the worker thread only.
        self.batches = 0
        self.coalesced_rows = 0
        self.max_batch_rows = 0
        self.expired_in_queue = 0
        self.degraded_batches = 0
        self._thread = threading.Thread(target=self._run, daemon=True, name="microbatcher")
        self._thread.start()

    @property
    def closed(self) -> bool:
        return self._closed

    def submit(self, row: Mapping[str, float], deadline: Deadline | None) -> Future:
        """Enqueue one validated row; the future resolves to ``(prob,
        shap_row | None, base | None, shap_error | None)`` or raises the
        request's error."""
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("micro-batcher is closed")
            self._queue.append((row, deadline, fut, time.monotonic()))
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
            "worker_alive": self._thread.is_alive(),
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
        while True:
            batch = self._collect()
            if batch is None:
                return
            with self._dispatch_lock:
                try:
                    self._dispatch(batch)
                except Exception as exc:  # fail this batch, keep serving
                    for _, _, fut, _ in batch:
                        if not fut.done():
                            fut.set_exception(exc)

    def _dispatch(self, batch: list) -> None:
        model = self._service._model
        live = []
        for row, dl, fut, enq in batch:
            if dl is not None and dl.expired():
                self.expired_in_queue += 1
                if not fut.done():
                    fut.set_exception(dl.exceeded("queued for micro-batch"))
            else:
                live.append((row, dl, fut))
        if not live:
            return
        n = len(live)
        bucket = model.bucket_of(n)
        scratch = self._scratch
        if scratch is None or scratch.shape[0] < bucket or scratch.shape[1] != model.n_features:
            scratch = self._scratch = np.zeros((bucket, model.n_features), np.float32)
        buf = scratch[:bucket]
        buf[:n] = model.rows_array([row for row, _, _ in live])
        buf[n:] = 0.0
        probs, phis, base, shap_error = model.score_explained(buf)
        if phis is None and model.shap_fn is not None:
            self.degraded_batches += 1
        self.batches += 1
        self.coalesced_rows += n
        self.max_batch_rows = max(self.max_batch_rows, n)
        for i, (_, dl, fut) in enumerate(live):
            if fut.done():
                continue
            if dl is not None and dl.expired():
                fut.set_exception(dl.exceeded("micro-batch scored"))
                continue
            fut.set_result(
                (
                    float(probs[i]),
                    None if phis is None else phis[i].tolist(),
                    base,
                    shap_error,
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


class ScorerService:
    """Restored model + fused scorer behind the reference API's endpoints.
    Concurrent single-row scoring is coalesced by `batcher` (a
    `MicroBatcher`) when ``ServeConfig.microbatch_enabled``."""

    def __init__(
        self,
        artifact: GBDTArtifact,
        config: ServeConfig | None = None,
        *,
        device: torch.device | str = "cuda",
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or ServeConfig()
        self.device = resolve_device(device)
        self._clock = clock
        self._model_key = self.config.model_key
        self._model = _CompiledModel(artifact, self.config, self.device)
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
    ) -> "ScorerService":
        """Startup restore of ``config.model_key`` from ``store``. The device
        is resolved first, so ``cuda`` without CUDA fails before any load."""
        cfg = config or ServeConfig()
        dev = resolve_device(device)
        artifact = GBDTArtifact.load(store, cfg.model_key, dev)
        return cls(artifact, cfg, device=dev, clock=clock)

    def close(self) -> None:
        """Stop the micro-batch worker (queued requests drain first);
        requests arriving afterwards score on their own launch."""
        if self.batcher is not None:
            self.batcher.close()

    @property
    def feature_names(self) -> list[str]:
        return self._model.feature_names

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
        serve."""
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
        return True, payload

    # -- /predict -----------------------------------------------------------------

    def _response(self, row: Mapping[str, float], result: tuple) -> dict:
        prob, phis_row, base, shap_error = result
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
        return resp

    def _predict_direct(self, row: Mapping[str, float], dl: Deadline | None) -> dict:
        """The un-coalesced path: this request's own (1, F) launch."""
        model = self._model
        probs, phis, base, shap_error = model.score_explained(model.rows_array([row]))
        if phis is None and model.shap_fn is not None:
            self.degraded_direct += 1
        if dl is not None:
            dl.check("scored")
        return self._response(
            row,
            (float(probs[0]), None if phis is None else phis[0].tolist(), base, shap_error),
        )

    def predict_single(
        self, payload: Mapping[str, Any], *, deadline: Deadline | None = None
    ) -> dict:
        """``POST /predict``: probability + per-row SHAP. With the
        micro-batcher the request is coalesced with concurrent callers into
        one padded bucket launch."""
        dl = deadline if deadline is not None else self._new_deadline()
        row = validate_single_input(payload)
        if dl is not None:
            dl.check("input validated")
        batcher = self.batcher
        fut = None
        if batcher is not None and not batcher.closed:
            with contextlib.suppress(RuntimeError):  # closed in the gap
                fut = batcher.submit(row, dl)
        if fut is None:
            return self._predict_direct(row, dl)
        if dl is None:
            return self._response(row, fut.result())
        try:
            return self._response(row, fut.result(timeout=max(0.0, dl.remaining())))
        except (FutureTimeout, TimeoutError):
            raise dl.exceeded("queued for micro-batch") from None

    async def predict_single_async(
        self, payload: Mapping[str, Any], *, deadline: Deadline | None = None
    ) -> dict:
        """Awaitable `predict_single`: the request coroutine suspends on the
        batcher's future under a loop-scheduled deadline."""
        dl = deadline if deadline is not None else self._new_deadline()
        row = validate_single_input(payload)
        if dl is not None:
            dl.check("input validated")
        batcher = self.batcher
        afut = None
        if batcher is not None and not batcher.closed:
            with contextlib.suppress(RuntimeError):
                afut = batcher.submit_async(row, dl)
        if afut is None:
            return await _in_executor(self._predict_direct, row, dl)
        result = await await_under_deadline(afut, dl, "queued for micro-batch")
        return self._response(row, result)

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
        service method with no HTTP route, as in the reference."""
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
        _, prob = model.margin_fn(x)
        row = x[0].cpu().tolist()
        return {
            "prob_default": float(prob[0]),
            "features": list(model.feature_names),
            "engineered_row": dict(zip(model.feature_names, row)),
        }

    # -- bulk -----------------------------------------------------------------------

    def predict_proba(self, X: np.ndarray, deadline: Deadline | None = None) -> np.ndarray:
        """Bulk P(default) for an (N, F) float array."""
        return self._model.predict_proba(X, deadline)

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
        prob = model.predict_proba(X, dl)
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
