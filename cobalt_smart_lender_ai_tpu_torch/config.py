"""Serving configuration: the subset of the reference `ServeConfig` that the
port's scoring service reads."""

from __future__ import annotations

import dataclasses


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
    #: Packed forest representation. Only ``"f32"`` is ported so far.
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
