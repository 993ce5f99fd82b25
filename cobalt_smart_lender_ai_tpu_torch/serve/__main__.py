"""CLI: restore the model artifact and serve the scoring API on the GPU.

    python -m cobalt_smart_lender_ai_tpu_torch.serve --store artifacts \\
        [--device cuda|cpu] [--port N] [--forest-precision f32|bf16|int8] \\
        [--no-microbatch] [--score-cache-size N] [--flight-slow-ms MS] \\
        [--canary [--model-name gbdt] [--canary-sample-rate R]] \\
        [--replicas N [--no-replica-devices]] [--bulk-shards N] \\
        [--profile-dir DIR]

``--device`` defaults to ``cuda``; without a CUDA device the command fails
at startup. ``--device cpu`` runs the plain PyTorch versions of the kernels.
A bf16 or int8 forest is gated at startup against the committed tolerances
and refused outside them. ``--canary`` serves the model registry's
``latest`` channel and shadow-scores any published canary on the same
device (``POST /admin/promote``, ``/admin/rollback``, ``GET /drift``).
``--replicas N`` (N >= 2) serves N replicas behind the least-loaded router
with the supervisor's healing loop and hedged failover
(``POST /admin/quarantine``, ``/admin/readmit``); on one card every replica
shares it, on several replica i takes card ``i % cards`` unless
``--no-replica-devices``. ``--bulk-shards N`` splits each bulk dispatch's
rows over an N-way dp mesh of the visible cards (-1 every card; clamped to
the cards there are), one scoring launch a shard. ``--profile-dir DIR``
captures a ``torch.profiler`` trace of the whole serving session into DIR
(`debug.profile_trace`; written when the server stops). The kernel
libraries come from the build cache (`compilecache.bootstrap_compile_cache`),
and ``/metrics`` carries its ``cobalt_compile_*`` families.
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.io import ObjectStore
from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--store",
        default=os.environ.get("COBALT_STORE_URI", "artifacts"),
        help="object-store root (a local directory)",
    )
    parser.add_argument("--model-key", default=ServeConfig.model_key)
    parser.add_argument("--host", default=ServeConfig.host)
    parser.add_argument("--port", type=int, default=ServeConfig.port)
    parser.add_argument(
        "--device",
        default="cuda",
        help="cuda (the default; the CUDA kernels) or cpu (their plain versions)",
    )
    parser.add_argument(
        "--no-microbatch",
        action="store_true",
        help="dispatch each request individually instead of coalescing "
        "concurrent requests into one device call",
    )
    parser.add_argument(
        "--microbatch-wait-ms",
        type=float,
        default=ServeConfig.microbatch_max_wait_ms,
        help="coalescing window: worst-case extra latency a request trades for throughput",
    )
    parser.add_argument(
        "--microbatch-max-rows",
        type=int,
        default=ServeConfig.microbatch_max_rows,
        help="dispatch early once this many requests are queued",
    )
    parser.add_argument(
        "--replicas",
        type=int,
        default=ServeConfig.replicas,
        help="shared-nothing serving replicas behind the least-loaded router "
        "(on one card they share it)",
    )
    parser.add_argument(
        "--no-replica-devices",
        action="store_true",
        help="do not place replicas on cards round-robin; every replica on "
        "the default card",
    )
    parser.add_argument(
        "--score-cache-size",
        type=int,
        default=ServeConfig.score_cache_size,
        help="entries in the content-hash score cache for repeated "
        "single-row payloads (0 disables)",
    )
    parser.add_argument(
        "--flight-slow-ms",
        type=float,
        default=ServeConfig.flight_slow_threshold_ms,
        help="requests at or over this wall time are always captured by the "
        "flight recorder (GET /debug/slowest names the slow phase)",
    )
    parser.add_argument(
        "--canary",
        action="store_true",
        help="enable the continuous-training loop: serve the model "
        "registry's 'latest' channel, shadow-score any published canary, "
        "expose /admin/promote, /admin/rollback and /drift",
    )
    parser.add_argument(
        "--model-name",
        default=ServeConfig.model_name,
        help="registry model name whose channels the canary loop follows",
    )
    parser.add_argument(
        "--canary-sample-rate",
        type=float,
        default=ServeConfig.canary_sample_rate,
        help="fraction of scoring traffic shadow-scored against the canary",
    )
    parser.add_argument(
        "--forest-precision",
        choices=("f32", "bf16", "int8"),
        default=ServeConfig.forest_precision,
        help="packed forest representation: f32 (bit-exact), bf16 or int8 "
        "(gated at startup against the committed tolerances)",
    )
    parser.add_argument(
        "--bulk-shards",
        type=int,
        default=ServeConfig.bulk_shards,
        help="row shards per bulk dispatch: 0/1 single device, -1 every "
        "visible device, N an N-way dp mesh (clamped to the host)",
    )
    parser.add_argument(
        "--profile-dir",
        default=None,
        help="capture a torch.profiler trace of the whole serving session "
        "into this directory (view in TensorBoard; telemetry spans appear "
        "as record_function ranges on the same timeline)",
    )
    return parser.parse_args(argv)


def build_service(args: argparse.Namespace) -> ScorerService | ReplicaSet:
    """The service the CLI serves, restored from ``args.store``: a plain
    `ScorerService` at ``--replicas 1``, else a `ReplicaSet`."""
    cfg = ServeConfig(
        host=args.host,
        port=args.port,
        model_key=args.model_key,
        microbatch_enabled=not args.no_microbatch,
        microbatch_max_wait_ms=args.microbatch_wait_ms,
        microbatch_max_rows=args.microbatch_max_rows,
        score_cache_size=args.score_cache_size,
        flight_slow_threshold_ms=args.flight_slow_ms,
        forest_precision=args.forest_precision,
        canary_enabled=args.canary,
        model_name=args.model_name,
        canary_sample_rate=args.canary_sample_rate,
        replicas=args.replicas,
        replica_devices=not args.no_replica_devices,
        bulk_shards=args.bulk_shards,
    )
    return ReplicaSet.from_store(ObjectStore(args.store), cfg, device=args.device)


def main(argv: Sequence[str] | None = None) -> None:
    args = parse_args(argv)
    # Kernel libraries persist across service restarts (the build cache
    # makes a restart load instead of compile), and the cobalt_compile_*
    # families land on this process's /metrics.
    from cobalt_smart_lender_ai_tpu_torch.compilecache import (
        bootstrap_compile_cache,
        publish_compile_metrics,
    )
    from cobalt_smart_lender_ai_tpu_torch.debug import profile_trace

    bootstrap_compile_cache()
    service = build_service(args)
    publish_compile_metrics(service.registry)
    _, ready = service.ready()
    if isinstance(service, ReplicaSet):
        print(
            f"[INFO] {len(service.replicas)} replicas behind the least-loaded router; "
            f"devices: {ready['replica_devices']}"
        )
        ready = ready["per_replica"][0]
    print(
        f"[INFO] model restored from {args.store}/{ready['model_key']}: "
        f"{ready['n_features']} features on {ready['device']} "
        f"(kernel {ready['kernel']}, forest precision {ready['precision']}, "
        f"quant table {ready['quant_table']})"
    )
    if ready["bulk"]["shards"] > 1:
        print(
            f"[INFO] bulk scoring sharded over the dp mesh: {ready['bulk']['shards']} shards "
            f"on {ready['bulk']['devices']}"
        )
    if service.config.canary_enabled:
        info = service.model_info
        print(
            f"[INFO] continuous training on: serving {args.model_name}/{info['version']} "
            f"({info['channel']}); canary shadow rate {args.canary_sample_rate:g}; "
            "POST /admin/promote, /admin/rollback; GET /drift"
        )
    from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import serve_forever

    if args.profile_dir:
        print(f"[INFO] profiler trace capturing to {args.profile_dir}")
    with profile_trace(args.profile_dir, device=args.device):
        print(f"[INFO] serving (asyncio) on {args.host}:{args.port}", flush=True)
        serve_forever(service, args.host, args.port)


if __name__ == "__main__":
    main()
