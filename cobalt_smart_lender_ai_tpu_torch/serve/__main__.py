"""CLI: restore the model artifact and serve the scoring API on the GPU.

    python -m cobalt_smart_lender_ai_tpu_torch.serve --store artifacts \\
        [--device cuda|cpu] [--port N]

``--device`` defaults to ``cuda``; without a CUDA device the command fails
at startup. ``--device cpu`` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.io import ObjectStore
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
        "--forest-precision",
        choices=("f32", "bf16", "int8"),
        default=ServeConfig.forest_precision,
        help="packed forest representation (only f32 is ported)",
    )
    return parser.parse_args(argv)


def build_service(args: argparse.Namespace) -> ScorerService:
    """The service the CLI serves, restored from ``args.store``."""
    cfg = ServeConfig(
        host=args.host,
        port=args.port,
        model_key=args.model_key,
        microbatch_max_wait_ms=args.microbatch_wait_ms,
        microbatch_max_rows=args.microbatch_max_rows,
        forest_precision=args.forest_precision,
    )
    return ScorerService.from_store(ObjectStore(args.store), cfg, device=args.device)


def main(argv: Sequence[str] | None = None) -> None:
    args = parse_args(argv)
    service = build_service(args)
    _, ready = service.ready()
    print(
        f"[INFO] model restored from {args.store}/{args.model_key}: "
        f"{ready['n_features']} features on {ready['device']} "
        f"(kernel {ready['kernel']}, forest precision {ready['precision']})"
    )
    from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import serve_forever

    print(f"[INFO] serving (asyncio) on {args.host}:{args.port}")
    serve_forever(service, args.host, args.port)


if __name__ == "__main__":
    main()
