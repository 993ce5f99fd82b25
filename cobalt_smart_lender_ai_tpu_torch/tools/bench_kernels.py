"""Scoring-kernel bench (the port's copy of the reference's
``tools/bench_kernels.py``): the ``score_forest`` kernel's one launch
against the plain margin + SHAP pair, at serving micro-batch bucket sizes,
per forest precision.

``fused`` is one `fused_score` call with SHAP through the single-device
partitioner: on the card one launch of ``csrc/score_forest.cu`` (walk +
margin + sigmoid + SHAP), ending with the probabilities and phis copied to
the host. ``reference`` is the counterpart of what the reference's
micro-batcher dispatched per batch before its fused kernel (a margin
program, the sigmoid, then a SHAP program): the plain margin
(`models.gbdt.predict_margin`), the sigmoid copied to the host, then the
plain SHAP (`explain.treeshap.shap_values`), on the same device. It is the
one place a plain version runs on a card tensor, as ``chip_smoke.py``'s
"plain ms" column does. One untimed warm-up call builds and loads the
library; the best of ``--repeats`` calls is kept.

The plain pair scores only the f32 forest, so the record carries one
``reference`` column (under ``f32``) and a ``fused`` column per precision;
bf16 and int8 add their `quantization_report` against f32. The forest is
the reference's serving-shaped one (25 trees of depth 3 on 4,096 seeded
rows of 20 features). ``--check RECORD`` is the reference's gate: at every
bucket the kernel is no slower than ``--slack`` x the pair it replaced.

    python -m cobalt_smart_lender_ai_tpu_torch.tools.bench_kernels --out K.json
    python -m cobalt_smart_lender_ai_tpu_torch.tools.bench_kernels --check K.json

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` times the plain versions against each other. The record adds a
``card`` block (`tools.bench_common`) and goes to ``--out`` or stdout.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.tools.bench_common import (
    card_block,
    device_count,
    force_devices,
    host_cpu_cores,
    platform_tag,
    summary,
    time_best,
    to_host,
    write_record,
)

__all__ = ["check_record", "kernel_rows", "main", "run_kernel_bench"]

#: Serving-shaped workload: the reference's serving model's scale (25
#: trees, depth 3, 20 features) at the micro-batcher's bucket sizes.
N_TREES = 25
DEPTH = 3
N_FEATURES = 20


def kernel_rows() -> tuple[np.ndarray, np.ndarray]:
    """The reference's seeded (4096, 20) float32 rows and int32 labels."""
    rng = np.random.default_rng(19)
    X = rng.normal(size=(4096, N_FEATURES)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 2] > 0).astype(np.int32)
    return X, y


def run_kernel_bench(
    buckets: list[int], *, repeats: int, precisions: list[str], device="cuda", forest=None
) -> dict:
    """The record: per precision and bucket the kernel's best seconds (and
    at f32 the plain pair's). ``forest`` replaces the seeded fit (a `Forest`
    of ``N_FEATURES`` features)."""
    from cobalt_smart_lender_ai_tpu_torch.explain.treeshap import shap_values
    from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier, predict_margin
    from cobalt_smart_lender_ai_tpu_torch.ops.score import pack_forest, quantization_report
    from cobalt_smart_lender_ai_tpu_torch.parallel.partitioner import SingleDevicePartitioner

    dev = resolve_device(device)
    X, y = kernel_rows()
    if forest is None:
        forest = GBDTClassifier(
            n_estimators=N_TREES, max_depth=DEPTH, n_bins=64, device=dev
        ).fit(X, y).forest
    forest = forest.to(dev)
    Xd = torch.from_numpy(X).to(dev)

    part = SingleDevicePartitioner(dev)
    results: dict[str, dict] = {}
    for precision in precisions:
        pack = pack_forest(forest, N_FEATURES, precision)
        quant = (
            None
            if precision == "f32"
            else quantization_report(forest, pack, N_FEATURES)
        )
        per_bucket: dict[str, dict] = {}
        for bucket in buckets:
            xb = Xd[:bucket].contiguous()
            fused_fn = part.compile_fused(pack, N_FEATURES, bucket, with_shap=True)

            def fused_pass():
                _, prob, phis, _ = fused_fn(xb)
                to_host(prob, phis)

            cell: dict[str, dict] = {}
            fused_s = time_best(fused_pass, repeats)
            cell["fused"] = {
                "dispatch_seconds": round(fused_s, 6),
                "rows_per_s": round(bucket / fused_s, 1),
            }
            if precision == "f32":

                def reference_pass():
                    # The plain pair: margin, the sigmoid on the host, then
                    # SHAP.
                    torch.sigmoid(predict_margin(forest, xb)).cpu().numpy()
                    phis, _ = shap_values(forest, xb, n_features=N_FEATURES)
                    to_host(phis)

                ref_s = time_best(reference_pass, repeats)
                cell["reference"] = {
                    "dispatch_seconds": round(ref_s, 6),
                    "rows_per_s": round(bucket / ref_s, 1),
                }
                cell["speedup"] = round(ref_s / fused_s, 2)
            per_bucket[str(bucket)] = cell
            line = f"[bench] {precision} bucket={bucket}: fused {fused_s * 1e3:.2f}ms"
            if "reference" in cell:
                line += (
                    f", reference {cell['reference']['dispatch_seconds'] * 1e3:.2f}ms"
                    f" ({cell['speedup']}x)"
                )
            print(line, file=sys.stderr)
        results[precision] = per_bucket
        if quant is not None:
            results[precision]["quantization"] = {
                k: v for k, v in quant.items() if k != "tolerance"
            }

    return {
        "bench": "score_kernels",
        "forest": {
            "n_trees": N_TREES,
            "depth": DEPTH,
            "n_features": N_FEATURES,
        },
        "repeats": repeats,
        "platform": platform_tag(dev),
        "interpret_mode": False,
        "devices": device_count(dev),
        "host_cpu_cores": host_cpu_cores(),
        "results": results,
    }


def check_record(record: dict, *, slack: float) -> int:
    """The gate: at every bucket, the kernel's f32 call must be no slower
    than ``slack`` x the plain pair it replaces."""
    failures = []
    f32 = (record.get("results") or {}).get("f32") or {}
    for bucket, cell in f32.items():
        if not isinstance(cell, dict) or "reference" not in cell:
            continue
        fused_s = cell["fused"]["dispatch_seconds"]
        ref_s = cell["reference"]["dispatch_seconds"]
        if fused_s > ref_s * slack:
            failures.append(
                f"bucket {bucket}: fused {fused_s:.6f}s > "
                f"{slack:g}x reference {ref_s:.6f}s"
            )
    if failures:
        print("KERNEL GATE FAIL", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print("kernel gate ok: fused <= reference at every bucket", file=sys.stderr)
    return 0


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="bench_kernels", description=__doc__.splitlines()[0])
    parser.add_argument("--buckets", default="16,64,256",
                        help="comma-separated serving bucket sizes")
    parser.add_argument("--repeats", type=int, default=5,
                        help="timed calls per cell (best is kept)")
    parser.add_argument("--precisions", default="f32,bf16,int8",
                        help="comma-separated forest precisions")
    parser.add_argument("--out", default=None,
                        help="write the record here (default: stdout)")
    parser.add_argument("--check", default=None, metavar="RECORD",
                        help="gate an existing record instead of running: "
                        "fused f32 call <= --slack x reference")
    parser.add_argument("--slack", type=float, default=1.0,
                        help="multiplier the kernel's call may not exceed "
                        "over the plain pair in --check")
    parser.add_argument("--force-devices", type=int, default=None,
                        help="name the one device this many times as the "
                        "visible devices (the record's devices)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    if args.check:
        with open(args.check) as fh:
            return check_record(json.load(fh), slack=args.slack)
    dev = resolve_device(args.device)
    buckets = sorted(int(b) for b in args.buckets.split(",") if b.strip())
    precisions = [p.strip() for p in args.precisions.split(",") if p.strip()]
    with force_devices(args.force_devices, dev) as forced:
        record = run_kernel_bench(
            buckets, repeats=args.repeats, precisions=precisions, device=dev
        )
    record["card"] = card_block(dev)
    if forced is not None:
        record["force_devices"] = forced
    write_record(record, args.out)
    if args.out:
        print(f"wrote {args.out}", file=sys.stderr)
    f32 = record["results"].get("f32", {})
    cells = [
        f"b{b} fused {c['fused']['dispatch_seconds'] * 1e3:.3f} ms"
        + (f" ({c['speedup']}x the plain pair)" if "speedup" in c else "")
        for b, c in f32.items()
    ]
    summary("bench_kernels", "score_kernels f32: " + "; ".join(cells), dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
