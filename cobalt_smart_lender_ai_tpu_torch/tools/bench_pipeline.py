"""Host-vs-device ingest bench (the port's copy of the reference's
``tools/bench_pipeline.py``): the host cleaning path against the device
ingest, rows/s at several frame sizes.

Both sides run the full raw-frame -> binned-feature-matrix flow:

- ``host``:   `clean_raw_frame` -> `prepare_cleaned_frame` ->
              `engineer_features` -> `ops.binning` (the host path, pandas-
              free in the port, whose numerics run on ``--device``);
- ``device``: `tokenize_raw_frame` (the stringy host frontier) ->
              `run_device_ingest` on ``--device``, its row-wise programs
              sharded ``--shards`` ways (`make_partitioner`, as
              ``DataConfig.ingest_shards`` does).

No scoring or histogram kernel runs on either side. Each side gets one
untimed warm-up pass per size, then the best of ``--repeats`` timed passes
is kept; a pass ends with the binned matrix copied to the host. The record
carries ``host_cpu_cores``: the host side and the device side's frontier
share the host's cores.

    python -m cobalt_smart_lender_ai_tpu_torch.tools.bench_pipeline --out P.json

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs both sides on the CPU. ``--force-devices n`` names the one device
``n`` times (the shards then share one card). The record adds a ``card``
block (`tools.bench_common`) and goes to ``--out`` or stdout.
"""

from __future__ import annotations

import argparse
import sys
from datetime import datetime

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

__all__ = ["TODAY", "main", "parse_args", "run_pipeline_bench"]

#: Frozen so reruns on other hosts benchmark the same frames.
TODAY = datetime(2026, 8, 1)


def run_pipeline_bench(
    sizes: list[int], *, repeats: int, shards: int, n_bins: int, device="cuda"
) -> dict:
    from cobalt_smart_lender_ai_tpu_torch.data.clean import clean_raw_frame
    from cobalt_smart_lender_ai_tpu_torch.data.device_pipeline import (
        run_device_ingest,
        tokenize_raw_frame,
    )
    from cobalt_smart_lender_ai_tpu_torch.data.features import (
        engineer_features,
        prepare_cleaned_frame,
    )
    from cobalt_smart_lender_ai_tpu_torch.data.synthetic import (
        synthetic_lendingclub_frame,
    )
    from cobalt_smart_lender_ai_tpu_torch.ops import binning
    from cobalt_smart_lender_ai_tpu_torch.parallel.partitioner import make_partitioner

    dev = resolve_device(device)
    results: dict[str, dict] = {}
    for n in sizes:
        raw = synthetic_lendingclub_frame(n, seed=7)

        def host_pass():
            cleaned, _ = clean_raw_frame(raw)
            prepared = prepare_cleaned_frame(cleaned, today=TODAY)
            tree, _, _ = engineer_features(prepared, device=dev)
            spec = binning.compute_bin_edges(tree.X, n_bins=n_bins)
            to_host(binning.transform(spec, tree.X))

        def device_pass():
            tok = tokenize_raw_frame(raw, today=TODAY)
            res = run_device_ingest(
                tok,
                device=dev,
                partitioner=make_partitioner(shards, device=dev),
                n_bins=n_bins,
            )
            to_host(res.bins)

        print(f"[bench] size={n}: host path...", file=sys.stderr)
        host_s = time_best(host_pass, repeats)
        print(f"[bench] size={n}: device path...", file=sys.stderr)
        dev_s = time_best(device_pass, repeats)
        results[f"rows_{n}"] = {
            "host": {
                "rows_per_s": round(n / host_s, 1),
                "best_pass_ms": round(host_s * 1e3, 3),
            },
            "device": {
                "rows_per_s": round(n / dev_s, 1),
                "best_pass_ms": round(dev_s * 1e3, 3),
                "shards": shards,
            },
            "speedup": round(host_s / dev_s, 2),
        }
        print(
            f"[bench] size={n}: host {n / host_s:,.0f} rows/s, "
            f"device {n / dev_s:,.0f} rows/s "
            f"({host_s / dev_s:.2f}x)",
            file=sys.stderr,
        )

    record = {
        "bench": "pipeline_ingest",
        "n_bins": n_bins,
        "repeats": repeats,
        "platform": platform_tag(dev),
        "devices": device_count(dev),
        "host_cpu_cores": host_cpu_cores(),
        "results": results,
    }
    largest = f"rows_{max(sizes)}"
    record["speedup_largest"] = results[largest]["speedup"]
    return record


def parse_args(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(prog="bench_pipeline", description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", default="4000,16000,48000",
                        help="comma-separated synthetic frame sizes")
    parser.add_argument("--repeats", type=int, default=3,
                        help="timed passes per side (best is kept)")
    parser.add_argument("--shards", type=int, default=-1,
                        help="device-side ingest shards (-1 = all devices)")
    parser.add_argument("--n-bins", type=int, default=255)
    parser.add_argument("--out", default=None,
                        help="write the record here (default: stdout)")
    parser.add_argument("--force-devices", type=int, default=None,
                        help="name the one device this many times as the "
                        "visible devices (the shards share one card)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    sizes = sorted(int(s) for s in args.sizes.split(",") if s.strip())
    with force_devices(args.force_devices, dev) as forced:
        record = run_pipeline_bench(
            sizes,
            repeats=args.repeats,
            shards=args.shards,
            n_bins=args.n_bins,
            device=dev,
        )
    record["card"] = card_block(dev)
    if forced is not None:
        record["force_devices"] = forced
    write_record(record, args.out)
    if args.out:
        print(f"wrote {args.out}", file=sys.stderr)
    summary(
        "bench_pipeline",
        "pipeline_ingest: " + "; ".join(
            f"{size} host {r['host']['rows_per_s']} rows/s, device "
            f"{r['device']['rows_per_s']} rows/s"
            for size, r in record["results"].items()
        ),
        dev,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
