#!/usr/bin/env python3
"""The gradient-histogram kernel at the first tree's shapes, on one GPU.

    python3 hist_smoke.py

The short loop for work on ``csrc/gradient_histogram.cu``: phases 5a and 5b
of ``chip_smoke.py`` alone. It makes chip_smoke's 1.84M seeded training rows,
bins them on the card, records the histogram calls of the first tree of the
committed model's configuration (level 0 direct, levels 1-6 subtracted,
level 6 direct) and holds the kernel to its plain version at each: two
launches bit-equal, cover bit-equal, g and h within 1e-5 per node, the rows
in another order bit-equal at level 6 subtracted; then active rows and the
kernel, plain, library and bound times; then the device time of each
stage of one launch (memsets, count, plan, scatter, histogram, finalize),
from ``torch.profiler`` over 10 launches. One line per shape, then one JSON
object of the records. Exits non-zero without a GPU or on any disagreement.
"""

from __future__ import annotations

import json
import sys
import time

import torch

import chip_smoke as cs
from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig
from cobalt_smart_lender_ai_tpu_torch.models import gbdt
from cobalt_smart_lender_ai_tpu_torch.ops.histogram import gradient_histogram_channels

PROFILED_LAUNCHES = 10


def stage_ms(bins: torch.Tensor, call: dict, n_bins: int) -> tuple[dict[str, float], int]:
    """Device ms per launch of each kernel and memset that one histogram
    launch runs, by name, from the profiler's trace of the card, and the
    launches whose records the profiler kept."""
    args = (bins, call["node"], call["g"], call["h"], call["w"])
    kw = dict(n_nodes=call["K"], n_bins=n_bins)
    return cs.device_ms_by_kernel(
        lambda: gradient_histogram_channels(*args, **kw), PROFILED_LAUNCHES, ("hist_kernel",)
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("hist_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card)
    t0 = time.perf_counter()
    cfg = GBDTConfig(**cs.TRAIN_CONFIG)
    Xn, yn = cs.training_rows(cs.N_TRAIN + cs.N_TEST)
    X = torch.from_numpy(Xn[: cs.N_TRAIN]).cuda()
    y = torch.from_numpy(yn[: cs.N_TRAIN]).cuda()
    _, bins = cs.binning_phase(X, cfg.n_bins)
    hp = gbdt.GBDTHyperparams.from_config(cfg)
    calls = cs.first_tree_calls(bins, y, hp, cfg.seed, cfg.n_bins, cfg.max_depth)
    records = cs.histogram_phase(bins, calls, cfg.n_bins)
    for r, c in zip(records, calls):
        print(cs.histogram_line(r, card))
        r["stage_ms"], kept = stage_ms(bins, c, cfg.n_bins)
        print(f"  stages (device ms per launch, {kept} of {PROFILED_LAUNCHES} kept): "
              + " ".join(f"{k}={v:.6f}" for k, v in r["stage_ms"].items()) + f" [{card}]")
    print(f"hist_smoke: {time.perf_counter() - t0:.1f}s [{card}]")
    print(json.dumps({"card": card, "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
