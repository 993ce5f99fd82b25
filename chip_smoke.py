#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels to their plain versions.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only-scoring   # phases 1-4 and 9, then the scoring split
    python3 chip_smoke.py --full-protocol  # build, then phase 8b at the defaults

Phases, each of which must pass:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, all started together; the ``-Xptxas=-v`` report goes to stderr);
3. kernel vs plain: `fused_score` (the ``score_forest`` kernel) against
   `fused_score_reference` on the same seeded rows of the committed 300-tree
   depth-7 model, at the /predict buckets 1, 8, 64 with SHAP and the bulk
   buckets 256, 4096 without: margins bitwise equal (to the plain version
   on the card and on the CPU, and across two calls), prob within 1e-6,
   phis within 1e-5, ``base + sum(phis)`` within 1e-4 of the margin; then
   each bucket's time per call (CUDA events, after warm-up), the plain
   version's time and the least time the card could take (``bound_ms``);
4. serving: the port's `ScorerService` on ``cuda`` behind its HTTP server
   answers 32 concurrent ``/predict`` requests (coalesced by the
   micro-batcher), one ``/predict_bulk_csv`` and one
   ``/feature_importance_bulk``; responses are checked against the plain
   version on the CPU, and the kernel's launch count over the phase must be
   one per micro-batch, per bulk chunk and per startup warm-up bucket;
5. training, at the full width of the model the repo serves (300 trees of
   depth 7, 255 bins, the 20 serving features, subsample and colsample 0.8,
   ``scale_pos_weight`` 3.767) on 1.84M seeded training rows and 460k held
   out (the 80/20 split of the ~2.3M-row LendingClub table):
   a. binning on the card equals binning on the CPU, bit for bit;
   b. the ``gradient_histogram`` kernel against its plain version at every
      histogram shape of the first tree (level 0 direct, levels 1-6
      sibling-subtracted, and the direct level-6 call): cover bit-equal, g
      and h of each node within 1e-5 of that node's largest |value| in the
      channel, two launches bit-equal, and at level 6 subtracted the rows in
      a random order bit-equal; active rows, kernel, plain, library (three
      ``torch.bincount``) and bound times per shape;
   c. ``GBDTClassifier.fit`` through the kernel (the main path): wall time,
      one launch per tree level, held-out AUC; a second fit of the level
      loop on the same bins, with CUDA events around each histogram launch,
      gives the same forest bit for bit and the time inside the launches; a
      fit with the plain histogram on the card grows tree 0 with the same
      splits and lands within 0.002 of its held-out AUC;
   d. the trained forest is saved as the ``.npz`` artifact, and the port's
      `ScorerService` on ``cuda`` serves it: 16 concurrent ``/predict`` (with
      SHAP) and one bulk CSV, checked against the plain scorer on the CPU;
   e. the first 10 trees of the level loop under ``torch.profiler``: the
      card's busy time, the histogram's part of it, its idle share and the
      kernel launches per tree;
6. the raw path, at the full width of the raw LendingClub table (146
   columns) and its scale (2.3M loans), ``today`` pinned:
   a. a 200,000-loan frame (seed 0) tokenized on the host and ingested on
      the card and on the CPU: the same `CleanReport` and `FeaturePlan`
      (medians within ``LOG_RTOL``), integer, categorical, one-hot,
      indicator and label columns bitwise equal, log1p-derived columns
      within ``LOG_RTOL``, bins of the columns log1p does not touch equal,
      the hashed split's masks equal;
   b. the main path: ``synthetic_lendingclub_frame(2_300_000, seed=0)``,
      `tokenize_raw_frame` on the host, `run_device_ingest` on the card,
      `drop_training_leakage`, the 20 serving features and the hashed
      split, then `GBDTClassifier.fit` with the committed configuration and
      the split's ``scale_pos_weight`` through the histogram kernel (300 x 7
      launches); rows, host and card seconds, peak card memory, held-out
      AUC and the classification report;
   c. the forest published with its `FeaturePlan` and served on the card:
      `ScorerService.predict_raw` on 64 raw rows of the table, each that
      survived cleaning bitwise equal to its ingested row, plus a payload
      with a missing numeric, an unknown grade and a missing hardship
      status; `fused_score` launches counted over the calls; then the
      kernel against its plain version on the trained forest at
      ``predict_raw``'s shape (one row, margin only): each matched row's
      kernel margin equals `fused_score_reference`'s on the card, bit for
      bit, and its prob, which is the response's, is within 1e-6;
   d. a SHAP launch made to fail on that service: ``/predict`` over HTTP
      answers 200, degraded, with the margin-only launch's probability,
      within 1e-6 of the plain version's;
7. the scoring split: at each bucket of phase 3 and each precision (f32,
   bf16, int8), the device time per call of the walk kernel
   (``shap_kernel`` or ``walk_kernel``) and of ``score_finalize_kernel``,
   from ``torch.profiler`` (last, as the profiler slows later launches),
   with the calls whose records the profiler kept;
8. the training protocol, `run_pipeline` from the raw table to a published
   artifact at full width (146 raw columns, 104 tree features after the
   leakage drop), ``today`` pinned; it runs before phase 7:
   a. card against CPU: one 50,000-loan frame through `run_pipeline` on
      the card and on the CPU under a cut profile whose candidates draw no
      row or column samples (`CHECK_PROFILE`): the same selected features,
      candidates, folds and best params, every CV job's AUC and the
      held-out AUC within 1e-4;
   b. the main path: phase 6's 2.3M-loan frame through `run_pipeline` with
      the reference CLI's quick profile (RFE in steps of 20 with a 20-tree
      depth-3 selector, a 4 x 2 search in ``"auto"`` chunks, so successive
      halving; rows and width not cut) into a store: the cleaned, tree and
      nn tables written as CSV and a manifest per stage (the seconds and
      bytes of the tables are printed), the halving report (rungs, chunk,
      survivors), seconds and histogram launches of each stage (each
      launch count as the stage's fits make them: one per tree level, a
      halving job's trees in whole chunks up to its last rung), the
      selected features, every candidate's mean CV AUC, the best params, CV
      and held-out AUC and peak card memory; ``metrics.json`` with the
      reference's keys, the artifact reloaded bit for bit, and 16 raw rows
      through `ScorerService.predict_raw` on it (margins bitwise equal to
      `fused_score_reference` on the same card tensor, prob within 1e-6);
      then the first tree's histograms, kernel against plain as in 5b, at
      the default RFE selector's shape (64 bins, the 104 features, depth
      6) and at a depth-9 candidate's (255 bins, the 20 selected features,
      up to K = 256 nodes);
9. the quantized forests, at the committed model's full width; it runs
   right after phase 4:
   a. the forest packed at bf16 and at int8 on the card and on the CPU,
      each through the publish gate (``pack_forest(check=True)``): the same
      table hash and tree records, and `quantization_report` on the card
      (the kernel) equal to the CPU's (the plain version) in its margin
      fields, its prob field within 1e-7; each precision's record bytes per
      tree;
   b. as phase 3, at each precision: the kernel against the plain version
      on phase 3's rows at the five buckets, margins bitwise (on the card,
      on the CPU, across two calls), then ms, plain ms and ``bound_ms``
      (the bytes of the quantized records and tables);
   c. as phase 4, a `ScorerService` at ``forest_precision="int8"`` on the
      card: ``/readyz`` reports ``int8`` and the table hash, responses
      match the plain int8 scorer on the CPU, and the launches are the
      warm-ups, the gate's two and one per micro-batch and bulk chunk.

10. the protocol's resumable, halving path, right after 8b, on its
    columns and its store:
    a. the quick search again on 8b's selected training columns and
       ``scale_pos_weight``, with halving and exhaustive: each survivor's
       split scores bitwise the exhaustive run's, the halving run bitwise
       8b's search, its chunk and rungs those the cost model and ladder
       give at this row count (26 and 75/150/300 at ~1.8M rows); wall
       seconds and launches of both, and the histogram's device ms per
       level over the first chunk of a rung's job (CUDA events);
    b. `run_pipeline(raw=None, resume=True)` on 8b's store: ``clean``,
       ``engineer``, ``rfe`` and ``search`` restored, the refit's forest
       and held-out AUC bitwise 8b's; then, after
       ``PipelineCheckpoint.invalidate("search")``, the search rerun with
       results, artifact and selection bitwise 8b's; seconds to validate
       the manifests, to restore the tree CSV and of each run; 4 raw rows
       served by the resumed artifact (one launch each);
    c. card against CPU at 50,000 loans (8a's frame): RFECV of the quick
       selector (``support_``, ``ranking_`` equal, scores within 1e-6) and
       a search in chunks of 12 trees whose candidates draw nothing (the
       same halving report and winner, scores within 1e-4).

11. the observability of both main paths (`telemetry/`):
    a. right after phase 4, phase 4's traffic to the committed model on
       the card plus 4 bursts of 64 /predict held into one 64-row batch
       each; ``/metrics`` parsed with the port's `parse_exposition`: the
       ``score_forest`` programs' dispatches equal the
       ``fused_score.launches`` delta over the phase, their CUDA-event
       seconds are above 0, and the 64-row SHAP bucket's device ms per
       dispatch is printed beside phase 3's; ``cobalt_device_mem_bytes``
       present and `device_info`'s ``bytes_limit`` equal to
       ``mem_get_info``'s total; ``/debug/trace`` holds ``serve.dispatch``
       spans, ``/debug/slowest`` requests with their phases, ``/slo``
       answers, ``X-Request-ID`` is echoed and minted;
    b. on 8b's run: ``cobalt_pipeline_stage_seconds`` observed once per
       stage, equal to ``result.timings``; ``pipeline.run`` with every
       stage as a child span; the histogram programs' dispatches equal
       8b's ``hist_launches`` (``rfe`` at the selector's 64 bins,
       ``search`` at 255), their event seconds beside the stages';
    c. the training CLI in a subprocess at 200,000 loans with
       ``--ledger-out`` and ``--trace-out``: the ledger loads, its program
       table has the histogram programs with dispatches, event seconds
       and the H100 roofline estimate, and the trace parses;
    d. 10,000 recorded dispatches timed on the host (µs each), and that
       times 5c's launches as a share of 5c's fit wall.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Exits non-zero, printing neither, when
CUDA is unavailable or any phase fails. ``--only-scoring`` runs phases 1-4,
9 and 7 (the short loop for work on ``csrc/score_forest.cu``) and prints
neither line. ``--full-protocol`` builds, then runs phase 8b with the
reference's default `RFEConfig` (104 -> 20 features at step 1, 84 refits of
50 trees) and `TuneConfig` (20 candidates x 3 folds, every candidate to its
full ``n_estimators``) on a new 2.3M-loan frame, and prints neither line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cobalt_smart_lender_ai_tpu_torch.config import (
    GBDTConfig,
    PipelineConfig,
    RFEConfig,
    ServeConfig,
    TuneConfig,
)
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.data.device_pipeline import (
    run_device_ingest,
    tokenize_raw_frame,
    transform_raw_rows,
)
from cobalt_smart_lender_ai_tpu_torch.data.features import drop_training_leakage
from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame, row_dicts
from cobalt_smart_lender_ai_tpu_torch.data.split import split_mask, train_test_split_hashed
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models import gbdt
from cobalt_smart_lender_ai_tpu_torch.ops import _build
from cobalt_smart_lender_ai_tpu_torch.ops.binning import compute_bin_edges, transform
from cobalt_smart_lender_ai_tpu_torch.ops.histogram import _program as histogram_program
from cobalt_smart_lender_ai_tpu_torch.ops.histogram import (
    gradient_histogram_channels,
    gradient_histogram_reference,
    histogram_cost,
)
from cobalt_smart_lender_ai_tpu_torch.ops.metrics import binary_classification_report, roc_auc
from cobalt_smart_lender_ai_tpu_torch.ops.score import (
    fused_score,
    fused_score_reference,
    pack_forest,
    quantization_report,
    score_cost,
    tree_table_layout,
)
from cobalt_smart_lender_ai_tpu_torch.parallel.budget import resolve_chunk_trees
from cobalt_smart_lender_ai_tpu_torch.parallel.rfe import SELECTOR_BINS, rfe_select
from cobalt_smart_lender_ai_tpu_torch.parallel.tune import (
    _pow2_jobs,
    halving_ladder,
    randomized_search,
    sample_candidates,
    search_buckets,
    stratified_kfold_masks,
)
from cobalt_smart_lender_ai_tpu_torch.pipeline import (
    STAGES,
    PipelineResult,
    quick_config,
    run_pipeline,
    stage_fingerprints,
)
from cobalt_smart_lender_ai_tpu_torch.reliability import PipelineCheckpoint
from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
from cobalt_smart_lender_ai_tpu_torch.telemetry import (
    default_program_registry,
    default_registry,
    default_tracer,
    device_info,
    load_ledger,
    parse_exposition,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import (
    ProgramHandle,
    peak_bytes_estimate,
    peak_flops_estimate,
)

ROOT = Path(__file__).resolve().parent
STORE = ROOT / "artifacts"
MODEL_KEY = ServeConfig.model_key
SEED = 0

#: Published H100 SXM peaks (NVIDIA data sheet), the program registry's:
#: HBM3 bytes/s and FP32 (non-tensor-core) FLOP/s.
HBM_BYTES_PER_S = peak_bytes_estimate("NVIDIA H100")
FP32_FLOP_PER_S = peak_flops_estimate("NVIDIA H100")

TOL_PROB = 1e-6
TOL_PHIS = 1e-5
TOL_ADDITIVITY = 1e-4
#: (rows, with SHAP) of the scoring checks: the /predict micro-batch buckets
#: and two bulk chunk sizes.
BUCKETS = ((1, True), (8, True), (64, True), (256, False), (4096, False))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def seeded_rows(pack, n: int, seed: int = SEED) -> np.ndarray:
    """(n, F) float32 rows straddling the forest's own thresholds (so every
    branch is taken), with about 10% NaN cells (missing directions)."""
    rng = np.random.default_rng(seed)
    thr = pack.thr.cpu().numpy()
    feat = pack.feature.cpu().numpy()
    X = rng.normal(size=(n, pack.n_features)).astype(np.float32)
    for f in range(pack.n_features):
        vals = thr[(feat == f) & np.isfinite(thr)]
        if vals.size:
            jitter = 1.0 + 0.05 * rng.normal(size=n).astype(np.float32)
            X[:, f] = rng.choice(vals, n) * jitter
    X[rng.random(X.shape) < 0.1] = np.nan
    return X


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time of work that moves ``nbytes`` and does ``flops``: the
    larger of bytes over HBM bandwidth and FP32 operations over the FP32
    peak, in ms, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(pack, n_rows: int, with_shap: bool) -> tuple[float, str]:
    """Least time the card could take for one `fused_score` call, from
    `score_cost`'s count of its bytes (each input read once, each output
    written once; the forest at its stored precision) and FP32
    operations."""
    return _bound(*score_cost(n_rows, pack.n_trees, pack.depth, pack.n_features,
                              pack.precision, with_shap))


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel_out, plain_out, with_shap: bool) -> dict:
    """Kernel vs plain on the same inputs; raises on any disagreement."""
    km, kp = kernel_out[0].cpu(), kernel_out[1].cpu()
    pm, pp = plain_out[0].cpu(), plain_out[1].cpu()
    if not torch.equal(km, pm):
        raise AssertionError(
            f"margins differ: max |d| = {float((km - pm).abs().max())}"
        )
    err = {"prob": float((kp - pp).abs().max())}
    if err["prob"] > TOL_PROB:
        raise AssertionError(f"prob differs by {err['prob']} > {TOL_PROB}")
    if with_shap:
        kphi, pphi = kernel_out[2].cpu(), plain_out[2].cpu()
        base = float(kernel_out[3])
        err["phis"] = float((kphi - pphi).abs().max())
        err["additivity"] = float((base + kphi.sum(1) - km).abs().max())
        if not bool(torch.isfinite(kphi).all()) or err["phis"] > TOL_PHIS:
            raise AssertionError(f"phis differ by {err['phis']} > {TOL_PHIS}")
        if err["additivity"] > TOL_ADDITIVITY:
            raise AssertionError(
                f"base + sum(phis) misses the margin by {err['additivity']}"
            )
    return err


def kernel_phase(device: str = "cuda", precision: str = "f32") -> list[dict]:
    """score_forest vs its plain version at the serving buckets, on the
    committed forest packed at ``precision``; returns one record per bucket
    (errors, times, bound). The rows are phase 3's at every precision."""
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, device)
    F = len(art.feature_names)
    f32_pack = pack_forest(art.forest, F)
    pack = f32_pack if precision == "f32" else pack_forest(art.forest, F, precision)
    cpu_pack = pack_forest(art.forest.to("cpu"), F, precision)
    records = []
    for bucket, with_shap in BUCKETS:
        Xn = seeded_rows(f32_pack, bucket, SEED + bucket)
        X = torch.from_numpy(Xn).to(device)
        out = fused_score(pack, X, n_features=F, with_shap=with_shap)
        plain = fused_score_reference(pack, X, n_features=F, with_shap=with_shap)
        err = compare(out, plain, with_shap)
        again = fused_score(pack, X, n_features=F, with_shap=with_shap)
        if not torch.equal(out[0], again[0]):
            raise AssertionError(f"bucket {bucket}: two calls give other margins")
        # The margins are also the CPU plain version's, bit for bit.
        cpu_margin = fused_score_reference(
            cpu_pack, torch.from_numpy(Xn), n_features=F, with_shap=False
        )[0]
        if not torch.equal(out[0].cpu(), cpu_margin):
            raise AssertionError(f"bucket {bucket}: margins differ from the CPU")
        rec = {"bucket": bucket, "with_shap": with_shap, "precision": precision, **err}
        if device == "cuda":
            kreps = 20 if with_shap else 200
            rec["ms"] = time_ms(
                lambda: fused_score(pack, X, n_features=F, with_shap=with_shap), kreps
            )
            rec["plain_ms"] = time_ms(
                lambda: fused_score_reference(pack, X, n_features=F, with_shap=with_shap),
                3,
                warmup=1,
            )
            rec["bound_ms"], rec["bound_by"] = bound_ms(pack, bucket, with_shap)
        records.append(rec)
    return records


def _post(url: str, body: bytes, content_type: str) -> dict:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": content_type}, method="POST"
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def request_rows(n: int, seed: int = SEED) -> list[dict]:
    """``n`` valid /predict payloads: floats for continuous fields, 0/1 ints
    for the one-hot indicators, aliases for the two names with spaces."""
    rng = np.random.default_rng(seed)
    alias = {v: k for k, v in schema.SERVING_FIELD_ALIASES.items()}
    rows = []
    for _ in range(n):
        row = {}
        for name in schema.SERVING_FEATURES:
            key = alias.get(name, name)
            if name in schema.SERVING_INT_FEATURES:
                row[key] = int(rng.integers(0, 2))
            elif name == "term":
                row[key] = float(rng.choice([36.0, 60.0]))
            else:
                row[key] = float(np.round(rng.uniform(0, 1) * 10 ** rng.integers(0, 5), 3))
        rows.append(row)
    return rows


def serving_phase(
    device: str = "cuda",
    n_requests: int = 32,
    bulk_rows: int = 5000,
    store_root: Path = STORE,
    model_key: str = MODEL_KEY,
    precision: str = "f32",
) -> dict:
    """The port's serving path over HTTP, with the forest packed at
    ``precision``: concurrent /predict, one bulk CSV, one importance
    request. Counts kernel launches over the whole phase: at startup one
    per warmed bucket, plus at bf16 and int8 the publish gate's two (the
    quantized pack's probe rows and its f32 reference's)."""
    store = ObjectStore(str(store_root))
    fused_score.launches = 0
    config = ServeConfig(model_key=model_key, forest_precision=precision)
    service = ScorerService.from_store(store, config, device=device)
    warm = fused_score.launches
    warmed = service._model.warm_buckets
    gate = 0 if precision == "f32" else 2
    if device == "cuda" and warm != len(warmed["shap"]) + len(warmed["margin"]) + gate:
        raise AssertionError(f"{warm} startup launches for the buckets {warmed} and "
                             f"{gate} gate launches")
    server = make_async_server(service, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    try:
        assert _get(base + "/healthz") == {"status": "ok"}
        rows = request_rows(n_requests)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_requests) as pool:
            resps = list(
                pool.map(
                    lambda r: _post(base + "/predict", json.dumps(r).encode(), "application/json"),
                    rows,
                )
            )
        predict_s = time.perf_counter() - t0
        Xb = seeded_rows(service._model.pack, bulk_rows, SEED + 1)
        names = service.feature_names
        lines = [",".join(f'"{n}"' for n in names)]
        lines += [",".join("" if np.isnan(v) else repr(float(v)) for v in r) for r in Xb]
        t0 = time.perf_counter()
        bulk = _post(base + "/predict_bulk_csv", "\n".join(lines).encode(), "text/csv")
        bulk_s = time.perf_counter() - t0
        imp = _post(
            base + "/feature_importance_bulk",
            json.dumps({"data": rows[:2]}).encode(),
            "application/json",
        )
        ready = _get(base + "/readyz")
    finally:
        server.close()
        service.close()
    if (ready["precision"], ready["quant_table"]) != (precision, service._model.pack.table_hash):
        raise AssertionError(f"/readyz reports {ready['precision']} {ready['quant_table']}")
    launches = fused_score.launches
    batches = ready["microbatch"]["batches"]
    bulk_chunks = -(-bulk_rows // service.config.max_batch_rows)
    if device == "cuda" and (launches == 0 or launches - warm != batches + bulk_chunks):
        raise AssertionError(
            f"{launches - warm} launches for {batches} micro-batches and "
            f"{bulk_chunks} bulk chunks: expected one launch each"
        )

    # Check the answers against the plain version on the CPU.
    art = GBDTArtifact.load(store, model_key, "cpu")
    F = len(art.feature_names)
    cpu_pack = pack_forest(art.forest, F, precision)
    Xr = torch.tensor(
        [[float(r[k]) for k in _request_keys()] for r in rows], dtype=torch.float32
    )
    _, prob, phis, base_v = fused_score_reference(cpu_pack, Xr, n_features=F)
    got_prob = torch.tensor([r["prob_default"] for r in resps])
    got_phis = torch.tensor([r["shap_values"] for r in resps])
    err = {
        "predict_prob": float((got_prob - prob).abs().max()),
        "predict_phis": float((got_phis - phis).abs().max()),
        "predict_base": max(abs(r["base_value"] - float(base_v)) for r in resps),
    }
    bulk_prob = fused_score_reference(
        cpu_pack, torch.from_numpy(Xb), n_features=F, with_shap=False
    )[1]
    got_bulk = torch.tensor([p["prob_default"] for p in bulk["predictions"]])
    err["bulk_prob"] = float((got_bulk - bulk_prob).abs().max())
    if max(err["predict_prob"], err["bulk_prob"]) > TOL_PROB:
        raise AssertionError(f"served probabilities disagree: {err}")
    if max(err["predict_phis"], err["predict_base"]) > TOL_PHIS:
        raise AssertionError(f"served SHAP values disagree: {err}")
    if not imp["top_features"] or len(bulk["predictions"]) != bulk_rows:
        raise AssertionError("empty importance or short bulk response")
    return {
        "precision": precision,
        "quant_table": ready["quant_table"],
        "launches": launches,
        "warmup_launches": warm,
        "microbatches": batches,
        "coalesced_rows": ready["microbatch"]["coalesced_rows"],
        "bulk_chunks": bulk_chunks,
        "predict_s": predict_s,
        "bulk_s": bulk_s,
        **err,
    }


def _request_keys() -> list[str]:
    alias = {v: k for k, v in schema.SERVING_FIELD_ALIASES.items()}
    return [alias.get(n, n) for n in schema.SERVING_FEATURES]


#: The quantized precisions of phase 9; the publish gate's prob field on
#: the card against the CPU's (two sigmoids).
QUANTIZED = ("bf16", "int8")
TOL_REPORT_PROB = 1e-7
REPORT_MARGIN_FIELDS = ("mean_abs_margin_delta", "max_abs_margin_delta")
QUANT_ARRAYS = ("thr_q", "leaf_q", "all_left", "thr_affine", "leaf_scale", "leaf_zero", "thr", "leaf")


def quantized_pack_phase(precision: str, device: str = "cuda") -> dict:
    """Phase 9a: the committed forest packed at ``precision`` on the card
    and on the CPU, each through the publish gate (``check=True``): the
    same table hash, stored tables and dequantized values (`QUANT_ARRAYS`;
    the SHAP cover ratios are computed on each device), and the card's
    `quantization_report` (scored by the kernel) equal to the CPU's (the
    plain version) in its margin fields, its prob field within
    `TOL_REPORT_PROB`."""
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, device)
    F = len(art.feature_names)
    cpu_forest = art.forest.to("cpu")
    pack = pack_forest(art.forest, F, precision, check=True)
    cpu_pack = pack_forest(cpu_forest, F, precision, check=True)
    differ = [k for k in QUANT_ARRAYS if not torch.equal(getattr(pack, k).cpu(), getattr(cpu_pack, k))]
    if pack.table_hash != cpu_pack.table_hash or differ:
        raise AssertionError(f"{precision}: the card's pack differs from the CPU's in {differ}")
    report = quantization_report(art.forest, pack, F)
    cpu_report = quantization_report(cpu_forest, cpu_pack, F)
    prob_err = abs(report["mean_abs_prob_delta"] - cpu_report["mean_abs_prob_delta"])
    if any(report[k] != cpu_report[k] for k in REPORT_MARGIN_FIELDS) or prob_err > TOL_REPORT_PROB:
        raise AssertionError(f"{precision}: card report {report} != CPU report {cpu_report}")
    if not report["within_tolerance"]:
        raise AssertionError(f"{precision}: outside its tolerance: {report}")
    return {
        "precision": precision,
        "table_hash": pack.table_hash,
        "record_bytes": 4 * tree_table_layout(pack.depth, precision)[1],
        "f32_record_bytes": 4 * tree_table_layout(pack.depth)[1],
        "report_prob_err": prob_err,
        **{k: report[k] for k in (*REPORT_MARGIN_FIELDS, "mean_abs_prob_delta")},
    }


#: Kernels of one `fused_score` call on the card.
SCORE_KERNELS = ("walk_kernel", "shap_kernel", "score_finalize_kernel")
PROFILED_CALLS = 20
#: Profiler sessions tried before `device_ms_by_kernel` gives up.
PROFILE_SESSIONS = 5
#: One-thread spin kernels (``at::cuda::...::spin_kernel``) launched at the
#: start of each profiler session, before the calls it measures, and left
#: out of its times.
LEAD_IN = 8
LEAD_IN_KERNEL = "spin_kernel"


def device_ms_by_kernel(
    fn, calls: int, expect: tuple[str, ...]
) -> tuple[dict[str, float], int]:
    """Device ms per call of each kernel and memset that ``fn`` runs, by
    name, from ``torch.profiler`` over ``calls`` calls after one of warm-up,
    and the fewest calls whose records a kernel of ``expect`` kept.

    A profiler session late in a long run loses the card's records of the
    first few kernels launched in it (17 of 20 scoring calls kept, with the
    first calls' records missing, in every session), so each session starts
    with `LEAD_IN` spin kernels and a synchronize, whose records are left
    out. Each kernel of ``expect`` runs once per call, so its time per call
    is its mean over the records kept, if they cover at least half of
    ``calls``; any other kernel or memset is averaged over the most calls
    a kernel of ``expect`` kept. A session that kept fewer is logged to
    stderr and run again, up to `PROFILE_SESSIONS` sessions, after which
    this raises; one that kept fewer than ``calls``, or fewer than all of
    its lead-in records, is logged too, with where the records lie in the
    session (`_record_spacing`). What a session measures does not depend on
    the sessions before it."""
    fn()
    torch.cuda.synchronize()
    for session in range(1, PROFILE_SESSIONS + 1):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        total: dict[str, float] = {}
        seen: dict[str, int] = {}
        lead_in = 0
        for e in prof.key_averages():
            if e.device_time_total > 0 and LEAD_IN_KERNEL in e.key:
                lead_in += e.count
            elif e.device_time_total > 0:
                name = kernel_name(e.key)
                total[name] = total.get(name, 0.0) + e.device_time_total / 1e3
                seen[name] = seen.get(name, 0) + e.count
        if lead_in != LEAD_IN:
            print(f"profiler session {session} kept {lead_in} of {LEAD_IN} lead-in "
                  f"records; {_record_spacing(prof, expect[0], wall_us)}", file=sys.stderr)
        kept = [seen.get(k, 0) for k in expect]
        if 2 * min(kept) >= calls:
            if min(kept) != calls:
                print(f"profiler session {session} kept {seen} of {calls} calls; "
                      f"{_record_spacing(prof, expect[0], wall_us)}", file=sys.stderr)
            return {name: t / (seen[name] if name in expect else max(kept))
                    for name, t in total.items()}, min(kept)
        print(f"profiler session {session} of {PROFILE_SESSIONS} saw {seen}: "
              f"fewer than half of {calls} calls of each of {expect}; "
              f"{_record_spacing(prof, expect[0], wall_us)}", file=sys.stderr)
    raise AssertionError(f"{PROFILE_SESSIONS} profiler sessions missed kernels of {expect}")


def _record_spacing(prof, name: str, wall_us: float) -> str:
    """Where a session's records of kernel ``name`` lie: their span against
    the session's wall time and the gaps between their starts, so that
    calls lost at a session's edges (a short span) tell apart from calls
    lost inside it (a gap of about twice the median)."""
    starts = sorted(
        e.time_range.start for e in prof.events()
        if e.device_type == DeviceType.CUDA and kernel_name(e.name) == name
    )
    if len(starts) < 2:
        return f"{name}: {len(starts)} records in a {wall_us:.0f} us session"
    gaps = np.diff(starts)
    return (f"{name}: {len(starts)} records over {starts[-1] - starts[0]:.0f} us of a "
            f"{wall_us:.0f} us session; gap median {np.median(gaps):.1f} us, "
            f"max {gaps.max():.1f} us after record {int(gaps.argmax())}")


def scoring_split(device: str = "cuda", precision: str = "f32") -> list[dict]:
    """Device ms per call of each kernel of `fused_score` at each bucket of
    `kernel_phase` (its rows, the forest packed at ``precision``), by name,
    from ``torch.profiler`` over `PROFILED_CALLS` calls
    (`device_ms_by_kernel`)."""
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, device)
    F = len(art.feature_names)
    f32_pack = pack_forest(art.forest, F)
    pack = f32_pack if precision == "f32" else pack_forest(art.forest, F, precision)
    records = []
    for bucket, with_shap in BUCKETS:
        X = torch.from_numpy(seeded_rows(f32_pack, bucket, SEED + bucket)).to(device)
        walk = "shap_kernel" if with_shap else "walk_kernel"
        ms, kept = device_ms_by_kernel(
            lambda: fused_score(pack, X, n_features=F, with_shap=with_shap),
            PROFILED_CALLS,
            (walk, "score_finalize_kernel"),
        )
        split = {k: v for k, v in ms.items() if k in SCORE_KERNELS}
        records.append({"bucket": bucket, "with_shap": with_shap, "precision": precision,
                        "kept": kept, **split})
    return records


# -- training ------------------------------------------------------------------

#: The committed model's configuration (its artifact header's ``config``).
TRAIN_CONFIG = dict(
    n_estimators=300,
    max_depth=7,
    learning_rate=0.05,
    n_bins=255,
    subsample=0.8,
    colsample_bytree=0.8,
    scale_pos_weight=3.767127752304077,
    seed=42,
)
#: 80/20 split of the ~2.3M-row LendingClub table.
N_TRAIN, N_TEST = 1_840_000, 460_000
#: Columns with ~10% missing cells, as in the LendingClub table.
NAN_COLUMNS = (
    "emp_length_num", "open_il_12m", "open_il_24m", "max_bal_bc",
    "num_rev_accts", "pub_rec_bankruptcies",
)
POSITIVE_RATE = 1.0 / (1.0 + 3.767127752304077)
TOL_HIST = 1e-5
TOL_AUC = 0.002


def training_rows(n: int, seed: int = SEED) -> tuple[np.ndarray, np.ndarray]:
    """``n`` seeded rows of the 20 serving features and a 0/1 label.

    Continuous columns are drawn among the committed model's own bin edges
    (so on the scale its thresholds live on), with 2% jitter; the one-hot
    indicators are 0/1; about 10% of the cells in `NAN_COLUMNS` are NaN. The
    label is drawn from a fixed logistic function of a few columns, with its
    intercept set for a positive rate of 1 / (1 + scale_pos_weight)."""
    rng = np.random.default_rng(seed)
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, "cpu")
    names = list(art.feature_names)
    edges = np.asarray(art.bin_edges, dtype=np.float32)
    X = np.empty((n, len(names)), np.float32)
    for f, name in enumerate(names):
        if name in schema.SERVING_INT_FEATURES:
            X[:, f] = rng.random(n, dtype=np.float32) < 0.3
            continue
        finite = edges[f][np.isfinite(edges[f])]
        X[:, f] = rng.choice(finite, n) * (1.0 + 0.02 * rng.standard_normal(n, dtype=np.float32))
        if name in NAN_COLUMNS:
            X[rng.random(n, dtype=np.float32) < 0.1, f] = np.nan

    def z(name: str) -> np.ndarray:
        col = X[:, names.index(name)]
        return np.nan_to_num((col - np.nanmean(col)) / (np.nanstd(col) + 1e-12))

    logit = (
        -1.4 * z("last_fico_range_high")
        + 0.6 * z("term")
        + 0.4 * z("installment")
        + 0.9 * X[:, names.index("grade_E")]
        + 0.3 * z("open_il_12m")
        - 0.3 * z("fico_range_low")
    )
    lo, hi = -20.0, 20.0
    for _ in range(60):  # intercept for the target positive rate
        mid = 0.5 * (lo + hi)
        rate = float(np.mean(1.0 / (1.0 + np.exp(-(logit + mid)))))
        lo, hi = (mid, hi) if rate < POSITIVE_RATE else (lo, mid)
    p = 1.0 / (1.0 + np.exp(-(logit + 0.5 * (lo + hi))))
    y = (rng.random(n) < p).astype(np.float32)
    return X, y


def binning_phase(X_train: torch.Tensor, n_bins: int) -> tuple[object, torch.Tensor]:
    """Edges and bins on the card; raises unless they equal the CPU's."""
    spec = compute_bin_edges(X_train, n_bins)
    bins = transform(spec, X_train)
    Xc = X_train.cpu()
    cpu_spec = compute_bin_edges(Xc, n_bins)
    if not torch.equal(spec.edges.cpu().view(torch.int32), cpu_spec.edges.view(torch.int32)):
        raise AssertionError("bin edges on the card differ from the CPU's")
    if not torch.equal(bins.cpu(), transform(cpu_spec, Xc)):
        raise AssertionError("bins on the card differ from the CPU's")
    return spec, bins


def histogram_bound_ms(bins: torch.Tensor, g, h, w, n_nodes: int, n_bins: int) -> tuple[float, str]:
    """Least time of one histogram pass, counted for this call's data:
    `histogram_cost` at the rows this call finds active (g, h or w
    nonzero), counted on the card."""
    N, F = bins.shape
    active = int(((g != 0) | (h != 0) | (w != 0)).sum())
    return _bound(*histogram_cost(N, F, n_nodes, n_bins, bins.element_size(), active))


def library_histogram(bins, node, g, h, w, n_nodes: int, n_bins: int):
    """One PyTorch call per channel computing the same sums (the yardstick:
    ``torch.bincount`` over the joint (node, feature, bin) index, which is
    built here too). Timed only; the port never calls it."""
    N, F = bins.shape
    feat = torch.arange(F, device=bins.device)
    seg = ((node.long()[:, None] * F + feat) * n_bins + bins.long()).reshape(-1)
    return [
        torch.bincount(seg, weights=v[:, None].expand(N, F).reshape(-1), minlength=n_nodes * F * n_bins)
        for v in (g, h, w)
    ]


def first_tree_calls(bins, y, hp, seed: int, n_bins: int, depth: int) -> list[dict]:
    """The histogram calls of the first tree: level 0 direct and levels
    1..depth-1 sibling-subtracted (the fit's path), plus the direct call of
    the last level (what ``hist_subtract=False`` makes there), each with its
    inputs as the fit makes them."""

    def recorder(into: list[dict]):
        def record(b, node, g, h, w, *, n_nodes, n_bins):
            into.append(dict(node=node.clone(), g=g.clone(), h=h.clone(), w=w.clone(), K=n_nodes))
            return gradient_histogram_channels(b, node, g, h, w, n_nodes=n_nodes, n_bins=n_bins)

        return record

    N, F = bins.shape
    args = (bins, y, torch.ones(N, device=bins.device),
            torch.ones(F, dtype=torch.bool, device=bins.device), hp, seed)
    kw = dict(n_trees_cap=1, depth_cap=depth, n_bins=n_bins)
    subtracted: list[dict] = []
    direct: list[dict] = []
    gbdt.fit_binned_resumable(*args, hist_subtract=True, histogram=recorder(subtracted), **kw)
    gbdt.fit_binned_resumable(*args, hist_subtract=False, histogram=recorder(direct), **kw)
    for i, c in enumerate(subtracted):
        c["label"] = "level 0 direct" if i == 0 else f"level {i} subtracted"
    direct[-1]["label"] = f"level {depth - 1} direct"
    return subtracted + direct[-1:]


def histogram_phase(bins: torch.Tensor, calls: list[dict], n_bins: int) -> list[dict]:
    """Kernel vs plain at each recorded call; returns one record per call.

    At ``level 6 subtracted`` the same rows in a seeded random order must
    give the same bits too (the kernel groups rows by node in no fixed
    order; its integer sums do not depend on it)."""
    records = []
    for c in calls:
        args = (bins, c["node"], c["g"], c["h"], c["w"])
        kw = dict(n_nodes=c["K"], n_bins=n_bins)
        got = torch.stack(gradient_histogram_channels(*args, **kw))
        again = torch.stack(gradient_histogram_channels(*args, **kw))
        ref = gradient_histogram_reference(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{c['label']}: two launches differ")
        if not torch.equal(got[2], ref[2]):
            raise AssertionError(f"{c['label']}: cover differs from the plain version")
        in_range = (c["node"] >= 0) & (c["node"] < c["K"])
        active = in_range & ((c["g"] != 0) | (c["h"] != 0) | (c["w"] != 0))
        rec = {"shape": c["label"], "K": c["K"], "active_rows": int(active.sum()),
               "max_abs_err": 0.0, "max_rel_err": 0.0}
        for ch in (0, 1):
            # Per node: each node's channel against its own largest |value|.
            err = (got[ch] - ref[ch]).abs().amax(dim=(1, 2))
            scale = ref[ch].abs().amax(dim=(1, 2))
            bad = err > TOL_HIST * scale
            if bool(bad.any()):
                k = int(bad.nonzero()[0, 0])
                raise AssertionError(
                    f"{c['label']}: channel {ch} of node {k} off by {float(err[k])} "
                    f"(scale {float(scale[k])})"
                )
            rel = torch.where(scale > 0, err / scale, torch.zeros_like(err))
            rec["max_abs_err"] = max(rec["max_abs_err"], float(err.max()))
            rec["max_rel_err"] = max(rec["max_rel_err"], float(rel.max()))
        rec["bit_equal"] = torch.equal(got, ref)
        if c["label"] == "level 6 subtracted":
            gen = torch.Generator(device=bins.device).manual_seed(SEED)
            perm = torch.randperm(bins.shape[0], generator=gen, device=bins.device)
            shuffled = [a[perm].contiguous() for a in args]
            if not torch.equal(got, torch.stack(gradient_histogram_channels(*shuffled, **kw))):
                raise AssertionError(f"{c['label']}: the rows in another order give other bits")
            rec["row_order_equal"] = True
            del shuffled
        rec["ms"] = time_ms(lambda: gradient_histogram_channels(*args, **kw), 20)
        rec["plain_ms"] = time_ms(lambda: gradient_histogram_reference(*args, **kw), 3, warmup=1)
        rec["library_ms"] = time_ms(lambda: library_histogram(*args, **kw), 3, warmup=1)
        rec["bound_ms"], rec["bound_by"] = histogram_bound_ms(bins, c["g"], c["h"], c["w"], c["K"], n_bins)
        records.append(rec)
    return records


def histogram_line(r: dict, card: str) -> str:
    """One printed line of a `histogram_phase` record."""
    order = f" row_order_equal={r['row_order_equal']}" if "row_order_equal" in r else ""
    return (f"kernel gradient_histogram {r['shape']} (K={r['K']}) active_rows={r['active_rows']} "
            f"ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} library_ms={r['library_ms']:.6f} "
            f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
            f"max_abs_err={r['max_abs_err']:.3g} max_rel_err={r['max_rel_err']:.3g} "
            f"bit_equal={r['bit_equal']}{order} [{card}]")


class TimedHistogram:
    """The kernel's wrapper with CUDA events around each call, to sum the
    device time inside the histogram launches of a fit."""

    def __init__(self):
        self.events: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def __call__(self, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = gradient_histogram_channels(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def plain_histogram(*args, **kw):
    return tuple(gradient_histogram_reference(*args, **kw))


def fit_with(bins, y, spec, cfg: GBDTConfig, histogram) -> tuple[gbdt.Forest, float]:
    """The level loop of `GBDTClassifier.fit` on bins already made, with
    ``histogram`` as the level's histogram op; returns the forest with its
    float thresholds and the wall seconds of the loop."""
    N, F = bins.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forest, _ = gbdt.fit_binned_resumable(
        bins, y, torch.ones(N, device=bins.device),
        torch.ones(F, dtype=torch.bool, device=bins.device),
        gbdt.GBDTHyperparams.from_config(cfg), cfg.seed,
        n_trees_cap=cfg.n_estimators, depth_cap=cfg.max_depth, n_bins=cfg.n_bins,
        hist_subtract=cfg.hist_subtract, histogram=histogram,
    )
    torch.cuda.synchronize()
    return gbdt.attach_float_thresholds(forest, spec), time.perf_counter() - t0


#: Kernels of one `gradient_histogram_channels` launch.
HIST_KERNELS = ("count_kernel", "plan_kernel", "scatter_kernel", "hist_kernel", "finalize_kernel")
PROFILED_TREES = 10


def kernel_name(event_name: str) -> str:
    """``void hist_kernel<unsigned char>(...)`` -> ``hist_kernel``."""
    return event_name.split("(")[0].split("<")[0].removeprefix("void ").strip()


def profile_level_loop(bins, y, spec, cfg: GBDTConfig, trees: int = PROFILED_TREES) -> dict:
    """The first ``trees`` trees of the level loop through the kernel, once
    unprofiled (wall seconds) and once under ``torch.profiler``: the card's
    busy time (every kernel, memset and copy it ran, summed: one stream, so
    none overlap), the histogram launches' part of it, and the kernel
    launches the host made per tree. The card's idle share is
    1 - busy / unprofiled wall, with the median wall of three runs (the
    loop waits on the host, whose speed varies). A profiler session slows
    the host's later launches, so this runs after every other timing."""
    short = GBDTConfig(**{**TRAIN_CONFIG, "n_estimators": trees})
    fit_with(bins, y, spec, short, gradient_histogram_channels)  # warm-up
    wall_s = float(np.median([
        fit_with(bins, y, spec, short, gradient_histogram_channels)[1] for _ in range(3)
    ]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit_with(bins, y, spec, short, gradient_histogram_channels)
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    hist_ms = sum(e.time_range.elapsed_us() for e in device if kernel_name(e.name) in HIST_KERNELS) / 1e3
    launches = sum(1 for e in events if e.name == "cudaLaunchKernel")
    if not busy_ms or not hist_ms or not launches:
        raise AssertionError(f"the profiler saw no work on the card: {busy_ms} ms, {launches} launches")
    return {
        "trees": trees,
        "wall_s": wall_s,
        "device_busy_ms": busy_ms,
        "hist_device_ms": hist_ms,
        "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
        "launches_per_tree": launches / trees,
    }


def held_out_auc(forest: gbdt.Forest, X_test: torch.Tensor, y_test: torch.Tensor) -> float:
    return float(roc_auc(y_test, gbdt.predict_margin(forest, X_test)))


def same_tree(a: gbdt.Forest, b: gbdt.Forest, t: int, bins: torch.Tensor) -> dict:
    """Tree ``t`` of two forests: split features and covers equal at every
    node and every training row in the same leaf. Thresholds and missing
    directions may differ only where the node's rows split alike (bins that
    hold none of its rows tie up to subtraction residues)."""
    out = {
        "thr_bin_differs_at": int((a.thr_bin[t] != b.thr_bin[t]).sum()),
        "missing_left_differs_at": int((a.missing_left[t] != b.missing_left[t]).sum()),
    }
    for f in ("feature", "cover"):
        if not torch.equal(getattr(a, f)[t], getattr(b, f)[t]):
            raise AssertionError(f"tree {t}: {f} differs between the kernel and plain fits")
    leaves = [
        gbdt.landed_leaves(
            f.feature[t : t + 1], f.thr_bin[t : t + 1], f.missing_left[t : t + 1],
            f.depth, bins, binned=True,
        )
        for f in (a, b)
    ]
    if not torch.equal(*leaves):
        raise AssertionError(f"tree {t}: training rows land in other leaves")
    return out


def training_phase(card: str) -> tuple[list[dict], dict]:
    """Phase 5; returns (histogram records per shape, fit/serve summary)."""
    dev = torch.device("cuda")
    cfg = GBDTConfig(**TRAIN_CONFIG)
    t0 = time.perf_counter()
    Xn, yn = training_rows(N_TRAIN + N_TEST)
    X = torch.from_numpy(Xn).to(dev)
    y = torch.from_numpy(yn).to(dev)
    X_train, X_test, y_train, y_test = X[:N_TRAIN], X[N_TRAIN:], y[:N_TRAIN], y[N_TRAIN:]
    summary = {
        "rows_train": N_TRAIN,
        "rows_test": N_TEST,
        "positive_rate": float(y.mean()),
        "data_s": time.perf_counter() - t0,
    }

    spec, bins = binning_phase(X_train, cfg.n_bins)
    hp = gbdt.GBDTHyperparams.from_config(cfg)
    calls = first_tree_calls(bins, y_train, hp, cfg.seed, cfg.n_bins, cfg.max_depth)
    records = histogram_phase(bins, calls, cfg.n_bins)
    del calls
    for r in records:
        print(histogram_line(r, card))

    # The main path: the user's entry point, GBDTClassifier.fit (binning
    # included) through the kernel; counts from 0 just before.
    gradient_histogram_channels.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = gbdt.GBDTClassifier(cfg, device="cuda").fit(X_train, y_train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = gradient_histogram_channels.launches
    expect = cfg.n_estimators * cfg.max_depth
    if launches != expect:
        raise AssertionError(f"{launches} histogram launches in the fit, expected {expect}")
    auc = held_out_auc(model.forest, X_test, y_test)
    summary.update(fit_s=fit_s, hist_launches=launches, held_out_auc=auc,
                   binned_rows=int(bins.shape[0]))
    if not 0.5 < auc <= 1.0:
        raise AssertionError(f"held-out AUC {auc} of the kernel fit")

    # A second fit through the kernel, with CUDA events around each launch:
    # the same forest bit for bit, and the device time inside the histogram.
    timer = TimedHistogram()
    again, summary["fit2_loop_s"] = fit_with(bins, y_train, spec, cfg, timer)
    summary["hist_ms_in_fit2"] = timer.total_ms()
    for f in ("feature", "thr_bin", "thr_float", "missing_left", "gain", "cover", "leaf_value"):
        if not torch.equal(getattr(model.forest, f), getattr(again, f)):
            raise AssertionError(f"two fits on the card differ in {f}")
    del again, timer

    plain, summary["plain_fit_loop_s"] = fit_with(bins, y_train, spec, cfg, plain_histogram)
    summary["plain_held_out_auc"] = held_out_auc(plain, X_test, y_test)
    summary["tree0_vs_plain"] = same_tree(model.forest, plain, 0, bins)
    if abs(summary["plain_held_out_auc"] - auc) > TOL_AUC:
        raise AssertionError(f"plain-histogram fit AUC {summary['plain_held_out_auc']} vs {auc}")
    del plain

    # Publish the kernel-trained forest, then serve it.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as root:
        key = "models/gbdt/model_tree"
        GBDTArtifact(
            forest=model.forest.to("cpu"),
            feature_names=tuple(schema.SERVING_FEATURES),
            bin_edges=spec.edges.cpu().numpy(),
            config=dict(TRAIN_CONFIG),
            metrics={"test_auc": auc, "train_rows": N_TRAIN, "trained_wall_s": fit_s},
        ).save(ObjectStore(root), key)
        summary["serve"] = serving_phase(
            "cuda", n_requests=16, bulk_rows=5000, store_root=Path(root), model_key=key
        )
    summary["loop_profile"] = profile_level_loop(bins, y_train, spec, cfg)
    return records, summary


# -- the raw path ------------------------------------------------------------------

#: Loans in the raw LendingClub table, and in the card-vs-CPU check.
RAW_ROWS, RAW_CHECK_ROWS = 2_300_000, 200_000
#: Snapshot date of the date -> age features, pinned.
TODAY = datetime(2026, 8, 1)
#: log1p-derived values: torch's log1p on the card and on the CPU may
#: differ in the last bits (a few float32 ulps, as against the reference).
LOG_RTOL = 3e-7
#: Raw rows scored through predict_raw.
RAW_SERVE_ROWS = 64


def _columns_agree(names, A: torch.Tensor, B: torch.Tensor, log_cols: set, what: str) -> None:
    """Bitwise equal (NaN == NaN) outside ``log_cols``, within LOG_RTOL in them."""
    if A.shape != B.shape:
        raise AssertionError(f"{what}: shapes {tuple(A.shape)} and {tuple(B.shape)}")
    both_nan = torch.isnan(A) & torch.isnan(B)
    for j, name in enumerate(names):
        a, b = A[:, j], B[:, j]
        if name in log_cols:
            ok = torch.isclose(a, b, rtol=LOG_RTOL, atol=0.0) | both_nan[:, j]
        else:
            ok = (a == b) | both_nan[:, j]
        if not bool(ok.all()):
            raise AssertionError(f"{what}: column {name!r} differs in {int((~ok).sum())} rows")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ingest_card_vs_cpu(n_rows: int = RAW_CHECK_ROWS, device: str = "cuda") -> dict:
    """Phase 6a: one tokenized frame ingested on the card and on the CPU."""
    tok = tokenize_raw_frame(synthetic_lendingclub_frame(n_rows, seed=SEED), today=TODAY)
    card = run_device_ingest(tok, device=device)
    cpu = run_device_ingest(tok, device="cpu")
    if dataclasses.asdict(card.report) != dataclasses.asdict(cpu.report):
        raise AssertionError(f"clean reports differ: {card.report} vs {cpu.report}")
    pc, pp = card.plan, cpu.plan
    for f in ("numeric_names", "categorical_vocab", "label_vocab", "log_cols",
              "tree_feature_names", "nn_feature_names", "asof"):
        if getattr(pc, f) != getattr(pp, f):
            raise AssertionError(f"plans differ in {f}")
    log_cols = set(pp.log_cols)
    for name, v in pp.medians.items():
        w = pc.medians[name]
        if (name in log_cols and not np.isclose(w, v, rtol=LOG_RTOL, atol=0.0)) or (
            name not in log_cols and w != v
        ):
            raise AssertionError(f"median of {name}: {w} on the card, {v} on the CPU")
    _columns_agree(pp.tree_feature_names, card.tree.X.cpu(), cpu.tree.X, log_cols, "tree")
    _columns_agree(pp.nn_feature_names, card.nn.X.cpu(), cpu.nn.X, log_cols, "nn")
    if not torch.equal(torch.nan_to_num(card.tree.y.cpu(), nan=-1.0), torch.nan_to_num(cpu.tree.y, nan=-1.0)):
        raise AssertionError("labels differ")
    exact = [j for j, n in enumerate(pp.tree_feature_names) if n not in log_cols]
    if not torch.equal(card.bins.cpu()[:, exact], cpu.bins[:, exact]):
        raise AssertionError("bins of the columns log1p does not touch differ")
    n = cpu.tree.n_rows
    if not torch.equal(split_mask(n, 0.2, 22, device).cpu(), split_mask(n, 0.2, 22, "cpu")):
        raise AssertionError("hashed split masks differ")
    log_bins = [j for j, nm in enumerate(pp.tree_feature_names) if nm in log_cols]
    return {
        "rows_in": tok.n_rows,
        "rows_out": n,
        "tree_features": len(pp.tree_feature_names),
        "exact_columns": len(exact),
        "log1p_bins_equal": torch.equal(card.bins.cpu()[:, log_bins], cpu.bins[:, log_bins]),
    }


def _boom(*args, **kwargs):
    raise RuntimeError("SHAP launch made to fail")


def raw_table(n_rows: int = RAW_ROWS) -> tuple[RawFrame, float]:
    """The seeded raw LendingClub table and the host seconds it took."""
    t0 = time.perf_counter()
    frame = synthetic_lendingclub_frame(n_rows, seed=SEED)
    return frame, time.perf_counter() - t0


def raw_path_phase(
    card: str,
    n_rows: int = RAW_ROWS,
    check_rows: int = RAW_CHECK_ROWS,
    device: str = "cuda",
    frame: RawFrame | None = None,
) -> tuple[dict, dict, tuple]:
    """Phase 6 on ``frame`` (``raw_table(n_rows)`` if None); returns
    (summary, launches of each kernel on this path, the training split of
    all tree features after the leakage drop as ``(X, y, names)`` on the
    host, for phase 8's histogram shapes). ``device="cpu"`` and small row
    counts rehearse it without a card."""
    dev = torch.device(device)
    out: dict = {"card_vs_cpu": ingest_card_vs_cpu(check_rows, device)}

    # b. Raw table -> host tokenize -> card ingest -> split -> fit.
    if frame is None:
        frame, out["generate_s"] = raw_table(n_rows)
    out["raw_columns"] = len(frame.columns)
    picks = np.sort(np.random.default_rng(SEED).choice(frame.n_rows, RAW_SERVE_ROWS, replace=False))
    payloads = row_dicts(frame, picks)
    t0 = time.perf_counter()
    tok = tokenize_raw_frame(frame, today=TODAY)
    out["tokenize_s"] = time.perf_counter() - t0
    out["rows_in"] = tok.n_rows

    gradient_histogram_channels.launches = 0
    fused_score.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    res = run_device_ingest(tok, device=dev)
    _sync(dev)
    out["ingest_s"] = time.perf_counter() - t0
    del tok
    out["rows_out"] = res.tree.n_rows
    out["tree_features"] = res.tree.n_features
    out["nn_features"] = res.nn.n_features
    out["report"] = dataclasses.asdict(res.report)
    ff = drop_training_leakage(res.tree)
    out["tree_features_after_leakage_drop"] = ff.n_features
    X_all, X_test, y_train, y_test = train_test_split_hashed(ff.X, ff.y)
    train_rows = (X_all.cpu(), y_train.cpu(), ff.feature_names)
    sel = torch.tensor([ff.feature_names.index(n) for n in schema.SERVING_FEATURES], device=dev)
    X_train, X_test = X_all.index_select(1, sel), X_test.index_select(1, sel)
    del X_all
    n_pos = float(y_train.sum())
    spw = (float(X_train.shape[0]) - n_pos) / max(n_pos, 1.0)
    cfg = GBDTConfig(**{**TRAIN_CONFIG, "scale_pos_weight": spw})
    out.update(rows_train=int(X_train.shape[0]), rows_test=int(X_test.shape[0]),
               positive_rate=n_pos / float(X_train.shape[0]), scale_pos_weight=spw)
    _sync(dev)
    t0 = time.perf_counter()
    model = gbdt.GBDTClassifier(cfg, device=dev).fit(X_train, y_train)
    _sync(dev)
    out["fit_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    hist_launches = gradient_histogram_channels.launches
    if dev.type == "cuda" and hist_launches != cfg.n_estimators * cfg.max_depth:
        raise AssertionError(f"{hist_launches} histogram launches in the raw-path fit")
    margin = gbdt.predict_margin(model.forest, X_test)
    out["held_out_auc"] = float(roc_auc(y_test, margin))
    pred = (torch.sigmoid(margin) >= 0.5).to(torch.int32)
    out["classification_report"] = binary_classification_report(y_test, pred)
    if out["held_out_auc"] < 0.90 and n_rows == RAW_ROWS:
        raise AssertionError(f"held-out AUC {out['held_out_auc']} on the raw path")
    del X_train, X_test, y_train, y_test, ff, margin, pred

    # c. Publish with the plan, serve raw rows on the card.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_raw_") as root:
        key = "models/gbdt/model_tree"
        plan = res.plan
        GBDTArtifact(
            forest=model.forest.to("cpu"),
            feature_names=tuple(schema.SERVING_FEATURES),
            bin_edges=model.bin_spec.edges.cpu().numpy(),
            plan=plan,
            config={**TRAIN_CONFIG, "scale_pos_weight": spw},
            metrics={"test_auc": out["held_out_auc"], "train_rows": out["rows_train"]},
        ).save(ObjectStore(root), key)
        service = ScorerService.from_store(ObjectStore(root), ServeConfig(model_key=key), device=dev)
        try:
            out["serve"] = serve_raw_rows(service, res, payloads, dev)
            out["degraded"] = degraded_predict(service)
        finally:
            service.close()
    launches = {"gradient_histogram": hist_launches, "score_forest": out["serve"]["predict_raw_launches"]}
    print(f"raw_path: {json.dumps(out)} [{card}]")
    return out, launches, train_rows


def serve_raw_rows(service: ScorerService, res, payloads: list[dict], dev: torch.device) -> dict:
    """Phase 6c: predict_raw on the raw rows, each held to its ingested row."""
    plan = res.plan
    tree = res.tree.X
    sel = [plan.tree_feature_names.index(n) for n in schema.SERVING_FEATURES]
    model = service._model
    odd = {"loan_amnt": 10000.0, "term": " 36 months", "int_rate": "11.5%", "grade": "ZZZ",
           "annual_inc": None, "hardship_status": None}
    fused_score.launches = 0
    t0 = time.perf_counter()
    resps = [service.predict_raw(p) for p in payloads + [odd]]
    predict_raw_s = time.perf_counter() - t0
    launches = fused_score.launches
    if dev.type == "cuda" and launches != len(resps):
        raise AssertionError(f"{launches} fused_score launches for {len(resps)} predict_raw calls")
    raw = transform_raw_rows(plan, payloads + [odd], device=dev)
    matched = 0
    matched_rows: list[np.ndarray] = []
    matched_resps: list[dict] = []
    for i, resp in enumerate(resps[:-1]):
        r = raw[i]
        hit = (((tree == r) | (torch.isnan(tree) & torch.isnan(r))).all(dim=1)).nonzero()
        if hit.numel() == 0:
            continue  # dropped by cleaning
        row = tree[int(hit[0, 0])].cpu().numpy()[sel]
        got = np.array([resp["engineered_row"][n] for n in schema.SERVING_FEATURES], np.float32)
        if not np.array_equal(got.view(np.int32), row.view(np.int32)):
            raise AssertionError(f"raw row {i}: engineered row differs from its ingested row")
        matched_rows.append(row)
        matched_resps.append(resp)
        matched += 1
    if matched < 0.9 * len(payloads):
        raise AssertionError(f"only {matched} of {len(payloads)} raw rows found in the ingest")
    err = _margin_only_vs_plain(model, matched_rows, [r["prob_default"] for r in matched_resps])
    names = list(plan.tree_feature_names)
    o = raw[-1].cpu().numpy()
    grade = [j for j, n in enumerate(names) if n.startswith("grade_")]
    fill = names.index(f"hardship_status_{schema.HARDSHIP_FILL}")
    hs = [j for j, n in enumerate(names) if n.startswith("hardship_status_")]
    if not (np.isnan(o[names.index("annual_inc")]) and (o[grade] == 0.0).all()
            and all(o[j] == (1.0 if j == fill else 0.0) for j in hs)):
        raise AssertionError("missing / unknown raw values do not follow training")
    return {"rows": len(resps), "matched": matched, "predict_raw_launches": launches,
            "predict_raw_s": predict_raw_s, "prob_max_abs_err": err}


def _margin_only_vs_plain(model, rows: list[np.ndarray], probs: list[float]) -> float:
    """Each row, one at a time as ``predict_raw`` and a one-row ``/predict``
    score it, through the margin-only launch and through the plain version
    on the same tensor on the model's device: margins bitwise equal, prob
    within `TOL_PROB`, and the response's prob that of the launch. Returns
    the largest prob difference from the plain version."""
    err = 0.0
    for i, (row, prob) in enumerate(zip(rows, probs)):
        x = torch.from_numpy(np.ascontiguousarray(row[None, :], np.float32)).to(model.device)
        k_margin, k_prob = model.margin_fn(x)
        p_margin, p_prob = fused_score_reference(
            model.pack, x, n_features=model.n_features, with_shap=False
        )
        if not torch.equal(k_margin, p_margin):
            raise AssertionError(f"row {i}: kernel margin {k_margin.tolist()} vs plain {p_margin.tolist()}")
        d = float((k_prob - p_prob).abs().max())
        if d > TOL_PROB or prob != float(k_prob[0]):
            raise AssertionError(
                f"row {i}: prob {prob}, kernel {float(k_prob[0])}, plain {float(p_prob[0])}"
            )
        err = max(err, d)
    return err


def degraded_predict(service: ScorerService) -> dict:
    """Phase 6d: the SHAP launch made to fail; /predict over HTTP degrades."""
    service._model.shap_fn = _boom
    server = make_async_server(service, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    try:
        row = request_rows(1, SEED + 6)[0]
        resp = _post(base + "/predict", json.dumps(row).encode(), "application/json")
        ready = _get(base + "/readyz")
    finally:
        server.close()
    if resp.get("degraded") is not True or resp.get("shap_values") is not None:
        raise AssertionError(f"/predict did not degrade: {resp}")
    model = service._model
    x = model.rows_array([{n: float(row[k]) for n, k in zip(schema.SERVING_FEATURES, _request_keys())}])
    if ready["microbatch"]["degraded_batches"] != 1:
        raise AssertionError(f"readyz after the degraded /predict: {ready['microbatch']}")
    err = _margin_only_vs_plain(model, [x[0]], [resp["prob_default"]])
    return {"prob_default": resp["prob_default"], "prob_max_abs_err": err,
            "degraded_batches": ready["microbatch"]["degraded_batches"]}


# -- the training protocol ---------------------------------------------------------

#: Loans of the card-vs-CPU protocol run (8a), and its profile: RFE 104 -> 62
#: -> 20 with a 10-tree selector, and a 4 x 2 search over depths 3 and 5 whose
#: CPU run takes seconds. Its candidates draw no row or column samples: the
#: card's random generator draws other numbers than the CPU's.
PROTOCOL_CHECK_ROWS = 50_000
CHECK_PROFILE = PipelineConfig(
    rfe=RFEConfig(n_select=20, step=42, n_estimators=10, max_depth=3),
    tune=TuneConfig(
        n_iter=4,
        cv_folds=2,
        param_space={"n_estimators": (10, 20), "max_depth": (3, 5), "learning_rate": (0.1,)},
    ),
)
#: CV and held-out AUC, card against CPU.
TOL_PROTOCOL_AUC = 1e-4
#: Raw rows scored through predict_raw on the pipeline's artifact.
PROTOCOL_SERVE_ROWS = 16
#: The depth of phase 8b's deepest histogram shape: the search's depth-9
#: candidates (K = 256 nodes at the last level).
DEEPEST = 9


def protocol_card_vs_cpu(device: str = "cuda", n_rows: int = PROTOCOL_CHECK_ROWS) -> dict:
    """Phase 8a: `run_pipeline` on one raw frame, on the card and on the CPU."""
    frame = synthetic_lendingclub_frame(n_rows, seed=SEED)
    runs, secs = {}, {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        runs[dev] = run_pipeline(CHECK_PROFILE, raw=frame, device=dev, today=TODAY)
        secs[dev] = time.perf_counter() - t0
    card, cpu = runs[device], runs["cpu"]
    cc, pc = card.search.cv_results_, cpu.search.cv_results_
    if card.selected_features != cpu.selected_features:
        raise AssertionError(f"RFE selected {card.selected_features} on the card, "
                             f"{cpu.selected_features} on the CPU")
    if cc["params"] != pc["params"] or not np.array_equal(cc["val_masks"], pc["val_masks"]):
        raise AssertionError("the search's candidates or folds differ between card and CPU")
    if card.best_params != cpu.best_params:
        raise AssertionError(f"best params {card.best_params} on the card, {cpu.best_params} on the CPU")
    cv_err = float(np.abs(cc["split_test_scores"] - pc["split_test_scores"]).max())
    test_err = abs(card.test_auc - cpu.test_auc)
    if max(cv_err, test_err) > TOL_PROTOCOL_AUC:
        raise AssertionError(f"AUCs differ between card and CPU: CV by {cv_err}, test by {test_err}")
    return {"loans": n_rows, "card_s": secs[device], "cpu_s": secs["cpu"],
            "selected_features": list(card.selected_features), "best_params": card.best_params,
            "cv_auc_max_abs_err": cv_err, "test_auc_abs_err": test_err,
            "test_auc": card.test_auc, "hist_launches": card.hist_launches}


def search_launches(base: GBDTConfig, tune: TuneConfig, search) -> int:
    """Histogram launches of `randomized_search`: one per tree level of
    every tree each CV job boosted, then of the refit. Under halving a job
    boosts whole chunks up to its last rung's budget (capped at its
    ``n_estimators``): ``min(chunk * ceil(scored_at / chunk), n_estimators)``
    trees, from the report's ``scored_at_trees`` and its depth's chunk."""
    report = search.cv_results_.get("halving")
    total = 0
    for c, cand in enumerate(search.cv_results_["params"]):
        g = base.replace(**cand)
        trees = g.n_estimators
        if report is not None:
            chunk = report["chunk_trees"][g.max_depth]
            trees = min(chunk * math.ceil(report["scored_at_trees"][c] / chunk), g.n_estimators)
        total += tune.cv_folds * trees * g.max_depth
    best = base.replace(**search.best_params_)
    return total + best.n_estimators * best.max_depth


def expected_launches(cfg: PipelineConfig, res: PipelineResult, n_features: int) -> dict[str, int]:
    """Histogram launches each stage of `run_pipeline` must make on the card:
    one per tree level of every fit (RFE refits, CV jobs, the refit)."""
    rfe_cfg = cfg.rfe
    n_iters = -(-(n_features - rfe_cfg.n_select) // rfe_cfg.step)
    return {"host_frontier": 0, "device_ingest": 0,
            "rfe": n_iters * rfe_cfg.n_estimators * rfe_cfg.max_depth,
            "search": search_launches(cfg.gbdt, cfg.tune, res.search), "eval": 0}


def serve_payloads(store: ObjectStore, key: str, payloads: list[dict], dev: torch.device) -> dict:
    """`ScorerService.predict_raw` on raw payloads with the published
    artifact: one ``score_forest`` launch per row (on the card), each
    prob against the plain version of the margin-only launch."""
    service = ScorerService.from_store(store, ServeConfig(model_key=key), device=dev)
    try:
        fused_score.launches = 0
        resps = [service.predict_raw(p) for p in payloads]
        launches = fused_score.launches
        if dev.type == "cuda" and launches != len(payloads):
            raise AssertionError(f"{launches} fused_score launches for {len(payloads)} rows")
        rows = [np.array([r["engineered_row"][n] for n in service.feature_names], np.float32)
                for r in resps]
        return {"rows": len(resps), "launches": launches,
                "prob_max_abs_err": _margin_only_vs_plain(
                    service._model, rows, [r["prob_default"] for r in resps])}
    finally:
        service.close()


def same_forest(a: gbdt.Forest, b: gbdt.Forest) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f).to(getattr(a, f).device))
               for f in ("feature", "thr_bin", "thr_float", "missing_left", "gain", "cover",
                         "leaf_value"))


def protocol_phase(
    card: str, frame: RawFrame, cfg: PipelineConfig, train_rows: tuple, root: str,
    device: str = "cuda",
) -> tuple[dict, dict, list[dict], PipelineResult, list[dict]]:
    """Phase 8b: the main path, `run_pipeline` from the raw table to a
    published artifact in the store at ``root`` (with its intermediate
    tables and stage manifests), served by `predict_raw`; then the first
    tree's histograms at the protocol's new shapes. Returns (summary,
    launches of each kernel on the path, histogram records, the run's
    result, the raw payloads it served)."""
    dev = torch.device(device)
    picks = np.sort(np.random.default_rng(SEED + 8).choice(frame.n_rows, PROTOCOL_SERVE_ROWS, replace=False))
    payloads = row_dicts(frame, picks)
    out: dict = {}
    store = ObjectStore(root)
    key = cfg.serve.model_key
    gradient_histogram_channels.launches = 0
    fused_score.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    obs = {"stages_before": stage_histogram()}
    hist_before = program_counts("gradient_histogram/")
    t0 = time.perf_counter()
    res = run_pipeline(cfg, raw=frame, store=store, device=dev, today=TODAY)
    out["run_pipeline_s"] = time.perf_counter() - t0
    obs["hist_programs"] = program_delta(hist_before, program_counts("gradient_histogram/"))
    hist_launches = gradient_histogram_channels.launches
    if dev.type == "cuda":
        out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    n_features = len(train_rows[2])
    expect = expected_launches(cfg, res, n_features)
    if dev.type == "cuda" and (res.hist_launches != expect or hist_launches != sum(expect.values())):
        raise AssertionError(f"histogram launches {res.hist_launches} (total {hist_launches}), "
                             f"expected {expect}")
    report = res.search.cv_results_.get("halving")
    out.update(
        stage_s=res.timings, hist_launches=res.hist_launches, tree_features=n_features,
        selected_features=list(res.selected_features),
        candidates=res.search.cv_results_["params"],
        mean_cv_auc=res.search.cv_results_["mean_test_score"].tolist(),
        best_params=res.best_params, cv_auc=res.cv_auc, test_auc=res.test_auc,
        scale_pos_weight=res.scale_pos_weight, stages_run=list(res.stages_run),
        intermediates=res.intermediates, halving=report,
    )
    if cfg.tune.halving_enabled and cfg.tune.chunk_trees is not None and report is None:
        raise AssertionError("the quick profile's search ran without halving")
    if report is not None:
        print(f"halving rungs (8b): budgets={report['budgets']} chunk={report['chunk_trees']} "
              f"rungs={json.dumps(report['rungs'])} survivors={report['survivors']} "
              f"scored_at_trees={report['scored_at_trees']} [{card}]")
    if res.intermediates:
        sizes = res.intermediates["bytes"]
        print(f"intermediates (8b): {res.intermediates['seconds']:.3f}s to write "
              f"{sum(sizes.values())} bytes ({json.dumps(sizes)}) [{card}]")
    if len(res.selected_features) != cfg.rfe.n_select or not 0.5 < res.test_auc <= 1.0:
        raise AssertionError(f"{len(res.selected_features)} features, test AUC {res.test_auc}")
    metrics = store.get_json(key + ".metrics.json")
    if set(metrics) != {"auc", "classification_report", "best_params"}:
        raise AssertionError(f"metrics.json keys {sorted(metrics)}")
    if store.get_json(key + ".features.json") != list(res.selected_features):
        raise AssertionError("features.json differs from the selected features")
    ckpt = PipelineCheckpoint(store, cfg.reliability.checkpoint_prefix)
    if any(ckpt.load(stage) is None for stage in STAGES):
        raise AssertionError("a stage manifest is missing after the run")
    art = GBDTArtifact.load(store, key, dev)
    if not same_forest(art.forest, res.artifact.forest):
        raise AssertionError("the reloaded artifact differs")
    if art.plan is None or art.feature_names != res.selected_features:
        raise AssertionError("the reloaded artifact lost its plan or its features")
    del art
    out["predict_raw"] = serve_payloads(store, key, payloads, dev)
    score_launches = out["predict_raw"]["launches"]
    records = []  # kernel against plain: on the card only
    if dev.type == "cuda":
        records = protocol_histogram_shapes(train_rows, out["selected_features"],
                                            out["scale_pos_weight"], dev)
    for r in records:
        print(histogram_line(r, card))
    print(f"protocol: {json.dumps(out)} [{card}]")
    out["observability"] = obs  # phase 11b reads it
    return out, {"gradient_histogram": hist_launches, "score_forest": score_launches}, records, res, payloads


def protocol_rows(frame: RawFrame, device: str = "cuda") -> tuple:
    """The training split of every tree feature after the leakage drop, as
    phase 6 makes it, on the host: ``(X, y, names)``."""
    res = run_device_ingest(tokenize_raw_frame(frame, today=TODAY), device=device)
    ff = drop_training_leakage(res.tree)
    X_train, _, y_train, _ = train_test_split_hashed(ff.X, ff.y)
    return X_train.cpu(), y_train.cpu(), ff.feature_names


def protocol_histogram_shapes(train_rows: tuple, selected: list[str], spw: float,
                              dev: torch.device) -> list[dict]:
    """The first tree's histogram calls, kernel against plain (as 5b), at the
    shapes the protocol brings: the default RFE selector's (64 bins, every
    tree feature, depth 6) and a depth-9 search candidate's (255 bins, the
    selected features, up to K = 256 nodes)."""
    X_cpu, y_cpu, names = train_rows
    X, y = X_cpu.to(dev), y_cpu.to(dev)
    rfe_cfg = RFEConfig()
    bins = transform(compute_bin_edges(X, SELECTOR_BINS), X)
    hp = gbdt.GBDTHyperparams.from_config(GBDTConfig(
        n_estimators=rfe_cfg.n_estimators, max_depth=rfe_cfg.max_depth, n_bins=SELECTOR_BINS,
        scale_pos_weight=spw))
    calls = first_tree_calls(bins, y, hp, gbdt.fold_in(rfe_cfg.seed, 0), SELECTOR_BINS,
                             rfe_cfg.max_depth)
    records = [dict(r, shape=f"rfe selector F={bins.shape[1]} B={SELECTOR_BINS} {r['shape']}")
               for r in histogram_phase(bins, calls, SELECTOR_BINS)]
    del bins, calls
    Xs = X.index_select(1, torch.tensor([names.index(n) for n in selected], device=dev))
    del X
    cfg = GBDTConfig(n_estimators=1, max_depth=DEEPEST, scale_pos_weight=spw)
    bins = transform(compute_bin_edges(Xs, cfg.n_bins), Xs)
    calls = first_tree_calls(bins, y, gbdt.GBDTHyperparams.from_config(cfg), cfg.seed,
                             cfg.n_bins, DEEPEST)
    records += [dict(r, shape=f"depth {DEEPEST} F={bins.shape[1]} B={cfg.n_bins} {r['shape']}")
                for r in histogram_phase(bins, calls, cfg.n_bins)]
    return records


# -- the protocol's resumable, halving path (phase 10) ---------------------------------

#: Report keys of the reference's halving search.
HALVING_KEYS = ("eta", "budgets", "rungs", "pruned_candidates", "survivors", "scored_at_trees",
                "dispatches", "chunk_trees")
#: 10c: card against CPU. RFECV's scores (20-tree depth-3 fold fits)
#: within 1e-6; the chunked search's (up to 48 trees of depth 5) within
#: 8a's tolerance: the card's fixed-point histogram sums round otherwise
#: than the CPU's float sums, and over 48 trees the margins drift apart by
#: ulps that reorder a few rows (2.03e-6 measured on the H100).
TOL_RFECV_AUC = 1e-6
#: 10c's search: chunks of 12 trees, candidates that draw nothing.
CHUNKED_TUNE = TuneConfig(
    n_iter=4, cv_folds=2, chunk_trees=12,
    param_space={"n_estimators": (24, 48), "max_depth": (3, 5), "learning_rate": (0.1, 0.3)},
)


def _cv_equal(a: dict, b: dict) -> bool:
    """Two searches' results bitwise equal: candidates, split and mean
    scores, and the halving report."""
    return (a["params"] == b["params"]
            and np.array_equal(a["split_test_scores"], b["split_test_scores"])
            and np.array_equal(a["mean_test_score"], b["mean_test_score"])
            and a.get("halving") == b.get("halving"))


def halving_phase(card: str, train_rows: tuple, cfg: PipelineConfig, res: PipelineResult,
                  device: str = "cuda") -> dict:
    """Phase 10a: the quick profile's search on 8b's selected training
    columns and ``scale_pos_weight``, with halving and exhaustive: each
    survivor's split scores bitwise the exhaustive run's, the halving run
    bitwise 8b's search, the rungs and chunk those the reference's cost
    model and ladder give at this row count; then one chunk of a rung-1 job
    with CUDA events around each histogram launch (on the card)."""
    dev = torch.device(device)
    X_cpu, y_cpu, names = train_rows
    X = X_cpu.index_select(1, torch.tensor([names.index(n) for n in res.selected_features])).to(dev)
    y = y_cpu.to(dev)
    N, F = X.shape
    base = cfg.gbdt.replace(scale_pos_weight=res.scale_pos_weight)
    runs, out = {}, {"rows": N, "features": F}
    for mode, halving in (("halving", True), ("exhaustive", False)):
        tune = dataclasses.replace(cfg.tune, halving_enabled=halving)
        gradient_histogram_channels.launches = 0
        _sync(dev)
        t0 = time.perf_counter()
        runs[mode] = randomized_search(X, y, base, tune, device=dev)
        _sync(dev)
        out[f"{mode}_s"] = time.perf_counter() - t0
        out[f"{mode}_launches"] = gradient_histogram_channels.launches
        expect = search_launches(base, tune, runs[mode])
        if dev.type == "cuda" and out[f"{mode}_launches"] != expect:
            raise AssertionError(f"{mode} search: {out[f'{mode}_launches']} launches, expected {expect}")
    hv, ex = runs["halving"], runs["exhaustive"]
    report = hv.cv_results_.get("halving")
    if report is None or "halving" in ex.cv_results_:
        raise AssertionError("halving did not engage, or engaged in the exhaustive run")
    surv = report["survivors"]
    if not np.array_equal(hv.cv_results_["split_test_scores"][surv], ex.cv_results_["split_test_scores"][surv]):
        raise AssertionError("a survivor's scores differ from the exhaustive run's")
    if not _cv_equal(hv.cv_results_, res.search.cv_results_) or hv.best_params_ != res.best_params:
        raise AssertionError("the halving search differs from 8b's on the same columns")
    # The reference's cost model and ladder at this shape.
    cands = hv.cv_results_["params"]
    K = cfg.tune.cv_folds
    cfgs = [base.replace(**c) for c in cands]
    chunk_of = {}
    for d in sorted({c.max_depth for c in cfgs}):
        groups = [g for g in search_buckets(cands, base) if cfgs[g[0]].max_depth == d]
        cap = max(cfgs[i].n_estimators for g in groups for i in g)
        ck = resolve_chunk_trees(cfg.tune.chunk_trees, n_trees=cap, n_rows=N, n_feats=F,
                                 n_bins=base.n_bins, depth=d, hist_subtract=base.hist_subtract,
                                 n_jobs=max(_pow2_jobs(len(g) * K, 1) for g in groups))
        chunk_of[d] = cap if ck is None else min(ck, cap)
    budgets = halving_ladder(max(c.n_estimators for c in cfgs), len(cands),
                             eta=cfg.tune.halving_eta, min_rungs=cfg.tune.halving_min_rungs)
    if report["chunk_trees"] != chunk_of or report["budgets"] != budgets:
        raise AssertionError(f"rungs {report['budgets']} chunk {report['chunk_trees']}, "
                             f"the cost model gives {budgets} and {chunk_of}")
    out.update(budgets=budgets, chunk_trees=chunk_of, rungs=report["rungs"], survivors=surv,
               scored_at_trees=report["scored_at_trees"], best_params=hv.best_params_,
               exhaustive_best_params=ex.best_params_,
               quick_shape_26_and_75_150_300=(chunk_of == {3: 26} and budgets == [75, 150, 300]))
    if dev.type == "cuda":
        out["rung_hist"] = rung_histogram(X, y, y_cpu, base, cfg.tune, cands.index(hv.best_params_),
                                          chunk_of)
    print(f"halving vs exhaustive (10a): {json.dumps(out)} [{card}]")
    return out


def rung_histogram(X, y, y_cpu, base: GBDTConfig, tune: TuneConfig, best: int, chunk_of: dict) -> dict:
    """The histogram inside a halving rung: the first chunk of candidate
    ``best``'s fold-0 job, with CUDA events around each launch; device ms
    per launch at each level."""
    dev = X.device
    F = X.shape[1]
    K = tune.cv_folds
    hp = gbdt.GBDTHyperparams.from_config(base.replace(**sample_candidates(
        tune.param_space, tune.n_iter, tune.seed)[best]))
    bins = transform(compute_bin_edges(X, base.n_bins), X)
    val = torch.from_numpy(stratified_kfold_masks(y_cpu.numpy(), K, tune.seed)).to(dev)
    timer = TimedHistogram()
    chunk = chunk_of[hp.max_depth]
    gbdt.fit_binned_resumable(
        bins, y, 1.0 - val[0].float(), torch.ones(F, dtype=torch.bool, device=dev), hp,
        gbdt.fold_in(tune.seed, best * K), n_trees_cap=chunk, depth_cap=hp.max_depth,
        n_bins=base.n_bins, histogram=timer,
    )
    total = timer.total_ms()
    per_call = [s.elapsed_time(e) for s, e in timer.events]
    return {
        "candidate": best, "trees": chunk, "launches": len(per_call), "ms_total": total,
        "ms_per_level": [float(np.mean(per_call[lvl::hp.max_depth])) for lvl in range(hp.max_depth)],
    }


def resume_phase(card: str, root: str, cfg: PipelineConfig, res: PipelineResult,
                 payloads: list[dict], device: str = "cuda") -> dict:
    """Phase 10b: resume 8b's run from its store on the card: all stages up
    to the search restored, the refit and the artifact bitwise 8b's; then,
    with the search's manifest invalidated, the search rerun bitwise 8b's;
    then raw rows served by the resumed artifact."""
    dev = torch.device(device)
    store = ObjectStore(root)
    ckpt = PipelineCheckpoint(store, cfg.reliability.checkpoint_prefix)
    out: dict = {}
    fps = stage_fingerprints(cfg)
    t0 = time.perf_counter()
    valid = {stage: ckpt.valid(stage, fps[stage]) for stage in STAGES}
    out["validate_s"] = time.perf_counter() - t0
    if not all(valid.values()):
        raise AssertionError(f"8b's manifests do not validate: {valid}")
    out["tree_csv_bytes"] = ckpt.load("engineer")["pointers"][cfg.data.tree_key]["size"]
    key = cfg.serve.model_key
    best = cfg.gbdt.replace(**res.best_params)
    runs = {}
    for name, skipped, run in (
        ("resume", ("clean", "engineer", "rfe", "search"), ("eval",)),
        ("resume_after_invalidate", ("clean", "engineer", "rfe"), ("search", "eval")),
    ):
        if name == "resume_after_invalidate":
            ckpt.invalidate("search")
        gradient_histogram_channels.launches = 0
        _sync(dev)
        t0 = time.perf_counter()
        r = runs[name] = run_pipeline(cfg, raw=None, store=store, resume=True, device=dev, today=TODAY)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_stage_s"] = r.timings
        out[f"{name}_launches"] = gradient_histogram_channels.launches
        if r.stages_skipped != skipped or r.stages_run != run:
            raise AssertionError(f"{name}: ran {r.stages_run}, skipped {r.stages_skipped}")
        if not same_forest(r.artifact.forest, res.artifact.forest) or r.test_auc != res.test_auc:
            raise AssertionError(f"{name}: the artifact or test AUC differs from 8b's")
        if r.selected_features != res.selected_features or r.best_params != res.best_params:
            raise AssertionError(f"{name}: the selection or the best params differ from 8b's")
    refit = best.n_estimators * best.max_depth
    rerun = search_launches(cfg.gbdt.replace(scale_pos_weight=res.scale_pos_weight), cfg.tune, res.search)
    if dev.type == "cuda" and (out["resume_launches"], out["resume_after_invalidate_launches"]) != (refit, rerun):
        raise AssertionError(f"resumed runs made {out['resume_launches']} and "
                             f"{out['resume_after_invalidate_launches']} launches, not {refit} and {rerun}")
    # The first resume's "restore" stage is the read of the tree CSV:
    # fetched and verified against its pointer, parsed, moved to the card.
    out["read_tree_csv_s"] = runs["resume"].timings["restore"]
    if not _cv_equal(runs["resume_after_invalidate"].search.cv_results_, res.search.cv_results_):
        raise AssertionError("the rerun search's results differ from 8b's")
    if not GBDTArtifact.load(store, key, dev).forest.leaf_value.equal(res.artifact.forest.leaf_value.to(dev)):
        raise AssertionError("the stored artifact differs from 8b's")
    out["predict_raw"] = serve_payloads(store, key, payloads[:4], dev)
    print(f"resume (10b): {json.dumps(out)} [{card}]")
    return out


def selection_card_vs_cpu(card: str, n_rows: int = PROTOCOL_CHECK_ROWS, device: str = "cuda") -> dict:
    """Phase 10c: RFECV and a chunked halving search on the card and on the
    CPU, on 8a's frame. Nothing draws at random (the quick selector;
    candidates with subsample = colsample = 1)."""
    X, y, _ = protocol_rows(synthetic_lendingclub_frame(n_rows, seed=SEED), device)
    n_pos = float(y.sum())
    rfe_cfg = dataclasses.replace(quick_config().rfe, scale_pos_weight=(len(y) - n_pos) / n_pos)
    out: dict = {"rows": int(X.shape[0]), "features": int(X.shape[1])}
    sel, secs = {}, {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        sel[dev] = rfe_select(X, y, rfe_cfg, cv_folds=3, device=dev)
        secs[dev] = time.perf_counter() - t0
    card_r, cpu_r = sel[device], sel["cpu"]
    if not (np.array_equal(card_r.support_, cpu_r.support_) and np.array_equal(card_r.ranking_, cpu_r.ranking_)):
        raise AssertionError("RFECV selects other features on the card")
    if sorted(card_r.cv_scores_) != sorted(cpu_r.cv_scores_):
        raise AssertionError("RFECV scored other feature counts on the card")
    rfecv_err = max(abs(card_r.cv_scores_[n] - cpu_r.cv_scores_[n]) for n in cpu_r.cv_scores_)
    out.update(rfecv_card_s=secs[device], rfecv_cpu_s=secs["cpu"], rfecv_cv_scores=cpu_r.cv_scores_,
               rfecv_n_features=cpu_r.n_features_, rfecv_max_abs_err=rfecv_err)
    Xs = X[:, torch.from_numpy(np.flatnonzero(cpu_r.support_))]
    search = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        search[dev] = randomized_search(Xs, y, GBDTConfig(), CHUNKED_TUNE, device=dev)
        secs[dev] = time.perf_counter() - t0
    card_s, cpu_s = search[device].cv_results_, search["cpu"].cv_results_
    if "halving" not in cpu_s or any(card_s["halving"][k] != cpu_s["halving"][k] for k in HALVING_KEYS):
        raise AssertionError("the halving reports differ between card and CPU")
    search_err = float(np.abs(card_s["split_test_scores"] - cpu_s["split_test_scores"]).max())
    if search[device].best_params_ != search["cpu"].best_params_:
        raise AssertionError("the halving search picked another winner on the card")
    out.update(search_card_s=secs[device], search_cpu_s=secs["cpu"], halving=cpu_s["halving"],
               best_params=search["cpu"].best_params_, search_max_abs_err=search_err)
    if rfecv_err > TOL_RFECV_AUC or search_err > TOL_PROTOCOL_AUC:
        raise AssertionError(f"card and CPU scores differ: RFECV by {rfecv_err}, search by {search_err}")
    print(f"selection card_vs_cpu (10c): {json.dumps(out)} [{card}]")
    return out


def quantized_phase(card: str) -> tuple[list[dict], dict]:
    """Phase 9: the bf16 and int8 packs (9a), the kernel against the plain
    version at every bucket on phase 3's rows (9b), and an int8 service
    over HTTP (9c). Prints each record; returns the kernel records and the
    service's."""
    records = []
    for precision in QUANTIZED:
        print(f"quantized pack: {json.dumps(quantized_pack_phase(precision))} [{card}]")
        for r in kernel_phase("cuda", precision):
            records.append(r)
            print(f"kernel score_forest precision={precision} bucket={r['bucket']} "
                  f"shap={r['with_shap']} ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} "
                  f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
                  f"err={ {k: r[k] for k in ('prob', 'phis', 'additivity') if k in r} } "
                  f"[{card}]")
    serving = serving_phase("cuda", precision="int8")
    print(f"serving: {json.dumps(serving)} [{card}]")
    return records, serving


# -- observability (phase 11) -----------------------------------------------------

#: Bursts of 64 concurrent /predict, each held into one 64-row batch (11a).
BURSTS_64 = 4
#: Rows of the training CLI's run in 11c.
CLI_ROWS = 200_000
#: Recorded dispatches timed on the host in 11d.
OVERHEAD_DISPATCHES = 10_000


def program_counts(prefix: str) -> dict[str, tuple[int, float]]:
    """``{program: (dispatches, dispatch seconds)}`` of the programs whose
    name starts with ``prefix`` (their finished events resolved)."""
    return {
        r["name"]: (r["dispatches"], r["dispatch_seconds"])
        for r in default_program_registry().table()
        if r["name"].startswith(prefix)
    }


def program_delta(before: dict, after: dict) -> dict[str, tuple[int, float]]:
    """Dispatches and seconds each program added between two counts."""
    out = {}
    for name, (n, sec) in after.items():
        n0, s0 = before.get(name, (0, 0.0))
        if n != n0:
            out[name] = (n - n0, sec - s0)
    return out


def _label_samples(fams: dict, family: str, label: str) -> dict[str, float]:
    """``{label value: value}`` of a `parse_exposition` family."""
    out = {}
    for key, value in fams.get(family, {}).get("samples", {}).items():
        for part in key.split("|")[1:]:
            name, _, v = part.partition("=")
            if name == label:
                out[v] = value
    return out


def _get_with_id(url: str, request_id: str | None) -> tuple[int, dict, bytes]:
    headers = {} if request_id is None else {"X-Request-ID": request_id}
    with urllib.request.urlopen(urllib.request.Request(url, headers=headers), timeout=60) as resp:
        return resp.status, dict(resp.headers), resp.read()


def observability_serving_phase(card: str, kernel_records: list[dict], device: str = "cuda") -> dict:
    """Phase 11a: phase 4's traffic (32 concurrent /predict, a 5,000-row
    bulk CSV, an importance request) to the committed model on the card,
    then `BURSTS_64` bursts of 64 concurrent /predict held into one 64-row
    batch each; ``/metrics`` scraped and parsed with the port's
    `parse_exposition`: the ``score_forest`` programs' dispatches sum to
    the ``fused_score.launches`` delta over the phase and their event
    seconds are above 0; the mean device ms per dispatch at the 64-row SHAP
    bucket beside phase 3's CUDA-event ms there; ``cobalt_device_mem_bytes``
    present, ``bytes_limit`` equal to ``mem_get_info``'s total;
    ``/debug/trace``, ``/debug/slowest``, ``/slo`` and ``X-Request-ID``.
    On ``device="cpu"`` the plain version's programs are read, and no
    launch is counted."""
    cuda = device == "cuda"
    entry = "score_forest/" if cuda else "score_forest_plain/"
    fused_score.launches = 0
    before = program_counts(entry)
    service = ScorerService.from_store(ObjectStore(str(STORE)), ServeConfig(), device=device)
    server = make_async_server(service, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    out: dict = {}
    try:
        rows = request_rows(32)
        with ThreadPoolExecutor(max_workers=64) as pool:
            list(pool.map(lambda r: _post(base + "/predict", json.dumps(r).encode(),
                                          "application/json"), rows))
            Xb = seeded_rows(service._model.pack, 5000, SEED + 1)
            lines = [",".join(f'"{n}"' for n in service.feature_names)]
            lines += [",".join("" if np.isnan(v) else repr(float(v)) for v in r) for r in Xb]
            _post(base + "/predict_bulk_csv", "\n".join(lines).encode(), "text/csv")
            _post(base + "/feature_importance_bulk", json.dumps({"data": rows[:2]}).encode(),
                  "application/json")
            burst = request_rows(64, SEED + 11)
            for _ in range(BURSTS_64):
                with service.batcher.pause():
                    futs = [pool.submit(_post, base + "/predict", json.dumps(r).encode(),
                                        "application/json") for r in burst]
                    while service.batcher.queue_depth() < len(burst):
                        time.sleep(0.001)
                [f.result() for f in futs]
        status, headers, text = _get_with_id(base + "/metrics", "chip-smoke-11a")
        if status != 200 or headers.get("X-Request-ID") != "chip-smoke-11a":
            raise AssertionError(f"/metrics answered {status} with X-Request-ID "
                                 f"{headers.get('X-Request-ID')!r}")
        fams = parse_exposition(text.decode())
        _, minted, _ = _get_with_id(base + "/healthz", None)
        if not minted.get("X-Request-ID"):
            raise AssertionError("no X-Request-ID minted for a request without one")
        trace = json.loads(_get_with_id(base + "/debug/trace", None)[2])
        slowest = json.loads(_get_with_id(base + "/debug/slowest", None)[2])["slowest"]
        slo = json.loads(_get_with_id(base + "/slo", None)[2])
    finally:
        server.close()
        service.close()
    launches = fused_score.launches
    dispatches = _label_samples(fams, "cobalt_program_dispatches_total", "program")
    seconds = _label_samples(fams, "cobalt_program_dispatch_seconds_total", "program")
    scraped = {k: (int(dispatches[k]), seconds[k]) for k in dispatches if k.startswith(entry)}
    delta = program_delta(before, scraped)
    n_disp = sum(n for n, _ in delta.values())
    if cuda and (n_disp != launches or launches == 0):
        raise AssertionError(f"score_forest programs dispatched {n_disp} times, "
                             f"fused_score.launches rose by {launches}: {delta}")
    if not all(sec > 0 for _, sec in delta.values()):
        raise AssertionError(f"a score_forest program has no event seconds: {delta}")
    n64, s64 = delta[entry + "f32/64/shap"]
    out["score_forest_dispatches"] = n_disp
    out["score_forest_programs"] = {k: {"dispatches": n, "seconds": sec} for k, (n, sec) in delta.items()}
    out["ms_per_dispatch_64_shap"] = s64 / n64 * 1e3
    out["phase3_ms_64_shap"] = next(r["ms"] for r in kernel_records if r["bucket"] == 64)
    mem = _label_samples(fams, "cobalt_device_mem_bytes", "device")
    if cuda:
        limit = device_info()[0]["memory_stats"]["bytes_limit"]
        total = torch.cuda.mem_get_info(0)[1]
        if not mem.get("cuda:0", 0) > 0 or limit != total:
            raise AssertionError(f"cobalt_device_mem_bytes {mem}, bytes_limit {limit} vs "
                                 f"mem_get_info {total}")
        out["bytes_limit"] = limit
    elif set(mem) != {"cpu"}:
        raise AssertionError(f"cobalt_device_mem_bytes on the CPU: {mem}")
    out["device_mem_bytes"] = mem
    dispatch_spans = [e for e in trace["traceEvents"] if e.get("name") == "serve.dispatch"]
    if not dispatch_spans:
        raise AssertionError("/debug/trace holds no serve.dispatch span")
    if not slowest or not all("dispatch" in r["phases_ms"] for r in slowest if r["route"] == "/predict"):
        raise AssertionError(f"/debug/slowest lists no request with its phases: {slowest[:2]}")
    if not slo.get("objectives"):
        raise AssertionError(f"/slo answered {slo}")
    out["trace_dispatch_spans"] = len(dispatch_spans)
    out["slowest"] = [{"route": r["route"], "duration_ms": r["duration_ms"],
                       "phases_ms": r["phases_ms"]} for r in slowest[:3]]
    print(f"observability serving (11a): score_forest dispatches {n_disp} = launches {launches}; "
          f"64-row SHAP bucket {out['ms_per_dispatch_64_shap']:.6f} ms per dispatch (CUDA events "
          f"in the registry, {n64} dispatches) vs phase 3 {out['phase3_ms_64_shap']:.6f} ms "
          f"[{card}]")
    return out


def stage_histogram() -> dict[str, tuple[int, float]]:
    """``{stage: (count, sum)}`` of ``cobalt_pipeline_stage_seconds``."""
    fam = default_registry().snapshot().get("cobalt_pipeline_stage_seconds", {})
    return {s["labels"]["stage"]: (s["count"], s["sum"]) for s in fam.get("samples", [])}


def observability_protocol(card: str, res: PipelineResult, obs: dict, cfg: PipelineConfig) -> dict:
    """Phase 11b, on 8b's run: ``cobalt_pipeline_stage_seconds`` observed
    once per stage, equal to ``result.timings`` to the snapshot's rounding;
    the tracer's last ``pipeline.run`` span with every stage as a child; the
    histogram programs' dispatches over the run equal to its
    ``hist_launches``, split into ``rfe`` (the selector's bins) and
    ``search`` (the model's), their event seconds beside the stages'."""
    hist = {k: (c - obs["stages_before"].get(k, (0, 0.0))[0],
                sm - obs["stages_before"].get(k, (0, 0.0))[1])
            for k, (c, sm) in stage_histogram().items()}
    for stage, sec in res.timings.items():
        count, total = hist.get(stage, (0, 0.0))
        if count != 1 or abs(total - round(sec, 6)) > 2e-6:
            raise AssertionError(f"stage {stage}: {count} observations summing {total}, timing {sec}")
    spans = default_tracer().export()
    run = [sp for sp in spans if sp["name"] == "pipeline.run"][-1]
    children = {sp["name"] for sp in spans if sp["parent_id"] == run["span_id"]}
    if children != {f"pipeline.{s}" for s in res.timings}:
        raise AssertionError(f"pipeline.run's children {sorted(children)}, stages {list(res.timings)}")
    delta = obs["hist_programs"]
    by_stage = {"rfe": SELECTOR_BINS, "search": cfg.gbdt.n_bins}
    split = {}
    for stage, n_bins in by_stage.items():
        rows = [v for k, v in delta.items() if k.endswith(f"xB{n_bins}")]
        split[stage] = (sum(n for n, _ in rows), sum(sec for _, sec in rows))
    total = sum(n for n, _ in delta.values())
    if total != sum(res.hist_launches.values()) or any(
        split[st][0] != res.hist_launches[st] for st in split
    ):
        raise AssertionError(f"histogram programs {delta} against hist_launches {res.hist_launches}")
    out = {
        "hist_dispatches": total,
        "hist_programs": {k: {"dispatches": n, "seconds": sec} for k, (n, sec) in delta.items()},
    }
    for stage, (n, sec) in split.items():
        out[f"{stage}_hist_s"] = sec
        out[f"{stage}_stage_s"] = res.timings[stage]
        print(f"observability protocol (11b): {stage} stage {res.timings[stage]:.3f}s, of it "
              f"{sec:.3f}s inside {n} histogram launches (CUDA events; "
              f"{100 * sec / res.timings[stage]:.1f}%) [{card}]")
    return out


def observability_cli(card: str, root: str, n_rows: int = CLI_ROWS) -> dict:
    """Phase 11c: the training CLI in a subprocess with ``--ledger-out``
    and ``--trace-out``: the ledger loads with `load_ledger`, its program
    table holds the histogram programs with dispatches, event seconds and
    the H100 roofline estimate, and the trace parses."""
    ledger_path, trace_path = f"{root}/ledger.json", f"{root}/trace.json"
    cmd = [sys.executable, "-m", "cobalt_smart_lender_ai_tpu_torch.pipeline", "--quick",
           "--synthetic-rows", str(n_rows), "--ledger-out", ledger_path, "--trace-out", trace_path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the training CLI exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    ledger = load_ledger(ledger_path)
    hist = [p for p in ledger["programs"] if p["name"].startswith("gradient_histogram/")]
    if not hist or not all(p["dispatches"] > 0 and p["dispatch_seconds"] > 0
                           and p["roofline_utilization"] is not None for p in hist):
        raise AssertionError(f"the ledger's histogram programs: {hist}")
    with open(trace_path) as fh:
        trace = json.load(fh)
    names = {e["name"] for e in trace["traceEvents"]}
    if "pipeline.run" not in names:
        raise AssertionError(f"the trace file holds {sorted(names)}")
    out = {
        "rows": n_rows,
        "wall_s": wall,
        "stages": ledger["stages"],
        "programs": [{k: p[k] for k in ("name", "dispatches", "dispatch_seconds", "bound_seconds",
                                        "roofline_utilization")} for p in hist],
        "devices": ledger["env"]["devices"],
    }
    print(f"observability cli (11c): {json.dumps(out)} [{card}]")
    return out


def recording_overhead(card: str, fit_s: float, fit_launches: int) -> dict:
    """Phase 11d: host µs of `OVERHEAD_DISPATCHES` recorded dispatches
    with no kernel between the events (what the histogram wrapper adds to
    a launch: the handle lookup, two event records, the cost count and the
    pool's resolution of finished pairs; the wrapper fetched the current
    stream before), on a handle of its own; that times 5c's launches, as a
    share of 5c's fit wall."""
    dev = torch.device("cuda", torch.cuda.current_device())
    own = ProgramHandle("overhead", "kernel", {})
    stream = torch.cuda.current_stream(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(OVERHEAD_DISPATCHES):
        histogram_program(20, 255, dev)
        pair = own.start(stream)
        flops, nbytes = histogram_cost(1_840_000, 20, 64, 255, 1)
        own.stop(pair, stream, rows=1_840_000, flops=flops, nbytes=nbytes)
    us = (time.perf_counter() - t0) / OVERHEAD_DISPATCHES * 1e6
    torch.cuda.synchronize()
    if own.resolved()[0] != OVERHEAD_DISPATCHES:
        raise AssertionError("the overhead handle lost dispatches")
    out = {"us_per_dispatch": us, "fit_launches": fit_launches,
           "fit_added_ms": us * fit_launches / 1e3, "fit_s": fit_s,
           "fit_share": us * fit_launches / 1e6 / fit_s}
    print(f"observability overhead (11d): {us:.3f} us per recorded dispatch; x {fit_launches} "
          f"launches = {out['fit_added_ms']:.3f} ms, {100 * out['fit_share']:.3f}% of 5c's "
          f"{fit_s:.3f}s fit [{card}]")
    return out


def print_scoring_split(card: str) -> None:
    for precision in ("f32", *QUANTIZED):
        for r in scoring_split("cuda", precision):
            kernels = " ".join(f"{k}={r[k]:.6f}" for k in SCORE_KERNELS if k in r)
            print(f"split score_forest precision={precision} bucket={r['bucket']} "
                  f"shap={r['with_shap']} (device ms per call, {r['kept']} of "
                  f"{PROFILED_CALLS} calls kept) {kernels} [{card}]")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument(
        "--only-scoring",
        action="store_true",
        help="run phases 1-4, 9 and the scoring split only; print no ok line",
    )
    mode.add_argument(
        "--full-protocol",
        action="store_true",
        help="build, then run phase 8b with the reference's default RFE (104 -> 20 "
        "features at step 1) and 20 x 3 search; print no ok line",
    )
    args = parser.parse_args()
    # The training protocol's stage and progress lines, on stderr.
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    kernels_built = ["score_forest", "gradient_histogram"]
    with ThreadPoolExecutor(max_workers=len(kernels_built)) as pool:
        list(pool.map(_build.build, kernels_built))  # one nvcc each, together
    for name in kernels_built:
        _build.load(name)
    print(f"build: {', '.join(k + '.cu' for k in kernels_built)} in "
          f"{time.perf_counter() - t0:.1f}s (in parallel)")
    for name in kernels_built:
        print(_build.build_log.get(name, f"{name}: library was already built"), file=sys.stderr)

    if args.full_protocol:
        frame, generate_s = raw_table()
        print(f"raw table: {frame.n_rows} loans generated in {generate_s:.1f}s [{card}]")
        t0 = time.perf_counter()
        cfg = PipelineConfig()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_protocol_") as root:
            protocol, _, _, res, _ = protocol_phase(card, frame, cfg, protocol_rows(frame), root)
        observability_protocol(card, res, protocol.pop("observability"), cfg)
        print(f"full protocol phase: {time.perf_counter() - t0:.1f}s [{card}]")
        return 0

    records = kernel_phase("cuda")
    for r in records:
        print(f"kernel score_forest bucket={r['bucket']} shap={r['with_shap']} "
              f"ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
              f"err={ {k: r[k] for k in ('prob', 'phis', 'additivity') if k in r} } "
              f"[{card}]")
    serving = serving_phase("cuda")
    print(f"serving: {json.dumps(serving)} [{card}]")
    observed = {"serving": observability_serving_phase(card, records)}
    quantized_records, quantized_serving = quantized_phase(card)
    if args.only_scoring:
        print_scoring_split(card)
        return 0
    t0 = time.perf_counter()
    hist_records, training = training_phase(card)
    training["phase_s"] = time.perf_counter() - t0
    print(f"training: {json.dumps(training)} [{card}]")
    frame, generate_s = raw_table()
    print(f"raw table: {frame.n_rows} loans generated in {generate_s:.1f}s [{card}]")
    t0 = time.perf_counter()
    raw, raw_launches, train_rows = raw_path_phase(card, frame=frame)
    print(f"raw_path phase: {time.perf_counter() - t0:.1f}s [{card}]")
    # Phase 8 runs before phase 7: a profiler session slows later launches.
    t0 = time.perf_counter()
    check = protocol_card_vs_cpu()
    print(f"protocol card_vs_cpu: {json.dumps(check)} [{card}]")
    quick = quick_config()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_protocol_") as root:
        protocol, protocol_launches, protocol_hist, res, payloads = protocol_phase(
            card, frame, quick, train_rows, root
        )
        observed["protocol"] = observability_protocol(card, res, protocol.pop("observability"), quick)
        del frame
        print(f"protocol phase: {time.perf_counter() - t0:.1f}s [{card}]")
        # Phase 10, on 8b's columns and store.
        t0 = time.perf_counter()
        halving = halving_phase(card, train_rows, quick, res)
        del train_rows
        resumed = resume_phase(card, root, quick, res, payloads)
        del res
    selection_card_vs_cpu(card)
    print(f"halving and resume phase: {time.perf_counter() - t0:.1f}s [{card}]")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        observed["cli"] = observability_cli(card, root)
    observed["overhead"] = recording_overhead(card, training["fit_s"], training["hist_launches"])
    print(f"observability phase: {time.perf_counter() - t0:.1f}s [{card}]")
    print_scoring_split(card)

    main_rec = next(r for r in records if r["bucket"] == 64)
    hist_main = next(r for r in hist_records if r["shape"] == "level 6 subtracted")
    kernels = [
        {
            "name": "score_forest",
            "route": "cuda",
            "source": "cobalt_smart_lender_ai_tpu_torch/csrc/score_forest.cu",
            "replaces": "cobalt_smart_lender_ai_tpu/ops/score_pallas.py:408",
            "launches": serving["launches"],
            "raw_path_launches": raw_launches["score_forest"],
            "protocol_launches": protocol_launches["score_forest"],
            "resume_launches": resumed["predict_raw"]["launches"],
            "precisions": ["f32", *QUANTIZED],
            "quantized_launches": quantized_serving["launches"],
            "max_abs_err": max(
                [max(r.get("prob", 0.0), r.get("phis", 0.0)) for r in records + quantized_records]
                + [raw["serve"]["prob_max_abs_err"], raw["degraded"]["prob_max_abs_err"],
                   protocol["predict_raw"]["prob_max_abs_err"],
                   resumed["predict_raw"]["prob_max_abs_err"],
                   quantized_serving["predict_prob"], quantized_serving["predict_phis"],
                   quantized_serving["bulk_prob"]]
            ),
            "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": None,
        },
        {
            "name": "gradient_histogram",
            "route": "cuda",
            "source": "cobalt_smart_lender_ai_tpu_torch/csrc/gradient_histogram.cu",
            "replaces": "cobalt_smart_lender_ai_tpu/ops/hist_pallas.py:51",
            "launches": training["hist_launches"],
            "raw_path_launches": raw_launches["gradient_histogram"],
            "protocol_launches": protocol_launches["gradient_histogram"],
            "halving_launches": halving["halving_launches"],
            "exhaustive_launches": halving["exhaustive_launches"],
            "resume_launches": resumed["resume_launches"] + resumed["resume_after_invalidate_launches"],
            "max_abs_err": max(r["max_abs_err"] for r in hist_records + protocol_hist),
            "ms": hist_main["ms"],
            "plain_ms": hist_main["plain_ms"],
            "bound_ms": hist_main["bound_ms"],
            "bound_by": hist_main["bound_by"],
            "library_ms": hist_main["library_ms"],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
