#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernel to its plain version.

    python3 chip_smoke.py

Phases, each of which must pass:

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the serving path from ``csrc/`` (``nvcc``);
3. kernel vs plain: `fused_score` (the ``score_forest`` kernel) against
   `fused_score_reference` on the same seeded rows of the committed 300-tree
   depth-7 model, at the /predict buckets 1, 8, 64 with SHAP and the bulk
   buckets 256, 4096 without: margins bitwise equal, prob within 1e-6, phis
   within 1e-5, ``base + sum(phis)`` within 1e-4 of the margin; then each
   bucket's kernel time (CUDA events, after warm-up), the plain version's
   time and the least time the card could take (``bound_ms``);
4. serving: the port's `ScorerService` on ``cuda`` behind its HTTP server
   answers 32 concurrent ``/predict`` requests (coalesced by the
   micro-batcher), one ``/predict_bulk_csv`` and one
   ``/feature_importance_bulk``; responses are checked against the plain
   version on the CPU, and the kernel's launch count over the phase must be
   one per micro-batch, per bulk chunk and per startup warm-up bucket.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Exits non-zero, printing neither, when
CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.ops import _build
from cobalt_smart_lender_ai_tpu_torch.ops.score import (
    fused_score,
    fused_score_reference,
    pack_forest,
)
from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

ROOT = Path(__file__).resolve().parent
STORE = ROOT / "artifacts"
MODEL_KEY = ServeConfig.model_key
SEED = 0

#: Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP32
#: (non-tensor-core) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

TOL_PROB = 1e-6
TOL_PHIS = 1e-5
TOL_ADDITIVITY = 1e-4


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


def shap_flops(depth: int) -> int:
    """FLOP the SHAP kernel does per (row, tree, leaf), counted from
    ``score_forest.cu``: player indicators, suffix and prefix polynomials,
    the bilinear contraction and the contribution."""
    d = depth
    return d + 2 * (d - 1) * (3 * d + 1) + d * (d * (d + 1) + 2 * d) + 3 * d


def bound_ms(pack, n_rows: int, with_shap: bool) -> tuple[float, str]:
    """Least time the card could take: the larger of the bytes the call must
    move (each input read once, each output written once) over HBM bandwidth
    and its FP32 operations over the FP32 peak."""
    T, L, d, F = pack.n_trees, 2**pack.depth, pack.depth, pack.n_features
    tensors = [pack.feature, pack.thr, pack.missing_left, pack.leaf]
    if with_shap:
        tensors += [pack.path_feature, pack.slot, pack.r_play]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += n_rows * F * 4 + 2 * n_rows * 4 + (n_rows * F * 4 if with_shap else 0)
    # Margin path: d compares and one add per row and tree, plus the sigmoid.
    flops = n_rows * T * (d + 1) + 3 * n_rows
    if with_shap:
        flops += n_rows * T * L * shap_flops(d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def kernel_phase(device: str = "cuda") -> list[dict]:
    """score_forest vs its plain version at the serving buckets; returns one
    record per bucket (errors, times, bound)."""
    art = GBDTArtifact.load(ObjectStore(str(STORE)), MODEL_KEY, device)
    F = len(art.feature_names)
    pack = pack_forest(art.forest, F)
    cpu_pack = pack_forest(art.forest.to("cpu"), F)
    records = []
    for bucket, with_shap in ((1, True), (8, True), (64, True), (256, False), (4096, False)):
        Xn = seeded_rows(pack, bucket, SEED + bucket)
        X = torch.from_numpy(Xn).to(device)
        out = fused_score(pack, X, n_features=F, with_shap=with_shap)
        plain = fused_score_reference(pack, X, n_features=F, with_shap=with_shap)
        err = compare(out, plain, with_shap)
        # The margins are also the CPU plain version's, bit for bit.
        cpu_margin = fused_score_reference(
            cpu_pack, torch.from_numpy(Xn), n_features=F, with_shap=False
        )[0]
        if not torch.equal(out[0].cpu(), cpu_margin):
            raise AssertionError(f"bucket {bucket}: margins differ from the CPU")
        rec = {"bucket": bucket, "with_shap": with_shap, **err}
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


def serving_phase(device: str = "cuda", n_requests: int = 32, bulk_rows: int = 5000) -> dict:
    """The port's serving path over HTTP: concurrent /predict, one bulk CSV,
    one importance request. Counts kernel launches over the whole phase."""
    store = ObjectStore(str(STORE))
    fused_score.launches = 0
    service = ScorerService.from_store(store, ServeConfig(), device=device)
    warm = fused_score.launches
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
    launches = fused_score.launches
    batches = ready["microbatch"]["batches"]
    bulk_chunks = -(-bulk_rows // service.config.max_batch_rows)
    if device == "cuda" and (launches == 0 or launches - warm != batches + bulk_chunks):
        raise AssertionError(
            f"{launches - warm} launches for {batches} micro-batches and "
            f"{bulk_chunks} bulk chunks: expected one launch each"
        )

    # Check the answers against the plain version on the CPU.
    art = GBDTArtifact.load(store, MODEL_KEY, "cpu")
    F = len(art.feature_names)
    cpu_pack = pack_forest(art.forest, F)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    _build.load("score_forest")
    print(f"build: score_forest.cu in {time.perf_counter() - t0:.1f}s")
    print(_build.build_log.get("score_forest", "(library was already built)"), file=sys.stderr)

    records = kernel_phase("cuda")
    for r in records:
        print(f"kernel score_forest bucket={r['bucket']} shap={r['with_shap']} "
              f"ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) "
              f"err={ {k: r[k] for k in ('prob', 'phis', 'additivity') if k in r} } "
              f"[{card}]")
    serving = serving_phase("cuda")
    print(f"serving: {json.dumps(serving)} [{card}]")

    main_rec = next(r for r in records if r["bucket"] == 64)
    kernels = [
        {
            "name": "score_forest",
            "route": "cuda",
            "source": "cobalt_smart_lender_ai_tpu_torch/csrc/score_forest.cu",
            "replaces": "cobalt_smart_lender_ai_tpu/ops/score_pallas.py:408",
            "launches": serving["launches"],
            "max_abs_err": max(
                max(r.get("prob", 0.0), r.get("phis", 0.0)) for r in records
            ),
            "ms": main_rec["ms"],
            "plain_ms": main_rec["plain_ms"],
            "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"],
            "library_ms": None,
        }
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
