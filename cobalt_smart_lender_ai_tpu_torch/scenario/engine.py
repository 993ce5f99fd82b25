"""PortfolioScorer: checkpointed offline batch scoring, row-sharded over a mesh.

The serving path (`serve/service.py`) scores what an HTTP client sends; this
engine scores what a *risk review* needs: an entire portfolio swept through a
counterfactual `ScenarioGrid`, through the same fused scoring kernel
(`ops.score.fused_score`, ``score_forest`` on the card) the bulk endpoint
launches, at row counts no client will ever POST. It is the reference's
``scenario/engine.py`` on one device, and keeps its properties:

**Bit-exact resumability.** Work is a flat, deterministic list of
``(scenario, chunk)`` items: scenarios in grid-expansion order (baseline
first), chunks at fixed ``[i*chunk_rows, (i+1)*chunk_rows)`` boundaries.
Every chunk's results land in the object store as an ``.npz`` (``scores``,
``n``, ``phi_sum`` in float64, ``base``) and the run's `PipelineCheckpoint`
manifest advances with a ``progress`` payload after each one. Kill the
process after K chunks, rerun with ``resume=True``, and the remaining items
are scored into the same artifacts: the concatenated scores are
*bit-identical* to an uninterrupted run, because each row's result depends
only on its own chunk's launch. A resume trusts a chunk only while its
bytes still hash to the md5 and size the manifest pinned. The shard count
is not part of the resume fingerprint (as in the reference): a row's result
does not depend on the mesh, so a sweep killed on one mesh resumes on
another to the same bits.

**One dispatch per chunk.** With SHAP, ONE `fused_score` launch returns the
margins and the phis together (the reference dispatches a margin program
and a SHAP program); it is counted under ``kind="shap"``, or under
``kind="margin"`` with ``compute_shap=False``. Scores are the host's numpy
sigmoid of the kernel's *margins* (`_sigmoid`, the reference's expression),
never the kernel's probabilities, so they equal the reference engine's bit
for bit wherever the margins do. Each chunk is zero-padded to
``padded_rows`` (the power-of-two cover of ``chunk_rows``), so a sweep
launches at one row bucket. A scenario's padded chunks go to the device
in one upload, at its first chunk scored (the reference uploads each
chunk); on the card the uploads, the launches and the copies back run on
the caller's current CUDA stream. A chunk's
``cobalt_portfolio_dispatch_seconds`` are its launch until the card is
done, and the scenario's upload for its first chunk, as the reference
times its dispatch; the copy back to the host comes after.

**Row shards.** As the reference, ``shards`` resolves through
`parallel.partitioner.make_partitioner`: 0 or 1 is one device, -1 every
visible device, N an N-way dp mesh clamped to the visible devices
(`device.mesh_devices`). On a mesh each chunk is padded to ``bucket *
n_shards`` rows (``bucket`` the power-of-two cover of the rows per shard)
and its dispatch launches ``score_forest`` once per shard, each on its
shard's stream; `describe` reports the mesh.

**Long-run deadline semantics.** ``run(deadline=None)`` is the default and
means "never abort"; a caller that wants a wall-clock budget passes an
explicit `reliability.Deadline`, checked between launches (a tripped budget
leaves a resumable checkpoint behind).

**Observability.** Each chunk's blocking seconds (upload, launch, results on
the host) are observed into ``cobalt_portfolio_dispatch_seconds`` (a
measured family the run ledger's attribution ratio is gated on), rows and
throughput into ``cobalt_portfolio_rows_total`` /
``cobalt_portfolio_rows_per_second``; each scenario gets a
``portfolio.scenario`` span and the reduction a ``portfolio.reduce`` span.
The launches themselves register on the kernel's own program handles
(``score_forest/f32/<bucket>/<shap|margin>``), which is what the ledger
attributes those seconds to.
"""

from __future__ import annotations

import hashlib
import math
import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.convert import forest_to_numpy
from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.io.artifacts import GBDTArtifact
from cobalt_smart_lender_ai_tpu_torch.io.model_registry import ModelRegistry
from cobalt_smart_lender_ai_tpu_torch.io.store import ObjectStore
from cobalt_smart_lender_ai_tpu_torch.ops.score import pack_forest, prepare_kernel
from cobalt_smart_lender_ai_tpu_torch.parallel.partitioner import make_partitioner
from cobalt_smart_lender_ai_tpu_torch.reliability.checkpoint import (
    PipelineCheckpoint,
    config_fingerprint,
)
from cobalt_smart_lender_ai_tpu_torch.scenario.grid import BASELINE, Scenario, ScenarioGrid
from cobalt_smart_lender_ai_tpu_torch.scenario.report import (
    DEFAULT_PD_BANDS,
    band_migration,
    delta_stats,
    pd_band_index,
    scenario_drift,
    shap_top_movers,
    write_report,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.drift import FeatureSketch
from cobalt_smart_lender_ai_tpu_torch.telemetry.metrics import default_registry
from cobalt_smart_lender_ai_tpu_torch.telemetry.tracing import default_tracer

__all__ = ["PortfolioInterrupted", "PortfolioScorer", "load_portfolio"]


class PortfolioInterrupted(RuntimeError):
    """Raised by the ``fail_after_chunks`` kill hook after the Kth freshly
    scored chunk: the checkpoint on disk is valid and resumable. Production
    kills (OOM, preemption) leave exactly the same state; this exception
    makes "die mid-sweep" deterministic for parity tests."""

    def __init__(self, run_id: str, items_done: int, items_total: int):
        super().__init__(
            f"portfolio run {run_id!r} interrupted after "
            f"{items_done}/{items_total} chunks (resumable)"
        )
        self.run_id = run_id
        self.items_done = items_done
        self.items_total = items_total


def load_portfolio(
    store: ObjectStore, key: str, feature_names: Sequence[str]
) -> tuple[np.ndarray, dict]:
    """A portfolio CSV object -> float32 matrix in the model's feature
    order. Missing columns become NaN (the trees route NaN like serving
    does); extra columns are ignored. Returns ``(X, meta)`` with the raw
    bytes' md5, the identity the resume fingerprint pins."""
    data = store.get_bytes(key)
    from cobalt_smart_lender_ai_tpu_torch.native import read_csv

    frame = read_csv(data, engine="auto")
    missing = [n for n in feature_names if n not in frame.columns]
    n = frame.n_rows
    cols = []
    for name in feature_names:
        if name in frame.columns:
            cols.append(np.asarray(frame[name], dtype=np.float32).reshape(n))
        else:
            cols.append(np.full(n, np.nan, dtype=np.float32))
    X = np.stack(cols, axis=1) if cols else np.zeros((n, 0), np.float32)
    meta = {
        "key": key,
        "rows": int(n),
        "md5": hashlib.md5(data).hexdigest(),
        "missing_features": missing,
    }
    return X, meta


def _metrics():
    reg = default_registry()
    return {
        "rows": reg.counter(
            "cobalt_portfolio_rows_total",
            "Portfolio rows scored (per scenario pass)",
        ),
        "dispatches": reg.counter(
            "cobalt_portfolio_dispatches_total",
            "Bulk program dispatches issued by the portfolio scorer",
            ("kind",),
        ),
        "seconds": reg.histogram(
            "cobalt_portfolio_dispatch_seconds",
            "Blocking dispatch wall seconds (portfolio bulk programs)",
            ("kind",),
        ),
        "scenarios": reg.counter(
            "cobalt_portfolio_scenarios_total",
            "Scenario passes completed (baseline included)",
        ),
        "rows_per_s": reg.gauge(
            "cobalt_portfolio_rows_per_second",
            "Portfolio scoring throughput over the current run",
        ),
        "resumed": reg.counter(
            "cobalt_portfolio_chunks_resumed_total",
            "Chunks skipped on resume (already checkpointed)",
        ),
    }


class PortfolioScorer:
    """Stream a portfolio (+ scenario grid) through the fused scoring kernel
    in fixed-size chunks, checkpointing every chunk.

    One instance packs the forest once on ``device`` (``cuda`` unless the
    caller asks for ``cpu``; on the CPU the kernel's plain version scores)
    and can `run` any number of sweeps against the same model."""

    def __init__(
        self,
        artifact: GBDTArtifact,
        store: ObjectStore,
        *,
        shards: int = 1,
        chunk_rows: int = 2048,
        compute_shap: bool = True,
        pd_bands: Sequence[float] = DEFAULT_PD_BANDS,
        training_sketch: FeatureSketch | None = None,
        psi_alert: float = 0.25,
        model_info: Mapping[str, Any] | None = None,
        prefix: str = "scenario_runs/",
        checkpoint_prefix: str = "checkpoints/",
        device: torch.device | str = "cuda",
        clock: Callable[[], float] = time.monotonic,
    ):
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        self.device = resolve_device(device)
        self.partitioner = make_partitioner(int(shards), device=self.device)
        self.artifact = artifact
        self.store = store
        self.chunk_rows = int(chunk_rows)
        self.compute_shap = bool(compute_shap)
        self.pd_bands = tuple(float(b) for b in pd_bands)
        self.training_sketch = training_sketch
        self.psi_alert = float(psi_alert)
        self.model_info = dict(model_info or {})
        self.prefix = prefix if prefix.endswith("/") else prefix + "/"
        self._ckpt = PipelineCheckpoint(store, prefix=checkpoint_prefix)
        self._clock = clock
        #: The kernel of every launch: the card's, or its plain version on
        #: the CPU. Part of the resume fingerprint: SHAP bytes differ between
        #: the two at float tolerance, so a resume never mixes their chunks.
        self.kernel = "score_forest" if self.device.type == "cuda" else "plain"
        # One row bucket for the whole run: every chunk is zero-padded to
        # `padded_rows` (power-of-two rows per shard), like the serving
        # buckets. Padding rows score garbage that is sliced off before
        # anything downstream sees it.
        n_shards = self.partitioner.n_shards
        per_shard = -(-self.chunk_rows // n_shards)
        self.padded_rows = (1 << max(per_shard - 1, 0).bit_length()) * n_shards
        self.pack = None
        self._md5: str | None = None
        #: The pack's base value, read back once in the compile stage.
        self._base: np.ndarray | None = None

    # -- construction from the registry ------------------------------------

    @classmethod
    def from_registry(
        cls,
        store: ObjectStore,
        *,
        model_name: str = "gbdt",
        channel: str = "latest",
        registry_prefix: str = "registry",
        device: torch.device | str = "cuda",
        **kwargs: Any,
    ) -> "PortfolioScorer":
        """Resolve the model by registry channel and inherit its provenance:
        the version/md5 land in the report's model block, and the training
        `FeatureSketch` (when the publisher recorded one) becomes the PSI
        baseline for OOD stress-point flagging."""
        dev = resolve_device(device)
        registry = ModelRegistry(store, prefix=registry_prefix)
        mv = registry.channel_record(model_name, channel)
        if mv is None:
            raise LookupError(
                f"model registry has no {channel!r} channel for "
                f"{model_name!r} under {registry_prefix!r}"
            )
        artifact = GBDTArtifact.load(store, mv.key, dev)
        sketch = None
        raw = mv.provenance.get("feature_sketch")
        if raw:
            sketch = FeatureSketch.from_json(raw)
        model_info = {
            "name": mv.name,
            "version": mv.version,
            "channel": channel,
            "key": mv.key,
            "md5": mv.md5,
            "kind": mv.kind,
            "config_hash": mv.provenance.get("config_hash"),
            "dataset_md5": mv.provenance.get("dataset_md5"),
        }
        kwargs.setdefault("training_sketch", sketch)
        kwargs.setdefault("model_info", model_info)
        return cls(artifact, store, device=dev, **kwargs)

    # -- plumbing -----------------------------------------------------------

    def _compile(self) -> float:
        """Pack the forest on the device, once, and on the card build (at
        its first use) and load the kernel library, so that no chunk's
        seconds hold the build: the run's ``compile`` stage. Everything the
        engine does on the card runs on the caller's current stream."""
        if self.pack is not None:
            return 0.0
        t0 = self._clock()
        forest = self.artifact.forest.to(self.device)
        n_features = len(self.artifact.feature_names)
        self.pack = pack_forest(forest, n_features, "f32")
        self._score = self.partitioner.compile_fused(
            self.pack, n_features, self.padded_rows, with_shap=self.compute_shap
        )
        prepare_kernel(self.device)
        self._base = self.pack.base.cpu().numpy()
        return self._clock() - t0

    def describe(self) -> dict:
        """The partitioner's shape block: its shards, mesh and devices."""
        return self.partitioner.describe()

    def _model_md5(self) -> str:
        """The registry's md5 of the model's ``.npz``; for an artifact given
        directly, an md5 of the forest's arrays and feature names. (An
        ``.npz`` re-serialized later carries other zip timestamps, so its
        bytes' md5 would move the resume fingerprint between a killed run
        and its resume.)"""
        md5 = self.model_info.get("md5")
        if md5:
            return str(md5)
        if self._md5 is None:
            h = hashlib.md5()
            for name, arr in sorted(forest_to_numpy(self.artifact.forest).items()):
                h.update(name.encode() + arr.dtype.str.encode() + str(arr.shape).encode())
                h.update(arr.tobytes())
            h.update("\0".join(self.artifact.feature_names).encode())
            self._md5 = h.hexdigest()
        return self._md5

    def _fingerprint(self, portfolio_md5: str, n_rows: int, grid_json: dict) -> str:
        # The kernel IS present: f32 margins are bit-identical across the
        # card and the plain version, but SHAP chunk bytes may differ at
        # float tolerance, so a resume never mixes chunks from the two.
        return config_fingerprint(
            {
                "model_md5": self._model_md5(),
                "features": list(self.artifact.feature_names),
                "portfolio_md5": portfolio_md5,
                "rows": int(n_rows),
                "chunk_rows": self.chunk_rows,
                "grid": grid_json,
                "pd_bands": list(self.pd_bands),
                "shap": self.compute_shap,
                "kernel": self.kernel,
            }
        )

    def _chunk_key(self, run_prefix: str, si: int, ci: int) -> str:
        return f"{run_prefix}chunks/s{si:03d}_c{ci:05d}.npz"

    def _verified_resume_point(
        self, stage: str, fingerprint: str, chunk_keys: Sequence[str]
    ) -> int:
        """How many leading work items can be trusted: the manifest's
        fingerprint must match and every completed chunk artifact must
        still hash to its pinned md5; otherwise start from zero."""
        manifest = self._ckpt.load(stage)
        if manifest is None or manifest.get("fingerprint") != fingerprint:
            return 0
        progress = manifest.get("progress") or {}
        done = int(progress.get("items_done", 0))
        done = max(0, min(done, len(chunk_keys)))
        pointers = manifest.get("pointers", {})
        for key in chunk_keys[:done]:
            ptr = pointers.get(key)
            if not ptr:
                return 0
            try:
                data = self.store.get_bytes(key)
            except Exception:
                return 0
            if (
                hashlib.md5(data).hexdigest() != ptr.get("md5")
                or len(data) != ptr.get("size")
            ):
                return 0
        return done

    @staticmethod
    def _sigmoid(margins: np.ndarray) -> np.ndarray:
        # The reference's expression over the kernel's margins, so engine
        # scores are bit-comparable with its outputs.
        with np.errstate(over="ignore"):
            return 1.0 / (1.0 + np.exp(-margins))

    def _pad(self, rows: np.ndarray, n_chunks: int) -> np.ndarray:
        """A scenario's rows as (chunks, ``padded_rows``, F), each chunk
        zero-padded as the reference pads it."""
        padded = np.zeros((n_chunks, self.padded_rows, rows.shape[1]), dtype=np.float32)
        for ci in range(n_chunks):
            chunk = rows[ci * self.chunk_rows : (ci + 1) * self.chunk_rows]
            padded[ci, : len(chunk)] = chunk
        return padded

    def _launch(self, X: torch.Tensor) -> tuple:
        """ONE dispatch over a staged chunk through the partitioner (one
        `fused_score` launch, or one per shard), waited for: the chunk's
        dispatch, which the reference times around its call and
        ``block_until_ready``. The outputs stay on the device; the caller
        copies them back."""
        out = self._score(X)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out

    # -- the sweep ----------------------------------------------------------

    def run(
        self,
        X: np.ndarray,
        grid: ScenarioGrid | None = None,
        *,
        run_id: str,
        resume: bool = False,
        deadline: Any = None,
        fail_after_chunks: int | None = None,
        ledger: Any = None,
        portfolio_meta: Mapping[str, Any] | None = None,
    ) -> dict:
        """Score the portfolio under the baseline + every grid scenario.

        ``deadline=None`` (the default) means a batch run never aborts
        itself; an explicit `Deadline` is honored cooperatively between
        launches. ``resume=True`` continues a killed run with the same
        ``run_id`` (and an unchanged model/portfolio/grid; anything else
        restarts). Returns the scenario report (also written to the store)."""
        metrics = _metrics()
        tracer = default_tracer()
        X = np.ascontiguousarray(X, dtype=np.float32)
        n_rows, n_features = X.shape
        if n_features != len(self.artifact.feature_names):
            raise ValueError(
                f"portfolio has {n_features} features, model expects "
                f"{len(self.artifact.feature_names)}"
            )
        if n_rows == 0:
            raise ValueError("portfolio is empty")

        grid_json = grid.to_json() if grid is not None else {"axes": []}
        scenarios: list[Scenario] = [BASELINE] + (
            grid.expand() if grid is not None else []
        )
        n_chunks = math.ceil(n_rows / self.chunk_rows)
        items = [
            (si, ci)
            for si in range(len(scenarios))
            for ci in range(n_chunks)
        ]
        run_prefix = f"{self.prefix}{run_id}/"
        chunk_keys = [self._chunk_key(run_prefix, si, ci) for si, ci in items]

        portfolio_md5 = hashlib.md5(X.tobytes()).hexdigest()
        fingerprint = self._fingerprint(portfolio_md5, n_rows, grid_json)
        stage = f"portfolio/{run_id}"

        timings: dict[str, float] = {}
        timings["compile"] = self._compile()

        done = 0
        if resume:
            done = self._verified_resume_point(stage, fingerprint, chunk_keys)
            if done:
                metrics["resumed"].inc(done)

        kind = "shap" if self.compute_shap else "margin"
        t_score0 = self._clock()
        rows_scored = 0
        fresh = 0
        k = 0
        for si, scenario in enumerate(scenarios):
            with tracer.span(
                "portfolio.scenario",
                scenario=scenario.scenario_id,
                rows=n_rows,
                chunks=n_chunks,
            ):
                staged = None  # the scenario's rows on the device
                for ci in range(n_chunks):
                    if k < done:
                        k += 1
                        continue
                    if deadline is not None:
                        deadline.check(
                            f"portfolio scenario {scenario.scenario_id!r} "
                            f"chunk {ci}"
                        )
                    lo = ci * self.chunk_rows
                    hi = min(n_rows, lo + self.chunk_rows)
                    if staged is None:
                        padded = self._pad(
                            scenario.apply(X, self.artifact.feature_names), n_chunks
                        )
                    t0 = time.perf_counter()
                    if staged is None:  # the first chunk's dispatch uploads them all
                        staged = torch.from_numpy(padded).to(self.device)
                    out = self._launch(staged[ci])
                    metrics["seconds"].labels(kind).observe(time.perf_counter() - t0)
                    metrics["dispatches"].labels(kind).inc()
                    arrays: dict[str, np.ndarray] = {
                        "scores": self._sigmoid(out[0][: hi - lo].cpu().numpy()),
                        "n": np.asarray(hi - lo, dtype=np.int64),
                    }
                    if self.compute_shap:
                        phis = out[2][: hi - lo].cpu().numpy()
                        arrays["phi_sum"] = phis.sum(axis=0, dtype=np.float64)
                        arrays["base"] = self._base
                    key = chunk_keys[k]
                    self.store.save_arrays(key, arrays)
                    self._ckpt.advance(
                        stage,
                        fingerprint=fingerprint,
                        new_outputs=[key],
                        progress={
                            "items_done": k + 1,
                            "items_total": len(items),
                            "scenario": scenario.scenario_id,
                            "chunk": ci,
                            "rows_done": rows_scored + (hi - lo),
                            "chunk_rows": self.chunk_rows,
                            "portfolio_md5": portfolio_md5,
                        },
                        extra={"run_prefix": run_prefix},
                    )
                    rows_scored += hi - lo
                    fresh += 1
                    k += 1
                    metrics["rows"].inc(hi - lo)
                    elapsed = self._clock() - t_score0
                    if elapsed > 0:
                        metrics["rows_per_s"].set(rows_scored / elapsed)
                    if (
                        fail_after_chunks is not None
                        and fresh >= fail_after_chunks
                        and k < len(items)
                    ):
                        raise PortfolioInterrupted(run_id, k, len(items))
            metrics["scenarios"].inc()
        timings["score"] = self._clock() - t_score0

        report = self._reduce(
            X,
            scenarios,
            grid_json,
            run_id=run_id,
            run_prefix=run_prefix,
            n_chunks=n_chunks,
            chunks_resumed=done,
            chunks_scored=fresh,
            rows_scored=rows_scored,
            portfolio_md5=portfolio_md5,
            portfolio_meta=portfolio_meta,
            fingerprint=fingerprint,
            timings=timings,
            tracer=tracer,
        )

        # Final manifest: progress complete + the report pinned alongside
        # the chunks, so `--resume` of a finished run is pure reduce.
        self._ckpt.advance(
            stage,
            fingerprint=fingerprint,
            new_outputs=[report["keys"]["report"]],
            progress={
                "items_done": len(items),
                "items_total": len(items),
                "complete": True,
                "rows_done": n_rows * len(scenarios),
                "chunk_rows": self.chunk_rows,
                "portfolio_md5": portfolio_md5,
            },
            extra={"run_prefix": run_prefix},
        )

        if ledger is not None:
            ledger.add_stages(timings)
            ledger.set("scenario_report", _slim(report))
        return report

    # -- reduction ----------------------------------------------------------

    def _load_scenario(
        self, run_prefix: str, si: int, n_chunks: int
    ) -> tuple[np.ndarray, np.ndarray | None]:
        scores, phi_sum = [], None
        for ci in range(n_chunks):
            arrays = self.store.load_arrays(self._chunk_key(run_prefix, si, ci))
            scores.append(arrays["scores"])
            if "phi_sum" in arrays:
                phi_sum = (
                    arrays["phi_sum"]
                    if phi_sum is None
                    else phi_sum + arrays["phi_sum"]
                )
        return np.concatenate(scores), phi_sum

    def _reduce(
        self,
        X: np.ndarray,
        scenarios: list[Scenario],
        grid_json: dict,
        *,
        run_id: str,
        run_prefix: str,
        n_chunks: int,
        chunks_resumed: int,
        chunks_scored: int,
        rows_scored: int,
        portfolio_md5: str,
        portfolio_meta: Mapping[str, Any] | None,
        fingerprint: str,
        timings: dict[str, float],
        tracer: Any,
    ) -> dict:
        t0 = self._clock()
        n_rows = X.shape[0]
        feature_names = list(self.artifact.feature_names)
        with tracer.span("portfolio.reduce", scenarios=len(scenarios)):
            base_scores, base_phi = self._load_scenario(run_prefix, 0, n_chunks)
            base_phi_mean = None if base_phi is None else base_phi / float(n_rows)
            base_bands = np.bincount(
                pd_band_index(base_scores, self.pd_bands),
                minlength=len(self.pd_bands) + 1,
            )
            scores_keys = {"baseline": f"{run_prefix}scores/baseline.npy"}
            self.store.save_array(scores_keys["baseline"], base_scores)

            scenario_blocks = []
            for si in range(1, len(scenarios)):
                scenario = scenarios[si]
                scores, phi = self._load_scenario(run_prefix, si, n_chunks)
                skey = f"{run_prefix}scores/s{si:03d}.npy"
                dkey = f"{run_prefix}deltas/s{si:03d}.npy"
                self.store.save_array(skey, scores)
                self.store.save_array(
                    dkey,
                    np.asarray(scores, np.float64) - np.asarray(base_scores, np.float64),
                )
                scores_keys[scenario.scenario_id] = skey
                block: dict[str, Any] = {
                    "id": scenario.scenario_id,
                    "index": si,
                    "perturbations": [p.to_json() for p in scenario.perturbations],
                    "scores_key": skey,
                    "deltas_key": dkey,
                    "mean_pd": float(np.mean(scores)),
                    "delta": delta_stats(base_scores, scores),
                    "migration": band_migration(base_scores, scores, self.pd_bands),
                }
                if phi is not None and base_phi_mean is not None:
                    block["shap_top"] = shap_top_movers(
                        phi / float(n_rows), base_phi_mean, feature_names
                    )
                if self.training_sketch is not None:
                    block["drift"] = scenario_drift(
                        self.training_sketch,
                        scenario.apply(X, feature_names),
                        feature_names,
                        scenario.features,
                        alert=self.psi_alert,
                    )
                scenario_blocks.append(block)
        timings["reduce"] = self._clock() - t0

        t0 = self._clock()
        baseline_block: dict[str, Any] = {
            "scores_key": scores_keys["baseline"],
            "mean_pd": float(np.mean(base_scores)),
            "p95_pd": float(np.percentile(base_scores, 95)),
            "band_counts": base_bands.tolist(),
        }
        if base_phi_mean is not None:
            baseline_block["mean_phi"] = {
                name: float(v) for name, v in zip(feature_names, base_phi_mean)
            }
        drift_note = None
        if self.training_sketch is None:
            drift_note = (
                "no training FeatureSketch available (model published "
                "without provenance sketch); PSI checks skipped"
            )
        report: dict[str, Any] = {
            "run_id": run_id,
            "created_unix": round(time.time(), 3),
            "fingerprint": fingerprint,
            "model": self.model_info or {"md5": self._model_md5(), "channel": "direct"},
            "portfolio": {
                "rows": int(n_rows),
                "md5": portfolio_md5,
                **dict(portfolio_meta or {}),
            },
            "grid": grid_json,
            "partitioner": self.describe(),
            "chunk_rows": self.chunk_rows,
            "padded_rows": self.padded_rows,
            "n_chunks": int(n_chunks),
            "pd_bands": list(self.pd_bands),
            "baseline": baseline_block,
            "scenarios": scenario_blocks,
            "resume": {
                "chunks_total": len(scenarios) * n_chunks,
                "chunks_resumed": int(chunks_resumed),
                "chunks_scored": int(chunks_scored),
            },
            "keys": {
                "report": f"{run_prefix}report.json",
                "scores": scores_keys,
            },
        }
        if drift_note:
            report["drift_note"] = drift_note
        score_s = timings.get("score", 0.0)
        report["telemetry"] = {
            "rows_scored": int(rows_scored),
            "score_seconds": round(score_s, 6),
            "rows_per_second": (
                None if score_s <= 0 else round(rows_scored / score_s, 1)
            ),
        }
        write_report(self.store, run_prefix, report)
        timings["write"] = self._clock() - t0
        report["stages"] = {k: round(v, 6) for k, v in timings.items()}
        return report


def _slim(report: Mapping[str, Any]) -> dict:
    """The ledger-embedded view: everything except per-scenario arrays."""
    out = {
        k: report[k]
        for k in (
            "run_id",
            "fingerprint",
            "model",
            "portfolio",
            "grid",
            "partitioner",
            "chunk_rows",
            "n_chunks",
            "resume",
            "telemetry",
            "keys",
        )
        if k in report
    }
    out["scenarios"] = [
        {
            "id": b["id"],
            "mean_pd": b["mean_pd"],
            "delta_mean": b["delta"]["mean"],
            "downgraded": b["migration"]["downgraded"],
            "upgraded": b["migration"]["upgraded"],
            "ood_features": (b.get("drift") or {}).get("ood_features", []),
        }
        for b in report.get("scenarios", [])
    ]
    return out
