"""`debug.profile_trace` and the serve CLI's ``--profile-dir`` on the CPU.

- A ``torch.profiler`` session around a CPU ``/predict`` over HTTP writes a
  trace (``*.pt.trace.json``, TensorBoard's profile plugin's format) that
  parses and holds the request's ``serve.*`` spans — recorded on the
  micro-batcher's and the server's threads, not the session's; ``None`` is a
  no-op, and the default device raises without a card.
- ``python -m cobalt_smart_lender_ai_tpu_torch.serve --device cpu
  --profile-dir DIR`` answers a request, shows the ``cobalt_compile_*``
  families on ``/metrics``, and writes the trace when it is stopped.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig, ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.debug import profile_trace
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier
from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

ROOT = Path(__file__).resolve().parent.parent
KEY = "models/gbdt/model_tree"


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    rng = np.random.default_rng(3)
    F = len(schema.SERVING_FEATURES)
    X = rng.normal(size=(800, F)).astype(np.float32)
    X[:, 12:] = rng.integers(0, 2, size=(800, F - 12))
    y = (X[:, 0] + 0.4 * rng.normal(size=800) > 0).astype(np.float32)
    model = GBDTClassifier(GBDTConfig(n_estimators=5, max_depth=3, n_bins=32), device="cpu").fit(X, y)
    root = tmp_path_factory.mktemp("profile") / "lake"
    GBDTArtifact(forest=model.forest, feature_names=tuple(schema.SERVING_FEATURES),
                 bin_edges=model.bin_spec.edges.numpy()).save(ObjectStore(str(root)), KEY)
    return str(root)


def _payload() -> bytes:
    return json.dumps({n: 1 if n in schema.SERVING_INT_FEATURES else 0.5
                       for n in schema.SERVING_FEATURES}).encode()


def _post(url: str, body: bytes) -> dict:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=60) as resp:
        return json.loads(resp.read())


def _trace_names(log_dir: Path) -> list[str]:
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    assert len(files) == 1, files
    doc = json.loads(Path(files[0]).read_text())
    return [e.get("name", "") for e in doc["traceEvents"]]


def test_profile_trace_holds_the_serve_spans_of_a_cpu_predict(store_root, tmp_path):
    service = ScorerService.from_store(ObjectStore(store_root), ServeConfig(), device="cpu")
    server = make_async_server(service, "127.0.0.1", 0)
    try:
        with profile_trace(str(tmp_path / "trace"), device="cpu"):
            resp = _post(f"http://127.0.0.1:{server.port}/predict", _payload())
    finally:
        server.close()
        service.close()
    assert 0 <= resp["prob_default"] <= 1
    names = _trace_names(tmp_path / "trace")
    assert "serve.microbatch_dispatch" in names
    assert {"http.request", "serve.validate", "serve.dispatch"} & set(names)


def test_profile_trace_none_is_a_no_op(tmp_path):
    with profile_trace(None):
        torch.ones(3).sum()
    with profile_trace(""):
        pass
    assert not torch.autograd._profiler_enabled()


def test_profile_trace_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        with profile_trace(str(tmp_path / "t")):
            pass
    assert not (tmp_path / "t").exists()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_ready(url: str, proc: subprocess.Popen, timeout: float = 120.0) -> None:
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.communicate()
        try:
            with opener.open(url + "/healthz", timeout=2) as resp:
                if resp.status == 200:
                    return
        except OSError:
            time.sleep(0.2)
    raise TimeoutError("server did not start")


def test_serve_cli_writes_a_trace_after_a_request_and_a_shutdown(store_root, tmp_path):
    port, trace = _free_port(), tmp_path / "cli_trace"
    proc = subprocess.Popen(
        [sys.executable, "-m", "cobalt_smart_lender_ai_tpu_torch.serve", "--store", store_root,
         "--device", "cpu", "--host", "127.0.0.1", "--port", str(port), "--profile-dir", str(trace)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "COBALT_COMPILE_CACHE": "0"},
    )
    try:
        url = f"http://127.0.0.1:{port}"
        _wait_ready(url, proc)
        assert 0 <= _post(url + "/predict", _payload())["prob_default"] <= 1
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(url + "/metrics", timeout=10) as resp:
            metrics = resp.read().decode()
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert f"profiler trace capturing to {trace}" in out
    for family in ("cobalt_compile_total", "cobalt_compile_cache_hits_total",
                   "cobalt_compile_cache_misses_total", "cobalt_compile_cache_saved_seconds_total"):
        assert f"# TYPE {family} counter" in metrics
    names = _trace_names(trace)
    assert "serve.microbatch_dispatch" in names
