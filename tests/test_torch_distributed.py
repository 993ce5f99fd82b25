"""The port's multi-process runtime: `parallel.distributed`.

- one process: `init_distributed` is a no-op, `DistributedConfig.from_env`
  reads the reference's ``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` /
  ``PROCESS_ID`` contract, and `make_global_mesh` is `make_mesh`;
- two processes on the CPU (gloo), each this file run as a script: the
  bootstrap (idempotent), an ``all_reduce``, the global mesh's shape, and a
  dp fit over the (1, 2) global mesh (each process one shard) that equals
  the one-process fit over a (1, 2) mesh of the CPU named twice, bit for
  bit: the float64 histogram partials and float32 leaf sums of two shards
  add the same either way. Each worker has a time limit, and a worker left
  alive is killed;
- NCCL ownership: under NCCL a rank's default mesh entry is the one card
  it is bound to, and a global mesh in which two ranks of one host list the
  same device raises (the two workers build one with the backend read as
  ``nccl``, both listing ``cpu``).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig, MeshConfig
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTHyperparams
from cobalt_smart_lender_ai_tpu_torch.parallel.distributed import (
    DistributedConfig,
    check_device_owners,
    init_distributed,
    local_mesh_devices,
    make_global_mesh,
)
from cobalt_smart_lender_ai_tpu_torch.parallel.mesh import make_mesh
from cobalt_smart_lender_ai_tpu_torch.parallel.sharded import fit_binned_dp

ROOT = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 240
FOREST_FIELDS = ("feature", "thr_bin", "missing_left", "gain", "cover", "leaf_value")


def _data(n: int = 1501, f: int = 6, b: int = 32):
    rng = np.random.default_rng(11)
    bins = torch.from_numpy(rng.integers(0, b, (n, f)).astype(np.uint8))
    y = torch.from_numpy((rng.random(n) < 0.35).astype(np.float32))
    return bins, y


def _fit(mesh):
    bins, y = _data()
    hp = GBDTHyperparams.from_config(GBDTConfig(n_estimators=5, max_depth=3, subsample=0.8,
                                                colsample_bytree=0.8))
    return fit_binned_dp(mesh, bins, y, None, None, hp, 3, n_trees_cap=5, depth_cap=3, n_bins=32)


def test_one_process_is_a_no_op(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert DistributedConfig.from_env() == DistributedConfig()
    assert init_distributed(device="cpu") is False
    assert init_distributed(DistributedConfig(num_processes=1), device="cpu") is False
    assert not torch.distributed.is_initialized()
    mesh = make_global_mesh(MeshConfig(hp=2), devices=["cpu"] * 4)
    assert mesh.shape == {"hp": 2, "dp": 2} and mesh.ranks is None


def test_from_env_reads_the_references_contract(monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:29500")
    monkeypatch.setenv("NUM_PROCESSES", "4")
    monkeypatch.setenv("PROCESS_ID", "2")
    assert DistributedConfig.from_env() == DistributedConfig("127.0.0.1:29500", 4, 2)
    monkeypatch.setenv("NUM_PROCESSES", "")
    assert DistributedConfig.from_env().num_processes is None
    with pytest.raises(ValueError, match="process's id"):
        init_distributed(DistributedConfig("127.0.0.1:1", 2, None), device="cpu")


def test_nccl_ranks_own_their_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert local_mesh_devices(None, "nccl") == [torch.device("cuda", 3)]
    assert local_mesh_devices(["cpu", "cpu"], "nccl") == [torch.device("cpu")] * 2
    one_card_each = [[("h", "cuda:0")], [("h", "cuda:1")], [("g", "cuda:0"), ("g", "cuda:0")]]
    check_device_owners(one_card_each, "nccl")
    shared = [[("h", "cuda:0"), ("h", "cuda:1")], [("h", "cuda:1")]]
    with pytest.raises(ValueError, match="ranks 0 and 1"):
        check_device_owners(shared, "nccl")
    check_device_owners(shared, "gloo")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank: int, port: int, out: str) -> None:
    """One of two processes: bootstrap, all_reduce, the global mesh and the
    dp fit; its results go to ``out`` as JSON (rank 0 also the forest)."""
    torch.set_num_threads(1)
    cfg = DistributedConfig(f"127.0.0.1:{port}", 2, rank)
    assert init_distributed(cfg, device="cpu", timeout_s=WORKER_TIMEOUT_S) is True
    assert init_distributed(cfg, device="cpu") is True  # idempotent
    t = torch.tensor([rank + 1.0])
    torch.distributed.all_reduce(t)
    mesh = make_global_mesh(MeshConfig(), devices=["cpu"])
    forest = _fit(mesh)
    doc = {
        "all_reduce": float(t),
        "shape": mesh.shape,
        "ranks": mesh.ranks.tolist(),
        "forest": {f: getattr(forest, f).tolist() for f in FOREST_FIELDS},
        "hp_mesh": make_global_mesh(MeshConfig(hp=2), devices=["cpu"]).shape,
        "nccl_refused": _nccl_mesh_error(),
    }
    Path(out).write_text(json.dumps(doc))
    torch.distributed.destroy_process_group()


def _nccl_mesh_error() -> str | None:
    """Both ranks list ``cpu`` on one host: under NCCL that is one device in
    two ranks, which the global mesh must refuse."""
    real = torch.distributed.get_backend
    torch.distributed.get_backend = lambda *a, **k: "nccl"
    try:
        make_global_mesh(MeshConfig(), devices=["cpu"])
    except ValueError as e:
        return str(e)
    finally:
        torch.distributed.get_backend = real
    return None


def test_two_gloo_processes_fit_as_one_process_mesh(tmp_path):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [
        subprocess.Popen([sys.executable, __file__, str(r), str(port), str(outs[r])], env=env,
                         cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    docs = [json.loads(o.read_text()) for o in outs]
    want = _fit(make_mesh(MeshConfig(), devices=["cpu", "cpu"]))
    for doc in docs:
        assert doc["all_reduce"] == 3.0
        assert doc["shape"] == {"hp": 1, "dp": 2} and doc["ranks"] == [[0, 1]]
        assert doc["hp_mesh"] == {"hp": 2, "dp": 1}
        assert "listed by ranks 0 and 1" in (doc["nccl_refused"] or "")
        for f in FOREST_FIELDS:
            got = torch.tensor(doc["forest"][f], dtype=getattr(want, f).dtype)
            assert torch.equal(got, getattr(want, f)), f


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
