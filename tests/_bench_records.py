"""Shared by ``tests/test_torch_bench_*.py``: the reference harnesses loaded
by path, and the comparison of a port record with the reference's (the
``bench`` value, the key tree and the trend metric names)."""

from __future__ import annotations

import contextlib
import importlib.util
import json
from pathlib import Path

import pytest

from cobalt_smart_lender_ai_tpu.telemetry import trend as ref_trend
from cobalt_smart_lender_ai_tpu_torch.telemetry import trend as port_trend

ROOT = Path(__file__).resolve().parent.parent

#: Keys of the serving records that are the services' own data, not the
#: harness's: the port's micro-batcher stats add ``degraded_batches``, and
#: its phase breakdown has no ``shap`` phase (SHAP runs inside the one
#: scoring launch).
SERVICE_KEYS = dict(ref_drop_under=[("phases", "shap")],
                    port_drop_under=[("microbatch", "degraded_batches")])


def load_reference(name: str, relpath: str):
    """A reference harness (a top-level script, not a package) as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def key_tree(value):
    """A record's dict structure: its keys all the way down, lists and
    scalars as leaves."""
    if isinstance(value, dict):
        return {k: key_tree(v) for k, v in value.items()}
    return None


def drop_under(tree, parent: str, key: str) -> None:
    """Remove ``key`` from every dict held under a key named ``parent``."""
    if not isinstance(tree, dict):
        return
    for k, v in tree.items():
        if k == parent and isinstance(v, dict):
            v.pop(key, None)
        drop_under(v, parent, key)


def assert_same_record_shape(ref_rec: dict, port_rec: dict, *, ref_only=(), port_only=(),
                             ref_drop_under=(), port_drop_under=()) -> None:
    """The port's record against the reference's: the same ``bench`` value,
    the same key tree but for the port's ``card`` block (which must say
    "no card" on the CPU) and the documented top-level keys of one side
    (``ref_only``, ``port_only``) or ``(parent, key)`` pairs under a key of
    one side, and the same trend metric names."""
    assert port_rec.get("bench") == ref_rec.get("bench")
    assert port_rec["card"] == {"name": None, "power_limit": None}
    want, got = key_tree(ref_rec), key_tree(port_rec)
    got.pop("card")
    for k in ref_only:
        want.pop(k)
    for k in port_only:
        got.pop(k)
    for parent, key in ref_drop_under:
        drop_under(want, parent, key)
    for parent, key in port_drop_under:
        drop_under(got, parent, key)
    assert got == want
    assert sorted(port_trend.extract_metrics(port_rec)) == sorted(ref_trend.extract_metrics(ref_rec))


@contextlib.contextmanager
def one_fit_each(ref_serve, port_serve):
    """While inside, each serving harness's `build_service` fits once and
    hands out fresh services over that artifact."""
    import cobalt_smart_lender_ai_tpu.serve.service as jax_service
    from cobalt_smart_lender_ai_tpu_torch.serve import service as port_service

    fits: dict = {}

    def ref_build(config, n_rows, seed=7, _real=ref_serve.build_service):
        if "ref" not in fits:
            svc, X = _real(config, n_rows, seed)
            fits["ref"] = (svc.artifact, X)
            svc.close()
        artifact, X = fits["ref"]
        return jax_service.ScorerService(artifact, config), X.copy()

    def port_build(config, n_rows, seed=7, *, device="cuda", _real=port_serve.build_service):
        if "port" not in fits:
            svc, X = _real(config, n_rows, seed, device=device)
            fits["port"] = (svc.artifact, X)
            svc.close()
        artifact, X = fits["port"]
        return port_service.ScorerService(artifact, config, device=device), X.copy()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_serve, "build_service", ref_build)
        mp.setattr(port_serve, "build_service", port_build)
        yield


def serve_records(ref_serve, port_serve, tmp_path, argv: list[str]) -> tuple[dict, dict]:
    """The reference's and the port's serving record of one mode."""
    ref_serve.main([*argv, "--out", str(tmp_path / "ref.json")])
    port_serve.main([*argv, "--device", "cpu", "--out", str(tmp_path / "port.json")])
    return (json.loads((tmp_path / "ref.json").read_text()),
            json.loads((tmp_path / "port.json").read_text()))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one CPU thread: the suite's workers share the
    host's cores, and the JAX side keeps its own pool."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
