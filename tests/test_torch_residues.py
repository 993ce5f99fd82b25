"""The small API residues of ported modules against the reference's.

`ObjectStore.put_file` / `get_file`, `io.load_metrics`,
`ProgramRegistry.get` and ``__version__`` (``version.py``, re-exported by
the package and written as an artifact's ``library_version``) behave as the
reference's do on the same store and registry.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import cobalt_smart_lender_ai_tpu as ref_pkg
import cobalt_smart_lender_ai_tpu_torch as port_pkg
from cobalt_smart_lender_ai_tpu.io import load_metrics as ref_load_metrics
from cobalt_smart_lender_ai_tpu.io import save_metrics as ref_save_metrics
from cobalt_smart_lender_ai_tpu.io.store import ObjectStore as RefStore
from cobalt_smart_lender_ai_tpu.telemetry.programs import ProgramRegistry as RefPrograms
from cobalt_smart_lender_ai_tpu.version import __version__ as ref_version
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore, load_metrics, save_metrics
from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import ProgramRegistry
from cobalt_smart_lender_ai_tpu_torch.version import __version__

METRICS = {
    "auc": 0.9347,
    "best_params": {"max_depth": 7, "learning_rate": 0.05},
    "classification_report": {"0": {"precision": 0.91, "recall": 0.88}, "accuracy": 0.87},
}


def test_version_is_the_references_and_the_package_reexports_it():
    assert __version__ == ref_version == "0.1.0"
    assert port_pkg.__version__ == __version__
    assert ref_pkg.__version__ == ref_version


def test_artifacts_record_the_version_module(tmp_path, monkeypatch):
    from cobalt_smart_lender_ai_tpu_torch.io import artifacts

    store = ObjectStore(str(tmp_path / "lake"))
    art = GBDTArtifact.load(ObjectStore("artifacts"), "models/gbdt/model_tree", device="cpu")
    monkeypatch.setattr(artifacts, "__version__", "9.9.9")
    art.save(store, "m")
    header = json.loads(bytes(np.load(tmp_path / "lake" / "m.npz")["__header__"]).decode())
    assert header["library_version"] == "9.9.9"


@pytest.mark.parametrize("payload", [b"", b"plain bytes\n", bytes(range(256)) * 41])
def test_put_file_and_get_file_as_the_reference(tmp_path, payload):
    src = tmp_path / "src.bin"
    src.write_bytes(payload)
    port, ref = ObjectStore(str(tmp_path / "port")), RefStore(str(tmp_path / "ref"))
    port.put_file("dir/a.bin", src)
    ref.put_file("dir/a.bin", str(src))
    assert port.get_bytes("dir/a.bin") == ref.get_bytes("dir/a.bin") == payload
    got = port.get_file("dir/a.bin", tmp_path / "out" / "deep" / "a.bin")
    want = ref.get_file("dir/a.bin", tmp_path / "out_ref" / "deep" / "a.bin")
    assert got == tmp_path / "out" / "deep" / "a.bin"
    assert got.read_bytes() == want.read_bytes() == payload
    # The reference's store reads the port's file and the other way round.
    assert RefStore(str(tmp_path / "port")).get_bytes("dir/a.bin") == payload
    assert ObjectStore(str(tmp_path / "ref")).get_bytes("dir/a.bin") == payload


def test_put_file_keeps_the_stores_key_rules(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"x")
    with pytest.raises(ValueError):
        ObjectStore(str(tmp_path / "port")).put_file("../escape.bin", src)
    with pytest.raises(FileNotFoundError):
        ObjectStore(str(tmp_path / "port")).get_file("missing.bin", tmp_path / "x.bin")


def test_load_metrics_reads_what_either_package_saved(tmp_path):
    port, ref = ObjectStore(str(tmp_path)), RefStore(str(tmp_path))
    save_metrics(port, "run/metrics.json", METRICS)
    ref_save_metrics(ref, "run/ref_metrics.json", METRICS)
    assert (tmp_path / "run" / "metrics.json").read_bytes() == (tmp_path / "run" / "ref_metrics.json").read_bytes()
    for key in ("run/metrics.json", "run/ref_metrics.json"):
        assert load_metrics(port, key) == ref_load_metrics(ref, key) == METRICS


def test_program_registry_get_as_the_reference():
    port, ref = ProgramRegistry(), RefPrograms()
    assert port.get("score_forest/f32/64/shap") is None and ref.get("score_forest/f32/64/shap") is None
    handle = port.register("score_forest/f32/64/shap", kind="kernel", meta={"bucket": 64})
    ref.register("score_forest/f32/64/shap", kind="kernel", meta={"bucket": 64})
    assert port.get("score_forest/f32/64/shap") is handle
    assert port.get("score_forest/f32/64/shap").name == ref.get("score_forest/f32/64/shap").name
    assert port.get("score_forest/f32/64/shap").kind == ref.get("score_forest/f32/64/shap").kind
    assert port.get("gradient_histogram/F20xB255") is None
