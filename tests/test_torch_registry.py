"""The port's dataset registry and raw bootstrap against the JAX package's,
on the CPU: a counterpart of each test of ``tests/test_registry.py``, the
download over a local ``file://`` URL (no test here touches a network), and
pins written by either package verified and pulled by the other (the same
object layout and JSON)."""

from __future__ import annotations

import hashlib
import json

import pytest

from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.io.registry import DatasetRegistry as JaxRegistry
from cobalt_smart_lender_ai_tpu_torch.data import bootstrap
from cobalt_smart_lender_ai_tpu_torch.data.bootstrap import bootstrap_synthetic, download_raw_archive
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame
from cobalt_smart_lender_ai_tpu_torch.io import REFERENCE_RAW_PINS, DatasetRegistry, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.io.frames import csv_to_frame, frame_to_csv


@pytest.fixture()
def registry(tmp_path):
    return DatasetRegistry(ObjectStore(str(tmp_path / "lake")))


def test_add_pull_roundtrip_and_layout(registry):
    data = b"row_id,loan_amnt\n1,1000\n"
    pin = registry.add("raw/sample.csv", data)
    assert pin.md5 == hashlib.md5(data).hexdigest()
    assert pin.size == len(data) and pin.hash == "md5"
    assert registry.pull("raw/sample.csv") == data
    assert registry.store.exists(f"dataset/cache/{pin.md5[:2]}/{pin.md5[2:]}")
    assert list(registry.names()) == ["raw/sample.csv"]


def test_identical_content_stored_once(registry):
    p1 = registry.add("a.csv", b"same bytes")
    p2 = registry.add("b.csv", b"same bytes")
    assert p1.md5 == p2.md5
    assert len(list(registry.store.list("dataset/cache/"))) == 1


def test_corruption_detected_on_pull(registry):
    pin = registry.add("x.bin", b"original")
    registry.store.put_bytes(f"dataset/cache/{pin.md5[:2]}/{pin.md5[2:]}", b"tampered")
    with pytest.raises(ValueError, match="failed verification"):
        registry.pull("x.bin")
    assert not registry.verify("x.bin")


def test_pin_survives_new_version(registry):
    registry.add("d.csv", b"v1")
    pin2 = registry.add("d.csv", b"v2-longer")
    assert registry.pull("d.csv") == b"v2-longer"
    assert registry.pin("d.csv") == pin2


def test_pull_writes_dest(registry, tmp_path):
    registry.add("d.csv", b"payload")
    dest = tmp_path / "out" / "d.csv"
    assert registry.pull("d.csv", dest) == b"payload" and dest.read_bytes() == b"payload"
    assert not registry.verify("never-pinned.csv")


def test_reference_pins_importable_and_verify_local(registry, tmp_path):
    registry.import_reference_pins()
    assert {p.path for p in REFERENCE_RAW_PINS} <= set(registry.names())
    raw = json.loads(registry.store.get_bytes("dataset/pins/Loan_status_2007-2020Q3-100ksample.csv.json"))
    assert raw == {
        "path": "Loan_status_2007-2020Q3-100ksample.csv",
        "md5": "4e01f7e3ef869a35b65c400d3edda715",
        "size": 73991891,
        "hash": "md5",
    }
    fake = tmp_path / "fake.csv"
    fake.write_bytes(b"not the real table")
    assert not registry.verify_local("Loan_status_2007-2020Q3-100ksample.csv", fake)
    registry.add("local.csv", fake)
    assert registry.verify_local("local.csv", fake)


def test_bootstrap_synthetic_writes_and_pins(registry, tmp_path):
    path = bootstrap_synthetic(tmp_path / "raw", registry=registry, n_rows=200, seed=3)
    assert path.exists()
    assert registry.verify("Loan_status_synthetic.csv")
    data = registry.pull("Loan_status_synthetic.csv")
    assert data == path.read_bytes() == frame_to_csv(synthetic_lendingclub_frame(200, seed=3))
    frame = csv_to_frame(data)
    # The generator plants duplicates for the cleaning stage to drop.
    assert frame.n_rows >= 200 and "loan_status" in frame.columns


def test_download_unreachable_raises_actionable_error(registry, tmp_path):
    missing = (tmp_path / "nowhere" / "x.zip").as_uri()
    with pytest.raises(ConnectionError, match="DatasetRegistry.add"):
        download_raw_archive(missing, tmp_path / "x.zip", registry=registry, timeout=0.5)
    assert not (tmp_path / "x.zip").exists()
    with pytest.raises(ValueError, match="is a directory"):
        download_raw_archive(missing, tmp_path, registry=registry)


def test_download_pins_on_success_over_file_url(registry, tmp_path):
    archive = tmp_path / "src" / "data.zip"
    archive.parent.mkdir()
    archive.write_bytes(b"archive-bytes")
    dest = download_raw_archive(archive.as_uri(), tmp_path / "data.zip", registry=registry)
    assert dest.read_bytes() == b"archive-bytes"
    assert registry.pull("data.zip") == b"archive-bytes"


def test_download_claiming_a_reference_pin_must_match_it(registry, tmp_path):
    name = REFERENCE_RAW_PINS[0].path
    fake = tmp_path / "src" / name
    fake.parent.mkdir()
    fake.write_bytes(b"not the reference table")
    with pytest.raises(ValueError, match="does not match its reference pin"):
        download_raw_archive(fake.as_uri(), tmp_path / name, registry=registry)
    assert not (tmp_path / name).exists() and list(registry.names()) == []


def test_bootstrap_cli_synthesizes_or_fetches(tmp_path, capsys):
    lake = tmp_path / "lake"
    path = bootstrap.main(["--workspace", str(tmp_path / "raw"), "--rows", "120", "--seed", "1",
                           "--store", str(lake)])
    assert capsys.readouterr().out.strip() == str(path)
    assert DatasetRegistry(ObjectStore(str(lake))).pull(path.name) == path.read_bytes()
    got = bootstrap.main(["--workspace", str(tmp_path / "w2"), "--url", path.as_uri()])
    assert got.read_bytes() == path.read_bytes()
    with pytest.raises(SystemExit):
        bootstrap.main(["--url", "file:///some/folder/"])


def test_jax_pins_verify_in_the_port(tmp_path):
    root = str(tmp_path / "lake")
    jpin = JaxRegistry(JaxStore(root)).add("raw/jax.csv", b"written by the JAX package")
    port = DatasetRegistry(ObjectStore(root))
    assert port.verify("raw/jax.csv")
    assert port.pull("raw/jax.csv") == b"written by the JAX package"
    assert port.pin("raw/jax.csv").md5 == jpin.md5


def test_port_pins_verify_in_jax(tmp_path):
    root = str(tmp_path / "lake")
    pin = DatasetRegistry(ObjectStore(root)).add("raw/port.csv", b"written by the port")
    ref = JaxRegistry(JaxStore(root))
    assert ref.verify("raw/port.csv")
    assert ref.pull("raw/port.csv") == b"written by the port"
    assert ref.pin("raw/port.csv").md5 == pin.md5 and list(ref.names()) == ["raw/port.csv"]
