"""The port's ``tools.bench_pipeline`` against the reference's
``tools/bench_pipeline.py``, on the CPU: at one frame size (1,000 loans,
one timed pass a side) the record's ``bench`` value, key tree and trend
metric names are the reference's, but for ``card``; the frozen date is the
reference's. The reference's ``--shards -1`` shards its device side over
its eight virtual devices, the port's over its one."""

from __future__ import annotations

import json

from _bench_records import (  # noqa: F401  (one_torch_thread is an autouse fixture)
    assert_same_record_shape,
    load_reference,
    one_torch_thread,
)

from cobalt_smart_lender_ai_tpu_torch.tools import bench_pipeline as port

ref = load_reference("ref_bench_pipeline", "tools/bench_pipeline.py")

ARGV = ["--sizes", "1000", "--repeats", "1"]


def test_record_shape_is_the_references(tmp_path):
    assert port.TODAY == ref.TODAY
    assert ref.main([*ARGV, "--out", str(tmp_path / "ref.json")]) == 0
    assert port.main([*ARGV, "--device", "cpu", "--out", str(tmp_path / "port.json")]) == 0
    ref_rec = json.loads((tmp_path / "ref.json").read_text())
    port_rec = json.loads((tmp_path / "port.json").read_text())
    assert port_rec["platform"] == "cpu" and port_rec["devices"] == 1
    assert list(port_rec["results"]) == ["rows_1000"]
    assert_same_record_shape(ref_rec, port_rec)


def test_force_devices_names_the_one_device_twice(tmp_path):
    assert port.main(["--sizes", "500,700", "--repeats", "1", "--device", "cpu", "--force-devices", "2",
                      "--out", str(tmp_path / "port.json")]) == 0
    rec = json.loads((tmp_path / "port.json").read_text())
    assert rec["devices"] == 2 and rec["force_devices"] == {"named": 2, "physical_devices": 1}
    assert list(rec["results"]) == ["rows_500", "rows_700"]
    assert rec["speedup_largest"] == rec["results"]["rows_700"]["speedup"]
    for row in rec["results"].values():
        assert row["host"]["rows_per_s"] > 0 and row["device"]["rows_per_s"] > 0
        assert row["device"]["shards"] == -1
