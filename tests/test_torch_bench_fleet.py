"""The port's ``tools.bench_serve --chaos`` and ``--traffic`` against the
reference's ``bench_serve.py``, on the CPU.

- One traffic schedule per shape and seed is the reference's, arrival for
  arrival (time, kind, payload), and so is its summary.
- ``--chaos`` (3 replicas, 2 clients, a second of load) and ``--traffic
  flash_crowd`` (2 s of arrivals at 8 -> 20 requests/s, and the harness's
  own 8 s settle window): the record's ``bench`` value, its key tree and
  its trend metric names are the reference's, but for the port's ``card``
  block and the services' own keys (`_bench_records.SERVICE_KEYS`).

Nothing timing-dependent is asserted: a heal, a scale-up or a brownout
rung shows in the values, not in the keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
from _bench_records import (  # noqa: F401  (one_torch_thread is an autouse fixture)
    SERVICE_KEYS,
    assert_same_record_shape,
    load_reference,
    one_fit_each,
    one_torch_thread,
    serve_records,
)

from cobalt_smart_lender_ai_tpu.data import schema as ref_schema
from cobalt_smart_lender_ai_tpu.reliability import traffic as ref_traffic
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.reliability import traffic
from cobalt_smart_lender_ai_tpu_torch.tools import bench_serve as port

ref = load_reference("ref_bench_serve_fleet", "bench_serve.py")


@pytest.fixture(scope="module")
def trained():
    with one_fit_each(ref, port):
        yield


def _generator(module, schema_module, shape: str, seed: int, payloads: list[dict]):
    """The arrival generator as each harness's `run_traffic_bench` builds it."""
    return module.TrafficGenerator(
        module.shape_by_name(shape, seed),
        base_rps=8.0,
        peak_rps=60.0,
        duration_s=6.0,
        tenants=module.TenantPopulation(
            list(payloads[0]),
            [schema_module.SERVING_FIELD_ALIASES.get(n, n) for n in schema_module.SERVING_INT_FEATURES],
            base_rows=payloads,
            jitter=0.03,
            seed=seed,
        ),
        seed=seed,
    )


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("shape", ["flash_crowd", "diurnal", "bursty", "ramp", "steady"])
def test_traffic_schedule_is_the_references(shape, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(64, 20)).astype(np.float32)
    payloads = port.build_payloads(X)
    ours = _generator(traffic, schema, shape, seed, payloads)
    theirs = _generator(ref_traffic, ref_schema, shape, seed, ref.build_payloads(X))
    got, want = ours.schedule(), theirs.schedule()
    assert len(got) == len(want) > 0
    assert [dataclasses.astuple(a) for a in got] == [dataclasses.astuple(a) for a in want]
    assert ours.summary() == theirs.summary()


@pytest.mark.parametrize(
    "argv",
    [
        pytest.param(["--chaos", "--clients", "2", "--duration-s", "1.0", "--warmup-s", "0.2",
                      "--rows", "800"], id="chaos"),
        pytest.param(["--traffic", "flash_crowd", "--traffic-duration-s", "2", "--traffic-peak-rps",
                      "20", "--rows", "800"], id="traffic"),
    ],
)
def test_fleet_record_shape_is_the_references(trained, tmp_path, argv):
    ref_rec, port_rec = serve_records(ref, port, tmp_path, argv)
    assert port_rec["platform"] == "cpu"
    assert_same_record_shape(ref_rec, port_rec, **SERVICE_KEYS)
