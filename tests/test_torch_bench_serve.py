"""The port's ``tools.bench_serve`` against the reference's ``bench_serve.py``.

The reference harness is loaded by path (the top-level script is not a
package) and runs on the JAX package on the CPU; the port's runs with
``--device cpu``.

- Deterministic inputs, bit for bit: `_percentile` on seeded samples, and
  `build_payloads` on one matrix; the mixed mode's CSV body is byte for byte
  what the reference's pandas ``to_csv`` writes.
- Each mode at its smallest size (the closed loop on/off with the HTTP
  scrape, single and mixed, 2 clients; the async HTTP grid, 1 impl, 2
  clients; bulk at 512 rows, one shard count; the chaos and traffic fleets
  in ``tests/test_torch_bench_fleet.py``): the record's ``bench`` value, its key tree and the trend
  metric names `telemetry.trend.extract_metrics` yields are the
  reference's. The documented differences: the port adds its ``card``
  block; and two keys are the services' own data, not the harness's: the
  port's micro-batcher stats add ``degraded_batches``, and its phase
  breakdown has no ``shap`` phase (SHAP is computed inside the one scoring
  launch). The bulk record is bit-identical across shard counts.

Both sides train their serving model once per module (each harness's
`build_service` is wrapped to reuse its first fit), so each mode pays only
its own load. Nothing timing-dependent is asserted: no rate, no heal, no
scale-up.
"""

from __future__ import annotations

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

from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.serve.service import _parse_csv
from cobalt_smart_lender_ai_tpu_torch.tools import bench_serve as port

ref = load_reference("ref_bench_serve", "bench_serve.py")



@pytest.fixture(scope="module")
def trained():
    with one_fit_each(ref, port):
        yield


@pytest.mark.parametrize("q", [0.0, 0.5, 0.95, 0.99, 0.999, 1.0])
@pytest.mark.parametrize("n", [0, 1, 7, 1000])
def test_percentile_is_the_references(n, q):
    samples = sorted(np.random.default_rng(n).exponential(size=n).tolist())
    got, want = port._percentile(samples, q), ref._percentile(samples, q)
    assert (np.isnan(got) and np.isnan(want)) if n == 0 else got == want


def test_payloads_and_the_mixed_csv_are_the_references():
    import pandas as pd

    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 20)).astype(np.float32) * 1e3
    X[rng.random(X.shape) < 0.1] = np.nan
    assert port.build_payloads(X) == ref.build_payloads(X)
    assert len(port.build_payloads(X, 32)) == 32
    body = port.build_csv(X[:64], schema.SERVING_FEATURES)
    assert body == pd.DataFrame(X[:64], columns=list(schema.SERVING_FEATURES)).to_csv(index=False).encode()
    header, columns = _parse_csv(body)
    assert header == list(schema.SERVING_FEATURES)
    np.testing.assert_array_equal(np.array(columns, dtype=np.float32).T, X[:64])


LOOP = ["--smoke", "--clients", "2", "--duration-s", "0.3", "--warmup-s", "0.2"]


@pytest.mark.parametrize(
    "argv",
    [
        pytest.param([*LOOP, "--http-smoke"], id="closed_loop_single"),
        # a second of load: each client reaches its 1-in-8 bulk calls
        pytest.param([*LOOP, "--mix", "mixed", "--duration-s", "1.0"], id="closed_loop_mixed"),
        pytest.param([*LOOP, "--async-clients", "--client-counts", "2"], id="async_http"),
        pytest.param(["--bulk", "--bulk-rows", "512", "--bulk-shards", "1", "--rows", "800"], id="bulk"),
    ],
)
def test_record_shape_is_the_references(trained, tmp_path, argv):
    ref_rec, port_rec = serve_records(ref, port, tmp_path, argv)
    if port_rec["bench"] == "serve_throughput" and "--mix" in argv:
        assert all("bulk_calls" in r for r in port_rec["results"].values())
    if port_rec["bench"] == "bulk_scoring":
        assert port_rec["bit_identical"] and port_rec["devices"] == 1
    assert port_rec["platform"] == "cpu"
    assert_same_record_shape(ref_rec, port_rec, **SERVICE_KEYS)
