"""The port's `MLPArtifact` and its msgpack codec (`io/flax_msgpack.py`)
against the JAX package's `MLPArtifact` and flax's serialization, on the
CPU.

Held bit for bit: the port's ``params_msgpack`` bytes are
``flax.serialization.msgpack_serialize`` of the same parameters; an
artifact the port writes is read by the JAX package's
`MLPArtifact.from_bytes` (header, scaler and parameters) and one the JAX
package writes is read by the port's; a round trip through the port gives
its own weights back. The JAX MLP applied to the parameters it read from
the port's artifact gives the port's logits within 1e-5, and the reverse.
The codec reads and writes the subset flax's parameter trees use byte for
byte as flax's msgpack does (maps of every size, keys of every length,
arrays of several dtypes, ranks and dims).
"""

from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from cobalt_smart_lender_ai_tpu.io import MLPArtifact as JaxMLPArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.models.nn import MLP as JaxMLP
from cobalt_smart_lender_ai_tpu_torch.convert import flax_params_to_state_dict
from cobalt_smart_lender_ai_tpu_torch.io import MLPArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.io.flax_msgpack import pack_tree, unpack_tree
from cobalt_smart_lender_ai_tpu_torch.models import MLP
from cobalt_smart_lender_ai_tpu_torch.models.nn import MinMaxStats, seeded_generator

HIDDEN = (32, 16)
F = 20
NAMES = tuple(f"f{i}" for i in range(F))
TOL_LOGITS = 1e-5


def _rows(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(200, F)).astype(np.float32) * 10
    X[rng.random(X.shape) < 0.1] = np.nan
    return X


@pytest.fixture(scope="module")
def port_artifact():
    X = _rows(0)
    scaler = MinMaxStats.fit(torch.from_numpy(X))
    module = MLP(F, HIDDEN, generator=seeded_generator(7))
    art = MLPArtifact(
        state_dict=module.state_dict(),
        scaler_low=scaler.low.numpy(),
        scaler_range=scaler.range_.numpy(),
        feature_names=NAMES,
        hidden_sizes=HIDDEN,
        config={"learning_rate": 0.01, "epochs": 12, "seed": 7},
        metrics={"test_auc": 0.8123},
    )
    return art, module, scaler


def test_the_reference_reads_the_ports_artifact(port_artifact):
    art, module, scaler = port_artifact
    ref = JaxMLPArtifact.from_bytes(art.to_bytes())
    assert ref.feature_names == NAMES and ref.hidden_sizes == HIDDEN
    assert ref.config == art.config and ref.metrics == art.metrics
    np.testing.assert_array_equal(ref.scaler_low, art.scaler_low)
    np.testing.assert_array_equal(ref.scaler_range, art.scaler_range)
    X = _rows(1)
    Xs = scaler(torch.from_numpy(X))
    with torch.no_grad():
        want = module(Xs).numpy()
    got = np.asarray(JaxMLP(hidden=HIDDEN).apply(ref.params, Xs.numpy()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_LOGITS)


def test_params_bytes_are_flax_msgpack_serialize(port_artifact):
    art = port_artifact[0]
    stored = np.load(io.BytesIO(art.to_bytes()))["params_msgpack"].tobytes()
    ref = JaxMLPArtifact.from_bytes(art.to_bytes())
    assert stored == serialization.msgpack_serialize(ref.params)
    params = JaxMLP(hidden=(128, 32, 16)).init(jax.random.PRNGKey(3), jnp.zeros((1, 68)))
    carried = MLPArtifact(flax_params_to_state_dict("mlp", params), np.zeros(68, np.float32),
                          np.ones(68, np.float32), tuple(f"c{i}" for i in range(68)), (128, 32, 16))
    stored = np.load(io.BytesIO(carried.to_bytes()))["params_msgpack"].tobytes()
    assert stored == serialization.msgpack_serialize(params)


def test_the_port_reads_the_references_artifact(tmp_path):
    params = JaxMLP(hidden=HIDDEN).init(jax.random.PRNGKey(5), jnp.zeros((1, F)))
    X = _rows(2)
    low = np.nanmin(X, axis=0).astype(np.float32)
    rng_ = (np.nanmax(X, axis=0) - low).astype(np.float32)
    ref = JaxMLPArtifact(params=params, scaler_low=low, scaler_range=rng_, feature_names=NAMES,
                         hidden_sizes=HIDDEN, config={"seed": 5}, metrics={"test_auc": 0.7})
    ref.save(JaxStore(str(tmp_path)), "models/gbdt_mlp/v1")
    art = MLPArtifact.load(ObjectStore(str(tmp_path)), "models/gbdt_mlp/v1", device="cpu")
    assert (art.feature_names, art.hidden_sizes, art.config, art.metrics) == (
        NAMES, HIDDEN, {"seed": 5}, {"test_auc": 0.7})
    np.testing.assert_array_equal(art.scaler_low, low)
    np.testing.assert_array_equal(art.scaler_range, rng_)
    module = MLP(F, HIDDEN)
    module.load_state_dict(art.state_dict)
    scaler = MinMaxStats(torch.from_numpy(art.scaler_low), torch.from_numpy(art.scaler_range))
    Xs = scaler(torch.from_numpy(X))
    with torch.no_grad():
        got = module(Xs).numpy()
    want = np.asarray(JaxMLP(hidden=HIDDEN).apply(params, Xs.numpy()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_LOGITS)


def test_the_ports_round_trip_is_bitwise(port_artifact, tmp_path):
    art = port_artifact[0]
    art.save(ObjectStore(str(tmp_path)), "k")
    back = MLPArtifact.load(ObjectStore(str(tmp_path)), "k", device="cpu")
    assert back.state_dict.keys() == art.state_dict.keys()
    for key, value in art.state_dict.items():
        assert torch.equal(back.state_dict[key], value), key
    np.testing.assert_array_equal(back.scaler_low, art.scaler_low)
    assert (back.feature_names, back.hidden_sizes, back.config, back.metrics) == (
        art.feature_names, art.hidden_sizes, art.config, art.metrics)
    with pytest.raises(ValueError, match="kind"):
        from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact

        GBDTArtifact.from_bytes(art.to_bytes(), device="cpu")


def _odd_tree() -> dict:
    """Every width of the codec's lengths and ints: fix, 8-, 16- and 32-bit
    keys, maps and payloads, shapes of several ranks and dims."""
    return {
        "arrays": {
            "scalar": np.array(3.0, np.float32),
            "empty": np.zeros((0, 3), np.int32),
            "f64": np.linspace(0, 1, 7),
            "u8": np.arange(16, dtype=np.uint8),
            "i64_3d": np.arange(24, dtype=np.int64).reshape(2, 3, 4),
            "bool": np.array([True, False]),
            "big": np.ones((70, 300), np.float32),
            "long_dim": np.zeros((70_000,), np.uint8),
            "wide_dim": np.zeros((2, 300), np.int8),
        },
        "map": {f"k{i:02d}": {"w": np.full((2,), i, np.float32)} for i in range(20)},
        "k" * 40: {"é" * 200: np.ones(1, np.float32)},
        "m" * 300: {},
    }


def test_codec_writes_and_reads_flax_msgpack():
    tree = _odd_tree()
    data = pack_tree(tree)
    assert data == serialization.msgpack_serialize(tree)
    back = unpack_tree(data)
    ref = serialization.msgpack_restore(data)
    flat_a = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert type(a) is type(b) and np.array_equal(np.asarray(a), np.asarray(b)), path
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape and a.flags.writeable
    with pytest.raises(ValueError, match="trailing"):
        unpack_tree(data + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        unpack_tree(data[:-1])
