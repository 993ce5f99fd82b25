"""The port's training loop (`models/train_loop.py`) and `debug.py` against
the JAX package's, on the CPU at small sizes.

`fit_binary` in the single-batch regime (batch >= rows, so each epoch is
one AdamW update and the permutation changes only the order of a sum), 5 to
12 epochs from the same weights (the JAX module's initial parameters carried
in by `convert`): the MLP with the L2 term and early stopping on a
validation set, FT-Transformer without dropout with chunked validation, and
TabNet with its per-row aux loss and no validation set. Held: every epoch's
loss and validation AUC within 1e-5 relative, the same epochs run (so the
same stop epoch), and the parameters within 1e-5, except the attention's
key bias: softmax does not depend on it, so its gradient is rounding noise,
which Adam (dividing the first moment by the root of the second) turns into
steps of up to lr that differ between the packages; it is held within lr
per update.

The port's own: any ``epochs_per_dispatch`` gives the history, the stop
epoch and the parameters of 1, bit for bit; a diverging loss raises
`FloatingPointError` naming the epoch (the JAX package's), for any
``epochs_per_dispatch``; every epoch run lands on ``cobalt_train_epoch_seconds``.
`debug.nan_guard` turns anomaly detection on and back off and a NaN
gradient raises inside it; `debug.assert_all_finite` names the bad leaf.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.models.ft_transformer import FTTransformer as JaxFT
from cobalt_smart_lender_ai_tpu.models.nn import MLP as JaxMLP
from cobalt_smart_lender_ai_tpu.models.tabnet import TabNet as JaxTabNet
from cobalt_smart_lender_ai_tpu.models.train_loop import TrainSettings as JaxSettings
from cobalt_smart_lender_ai_tpu.models.train_loop import fit_binary as jax_fit_binary
from cobalt_smart_lender_ai_tpu_torch.config import MLPConfig
from cobalt_smart_lender_ai_tpu_torch.convert import flax_params_to_state_dict
from cobalt_smart_lender_ai_tpu_torch.debug import assert_all_finite, nan_guard
from cobalt_smart_lender_ai_tpu_torch.models import MLP, FTTransformer, MLPClassifier, TabNet
from cobalt_smart_lender_ai_tpu_torch.models.train_loop import TrainSettings, fit_binary
from cobalt_smart_lender_ai_tpu_torch.telemetry import default_registry

RTOL_HISTORY = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed: int, n: int, F: int):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + rng.logistic(size=n) * 0.5 > 0).astype(np.float32)
    return X, y


def _case(family: str):
    """(JAX apply_fn, JAX params, port module, port apply_fn, X, y, X_val,
    y_val, settings kwargs) of one family's single-batch fit."""
    X, y = _data(0, 192, 8)
    Xv, yv = _data(1, 96, 8)
    if family == "mlp":
        jm = JaxMLP(hidden=(16, 8))
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))
        port = MLP(8, (16, 8))
        return (lambda p, xb, rngs: jm.apply(p, xb), params, port, None, X, y, Xv, yv,
                dict(epochs=12, learning_rate=3e-2, l2=1e-3, early_stop_patience=2,
                     early_stop_min_delta=1e-3))
    if family == "ft_transformer":
        rng = np.random.default_rng(2)
        Xc, Xvc = rng.integers(0, 4, (192, 2)), rng.integers(0, 4, (96, 2))
        jm = JaxFT(n_numeric=8, vocab_sizes=(4, 4), d_token=8, n_blocks=1, n_heads=2, dropout=0.0)
        params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8)), jnp.zeros((1, 2), jnp.int32))
        port = FTTransformer(8, (4, 4), d_token=8, n_blocks=1, n_heads=2, dropout=0.0)

        def jax_apply(p, b, rngs):
            return jm.apply(p, b[0], b[1], deterministic=True)

        return (jax_apply, params, port, lambda b, gen: port(b[0], b[1], gen),
                (X, Xc), y, (Xv, Xvc), yv,
                dict(epochs=5, learning_rate=1e-3, weight_decay=1e-5, val_batch_rows=40))
    jm = JaxTabNet(n_features=8, n_steps=2, width=4)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 8)))
    port = TabNet(8, 2, 4)

    def jax_apply(p, xb, rngs=None):
        logit, entropy, _ = jm.apply(p, xb)
        return logit, 1e-3 * entropy

    def port_apply(xb, gen):
        logit, entropy, _ = port(xb)
        return logit, 1e-3 * entropy

    return (jax_apply, params, port, port_apply, X, y, None, None,
            dict(epochs=5, learning_rate=2e-2, pos_weight=1.5))


def _torch_batch(X):
    if isinstance(X, tuple):
        return torch.from_numpy(X[0]), torch.from_numpy(X[1]).long()
    return None if X is None else torch.from_numpy(X)


@pytest.mark.parametrize("family", ["mlp", "ft_transformer", "tabnet"])
def test_single_batch_fit_is_the_references(family):
    jax_apply, params, port, port_apply, X, y, Xv, yv, kw = _case(family)
    n = len(y)
    ref_params, ref_hist = jax_fit_binary(
        jax_apply, params, X, y, JaxSettings(batch_size=n, **kw),
        **({} if Xv is None else {"X_val": Xv, "y_val": yv}),
    )
    port.load_state_dict(flax_params_to_state_dict(family, params))
    hist = fit_binary(
        port, _torch_batch(X), torch.from_numpy(y), TrainSettings(batch_size=n, **kw),
        X_val=_torch_batch(Xv), y_val=None if yv is None else torch.from_numpy(yv),
        apply_fn=port_apply,
    )
    assert len(hist["loss"]) == len(ref_hist["loss"])  # the same stop epoch
    np.testing.assert_allclose(hist["loss"], ref_hist["loss"], rtol=RTOL_HISTORY)
    np.testing.assert_allclose(hist["val_auc"], ref_hist["val_auc"], rtol=RTOL_HISTORY)
    if family == "mlp":
        assert len(hist["loss"]) < kw["epochs"]  # early stopping fired
    want = flax_params_to_state_dict(family, ref_params)
    for key, value in port.state_dict().items():
        tol = kw["learning_rate"] * len(hist["loss"]) if key.endswith("attn.key.bias") else 1e-5
        err = float((value - want[key]).abs().max())
        assert err <= tol, (key, err, tol)


def _mlp_run(k: int) -> MLPClassifier:
    rng = np.random.default_rng(5)
    X = rng.normal(size=(600, 12)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + rng.logistic(size=600) * 0.4 > 0).astype(np.int32)
    cfg = MLPConfig(hidden_sizes=(16, 8), epochs=12, batch_size=128, early_stop_patience=3,
                    epochs_per_dispatch=k, seed=3)
    return MLPClassifier(cfg, device="cpu").fit(X, y)


def test_epochs_per_dispatch_is_bit_identical():
    """For any K the history, the stop epoch and the restored parameters
    are those of K = 1, bit for bit."""
    a, b, c = _mlp_run(1), _mlp_run(5), _mlp_run(12)
    assert a.history["loss"] == b.history["loss"] == c.history["loss"]
    assert a.history["val_auc"] == b.history["val_auc"] == c.history["val_auc"]
    assert len(a.history["loss"]) < 12  # stopped early: K = 5 and 12 train past the stop
    for other in (b, c):
        for (key, x), y in zip(a.module.state_dict().items(), other.module.state_dict().values()):
            assert torch.equal(x, y), key


def test_epoch_seconds_count_the_epochs_run():
    family = default_registry().histogram("cobalt_train_epoch_seconds", "")
    before = family.count
    run = _mlp_run(5)
    assert family.count - before == len(run.history["loss"])


@pytest.mark.parametrize("k", [1, 3])
def test_divergence_raises_naming_the_references_epoch(k):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    y = (rng.random(64) > 0.5).astype(np.float32)
    jm = JaxMLP(hidden=(4,))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    with pytest.raises(FloatingPointError, match="diverged") as ref:
        jax_fit_binary(lambda p, xb, rngs: jm.apply(p, xb), params, X, y,
                       JaxSettings(epochs=2, batch_size=32, l2=1e38))
    port = MLP(4, (4,))
    port.load_state_dict(flax_params_to_state_dict("mlp", params))
    with pytest.raises(FloatingPointError, match="diverged") as got:
        fit_binary(port, torch.from_numpy(X), torch.from_numpy(y),
                   TrainSettings(epochs=2, batch_size=32, l2=1e38, epochs_per_dispatch=k))
    assert str(got.value).split(":")[0] == str(ref.value).split(":")[0] == "epoch 0"
    assert "cobalt_smart_lender_ai_tpu_torch.debug.nan_guard" in str(got.value)


def test_divergence_after_good_epochs_keeps_counting():
    """A loss that turns NaN in epoch 3 names epoch 3 for any K."""
    X, y = _data(3, 64, 4)
    for k in (1, 2, 4):
        model = MLP(4, (4,))
        calls = [0]

        def apply_fn(xb, gen, model=model, calls=calls):
            calls[0] += 1
            out = model(xb)
            return out * float("nan") if calls[0] > 6 else out  # 2 steps an epoch

        with pytest.raises(FloatingPointError, match="^epoch 3: training loss is nan"):
            fit_binary(model, torch.from_numpy(X), torch.from_numpy(y),
                       TrainSettings(epochs=6, batch_size=32, epochs_per_dispatch=k), apply_fn=apply_fn)


def test_nan_guard_toggles_anomaly_detection():
    assert not torch.is_anomaly_enabled()
    with nan_guard():
        assert torch.is_anomaly_enabled()
        x = torch.zeros(2, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()  # NaN forward, NaN gradient
    assert not torch.is_anomaly_enabled()
    with nan_guard(False):
        assert not torch.is_anomaly_enabled()


def test_assert_all_finite_passes_and_names_the_bad_leaf():
    assert_all_finite({"a": torch.ones(3), "b": np.zeros(2), "c": [torch.arange(3)]})
    with pytest.raises(FloatingPointError, match=r"loss\['w'\]\[1\]"):
        assert_all_finite({"w": [torch.ones(2), torch.tensor([1.0, float("inf")])]}, name="loss")
    with pytest.raises(FloatingPointError, match="state"):
        assert_all_finite(MLP(3, (2,)).state_dict() | {"x": torch.tensor(float("nan"))}, name="state")
