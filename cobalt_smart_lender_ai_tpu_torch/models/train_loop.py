"""The training loop of the neural challengers (MLP, FT-Transformer, TabNet):
the reference's ``models/train_loop.py`` in PyTorch.

Semantics, as the reference's Keras-shaped loop has them
(`notebooks/04_model_training.ipynb` cells 39-40, AdamW, exponential decay,
early stopping):

- rows are padded to whole batches at weight 0, and ``pos_weight`` is folded
  into the row weights, so the weighted BCE (averaged over weight) ignores
  the padding;
- an explicit L2 term over the dense layers' weights only (the reference's
  flax ``kernel`` leaves: every `torch.nn.Linear` weight, the attention's
  projections included; no bias, embedding, LayerNorm or FT token weight);
- a model may return ``(logits, aux)``: a per-row ``(B,)`` aux (TabNet's
  sparsity term) is weighted like the BCE, a scalar aux is added as is;
- AdamW with decoupled weight decay at ``lr_t = lr0 * rate ** (t / steps)``
  for update ``t`` counted from 0 (optax's ``exponential_decay``, not
  staircase);
- early stopping on validation ROC-AUC (``auc > best + min_delta``), the
  best epoch's parameters restored; validation in fixed chunks of
  ``val_batch_rows`` when set;
- a non-finite epoch loss raises `FloatingPointError`, the epochs before it
  kept in the history.

Each epoch permutes the padded rows with a seeded `torch.Generator` on the
data's device (which also draws the dropout masks). Early-stop bookkeeping
(best parameters, best AUC, patience, the run state) stays on the device:
the host reads the losses, AUCs and state once every ``epochs_per_dispatch``
epochs. An epoch that starts after a stop inside such a group still trains
(nothing on the host knows yet), but changes neither the bookkeeping nor
the history, and the best parameters are what the fit returns; so for any
``epochs_per_dispatch`` the history, the stop epoch and the parameters are
bit for bit those of 1, at the cost of up to ``epochs_per_dispatch - 1``
epochs trained in vain after a stop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
from torch import nn

from cobalt_smart_lender_ai_tpu_torch.ops.metrics import roc_auc
from cobalt_smart_lender_ai_tpu_torch.telemetry import default_registry, log_buckets, span

__all__ = ["TrainSettings", "fit_binary", "l2_penalty", "sigmoid_bce"]

Batch = Any  # a tensor, or a tuple of tensors sharing a leading row axis

#: Host-observed wall time per completed epoch: each group of
#: ``epochs_per_dispatch`` epochs contributes one observation of its average
#: per epoch it ran.
_EPOCH_SECONDS = default_registry().histogram(
    "cobalt_train_epoch_seconds",
    "wall time per completed training epoch (fit_binary host loop)",
    buckets=log_buckets(1e-3, 600.0, per_decade=2),
)

RUNNING, STOPPED_EARLY, DIVERGED = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    batch_size: int = 1024
    epochs: int = 30
    learning_rate: float = 1e-3
    lr_decay_rate: float = 0.9
    lr_decay_steps: int = 1000
    weight_decay: float = 1e-4
    l2: float = 0.0  # explicit L2 loss term (Keras kernel_regularizer analog)
    pos_weight: float = 1.0
    early_stop_patience: int = 5
    early_stop_min_delta: float = 1e-4
    seed: int = 0
    check_finite: bool = True  # raise on a NaN/inf epoch loss
    #: Validation AUC in zero-padded chunks of this many rows instead of one
    #: forward over every row (FT-Transformer's attention holds a (rows,
    #: heads, tokens, tokens) tensor).
    val_batch_rows: int | None = None
    #: Epochs between two host reads of the history and the run state; the
    #: results are bit for bit the same for any value.
    epochs_per_dispatch: int = 1


def _map(fn: Callable[[torch.Tensor], torch.Tensor], X: Batch) -> Batch:
    return tuple(fn(a) for a in X) if isinstance(X, tuple) else fn(X)


def _first(X: Batch) -> torch.Tensor:
    return X[0] if isinstance(X, tuple) else X


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row binary cross-entropy of logits, in optax's form
    ``relu(x) - x z + log1p(exp(-|x|))``."""
    return torch.relu(logits) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def l2_penalty(module: nn.Module) -> torch.Tensor:
    """Sum of squares of every `nn.Linear` weight of ``module``."""
    terms = [m.weight.square().sum() for m in module.modules() if isinstance(m, nn.Linear)]
    if not terms:
        return torch.zeros((), device=next(module.parameters()).device)
    return torch.stack(terms).sum()


def _logits(out: Any) -> torch.Tensor:
    return out[0] if isinstance(out, tuple) else out


def fit_binary(
    module: nn.Module,
    X: Batch,
    y: torch.Tensor,
    settings: TrainSettings,
    *,
    X_val: Batch | None = None,
    y_val: torch.Tensor | None = None,
    sample_weight: torch.Tensor | None = None,
    uses_dropout: bool = False,
    apply_fn: Callable[[Batch, torch.Generator | None], Any] | None = None,
) -> dict[str, list[float]]:
    """Train ``module`` in place on the device of ``X``; returns the history
    ``{"loss": [...], "val_auc": [...]}`` (``val_auc`` empty without a
    validation set). With one, the module ends holding the best epoch's
    parameters.

    ``apply_fn(X_batch, generator)`` returns logits, or ``(logits, aux)``
    with ``aux`` a per-row ``(B,)`` tensor or a scalar; the generator is the
    loop's while training a model that ``uses_dropout`` and None otherwise
    (and always None for validation). It defaults to ``module(X_batch)``."""
    s = settings
    if apply_fn is None:
        apply_fn = lambda xb, generator: module(xb)  # noqa: E731
    first = _first(X)
    dev = first.device
    N = first.shape[0]
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    w = (
        torch.ones(N, dtype=torch.float32, device=dev)
        if sample_weight is None
        else torch.as_tensor(sample_weight, dtype=torch.float32, device=dev)
    )
    w = w * torch.where(y > 0.5, torch.tensor(float(s.pos_weight), device=dev), 1.0)

    bs = min(s.batch_size, N)
    n_batches = -(-N // bs)
    n_padded = n_batches * bs

    def pad_rows(a: torch.Tensor) -> torch.Tensor:
        return torch.cat([a, a.new_zeros((n_padded - N,) + tuple(a.shape[1:]))])

    Xp, yp, wp = _map(pad_rows, X), pad_rows(y), pad_rows(w)  # padded rows weigh 0

    params = [p for p in module.parameters() if p.requires_grad]
    optimizer = torch.optim.AdamW(
        params, lr=s.learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=s.weight_decay
    )
    generator = torch.Generator(device=dev)
    generator.manual_seed(int(s.seed))

    def loss_fn(xb: Batch, yb: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
        out = apply_fn(xb, generator if uses_dropout else None)
        logits, aux = out if isinstance(out, tuple) else (out, None)
        total_w = wb.sum().clamp_min(1e-6)
        loss = (wb * sigmoid_bce(logits, yb)).sum() / total_w
        if s.l2:
            loss = loss + s.l2 * l2_penalty(module)
        if aux is not None:
            aux = torch.as_tensor(aux, dtype=torch.float32, device=dev)
            loss = loss + ((wb * aux).sum() / total_w if aux.dim() == 1 else aux)
        return loss

    step = 0

    def train_epoch() -> torch.Tensor:
        nonlocal step
        module.train()
        perm = torch.randperm(n_padded, generator=generator, device=dev)
        Xs, ys, ws = _map(lambda a: a[perm], Xp), yp[perm], wp[perm]
        losses = []
        for b in range(n_batches):
            sl = slice(b * bs, (b + 1) * bs)
            loss = loss_fn(_map(lambda a: a[sl], Xs), ys[sl], ws[sl])
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            for group in optimizer.param_groups:
                group["lr"] = s.learning_rate * s.lr_decay_rate ** (step / s.lr_decay_steps)
            optimizer.step()
            step += 1
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    has_val = X_val is not None
    if has_val:
        y_val_t = torch.as_tensor(y_val, dtype=torch.float32, device=dev)
        n_val = _first(X_val).shape[0]
        if s.val_batch_rows:
            # Fixed-shape chunks, the padding weighted out of the AUC; capped
            # at the validation size so a small set pays no padded forward.
            vb = min(s.val_batch_rows, n_val)
            n_chunks = -(-n_val // vb)
            vpad = n_chunks * vb - n_val
            Xv = _map(lambda a: torch.cat([a, a.new_zeros((vpad,) + tuple(a.shape[1:]))]), X_val)
            val_w = torch.cat([torch.ones(n_val, device=dev), torch.zeros(vpad, device=dev)])
            y_val_p = torch.cat([y_val_t, torch.zeros(vpad, device=dev)])

            def val_auc() -> torch.Tensor:
                logits = torch.cat([
                    _logits(apply_fn(_map(lambda a: a[i * vb : (i + 1) * vb], Xv), None))
                    for i in range(n_chunks)
                ])
                return roc_auc(y_val_p, logits, weight=val_w)
        else:

            def val_auc() -> torch.Tensor:
                return roc_auc(y_val_t, _logits(apply_fn(X_val, None)))

    K = max(1, min(s.epochs_per_dispatch, s.epochs))
    best = [p.detach().clone() for p in params]
    best_auc = torch.tensor(float("-inf"), device=dev)
    wait = torch.zeros((), dtype=torch.int32, device=dev)
    state = torch.zeros((), dtype=torch.int32, device=dev)
    nan = torch.tensor(float("nan"), device=dev)
    history: dict[str, list[float]] = {"loss": [], "val_auc": []}
    epoch = 0
    while epoch < s.epochs:
        k = min(K, s.epochs - epoch)
        t_step = time.monotonic()
        with span("train.super_step", k=K, batch_size=bs):
            rows = []
            for _ in range(k):
                active = state == RUNNING
                loss = train_epoch()
                diverged = ~torch.isfinite(loss) if s.check_finite else torch.zeros((), dtype=torch.bool, device=dev)
                if has_val:
                    module.eval()
                    with torch.no_grad():
                        auc = val_auc()
                    improved = active & (auc > best_auc + s.early_stop_min_delta)
                    with torch.no_grad():
                        for b, p in zip(best, params):
                            b.copy_(torch.where(improved, p, b))
                    best_auc = torch.where(improved, auc, best_auc)
                    wait = torch.where(active, torch.where(improved, 0, wait + 1), wait).to(torch.int32)
                    early = wait >= s.early_stop_patience
                else:
                    auc = nan
                    early = torch.zeros((), dtype=torch.bool, device=dev)
                new_state = torch.where(diverged, DIVERGED, torch.where(early, STOPPED_EARLY, state))
                state = torch.where(active, new_state, state).to(torch.int32)
                rows.append(torch.stack([loss, auc, active.to(torch.float32)]))
            # One host read per group: its losses, AUCs, which epochs ran,
            # and the state (the read is the sync, so it is inside the span).
            got = torch.stack(rows + [state.to(torch.float32).expand(3)]).cpu()
        epoch += k
        losses, aucs, ran = got[:k, 0], got[:k, 1], got[:k, 2] > 0.5
        host_state = int(got[k, 0])
        n_ran = int(ran.sum())
        if n_ran:
            per_epoch_s = (time.monotonic() - t_step) / n_ran
            for _ in range(n_ran):
                _EPOCH_SECONDS.observe(per_epoch_s)
        if host_state == DIVERGED:
            ran_idx = torch.nonzero(ran).flatten().tolist()
            bad = ran_idx[-1]
            diverged_at = len(history["loss"]) + bad
            # The epochs that completed before the bad one stay in the
            # history; the diverging epoch itself does not.
            history["loss"].extend(losses[ran_idx[:-1]].tolist())
            if has_val:
                history["val_auc"].extend(aucs[ran_idx[:-1]].tolist())
            raise FloatingPointError(
                f"epoch {diverged_at}: training loss is {float(losses[bad])} — diverged "
                "(inspect with cobalt_smart_lender_ai_tpu_torch.debug.nan_guard)"
            )
        history["loss"].extend(losses[ran].tolist())
        if has_val:
            history["val_auc"].extend(aucs[ran].tolist())
        if host_state != RUNNING:
            break
    if has_val:
        with torch.no_grad():
            for p, b in zip(params, best):
                p.copy_(b)
    module.eval()
    return history
