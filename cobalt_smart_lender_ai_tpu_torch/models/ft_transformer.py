"""FT-Transformer on numeric and categorical columns: the reference's
``models/ft_transformer.py`` (its BASELINE configs[3]) in PyTorch.

A per-feature linear tokenizer for the numeric columns, one embedding per
categorical column, a [CLS] token, pre-norm transformer blocks, and a head
on the [CLS] token's final state. The modules follow flax's defaults where
they differ from torch's, so a fit from a seed trains like the
reference's: LayerNorm epsilon 1e-6, the tanh approximation of GELU, dense
weights LeCun-normal, ``num_w`` and ``cls`` normal truncated at two standard
deviations of 0.02, embeddings normal with variance ``1 / d_token``.

Attention is written out (q, k, v projections with bias; ``softmax(q k^T /
sqrt(head_dim))``; dropout on the weights; the output projection) rather
than `torch.nn.functional.scaled_dot_product_attention`: flax draws ONE
attention-dropout mask of shape (tokens, tokens) shared by every row and
head (``broadcast_dropout=True``), which that function cannot do, and its
fused backends would change the numerics the card is held to. Dropout
masks come from the `torch.Generator` the train loop passes; without one
the model is deterministic.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cobalt_smart_lender_ai_tpu_torch.config import FTTransformerConfig
from cobalt_smart_lender_ai_tpu_torch.data.split import split_mask
from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.models.nn import dense, seeded_generator
from cobalt_smart_lender_ai_tpu_torch.models.train_loop import TrainSettings, fit_binary

__all__ = ["FTTransformer", "FTTransformerClassifier", "StandardStats"]

LAYER_NORM_EPS = 1e-6


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None, shape=None) -> torch.Tensor:
    """flax's ``Dropout``: keep with probability ``1 - rate`` and scale by
    its inverse; identity without a generator. ``shape`` (broadcastable to
    ``x``) shares one mask across the axes where it is 1."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.empty(shape or x.shape, device=x.device).bernoulli_(1.0 - rate, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0)


def _trunc_normal(shape: tuple[int, ...], std: float, generator: torch.Generator) -> nn.Parameter:
    t = torch.empty(shape)
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return nn.Parameter(t)


class SelfAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention(h, h)``: ``query``, ``key``,
    ``value`` and ``out`` are its four dense projections."""

    def __init__(self, d: int, n_heads: int, rate: float, generator: torch.Generator):
        super().__init__()
        if d % n_heads:
            raise ValueError(f"d_token {d} is not a multiple of n_heads {n_heads}")
        self.n_heads = n_heads
        self.rate = rate
        self.query = dense(d, d, generator)
        self.key = dense(d, d, generator)
        self.value = dense(d, d, generator)
        self.out = dense(d, d, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        B, L, d = x.shape
        H = self.n_heads
        hd = d // H
        q = self.query(x).view(B, L, H, hd) / math.sqrt(hd)
        k = self.key(x).view(B, L, H, hd)
        v = self.value(x).view(B, L, H, hd)
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        weights = dropout(weights, self.rate, generator, shape=(1, 1, L, L))
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, L, d))


class Block(nn.Module):
    """Pre-norm attention, then a GELU feed-forward, each with a residual."""

    def __init__(self, d: int, n_heads: int, ffn_mult: int, rate: float, generator: torch.Generator):
        super().__init__()
        self.rate = rate
        self.ln1 = nn.LayerNorm(d, eps=LAYER_NORM_EPS)
        self.attn = SelfAttention(d, n_heads, rate, generator)
        self.ln2 = nn.LayerNorm(d, eps=LAYER_NORM_EPS)
        self.ff1 = dense(d, d * ffn_mult, generator)
        self.ff2 = dense(d * ffn_mult, d, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + dropout(self.attn(self.ln1(x), generator), self.rate, generator)
        h = self.ff2(F.gelu(self.ff1(self.ln2(x)), approximate="tanh"))
        return x + dropout(h, self.rate, generator)


class FTTransformer(nn.Module):
    def __init__(
        self,
        n_numeric: int,
        vocab_sizes: Sequence[int],
        d_token: int = 64,
        n_blocks: int = 3,
        n_heads: int = 8,
        ffn_mult: int = 2,
        dropout: float = 0.1,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = generator if generator is not None else seeded_generator(0)
        d = d_token
        self.n_numeric = n_numeric
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        if n_numeric:
            self.num_w = _trunc_normal((n_numeric, d), 0.02, gen)
            self.num_b = nn.Parameter(torch.zeros(n_numeric, d))
        self.cat_emb = nn.ModuleList()
        for vocab in self.vocab_sizes:
            emb = torch.nn.utils.skip_init(nn.Embedding, vocab, d)
            with torch.no_grad():
                emb.weight.normal_(0.0, math.sqrt(1.0 / d), generator=gen)
            self.cat_emb.append(emb)
        self.cls = _trunc_normal((1, 1, d), 0.02, gen)
        self.blocks = nn.ModuleList(
            Block(d, n_heads, ffn_mult, dropout, gen) for _ in range(n_blocks)
        )
        self.ln_f = nn.LayerNorm(d, eps=LAYER_NORM_EPS)
        self.head = dense(d, 1, gen)

    def forward(
        self, x_num: torch.Tensor, x_cat: torch.Tensor, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        B = x_num.shape[0]
        tokens = [self.cls.expand(B, 1, -1)]
        if self.n_numeric:
            tokens.append(x_num[..., None] * self.num_w[None] + self.num_b[None])  # (B, Fn, d)
        for i, emb in enumerate(self.cat_emb):
            tokens.append(emb(x_cat[:, i])[:, None, :])
        x = torch.cat(tokens, dim=1)
        for block in self.blocks:
            x = block(x, generator)
        return self.head(self.ln_f(x[:, 0]))[..., 0]


@dataclasses.dataclass(frozen=True)
class StandardStats:
    """Standardisation with NaN-mean imputation; NaN scales to 0."""

    mean: torch.Tensor
    scale: torch.Tensor

    @staticmethod
    def fit(X: torch.Tensor) -> "StandardStats":
        mean = torch.nanmean(X, dim=0)
        mean = torch.where(torch.isnan(mean), 0.0, mean)
        Xf = torch.where(torch.isnan(X), mean[None, :], X)
        return StandardStats(mean=mean, scale=torch.clamp_min(Xf.std(dim=0, correction=0), 1e-8))

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        Xs = (X - self.mean[None, :]) / self.scale[None, :]
        return torch.where(torch.isnan(Xs), 0.0, Xs)


class FTTransformerClassifier:
    """Facade over ``(x_num, x_cat)`` inputs on ``device`` (``cuda`` unless
    the caller asks for ``cpu``). Categorical columns are integer label
    codes (the nn feature frame's encoding); a code outside its vocabulary
    clamps to the last embedding row."""

    def __init__(
        self,
        vocab_sizes: Sequence[int],
        config: FTTransformerConfig | None = None,
        *,
        device: torch.device | str = "cuda",
    ):
        self.config = config or FTTransformerConfig()
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.device = resolve_device(device)
        self.module: FTTransformer | None = None
        self.scaler: StandardStats | None = None
        self.history: dict | None = None

    def _prep(self, X_num, X_cat) -> tuple[torch.Tensor, torch.Tensor]:
        X_num = torch.as_tensor(X_num, dtype=torch.float32).to(self.device)
        X_cat = torch.as_tensor(X_cat).to(self.device, torch.int64)
        caps = torch.tensor(self.vocab_sizes, dtype=torch.int64, device=self.device)[None, :] - 1
        return X_num, torch.clip(X_cat, torch.zeros_like(caps), caps)

    def fit(self, X_num, X_cat, y, val=None) -> "FTTransformerClassifier":
        cfg = self.config
        X_num, X_cat = self._prep(X_num, X_cat)
        y = torch.as_tensor(y, dtype=torch.float32).to(self.device)
        if val is None:
            va = split_mask(int(X_num.shape[0]), 0.1, cfg.seed, self.device)
            val = ((X_num[va], X_cat[va]), y[va])
            X_num, X_cat, y = X_num[~va], X_cat[~va], y[~va]
        (Xv_num, Xv_cat), y_val = val
        Xv_num, Xv_cat = self._prep(Xv_num, Xv_cat)

        self.scaler = StandardStats.fit(X_num)
        self.module = FTTransformer(
            int(X_num.shape[1]),
            self.vocab_sizes,
            d_token=cfg.d_token,
            n_blocks=cfg.n_blocks,
            n_heads=cfg.n_heads,
            ffn_mult=cfg.ffn_mult,
            dropout=cfg.dropout,
            generator=seeded_generator(cfg.seed),
        ).to(self.device)
        n_pos = float(y.sum())
        pos_weight = (float(y.shape[0]) - n_pos) / max(n_pos, 1.0)
        module = self.module

        def apply_fn(batch, generator):
            xn, xc = batch
            return module(xn, xc, generator)

        settings = TrainSettings(
            batch_size=cfg.batch_size,
            epochs=cfg.epochs,
            learning_rate=cfg.learning_rate,
            weight_decay=cfg.weight_decay,
            pos_weight=pos_weight,
            seed=cfg.seed,
            val_batch_rows=cfg.eval_batch_rows,
            epochs_per_dispatch=cfg.epochs_per_dispatch,
        )
        self.history = fit_binary(
            module,
            (self.scaler(X_num), X_cat),
            y,
            settings,
            X_val=(self.scaler(Xv_num), Xv_cat),
            y_val=y_val,
            uses_dropout=True,
            apply_fn=apply_fn,
        )
        return self

    def predict_logits(self, X_num, X_cat, batch_rows: int | None = None) -> torch.Tensor:
        """Logits in zero-padded chunks of ``batch_rows`` (the config's
        ``eval_batch_rows`` by default): attention holds a (rows, heads,
        tokens, tokens) tensor, so one forward over every row would not fit."""
        if self.module is None or self.scaler is None:
            raise RuntimeError("fit first")
        if batch_rows is None:
            batch_rows = self.config.eval_batch_rows
        X_num, X_cat = self._prep(X_num, X_cat)
        X_num = self.scaler(X_num)
        n = X_num.shape[0]
        with torch.no_grad():
            if n <= batch_rows:
                return self.module(X_num, X_cat)
            pad = (-n) % batch_rows
            X_num = torch.cat([X_num, X_num.new_zeros((pad, X_num.shape[1]))])
            X_cat = torch.cat([X_cat, X_cat.new_zeros((pad, X_cat.shape[1]))])
            out = [
                self.module(X_num[i : i + batch_rows], X_cat[i : i + batch_rows])
                for i in range(0, n + pad, batch_rows)
            ]
        return torch.cat(out)[:n]

    def predict_proba(self, X_num, X_cat) -> torch.Tensor:
        p1 = torch.sigmoid(self.predict_logits(X_num, X_cat))
        return torch.stack([1.0 - p1, p1], dim=1)

    def predict(self, X_num, X_cat, threshold: float = 0.5) -> np.ndarray:
        return (self.predict_proba(X_num, X_cat)[:, 1] >= threshold).cpu().numpy().astype(np.int32)
