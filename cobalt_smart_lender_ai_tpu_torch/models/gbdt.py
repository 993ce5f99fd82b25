"""Histogram gradient-boosted decision trees: the tensorized `Forest`, its
fit and its plain scoring functions.

A `Forest` holds ``T`` complete trees of depth ``d``: internal nodes are
heap-indexed ``0 .. 2^d - 2`` and the ``2^d`` leaves are stored separately
(heap slots ``2^d - 1 ..``). Nodes that do not split carry a trivial split
(threshold ``n_bins - 1``, missing left: every row goes left), so every tree
has the same shape.

The fit (`fit_binned_jobs`) follows the reference's ``models/gbdt.py``
step for step: per tree, a logistic gradient and hessian under one per-row
weight (sample weight x ``scale_pos_weight`` x a Bernoulli row subsample),
a per-tree column sample, then one histogram pass per level
(`ops.histogram.gradient_histogram_jobs`, a CUDA kernel on the card), the
split search with a learned missing direction, routing, and the leaf sums.
Trees at index ``>= n_estimators`` are inert and levels ``>= max_depth``
trivial, as in the reference. It advances J jobs over one shared bins
matrix at once, each with its own sample weight, margin, seed and
hyperparameters: one histogram launch per level for all of them and one
set of torch ops with a leading job axis, the reference's vmapped CV runner
(``parallel/tune.py``'s ``_make_cv_runner``). Each job gets the bits that a
fit of its own gives. `fit_binned_resumable` is its ``J = 1`` case. With
``dp`` the rows are split over a mesh's dp axis and each level's histograms
reduced exactly across the shards (`parallel.sharded.fit_binned_dp`).

Randomness: the row and column samples of tree ``t`` come from a
`torch.Generator` on the fit's device seeded from ``(seed, t)``, so a
chunked fit draws what an unchunked one does. These are not the reference's
threefry streams, and the card's generator draws other numbers than the
CPU's: with sampling on, the port's forests differ from the reference's (and
the card's from the CPU's) tree by tree and agree in held-out AUC; with
``subsample = colsample_bytree = 1`` they agree split for split. A fit that
is one of many (an RFE refit, a CV job) takes its seed from `fold_in`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig
from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.ops.binning import (
    BinSpec,
    compute_bin_edges,
    float_threshold,
    transform,
)
from cobalt_smart_lender_ai_tpu_torch.ops.histogram import (
    gradient_histogram_channels,
    gradient_histogram_jobs,
    gradient_histogram_sharded,
)
from cobalt_smart_lender_ai_tpu_torch.parallel.budget import resolve_chunk_trees
from cobalt_smart_lender_ai_tpu_torch.parallel.mesh import RowShards


@dataclasses.dataclass(frozen=True)
class Forest:
    """Tensorized forest. ``cover`` is the training-row count reaching each
    heap slot (internal nodes, then leaves) — TreeSHAP's path weights."""

    feature: torch.Tensor  # (T, I) int32
    thr_bin: torch.Tensor  # (T, I) int32; trivial splits are n_bins - 1
    thr_float: torch.Tensor  # (T, I) float32; trivial splits are +inf
    missing_left: torch.Tensor  # (T, I) bool
    gain: torch.Tensor  # (T, I) float32; 0 for trivial (non-)splits
    cover: torch.Tensor  # (T, I + L) float32
    leaf_value: torch.Tensor  # (T, L) float32, already scaled by learning rate
    depth: int

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def device(self) -> torch.device:
        return self.feature.device

    def to(self, device: torch.device | str) -> "Forest":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if f.name != "depth"
            },
        )


@dataclasses.dataclass(frozen=True)
class GBDTHyperparams:
    """The fit's hyperparameters as plain Python scalars."""

    learning_rate: float
    gamma: float
    reg_lambda: float
    min_child_weight: float
    scale_pos_weight: float
    subsample: float
    colsample_bytree: float
    n_estimators: int
    max_depth: int

    @staticmethod
    def from_config(cfg: GBDTConfig) -> "GBDTHyperparams":
        return GBDTHyperparams(
            learning_rate=float(cfg.learning_rate),
            gamma=float(cfg.gamma),
            reg_lambda=float(cfg.reg_lambda),
            min_child_weight=float(cfg.min_child_weight),
            scale_pos_weight=float(cfg.scale_pos_weight),
            subsample=float(cfg.subsample),
            colsample_bytree=float(cfg.colsample_bytree),
            n_estimators=int(cfg.n_estimators),
            max_depth=int(cfg.max_depth),
        )


def _split_gain(GL, HL, GR, HR, Gt, Ht, reg_lambda, gamma):
    """XGBoost structure-score gain."""
    return 0.5 * (
        GL * GL / (HL + reg_lambda)
        + GR * GR / (HR + reg_lambda)
        - Gt * Gt / (Ht + reg_lambda)
    ) - gamma


#: Block length of the reference's cumulative sum on the CPU (its compiler
#: rewrites a cumulative reduce-window into blocks of 16).
_SCAN_BLOCK = 16


def _sequential_prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, one float32 add at a time."""
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
        out[..., i] = acc
    return out


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, in the reference's order of
    float32 adds on the CPU: sequential within blocks of 16, the block totals
    summed the same way, and each block's carry added to its prefix. The
    split search compares gains of adjacent thresholds, so another order
    (``torch.cumsum`` accumulates in float64 on the CPU and in parallel on
    the card) would break near-ties differently from the reference."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential_prefix(x)
    nb = -(-n // _SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    within = _sequential_prefix(xp.reshape(*x.shape[:-1], nb, _SCAN_BLOCK))
    carry = prefix_sum(within[..., -1])[..., :-1]
    out = torch.cat([within[..., :1, :], within[..., 1:, :] + carry[..., None]], dim=-2)
    return out.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n]


def _tree_generator(
    seed: int, tree_idx: int, device: torch.device, shard: int | None = None
) -> torch.Generator:
    """The random stream of global tree ``tree_idx``; a dp shard's row
    stream folds its dp index ``shard`` into the seed."""
    if shard is not None:
        seed = fold_in(seed, shard)
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(tree_idx) & 0xFFFFFFFF))
    return gen


def _column_draw(seed: int, tree_idx: int, n_rows: int, n_features: int, device) -> torch.Tensor:
    """Tree ``tree_idx``'s column-sample draws as a fit over ``n_rows`` rows
    on one device takes them: after that fit's row draws, from the same
    stream. A dp fit draws them so, once, on its lead device."""
    gen = _tree_generator(seed, tree_idx, device)
    torch.rand(n_rows, generator=gen, device=device)
    return torch.rand(n_features, generator=gen, device=device)


def fold_in(seed: int, data: int) -> int:
    """A 32-bit seed derived from ``(seed, data)``, for one fit of many (an
    RFE refit, a CV job): the stand-in for the reference's
    ``jax.random.fold_in``, so that each fit's stream depends only on its
    key and not on which fits ran before it."""
    words = [int(seed) & 0xFFFFFFFF, int(data) & 0xFFFFFFFF]
    return int(np.random.SeedSequence(words).generate_state(1)[0])


HistogramFn = Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _f32(x: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _per_job(values, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """One value per job as a ``(J,)`` tensor."""
    return torch.tensor(values, dtype=dtype, device=device)


def fit_binned_jobs(
    bins: torch.Tensor,  # (N, F) uint8/int32, shared by the jobs
    y: torch.Tensor,  # (N,) {0,1}
    sample_weight: torch.Tensor,  # (J, N) float32
    feature_mask: torch.Tensor,  # (F,) bool
    hps: Sequence[GBDTHyperparams],
    seeds: Sequence[int],
    *,
    n_trees_cap: int,
    depth_cap: int,
    n_bins: int,
    init_margin: torch.Tensor | None = None,  # (J, N)
    tree_offset: int = 0,
    hist_subtract: bool = True,
    histogram: HistogramFn = gradient_histogram_jobs,
    dp: RowShards | None = None,
) -> tuple[list[Forest], torch.Tensor]:
    """Train ``n_trees_cap`` boosting rounds of J jobs at once from
    ``init_margin``; returns (the J forest chunks, with zero float
    thresholds, and the ``(J, N)`` final margins).

    Job ``j`` fits ``hps[j]`` with ``sample_weight[j]`` from
    ``init_margin[j]`` on its own random streams (``seeds[j]``); bins, labels
    and the feature mask are shared. Each level is one ``histogram`` call
    for all jobs (``(J, N)`` inputs, three ``(J, K, F, B)`` outputs: the
    kernel's wrapper, which runs its plain version on CPU tensors) and one
    set of torch ops with a leading job axis; a job's ``max_depth`` and
    ``n_estimators`` mask its levels and trees under ``depth_cap`` and the
    tree index. Tree indices are offset by ``tree_offset`` for the random
    streams and the ``n_estimators`` mask. ``hist_subtract`` builds left
    children only and takes right = parent - left.

    Job ``j``'s forest and margin are, bit for bit, those of
    `fit_binned_resumable` on its own inputs with the same ``n_trees_cap``
    and ``depth_cap``: the batched ops are exact (integer, comparison and
    single IEEE operations, elementwise) or sum integers (covers); the
    sigmoid and the leaf sums, whose float results could depend on the
    shape they run at, run per job at one job's shapes.

    ``dp`` (`parallel.mesh.RowShards`, the dp axis of a mesh; the
    reference's ``axis_name``) splits the rows into shards: the inputs are
    all ``N`` rows on the lead shard's device, each local shard works on its
    rows on its own device and stream, each level's histograms are
    `gradient_histogram_sharded` over the shards (on the card, the bits of
    one launch over all rows) and the leaf sums are each shard's one-hot
    product added in float32 across shards (not the single device's bits,
    as the reference's psum'd float32 sums are not). The split search runs
    once, on the lead device. A shard's row subsample comes from its own
    stream (the seed folded with its dp index, as the reference folds
    ``axis_index`` into its row key); the column sample is the one a fit on
    one device draws. The margins that come back hold this process's
    shards' rows (every row with one process; the rows of other processes
    stay at ``init_margin``)."""
    dev = bins.device
    N, F = bins.shape
    J = len(hps)
    if len(seeds) != J or sample_weight.shape != (J, N):
        raise ValueError(f"{J} jobs need {J} seeds and a ({J}, {N}) sample_weight")
    if dp is not None:
        if histogram is not gradient_histogram_jobs:
            raise ValueError("a dp fit takes its histograms from the sharded kernel entry")
        if dp.lead != dev or dp.n_rows != N:
            raise ValueError(f"dp shards {dp.n_rows} rows led by {dp.lead}; bins are {N} on {dev}")
    n_internal = 2**depth_cap - 1
    n_leaves = 2**depth_cap
    T = n_trees_cap
    bins = bins.contiguous()
    y = y.to(device=dev, dtype=torch.float32)
    # Per-job hyperparameters, shaped to broadcast over (J, K, F, B); the
    # leaf step reads job j's lambda and learning rate as views.
    lam = _per_job([hp.reg_lambda for hp in hps], dev).view(J, 1, 1, 1)
    lr = _per_job([hp.learning_rate for hp in hps], dev)
    gamma = _per_job([hp.gamma for hp in hps], dev).view(J, 1, 1, 1)
    mcw = _per_job([hp.min_child_weight for hp in hps], dev).view(J, 1, 1, 1)
    spw = _per_job([hp.scale_pos_weight for hp in hps], dev).view(J, 1)
    max_depth = _per_job([hp.max_depth for hp in hps], dev, torch.int64).view(J, 1)
    base_w = sample_weight.to(device=dev, dtype=torch.float32) * torch.where(
        y > 0.5, spw, _f32(1.0, dev)
    )
    feature_mask = feature_mask.to(device=dev, dtype=torch.bool)
    n_avail = feature_mask.sum().to(torch.float32)
    n_keep = torch.clamp(
        torch.round(_per_job([hp.colsample_bytree for hp in hps], dev) * n_avail), min=1
    ).to(torch.int64)[:, None]
    # Which jobs may split at each level, made once a call, not a level.
    level_on = [level < max_depth for level in range(depth_cap)]

    feats_all = torch.zeros((J, T, n_internal), dtype=torch.int32, device=dev)
    thrs_all = torch.full((J, T, n_internal), n_bins - 1, dtype=torch.int32, device=dev)
    mls_all = torch.ones((J, T, n_internal), dtype=torch.bool, device=dev)
    gains_all = torch.zeros((J, T, n_internal), dtype=torch.float32, device=dev)
    covers_all = torch.zeros((J, T, n_internal + n_leaves), dtype=torch.float32, device=dev)
    leaves_all = torch.zeros((J, T, n_leaves), dtype=torch.float32, device=dev)
    margin = (
        torch.zeros((J, N), dtype=torch.float32, device=dev)
        if init_margin is None
        else init_margin.to(device=dev, dtype=torch.float32).clone()
    )

    # The row shards: views of the inputs (copies on another device). One
    # shard, without dp, is every row on the caller's stream.
    if dp is None:
        run = lambda fn: [fn(0)]  # noqa: E731
        devs, sbins, sy, sbase, smargin = [dev], [bins], [y], [base_w], [margin]
    else:
        run, devs = dp.run, dp.devices
        sbins, sy = dp.split(bins), dp.split(y)
        sbase, smargin = dp.split(base_w, dim=1), dp.split(margin, dim=1)
    srows = [torch.arange(b.shape[0], device=d)[None, :] for b, d in zip(sbins, devs)]

    def level_histogram(parts, n_nodes):
        if dp is None:
            return histogram(*parts[0], n_nodes=n_nodes, n_bins=n_bins)
        return gradient_histogram_sharded(
            parts, n_nodes=n_nodes, n_bins=n_bins, n_rows=N, run=dp.run, group=dp.group
        )

    for t in range(T):
        tree_idx = t + int(tree_offset)
        if dp is None:
            sub, u = [], []
            for hp, seed in zip(hps, seeds):
                gen = _tree_generator(seed, tree_idx, dev)
                sub.append(torch.rand(N, generator=gen, device=dev) < hp.subsample)
                u.append(torch.rand(F, generator=gen, device=dev))
            ssub = [torch.stack(sub)]
        else:
            u = [_column_draw(seed, tree_idx, N, F, dev) for seed in seeds]

            def row_sample(s):
                n_s, d = sbins[s].shape[0], devs[s]
                return torch.stack([
                    torch.rand(n_s, generator=_tree_generator(seed, tree_idx, d, dp.index[s]),
                               device=d) < hp.subsample
                    for hp, seed in zip(hps, seeds)
                ])

            ssub = run(row_sample)

        def gradients(s):
            w = sbase[s] * ssub[s].to(torch.float32)
            w_pos = (w > 0).to(torch.float32)
            # Per job: a transcendental's vectorized and scalar paths may
            # round differently, and which rows take which depends on the
            # shape.
            p = torch.stack([torch.sigmoid(m) for m in smargin[s]])
            g = (w * (p - sy[s])).contiguous()
            h = (w * torch.clamp(p * (1.0 - p), min=1e-16)).contiguous()
            return g, h, w_pos

        sg = run(gradients)

        u = torch.where(feature_mask, torch.stack(u), float("inf"))
        ranks = torch.argsort(torch.argsort(u, dim=1, stable=True), dim=1, stable=True)
        cmask = (ranks < n_keep) & feature_mask  # (J, F)

        snode = run(lambda s: torch.zeros((J, sbins[s].shape[0]), dtype=torch.int32, device=devs[s]))
        feats, thrs, mls = feats_all[:, t], thrs_all[:, t], mls_all[:, t]
        gains, covers = gains_all[:, t], covers_all[:, t]
        prev = None
        for level in range(depth_cap):
            K = 2**level
            off = K - 1
            slocal = run(lambda s: snode[s] - off)
            if level == 0 or not hist_subtract:
                hg, hh, hw = level_histogram(
                    [(sbins[s], slocal[s], *sg[s]) for s in range(len(devs))], K
                )
            else:
                def left_inputs(s):
                    g, h, w_pos = sg[s]
                    left_m = (slocal[s] % 2 == 0).to(torch.float32)
                    return sbins[s], slocal[s] // 2, g * left_m, h * left_m, w_pos * left_m

                left = level_histogram(run(left_inputs), K // 2)
                # A right-child bin that holds none of the node's training
                # rows (an exact zero count: covers are integers) gets
                # exact zero sums, not the last-bit residue of parent -
                # left. Thresholds across such bins then tie exactly and
                # the first wins, on the card as on the CPU; the rows of
                # weight 0 (a CV job's fold) that fall there go the same way
                # on both.
                right_w = prev[2] - left[2]
                empty = right_w == 0
                right = (
                    torch.where(empty, 0.0, prev[0] - left[0]),
                    torch.where(empty, 0.0, prev[1] - left[1]),
                    right_w,
                )
                hg, hh, hw = (
                    torch.stack([lc, rc], dim=2).reshape(J, K, F, n_bins)
                    for lc, rc in zip(left, right)
                )
            prev = (hg, hh, hw)
            covers[:, off : off + K] = hw[:, :, 0, :].sum(-1)
            miss_g, miss_h = hg[..., 0], hh[..., 0]
            cum_g, cum_h = prefix_sum(torch.stack([hg[..., 1:], hh[..., 1:]]))
            Gt = (cum_g[..., -1] + miss_g)[..., None]
            Ht = (cum_h[..., -1] + miss_h)[..., None]
            GL, HL = cum_g[..., :-1], cum_h[..., :-1]
            Gm, Hm = miss_g[..., None], miss_h[..., None]

            def masked_gain(GLv, HLv):
                GRv, HRv = Gt - GLv, Ht - HLv
                ok = (HLv >= mcw) & (HRv >= mcw) & cmask[:, None, :, None]
                gv = _split_gain(GLv, HLv, GRv, HRv, Gt, Ht, lam, gamma)
                return torch.where(ok, gv, float("-inf"))

            gain_ml = masked_gain(GL + Gm, HL + Hm)  # missing goes left
            gain_mr = masked_gain(GL, HL)  # missing goes right
            go_ml = (gain_ml >= gain_mr).reshape(J, K, -1)
            flat = torch.maximum(gain_ml, gain_mr).reshape(J, K, -1)
            best = torch.argmax(flat, dim=2)  # first index on ties
            best_gain = flat.gather(2, best[..., None])[..., 0]
            bf = (best // (n_bins - 2)).to(torch.int32)
            bt = (best % (n_bins - 2)).to(torch.int32) + 1
            bml = go_ml.gather(2, best[..., None])[..., 0]

            do_split = (best_gain > 0.0) & level_on[level]
            feat_lvl = torch.where(do_split, bf, 0)
            thr_lvl = torch.where(do_split, bt, n_bins - 1)
            ml_lvl = torch.where(do_split, bml, True)
            feats[:, off : off + K] = feat_lvl
            thrs[:, off : off + K] = thr_lvl
            mls[:, off : off + K] = ml_lvl
            gains[:, off : off + K] = torch.where(do_split, best_gain, 0.0)

            def route(s):
                d, lidx = devs[s], slocal[s].long()
                b_row = sbins[s][srows[s], feat_lvl.to(d).long().gather(1, lidx)].long()
                go_left = torch.where(
                    b_row == 0, ml_lvl.to(d).gather(1, lidx), b_row <= thr_lvl.to(d).gather(1, lidx)
                )
                return 2 * snode[s] + 1 + (~go_left).to(torch.int32)

            snode = run(route)

        # Per job: the leaf sums at one job's shapes, the (N, L) one-hot of
        # that job only (3.77 GB at depth 9 and 1.84M rows).
        for j, hp in enumerate(hps):
            def leaf_sums(s):
                g, h, w_pos = sg[s]
                leaf_local = (snode[s][j] - (2**depth_cap - 1)).long()
                # Leaf (g, h, cover) sums as a one-hot product, as the
                # reference takes them: a matrix product adds in a fixed
                # order on the card, where index_add_'s float atomics would
                # make two fits differ.
                oh_leaf = torch.zeros((leaf_local.shape[0], n_leaves), dtype=torch.float32,
                                      device=devs[s])
                oh_leaf.scatter_(1, leaf_local[:, None], 1.0)
                return leaf_local, (oh_leaf.T @ torch.stack([g[j], h[j], w_pos[j]], dim=1)).T

            leaf = run(leaf_sums)
            sums = leaf[0][1] if dp is None else dp.sum([x[1] for x in leaf])
            covers[j, n_internal:] = sums[2]
            tree_on = 1.0 if tree_idx < hp.n_estimators else 0.0
            leaf_val = -sums[0] / (sums[1] + lam[j, 0, 0, 0]) * lr[j]
            leaf_val = torch.where(sums[1] > 0, leaf_val, 0.0) * tree_on
            gains[j].mul_(tree_on)  # inert trees must not pollute gain importances
            leaves_all[j, t] = leaf_val

            def add_leaves(s):
                smargin[s][j] = smargin[s][j] + leaf_val.to(devs[s])[leaf[s][0]]

            run(add_leaves)

    if dp is not None:
        for (a, b), d, m in zip(dp.bounds, devs, smargin):
            if d != dev:
                margin[:, a:b] = m.to(dev)
    thr_float = torch.zeros((T, n_internal), dtype=torch.float32, device=dev)
    forests = [
        Forest(
            feature=feats_all[j],
            thr_bin=thrs_all[j],
            thr_float=thr_float.clone(),
            missing_left=mls_all[j],
            gain=gains_all[j],
            cover=covers_all[j],
            leaf_value=leaves_all[j],
            depth=depth_cap,
        )
        for j in range(J)
    ]
    return forests, margin


def fit_binned_resumable(
    bins: torch.Tensor,  # (N, F) uint8/int32
    y: torch.Tensor,  # (N,) {0,1}
    sample_weight: torch.Tensor,  # (N,) float32
    feature_mask: torch.Tensor,  # (F,) bool
    hp: GBDTHyperparams,
    seed: int,
    *,
    n_trees_cap: int,
    depth_cap: int,
    n_bins: int,
    init_margin: torch.Tensor | None = None,
    tree_offset: int = 0,
    hist_subtract: bool = True,
    histogram: HistogramFn = gradient_histogram_channels,
    dp: RowShards | None = None,
) -> tuple[Forest, torch.Tensor]:
    """Train ``n_trees_cap`` boosting rounds from ``init_margin``; returns
    (forest chunk with zero float thresholds, final margin): one fit,
    `fit_binned_jobs` at ``J = 1``. Tree indices are offset by
    ``tree_offset`` for the random streams and the ``n_estimators`` mask.
    ``hist_subtract`` builds left children only and takes right = parent -
    left. ``histogram`` is the level's histogram op on ``(N,)`` inputs: the
    kernel's wrapper, which runs its plain version on CPU tensors (a caller
    comparing the two on the card passes the plain version). ``dp`` splits
    the rows over a mesh's dp axis (`fit_binned_jobs`)."""

    def one_job(b, node, g, h, w, **kw):
        return tuple(x[None] for x in histogram(b, node[0], g[0], h[0], w[0], **kw))

    # The kernel's wrapper takes the (1, N) rows as they are: its J = 1
    # case, without a round trip through (N,) views each level.
    level_hist = gradient_histogram_jobs if histogram is gradient_histogram_channels else one_job

    forests, margin = fit_binned_jobs(
        bins, y, sample_weight.to(device=bins.device, dtype=torch.float32)[None],
        feature_mask, [hp], [seed], n_trees_cap=n_trees_cap, depth_cap=depth_cap,
        n_bins=n_bins, init_margin=None if init_margin is None else init_margin[None],
        tree_offset=tree_offset, hist_subtract=hist_subtract, histogram=level_hist, dp=dp,
    )
    return forests[0], margin[0]


def fit_binned(
    bins: torch.Tensor,
    y: torch.Tensor,
    sample_weight: torch.Tensor,
    feature_mask: torch.Tensor,
    hp: GBDTHyperparams,
    seed: int,
    *,
    n_trees_cap: int,
    depth_cap: int,
    n_bins: int,
    hist_subtract: bool = True,
) -> Forest:
    """One-chunk fit (see `fit_binned_resumable` for the semantics)."""
    forest, _ = fit_binned_resumable(
        bins, y, sample_weight, feature_mask, hp, seed,
        n_trees_cap=n_trees_cap, depth_cap=depth_cap, n_bins=n_bins,
        hist_subtract=hist_subtract,
    )
    return forest


def fit_binned_chunked(
    bins: torch.Tensor,
    y: torch.Tensor,
    sample_weight: torch.Tensor,
    feature_mask: torch.Tensor,
    hp: GBDTHyperparams,
    seed: int,
    *,
    n_trees_cap: int,
    depth_cap: int,
    n_bins: int,
    chunk_trees: int,
    hist_subtract: bool = True,
) -> Forest:
    """Fit in chunks of ``chunk_trees`` rounds, carrying the margin between
    chunks; bit-identical to `fit_binned` (same per-tree random streams via
    the global tree index). The last chunk is ragged: PyTorch runs eagerly,
    so a shorter chunk costs no recompilation."""
    if chunk_trees <= 0:
        raise ValueError(f"chunk_trees must be positive, got {chunk_trees}")
    margin = torch.zeros(bins.shape[0], dtype=torch.float32, device=bins.device)
    chunks = []
    for off in range(0, n_trees_cap, chunk_trees):
        forest_c, margin = fit_binned_resumable(
            bins, y, sample_weight, feature_mask, hp, seed,
            n_trees_cap=min(chunk_trees, n_trees_cap - off), depth_cap=depth_cap,
            n_bins=n_bins, init_margin=margin, tree_offset=off,
            hist_subtract=hist_subtract,
        )
        chunks.append(forest_c)
    return concat_forest_chunks(chunks, n_trees_cap, depth_cap)


def concat_forest_chunks(chunks: list[Forest], n_trees_cap: int, depth_cap: int) -> Forest:
    """Concatenate per-chunk forests along the tree axis, trimmed to
    ``n_trees_cap`` trees."""
    return Forest(
        **{
            f.name: torch.cat([getattr(c, f.name) for c in chunks])[:n_trees_cap]
            for f in dataclasses.fields(Forest)
            if f.name != "depth"
        },
        depth=depth_cap,
    )


def attach_float_thresholds(forest: Forest, spec: BinSpec) -> Forest:
    """Resolve bin thresholds into raw-feature thresholds so serving scores
    unbinned rows. Trivial splits resolve to +inf (all-left)."""
    return dataclasses.replace(
        forest, thr_float=float_threshold(spec, forest.feature, forest.thr_bin)
    )


def landed_leaves(
    feature: torch.Tensor,
    thr: torch.Tensor,
    missing_left: torch.Tensor,
    depth: int,
    X: torch.Tensor,
    *,
    binned: bool = False,
) -> torch.Tensor:
    """(N, T) index of the leaf each row lands in, per tree: ``depth`` levels
    of ``x <= thr``. Raw float rows: NaN follows the learned missing
    direction. Binned rows (``binned=True``, thresholds in bins): bin 0 does."""
    N, T = X.shape[0], feature.shape[0]
    trees = torch.arange(T, device=X.device)
    feat = feature.long()
    Xg = X.long() if binned else X
    node = torch.zeros((N, T), dtype=torch.long, device=X.device)
    for _ in range(depth):
        x = torch.gather(Xg, 1, feat[trees, node])
        missing = x == 0 if binned else torch.isnan(x)
        go_left = torch.where(missing, missing_left[trees, node], x <= thr[trees, node])
        node = 2 * node + 2 - go_left.long()
    return node - (2**depth - 1)


def sum_trees_in_order(values: torch.Tensor) -> torch.Tensor:
    """Sum (N, T) per-tree values over trees one f32 add at a time, tree 0
    first, starting at 0.0 — the reference's ``lax.scan`` order, so margins
    agree bit for bit."""
    margin = torch.zeros(values.shape[0], dtype=torch.float32, device=values.device)
    for t in range(values.shape[1]):
        margin = margin + values[:, t]
    return margin


def predict_margin(forest: Forest, X: torch.Tensor, use_binned: bool = False) -> torch.Tensor:
    """Sum-of-trees margin (log-odds) of ``X`` (N, F): raw float rows by
    default (float thresholds), or bin indices with ``use_binned=True``."""
    thr = forest.thr_bin if use_binned else forest.thr_float
    leaves = landed_leaves(
        forest.feature, thr, forest.missing_left, forest.depth, X, binned=use_binned
    )
    trees = torch.arange(forest.n_trees, device=X.device)
    return sum_trees_in_order(forest.leaf_value[trees, leaves])


def gain_importances(
    forest: Forest, n_features: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(total_gain, n_splits) per feature over the real splits — backs the
    booster "gain" scores that ``/feature_importance_bulk`` serves."""
    real = forest.gain > 0.0
    idx = forest.feature.reshape(-1).long()
    zeros = torch.zeros(n_features, dtype=torch.float32, device=forest.device)
    total_gain = zeros.index_add(
        0, idx, torch.where(real, forest.gain, 0.0).reshape(-1)
    )
    n_splits = zeros.index_add(0, idx, real.reshape(-1).float())
    return total_gain, n_splits


class GBDTClassifier:
    """sklearn/xgboost-shaped facade: the drop-in for ``XGBClassifier`` in
    the reference's training script. Runs on ``device`` (``cuda`` unless the
    caller asks for ``cpu``; ``cuda`` without a card raises here)."""

    def __init__(
        self,
        config: GBDTConfig | None = None,
        *,
        device: torch.device | str = "cuda",
        **overrides,
    ):
        cfg = config or GBDTConfig()
        if overrides:
            cfg = cfg.replace(**overrides)
        self.config = cfg
        self.device = resolve_device(device)
        self.forest: Forest | None = None
        self.bin_spec: BinSpec | None = None
        self.n_features_: int | None = None

    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device, dtype=dtype)

    def fit(self, X, y, sample_weight=None, feature_mask=None) -> "GBDTClassifier":
        X = self._tensor(X, torch.float32)
        y = self._tensor(y, torch.float32)
        N, F = X.shape
        self.n_features_ = F
        cfg = self.config
        self.bin_spec = compute_bin_edges(X, n_bins=cfg.n_bins)
        bins = transform(self.bin_spec, X)
        sw = (
            torch.ones(N, dtype=torch.float32, device=self.device)
            if sample_weight is None
            else self._tensor(sample_weight, torch.float32)
        )
        fm = (
            torch.ones(F, dtype=torch.bool, device=self.device)
            if feature_mask is None
            else self._tensor(feature_mask, torch.bool)
        )
        hp = GBDTHyperparams.from_config(cfg)
        kw = dict(
            n_trees_cap=cfg.n_estimators,
            depth_cap=cfg.max_depth,
            n_bins=cfg.n_bins,
            hist_subtract=cfg.hist_subtract,
        )
        chunk = resolve_chunk_trees(
            cfg.chunk_trees, n_trees=cfg.n_estimators, n_rows=N, n_feats=F,
            n_bins=cfg.n_bins, depth=cfg.max_depth, hist_subtract=cfg.hist_subtract,
        )
        if chunk is not None:
            forest = fit_binned_chunked(bins, y, sw, fm, hp, cfg.seed, chunk_trees=chunk, **kw)
        else:
            forest = fit_binned(bins, y, sw, fm, hp, cfg.seed, **kw)
        self.forest = attach_float_thresholds(forest, self.bin_spec)
        return self

    def _fitted(self) -> Forest:
        if self.forest is None:
            raise RuntimeError("GBDTClassifier is not fitted yet; call fit first")
        return self.forest

    def predict_margin(self, X) -> torch.Tensor:
        return predict_margin(self._fitted(), self._tensor(X, torch.float32))

    def predict_proba(self, X) -> torch.Tensor:
        """(N, 2) probabilities, matching ``XGBClassifier.predict_proba``."""
        p1 = torch.sigmoid(self.predict_margin(X))
        return torch.stack([1.0 - p1, p1], dim=1)

    def predict(self, X, threshold: float = 0.5) -> torch.Tensor:
        return (self.predict_proba(X)[:, 1] >= threshold).to(torch.int32)

    @property
    def feature_importances_(self) -> np.ndarray:
        """Normalized total-gain importances."""
        forest = self._fitted()
        total_gain, _ = gain_importances(forest, self.n_features_)
        tg = total_gain.cpu().numpy()
        s = tg.sum()
        return tg / s if s > 0 else tg
