"""Exact path-dependent TreeSHAP over the tensorized forest, in plain PyTorch.

Every leaf of a depth-``d`` complete tree has a static ancestor path, so the
Shapley sum over feature coalitions factorizes per leaf into a product
polynomial. For a leaf with path factors ``f_j(t) = r_j + z_j t`` (``z_j`` the
row's walk-indicator product over the positions of player ``j``, ``r_j`` the
training cover-ratio product), feature ``j``'s attribution from that leaf is::

    leaf_value * (z_j - r_j) * sum_{a,b} Wt[a, b] * P_a^{(j)} * S_b^{(j)}

where ``P^{(j)}``/``S^{(j)}`` are the coefficients of the prefix/suffix
products ``prod_{j' < j} f_{j'}`` and ``prod_{j' > j} f_{j'}``, and
``Wt[a, b] = W[a + b, d]`` is the Shapley kernel as a bilinear form.
Duplicate features on a path share the earliest position's slot; players
that own no position get ``z = r = 1`` and contribute exactly zero.

The same algebra runs in the reference package's ``explain/treeshap.py`` and
in the CUDA kernel ``csrc/score_forest.cu``; `leaf_tables` computes the
row-independent per-leaf tables both this module and the kernel consume.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from cobalt_smart_lender_ai_tpu_torch.models.gbdt import Forest

#: Upper bound on the elements of one tree chunk's (N, Tc, L, d, d) member
#: broadcast in `shap_phis` — keeps the plain version's memory bounded.
_CHUNK_ELEMENTS = 1 << 22


def path_structure(depth: int) -> tuple[np.ndarray, np.ndarray]:
    """Static ancestor structure of a depth-d complete tree: ``paths`` (L, d)
    heap indices of each leaf's internal-node ancestors root-first, and
    ``dirs`` (L, d) True where the path takes the left child."""
    L = 2**depth
    paths = np.zeros((L, depth), dtype=np.int32)
    dirs = np.zeros((L, depth), dtype=bool)
    for leaf in range(L):
        node = 0
        for level in range(depth):
            paths[leaf, level] = node
            go_left = not (leaf >> (depth - 1 - level)) & 1
            dirs[leaf, level] = go_left
            node = 2 * node + 1 + (0 if go_left else 1)
    return paths, dirs


def child_heap(depth: int) -> np.ndarray:
    """(L, d) heap slot of the child each path step moves to (the last step
    lands on the leaf's own slot ``2^d - 1 + leaf``)."""
    paths, _ = path_structure(depth)
    L = 2**depth
    return np.concatenate(
        [paths[:, 1:], (np.arange(L, dtype=np.int32) + L - 1)[:, None]], axis=1
    )


def shapley_kernel(depth: int) -> np.ndarray:
    """W[k, M] = k! (M-k-1)! / M! — weight of a size-k coalition among M
    players. Invalid entries (k >= M) are 0."""
    W = np.zeros((depth + 1, depth + 1), dtype=np.float64)
    for M in range(1, depth + 1):
        for k in range(M):
            W[k, M] = math.factorial(k) * math.factorial(M - k - 1) / math.factorial(M)
    return W


def bilinear_kernel(depth: int) -> np.ndarray:
    """Wt[a, b] = W[a+b, depth] (0 where a+b >= depth): contracts prefix x
    suffix coefficients directly against the Shapley kernel."""
    W = shapley_kernel(depth)
    Wt = np.zeros((depth + 1, depth + 1), dtype=np.float64)
    for a in range(depth + 1):
        for b in range(depth + 1):
            if a + b < depth:
                Wt[a, b] = W[a + b, depth]
    return Wt


def leaf_tables(
    feature: torch.Tensor, cover: torch.Tensor, depth: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-independent per-leaf tables of every tree, each (T, L, d):

    - ``path_feature``: the feature tested at each path position (int32);
    - ``slot``: the player each position belongs to — the earliest position
      on the path testing the same feature (uint8);
    - ``r_play``: each player's cover-ratio product (float32);
    - ``ratio``: each position's child/parent cover ratio (float32).
    """
    device = feature.device
    paths = torch.from_numpy(path_structure(depth)[0]).long().to(device)
    child = torch.from_numpy(child_heap(depth)).long().to(device)
    pf = feature[:, paths]
    parent = cover[:, paths]
    ratio = torch.where(
        parent > 0, cover[:, child] / torch.clamp(parent, min=1e-30), 0.0
    )
    same = pf[..., :, None] == pf[..., None, :]  # (T, L, d, d)
    lower = torch.tril(torch.ones((depth, depth), dtype=torch.bool, device=device))
    # argmax returns the first maximal index: the earliest same-feature slot.
    slot = torch.argmax((same & lower).to(torch.uint8), dim=-1)
    member = slot[..., None] == torch.arange(depth, device=device)
    r_play = torch.where(member, ratio[..., None], 1.0).prod(dim=-2)
    return pf, slot.to(torch.uint8), r_play, ratio


def shap_phis(
    X: torch.Tensor,
    thr: torch.Tensor,
    missing_left: torch.Tensor,
    leaf_value: torch.Tensor,
    path_feature: torch.Tensor,
    slot: torch.Tensor,
    r_play: torch.Tensor,
    depth: int,
    n_features: int,
) -> torch.Tensor:
    """(N, n_features) attributions of the forest margin for rows ``X``,
    from the per-leaf tables of `leaf_tables`, computed in ``X.dtype``.
    Trees are processed in chunks so the broadcast intermediates stay
    bounded. As in the kernel, each tree's attributions are summed in
    ``X.dtype`` and the per-tree sums are added in float64: phis reach |8|
    on the serving model, where a float32 running total over 300 trees
    loses up to ~3e-5."""
    d = depth
    device = X.device
    N, T, L = X.shape[0], thr.shape[0], 2**d
    paths_np, dirs_np = path_structure(d)
    paths = torch.from_numpy(paths_np).long().to(device)
    dirs = torch.from_numpy(dirs_np).to(device)
    Wt = torch.from_numpy(bilinear_kernel(d)).to(device, X.dtype)
    players = torch.arange(d, device=device)
    total = torch.zeros((N, n_features), dtype=torch.float64, device=device)
    chunk = max(1, _CHUNK_ELEMENTS // max(1, N * L * d * d))
    for t0 in range(0, T, chunk):
        sl = slice(t0, min(T, t0 + chunk))
        pf = path_feature[sl].long()  # (Tc, L, d)
        xv = X[:, pf]  # (N, Tc, L, d)
        go_left = torch.where(
            torch.isnan(xv), missing_left[sl][:, paths], xv <= thr[sl][:, paths]
        )
        ind = (go_left == dirs).to(X.dtype)
        member = slot[sl].long()[..., None] == players  # (Tc, L, d, d)
        z = torch.where(member, ind[..., None], 1.0).prod(dim=-2)  # (N, Tc, L, d)
        r = r_play[sl].expand_as(z)
        e0 = torch.zeros(z.shape[:-1] + (d + 1,), dtype=X.dtype, device=device)
        e0[..., 0] = 1.0

        def mul(c: torch.Tensor, j: int) -> torch.Tensor:
            shifted = F.pad(c[..., :-1], (1, 0))
            return r[..., j, None] * c + z[..., j, None] * shifted

        prefs = [e0]
        for j in range(d - 1):
            prefs.append(mul(prefs[-1], j))
        sufs = [e0]
        for j in range(d - 1, 0, -1):
            sufs.append(mul(sufs[-1], j))
        P = torch.stack(prefs, dim=-2)  # (N, Tc, L, d, d+1)
        S = torch.stack(sufs[::-1], dim=-2)
        # Full-precision matmul: TF32 is off for matmuls unless a caller
        # enables it (torch.backends.cuda.matmul.allow_tf32 defaults False).
        psi = (torch.matmul(P, Wt) * S).sum(dim=-1)  # (N, Tc, L, d)
        contrib = (z - r) * psi * leaf_value[sl][:, :, None]
        tree_of = torch.arange(pf.shape[0], device=device)[:, None, None]
        tree_phis = torch.zeros(
            (N, pf.shape[0] * n_features), dtype=X.dtype, device=device
        )
        tree_phis.index_add_(
            1, (tree_of * n_features + pf).reshape(-1), contrib.reshape(N, -1)
        )
        total += tree_phis.view(N, -1, n_features).sum(dim=1, dtype=torch.float64)
    return total.to(X.dtype)


def expected_margin(
    leaf_value: torch.Tensor, ratio: torch.Tensor
) -> torch.Tensor:
    """The SHAP base value: the cover-weighted expected margin, a forest-only
    scalar (sum over trees and leaves of value x path cover-ratio product)."""
    return torch.sum(leaf_value * torch.prod(ratio, dim=2))


def shap_values(
    forest: Forest, X: torch.Tensor, *, n_features: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-feature attributions of the forest margin (log-odds).

    Returns ``(phis, base_value)`` with ``phis`` of shape (N, n_features),
    satisfying ``base_value + phis.sum(-1) == predict_margin(forest, X)`` to
    float tolerance."""
    pf, slot, r_play, ratio = leaf_tables(forest.feature, forest.cover, forest.depth)
    phis = shap_phis(
        X,
        forest.thr_float,
        forest.missing_left,
        forest.leaf_value,
        pf,
        slot,
        r_play,
        forest.depth,
        n_features,
    )
    return phis, expected_margin(forest.leaf_value, ratio)
