"""The reference's dispatch-budget cost model: chunk sizes derived from the
workload's shape.

The reference splits every long fit into margin-carried chunks so that no
single device dispatch outlives a budget of ``DISPATCH_BUDGET_S`` seconds,
and derives each chunk from a cost model of one boosting round:

    t_tree ~ n_jobs * F * B * ( N * (A_LEVEL * depth + B_NODE * n_nodes)
                                + C_FIX * n_nodes ),   n_nodes = 2^depth - 1

(``n_nodes`` x 0.75 with sibling-subtraction histograms). The port runs
eagerly and has no dispatch limit, but the chunk size is part of a
successive-halving search's result: a rung boosts whole chunks, so the
margins it scores have ``chunk * ceil(budget / chunk)`` trees. ``"auto"``
therefore resolves here to the reference's integer for the same shape,
with the constants copied verbatim.

The reference also corrects the model from measured dispatch walls kept in
a file under the user's cache directory (``calibration_factor``, the
calibration ratchet). That is not ported: it would change chunk sizes, and
so halving's rungs, from one run to the next. The port's factor is 1.0,
which equals the reference on a machine without that file.
"""

from __future__ import annotations

__all__ = [
    "AUTO",
    "DISPATCH_BUDGET_S",
    "auto_chunk_trees",
    "auto_steps_per_dispatch",
    "est_tree_seconds",
    "resolve_chunk_trees",
]

#: Per-dispatch wall target (seconds).
DISPATCH_BUDGET_S = 18.0
#: s per row*feat*bin per tree level.
A_LEVEL = 6.0e-12
#: s per row*feat*bin per tree node.
B_NODE = 7.0e-14
#: s per job*feat*bin per tree node, independent of the row count.
C_FIX = 5.9e-9
#: The ``chunk_trees`` value that derives the chunk from the workload.
AUTO = "auto"


def est_tree_seconds(
    n_rows: int,
    n_feats: int,
    n_bins: int,
    depth: int,
    n_jobs: int = 1,
    *,
    hist_subtract: bool = False,
) -> float:
    """The model's seconds for one boosting round of ``n_jobs`` jobs over
    ``n_rows`` x ``n_feats`` rows binned at ``n_bins``."""
    n_nodes = 2.0**depth - 1.0
    if hist_subtract:
        n_nodes *= 0.75
    linear = n_rows * (A_LEVEL * depth + B_NODE * n_nodes)
    fixed = C_FIX * n_nodes
    return n_jobs * n_feats * n_bins * (linear + fixed)


def auto_chunk_trees(
    n_trees: int,
    *,
    n_rows: int,
    n_feats: int,
    n_bins: int,
    depth: int,
    n_jobs: int = 1,
    budget_s: float = DISPATCH_BUDGET_S,
    hist_subtract: bool = False,
) -> int | None:
    """Boosting rounds per chunk of an ``n_trees``-round fit, or None when
    the whole fit fits the budget."""
    t_tree = est_tree_seconds(
        n_rows, n_feats, n_bins, depth, n_jobs, hist_subtract=hist_subtract
    )
    if t_tree * n_trees <= budget_s:
        return None
    return max(1, int(budget_s / max(t_tree, 1e-12)))


def resolve_chunk_trees(
    chunk_trees: int | str | None,
    *,
    n_trees: int,
    n_rows: int,
    n_feats: int,
    n_bins: int,
    depth: int,
    n_jobs: int = 1,
    budget_s: float = DISPATCH_BUDGET_S,
    hist_subtract: bool = False,
) -> int | None:
    """A config's ``chunk_trees`` (an int, None or ``"auto"``) as the int or
    None that the fit loops take."""
    if chunk_trees == AUTO:
        return auto_chunk_trees(
            n_trees,
            n_rows=n_rows,
            n_feats=n_feats,
            n_bins=n_bins,
            depth=depth,
            n_jobs=n_jobs,
            budget_s=budget_s,
            hist_subtract=hist_subtract,
        )
    if isinstance(chunk_trees, str):
        raise ValueError(f"chunk_trees must be an int, None, or {AUTO!r}; got {chunk_trees!r}")
    return chunk_trees


def auto_steps_per_dispatch(
    n_steps: int, *, fit_seconds: float, budget_s: float = DISPATCH_BUDGET_S
) -> int:
    """Whole work items of ``fit_seconds`` each that fit one budget (at
    least 1, at most ``n_steps``): the reference's RFE steps per dispatch."""
    if n_steps <= 1:
        return max(n_steps, 1)
    k = int(budget_s / max(fit_seconds, 1e-12))
    return max(1, min(k, n_steps))
