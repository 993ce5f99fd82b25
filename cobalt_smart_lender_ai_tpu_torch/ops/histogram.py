"""Gradient / hessian / cover histograms — the hot op of histogram GBDT.

`gradient_histogram_jobs` is the wrapper of the CUDA kernel
``csrc/gradient_histogram.cu``, which replaces the reference package's
Pallas kernel (``ops/hist_pallas.py::_hist_kernel``) and the XLA
formulations it stands in for: ``_hist_segsum`` and ``_hist_matmul`` for
one fit, and ``_hist_matmul_jobs``, the joint histogram of every
(candidate, fold) job of a search bucket that the reference's vmap rule
(``_channels_matmul_vmappable``) runs. J jobs share the bins matrix; each
has its own node, g, h and w. `gradient_histogram_channels` is its ``J =
1`` case, one fit's level. On a CUDA tensor the wrapper launches the kernel
or raises; on a CPU tensor it runs `gradient_histogram_jobs_reference`, the
plain PyTorch version: the reference's ``_hist_segsum``, one joint (job,
node, feature, bin) segment sum per channel. There is no fallback from one
to the other.

Three channels per bucket: gradient, hessian and the row-weight cover, so a
node's cover falls out as ``hw[k, f, :].sum()`` for any feature ``f``.

Non-finite inputs give the same bins on both: a bin that a NaN reaches, or
both a +inf and a -inf, holds NaN; one that only infinities of one sign
reach holds that infinity; every other bin holds its finite sum.

`gradient_histogram_sharded` is the sharded entry of the same kernel, for a
fit whose rows are split over a dp mesh (the reference's ``psum`` of each
level's histograms over its ``axis_name``): each shard takes its scale
state (`histogram_scale_state`), the shards agree on one (the state a
launch over all their rows would take), each adds its rows under it
(`histogram_accumulate`), the partials are summed and the total is
finalized once (`histogram_finalize`). On the card the result is the bits
of `gradient_histogram_jobs` over all rows; the plain versions sum float64
partials and round once.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import time

import torch

from cobalt_smart_lender_ai_tpu_torch.ops import _build
from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import launch_handle

__all__ = [
    "gradient_histogram",
    "gradient_histogram_channels",
    "gradient_histogram_jobs",
    "gradient_histogram_jobs_reference",
    "gradient_histogram_reference",
    "gradient_histogram_sharded",
    "histogram_accumulate",
    "histogram_cost",
    "histogram_finalize",
    "histogram_partial_reference",
    "histogram_scale_state",
    "histogram_supported",
]

#: Shared memory one block may use on Hopper (227 KB); one (node, feature)
#: histogram of the kernel takes 3 * n_bins int64.
SMEM_LIMIT = 232_448


def histogram_supported(n_bins: int) -> bool:
    """Shape guard of the kernel: one (node, feature) histogram must fit in
    a block's shared memory."""
    return 1 <= n_bins and 3 * n_bins * 8 <= SMEM_LIMIT


def histogram_cost(
    n_rows: int,
    n_features: int,
    n_nodes: int,
    n_bins: int,
    bin_bytes: int,
    active_rows: int | None = None,
    n_jobs: int = 1,
    bin_rows: int | None = None,
) -> tuple[int, int]:
    """(FLOPs, bytes) of one histogram pass of ``n_jobs`` jobs over one
    shared bins matrix, from shapes, the count of active (job, row) pairs
    (``active_rows``: those whose g, h or w is nonzero; the others add
    nothing) and the count of rows active in any job (``bin_rows``: the
    rows whose bins the function needs). ``active_rows=None`` takes every
    row of every job as active, and then every row's bins as needed: the
    shape-only upper bound the program registry records per launch, since
    counting active rows is a reduction on the card. One job's
    ``bin_rows`` is its ``active_rows``; J > 1 jobs with ``active_rows``
    need ``bin_rows`` too.

    Bytes: node, g, h and w of every row of every job (16 B), the F bins of
    each needed row once (the jobs share them) and the (3, J, K, F, B) f32
    output written once. Operations: three adds per (active pair,
    feature)."""
    if active_rows is None:
        active, needed = n_jobs * n_rows, n_rows
    else:
        active = active_rows
        needed = active_rows if bin_rows is None and n_jobs == 1 else bin_rows
        if needed is None:
            raise ValueError(f"{n_jobs} jobs with active_rows need bin_rows")
    nbytes = (
        16 * n_jobs * n_rows
        + needed * n_features * bin_bytes
        + 3 * n_jobs * n_nodes * n_features * n_bins * 4
    )
    return 3 * active * n_features, nbytes


def _program(F: int, n_bins: int, device: torch.device, n_jobs: int = 1, part: str = ""):
    """The launch's program: ``F<F>xB<B>`` for one fit, ``J<J>xF<F>xB<B>``
    for a joint launch of J jobs; a pass of the sharded entry prefixes its
    name (``sharded_accumulate/``, ``sharded_finalize/``; the scale state's
    is ``sharded_state/J<J>``)."""
    key = f"F{F}xB{n_bins}" if n_jobs == 1 else f"J{n_jobs}xF{F}xB{n_bins}"
    if part == "state":
        key = f"sharded_state/J{n_jobs}"
    elif part:
        key = f"sharded_{part}/{key}"
    return launch_handle(
        "gradient_histogram",
        key,
        device,
        lambda: _build.take_build_seconds("gradient_histogram"),
        cost_basis="shape-only upper bound: every row counted active",
    )


def histogram_partial_reference(
    bins: torch.Tensor,
    node_local: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    w: torch.Tensor,
    *,
    n_nodes: int,
    n_bins: int,
) -> torch.Tensor:
    """The float64 ``(3, J*n_nodes*F*n_bins)`` sums of the plain version,
    not yet rounded: `gradient_histogram_jobs_reference` before its last
    step, and the plain version of one shard's `histogram_accumulate`."""
    J, N = node_local.shape
    F = bins.shape[1]
    dev = bins.device
    node = node_local.long()
    inside = (node >= 0) & (node < n_nodes)
    # Rows outside the nodes go to one extra segment, dropped at the end.
    job_seg = torch.arange(J, dtype=torch.int64, device=dev)[:, None] * n_nodes
    segment = torch.where(inside, job_seg + node, J * n_nodes)
    feat = torch.arange(F, dtype=torch.int64, device=dev)
    idx = ((segment[:, :, None] * F + feat) * n_bins + bins.long()[None]).reshape(-1)
    del segment, node, inside
    size = J * n_nodes * F * n_bins
    out = torch.zeros((3, size + F * n_bins), dtype=torch.float64, device=dev)
    for c, v in enumerate((g, h, w)):
        out[c].index_add_(0, idx, v.to(torch.float64)[:, :, None].expand(J, N, F).reshape(-1))
    return out[:, :size]


def gradient_histogram_jobs_reference(
    bins: torch.Tensor,
    node_local: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    w: torch.Tensor,
    *,
    n_nodes: int,
    n_bins: int,
) -> torch.Tensor:
    """The plain version: ``(3, J, n_nodes, F, n_bins)`` float32 sums of
    (g, h, w) of J jobs over one shared ``(N, F)`` bins matrix, one
    ``index_add_`` per channel over ``((j*n_nodes + node)*F + f)*B + bin``;
    ``node_local``, ``g``, ``h`` and ``w`` are ``(J, N)``. A row whose node
    lies outside ``[0, n_nodes)`` adds nothing.

    The sums are taken in float64 and rounded once to float32. A float32
    running sum drifts where one bin takes many equal values: at the
    full-width fit's first level (1.84M rows; g is 0.5 or -1.88 at the
    first tree) float32 atomics miss the float64 sum by ~1e-3 of the bin,
    which no kernel could be held to. A NaN or an infinity reaches only
    the bins of its row, where the float64 sum leaves NaN or the infinity.
    Each job's segments receive its rows in row order, so job j gets the
    bits of `gradient_histogram_reference` on its own inputs."""
    J, F = node_local.shape[0], bins.shape[1]
    out = histogram_partial_reference(bins, node_local, g, h, w, n_nodes=n_nodes, n_bins=n_bins)
    return out.to(torch.float32).reshape(3, J, n_nodes, F, n_bins)


def gradient_histogram_reference(
    bins: torch.Tensor,
    node_local: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    w: torch.Tensor,
    *,
    n_nodes: int,
    n_bins: int,
) -> torch.Tensor:
    """The plain version of one fit's level: ``(3, n_nodes, F, n_bins)``
    float32, `gradient_histogram_jobs_reference` at ``J = 1`` on ``(N,)``
    inputs."""
    out = gradient_histogram_jobs_reference(
        bins, node_local[None], g[None], h[None], w[None], n_nodes=n_nodes, n_bins=n_bins
    )
    return out[:, 0]


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel, its C signatures declared once."""
    lib = _build.load("gradient_histogram")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gradient_histogram.argtypes = [i, p, i, p, p, p, p, i, i, i, i, i, p, p, p, p]
    lib.gradient_histogram.restype = i
    lib.gradient_histogram_scratch_words.argtypes = [i, i, i]
    lib.gradient_histogram_scratch_words.restype = ctypes.c_longlong
    lib.gradient_histogram_acc_words.argtypes = [i, i, i, i]
    lib.gradient_histogram_acc_words.restype = ctypes.c_longlong
    lib.gradient_histogram_error_string.argtypes = [i]
    lib.gradient_histogram_error_string.restype = ctypes.c_char_p
    ll = ctypes.c_longlong
    lib.gradient_histogram_state_words.argtypes = [i]
    lib.gradient_histogram_state_words.restype = i
    lib.gradient_histogram_scale_state.argtypes = [i, p, p, p, i, i, p, p]
    lib.gradient_histogram_scale_state.restype = i
    lib.gradient_histogram_accumulate.argtypes = [i, p, i, p, p, p, p, i, i, i, i, i, ll, p, p, p, p]
    lib.gradient_histogram_accumulate.restype = i
    lib.gradient_histogram_finalize.argtypes = [i, p, p, ll, i, i, i, i, p, p]
    lib.gradient_histogram_finalize.restype = i
    return lib


_COUNT_LOCK = threading.Lock()


def _check_launch(bins, node_local, g, h, w, n_nodes: int, n_bins: int) -> tuple[int, int, int]:
    """The kernel's input checks; returns ``(N, F, J)``."""
    if bins.device.type != "cuda":
        raise ValueError(f"gradient_histogram runs on cpu or cuda tensors, got {bins.device}")
    if bins.dim() != 2 or bins.dtype not in (torch.uint8, torch.int32) or not bins.is_contiguous():
        raise ValueError("bins must be a contiguous (N, F) uint8 or int32 tensor")
    N, F = bins.shape
    if node_local.dim() != 2 or node_local.shape[1] != N:
        raise ValueError(f"node_local must be (J, {N}), got {tuple(node_local.shape)}")
    J = node_local.shape[0]
    if node_local.dtype != torch.int32 or not node_local.is_contiguous():
        raise ValueError("node_local must be a contiguous (J, N) int32 tensor")
    _check_channels(g, h, w, J, N, bins.device)
    if node_local.device != bins.device:
        raise ValueError(f"node_local is on {node_local.device}, bins on {bins.device}")
    if N < 1 or F < 1 or J < 1 or n_nodes < 1 or not histogram_supported(n_bins):
        raise ValueError(
            f"gradient_histogram does not take N={N}, F={F}, J={J}, n_nodes={n_nodes}, "
            f"n_bins={n_bins}"
        )
    if bins.dtype == torch.uint8 and n_bins > 256:
        raise ValueError(f"uint8 bins cannot index n_bins={n_bins}")
    return N, F, J


def _check_channels(g, h, w, J: int, N: int, device: torch.device) -> None:
    for name, v in (("g", g), ("h", h), ("w", w)):
        if v.dtype != torch.float32 or v.shape != (J, N) or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (J, N) float32 tensor")
        if v.device != device:
            raise ValueError(f"{name} is on {v.device}, bins on {device}")


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.gradient_histogram_error_string(err).decode()
        raise RuntimeError(f"gradient_histogram: CUDA error {err} ({msg}) {what}")


def gradient_histogram_jobs(
    bins: torch.Tensor,
    node_local: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    w: torch.Tensor,
    *,
    n_nodes: int,
    n_bins: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (g, h, w) sums of J jobs as three ``(J, n_nodes, F, n_bins)``
    float32 views of one ``(3, J, n_nodes, F, n_bins)`` tensor: the layout
    the reference's vmap rule returns (``_hist_matmul_jobs``'s ``(F, B, J,
    3, K)`` read as three ``(J, K, F, B)``).

    ``bins`` is ``(N, F)`` uint8 or int32, shared by the jobs;
    ``node_local`` is ``(J, N)`` int32 in ``[0, n_nodes)`` (rows outside it
    add nothing), ``g``, ``h``, ``w`` ``(J, N)`` float32. A CPU ``bins``
    runs `gradient_histogram_jobs_reference`; a CUDA ``bins`` launches the
    kernel once for all J jobs on the current stream (counted once in
    ``gradient_histogram_channels.launches``, which counts every launch of
    the kernel) or raises. The launch groups the active rows (node in
    range, g, h or w nonzero) by (job, node) on the card, with no copy to
    the host, so that each block sums one job's node only. Its sums are
    int64 fixed point, scaled per (job, channel): each job gets the bits
    that a launch on its inputs alone gives; g and h agree with the plain
    version within float32 rounding, the cover bit for bit, and two
    launches on the same inputs, or on the same rows in another order, give
    the same bits. A NaN or infinity in a job's g, h or w leaves the bins
    its row reaches as the plain version leaves them (NaN, or the
    infinity); the other bins, that job's and every other job's, keep their
    fixed-point sums, whose scale is taken over the finite values only.

    Each call is recorded on its program handle (`telemetry.programs`,
    ``gradient_histogram/F<F>xB<n_bins>`` for one job,
    ``gradient_histogram/J<J>xF<F>xB<n_bins>`` for J > 1): CUDA events
    around the launch on the card, wall seconds of the plain version on the
    CPU, and `histogram_cost`'s shape-only FLOPs and bytes: all J jobs'
    rows, the shared bins read once."""
    if bins.device.type == "cpu":
        t0 = time.perf_counter()
        out = gradient_histogram_jobs_reference(
            bins, node_local, g, h, w, n_nodes=n_nodes, n_bins=n_bins
        )
        (J, N), F = node_local.shape, bins.shape[1]
        flops, nbytes = histogram_cost(N, F, n_nodes, n_bins, bins.element_size(), n_jobs=J)
        _program(F, n_bins, bins.device, J).record_dispatch(
            time.perf_counter() - t0, rows=J * N, flops=flops, nbytes=nbytes
        )
        return out[0], out[1], out[2]
    N, F, J = _check_launch(bins, node_local, g, h, w, n_nodes, n_bins)
    lib = _library()
    out = torch.empty((3, J, n_nodes, F, n_bins), dtype=torch.float32, device=bins.device)
    # The int64 sums, then the words of non-finite bits of each bin.
    acc = torch.empty(
        lib.gradient_histogram_acc_words(n_nodes, F, n_bins, J),
        dtype=torch.int64,
        device=bins.device,
    )
    # Per job the largest |g|, |h|, |w|; per (job, node) counts and segment
    # offsets; the work table and the row indices grouped by segment.
    scratch = torch.empty(
        lib.gradient_histogram_scratch_words(N, n_nodes, J), dtype=torch.int32, device=bins.device
    )
    dev = bins.device.index if bins.device.index is not None else torch.cuda.current_device()
    prog = _program(F, n_bins, bins.device, J)
    stream = torch.cuda.current_stream(bins.device)
    pair = prog.start(stream)
    err = lib.gradient_histogram(
        dev,
        bins.data_ptr(),
        1 if bins.dtype == torch.uint8 else 0,
        node_local.data_ptr(),
        g.data_ptr(),
        h.data_ptr(),
        w.data_ptr(),
        N,
        F,
        n_nodes,
        n_bins,
        J,
        acc.data_ptr(),
        scratch.data_ptr(),
        out.data_ptr(),
        stream.cuda_stream,
    )
    if err != 0:
        msg = lib.gradient_histogram_error_string(err).decode()
        raise RuntimeError(f"gradient_histogram: CUDA error {err} ({msg}) launching the kernel")
    flops, nbytes = histogram_cost(N, F, n_nodes, n_bins, bins.element_size(), n_jobs=J)
    prog.stop(pair, stream, rows=J * N, flops=flops, nbytes=nbytes)
    with _COUNT_LOCK:
        gradient_histogram_channels.launches += 1
    return out[0], out[1], out[2]


def gradient_histogram_channels(
    bins: torch.Tensor,
    node_local: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    w: torch.Tensor,
    *,
    n_nodes: int,
    n_bins: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fit's level: the (g, h, w) sums as three ``(n_nodes, F,
    n_bins)`` float32 views, `gradient_histogram_jobs` at ``J = 1`` on
    ``(N,)`` ``node_local``, ``g``, ``h`` and ``w`` (the same launch, the
    same checks, the same program ``gradient_histogram/F<F>xB<n_bins>``).

    ``launches`` counts every launch of the kernel, one fit's or a joint
    one of J jobs, each once."""
    hg, hh, hw = gradient_histogram_jobs(
        bins, node_local[None], g[None], h[None], w[None], n_nodes=n_nodes, n_bins=n_bins
    )
    return hg[0], hh[0], hw[0]


gradient_histogram_channels.launches = 0


def gradient_histogram(
    bins: torch.Tensor,
    node_local: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    w: torch.Tensor,
    *,
    n_nodes: int,
    n_bins: int,
) -> torch.Tensor:
    """`gradient_histogram_channels` stacked as ``(n_nodes, F, n_bins, 3)``,
    the reference's ``gradient_histogram`` layout."""
    hg, hh, hw = gradient_histogram_channels(
        bins, node_local, g, h, w, n_nodes=n_nodes, n_bins=n_bins
    )
    return torch.stack([hg, hh, hw], dim=-1)


# -- the sharded entry --------------------------------------------------------------

#: int32 words of one job's scale state: the largest finite |g|, |h|, |w|
#: (float32 bits) and the non-finite channel flags (bit c: channel c).
STATE_WORDS = 4


def histogram_scale_state(g: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One shard's scale state, ``(J, 4)`` int32: per job the float32 bits
    of the largest finite |g|, |h| and |w| over ALL its ``(J, N)`` rows, and
    its non-finite flags. A CUDA tensor launches ``state_kernel`` on the
    current stream (counted in ``histogram_scale_state.launches``) or
    raises; a CPU tensor runs the same reduction in torch."""
    J, N = g.shape
    if g.device.type == "cpu":
        out = torch.zeros((J, STATE_WORDS), dtype=torch.int32)
        for c, v in enumerate((g, h, w)):
            finite = torch.isfinite(v)
            m = torch.where(finite, v.abs(), 0.0).amax(dim=1) if N else torch.zeros(J)
            out[:, c] = m.to(torch.float32).view(torch.int32)
            out[:, 3] |= (~finite).any(dim=1).to(torch.int32) << c
        return out
    _check_channels(g, h, w, J, N, g.device)
    if N < 1 or J < 1:
        raise ValueError(f"histogram_scale_state does not take J={J}, N={N}")
    lib = _library()
    out = torch.empty((J, STATE_WORDS), dtype=torch.int32, device=g.device)
    stream = torch.cuda.current_stream(g.device)
    prog = _program(0, 0, g.device, J, "state")
    pair = prog.start(stream)
    err = lib.gradient_histogram_scale_state(
        _device_index(g), g.data_ptr(), h.data_ptr(), w.data_ptr(), N, J, out.data_ptr(),
        stream.cuda_stream,
    )
    _raise(lib, err, "launching the scale-state kernel")
    prog.stop(pair, stream, rows=J * N, nbytes=12 * J * N + 16 * J)
    with _COUNT_LOCK:
        histogram_scale_state.launches += 1
    return out


histogram_scale_state.launches = 0


def reduce_scale_states(states, lead: torch.device, group=None) -> torch.Tensor:
    """The agreed state of every shard's ``(J, 4)`` state, on ``lead``: the
    max of the bits (non-negative floats order as their bits do) and the OR
    of the flags, across processes too when ``group`` is given (MAX over
    the flags' bits as 0/1 values: NCCL has no bitwise OR)."""
    stacked = torch.stack([s.to(lead) for s in states])
    out = stacked.amax(dim=0)
    flags = stacked[0, :, 3].clone()
    for s in stacked[1:]:
        flags |= s[:, 3]
    out[:, 3] = flags
    if group is not None:
        import torch.distributed as dist

        bits = torch.arange(3, dtype=torch.int32, device=lead)
        flag_bits = (out[:, 3:4] >> bits) & 1
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)  # the flags word is redone below
        dist.all_reduce(flag_bits, op=dist.ReduceOp.MAX, group=group)
        out[:, 3] = (flag_bits << bits).sum(dim=1).to(torch.int32)
    return out


def histogram_accumulate(
    bins: torch.Tensor,
    node_local: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    w: torch.Tensor,
    state: torch.Tensor,
    *,
    n_nodes: int,
    n_bins: int,
    scale_rows: int,
) -> torch.Tensor:
    """One shard's partial sums of J jobs (inputs as `gradient_histogram_jobs`
    takes them) under the agreed ``state`` (``(J, 4)`` int32) and the
    shards' total of ``scale_rows`` rows. A CUDA ``bins`` launches kernels 1-4
    of the kernel on the current stream (counted in
    ``histogram_accumulate.launches``) or raises, and returns the int64
    accumulator: ``3*J*K*F*B`` fixed-point sums, then the non-finite words;
    a CPU ``bins`` returns the plain version's float64 ``(3, J*K*F*B)``
    sums (``state`` unused)."""
    J, N = node_local.shape
    F = bins.shape[1]
    if state.shape != (J, STATE_WORDS) or state.dtype != torch.int32:
        raise ValueError(f"state must be a ({J}, {STATE_WORDS}) int32 tensor")
    if bins.device.type == "cpu":
        t0 = time.perf_counter()
        out = histogram_partial_reference(bins, node_local, g, h, w, n_nodes=n_nodes, n_bins=n_bins)
        flops, nbytes = histogram_cost(N, F, n_nodes, n_bins, bins.element_size(), n_jobs=J)
        _program(F, n_bins, bins.device, J, "accumulate").record_dispatch(
            time.perf_counter() - t0, rows=J * N, flops=flops, nbytes=nbytes
        )
        return out
    N, F, J = _check_launch(bins, node_local, g, h, w, n_nodes, n_bins)
    if state.device != bins.device or not state.is_contiguous():
        raise ValueError(f"state must be contiguous on {bins.device}")
    if scale_rows < N:
        raise ValueError(f"scale_rows={scale_rows} is fewer than this shard's {N} rows")
    lib = _library()
    acc = torch.empty(
        lib.gradient_histogram_acc_words(n_nodes, F, n_bins, J), dtype=torch.int64, device=bins.device
    )
    scratch = torch.empty(
        lib.gradient_histogram_scratch_words(N, n_nodes, J), dtype=torch.int32, device=bins.device
    )
    prog = _program(F, n_bins, bins.device, J, "accumulate")
    stream = torch.cuda.current_stream(bins.device)
    pair = prog.start(stream)
    err = lib.gradient_histogram_accumulate(
        _device_index(bins), bins.data_ptr(), 1 if bins.dtype == torch.uint8 else 0,
        node_local.data_ptr(), g.data_ptr(), h.data_ptr(), w.data_ptr(), N, F, n_nodes, n_bins, J,
        int(scale_rows), state.data_ptr(), acc.data_ptr(), scratch.data_ptr(), stream.cuda_stream,
    )
    _raise(lib, err, "launching the accumulate pass")
    flops, nbytes = histogram_cost(N, F, n_nodes, n_bins, bins.element_size(), n_jobs=J)
    prog.stop(pair, stream, rows=J * N, flops=flops, nbytes=nbytes)
    with _COUNT_LOCK:
        histogram_accumulate.launches += 1
    return acc


histogram_accumulate.launches = 0


def sum_partials(parts, lead: torch.device, per_channel: int, group=None) -> torch.Tensor:
    """The shards' partials summed on ``lead``, in shard order, then across
    processes when ``group`` is given. float64 partials (the plain version)
    add; int64 accumulators add their ``3 * per_channel`` fixed-point sums
    and OR their non-finite words (across processes: MAX over the words'
    nine bits as 0/1 values, only when some word is set)."""
    total = parts[0].to(lead).clone()
    if total.dtype == torch.float64:
        for p in parts[1:]:
            total += p.to(lead)
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total
    n = 3 * per_channel
    words = total[n:].view(torch.int32)
    for p in parts[1:]:
        p = p.to(lead)
        total[:n] += p[:n]
        words |= p[n:].view(torch.int32)
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(total[:n], op=dist.ReduceOp.SUM, group=group)
        any_set = torch.tensor([int(bool((words != 0).any()))], dtype=torch.int32, device=lead)
        dist.all_reduce(any_set, op=dist.ReduceOp.MAX, group=group)
        if int(any_set):
            bits = torch.arange(9, dtype=torch.int32, device=lead)
            unpacked = (words[:, None] >> bits) & 1
            dist.all_reduce(unpacked, op=dist.ReduceOp.MAX, group=group)
            words.copy_((unpacked << bits).sum(dim=1).to(torch.int32))
    return total


def histogram_finalize(
    total: torch.Tensor,
    state: torch.Tensor,
    *,
    n_jobs: int,
    n_nodes: int,
    n_features: int,
    n_bins: int,
    scale_rows: int,
) -> torch.Tensor:
    """The summed partials as ``(3, J, n_nodes, F, n_bins)`` float32. An int64
    accumulator on the card launches ``finalize_kernel`` once on the current
    stream (counted in ``histogram_finalize.launches``) or raises; the plain
    version's float64 sums are rounded once."""
    shape = (3, n_jobs, n_nodes, n_features, n_bins)
    if total.device.type == "cpu":
        return total.to(torch.float32).reshape(shape)
    lib = _library()
    words = lib.gradient_histogram_acc_words(n_nodes, n_features, n_bins, n_jobs)
    if total.dtype != torch.int64 or total.numel() != words or not total.is_contiguous():
        raise ValueError(f"total must be a contiguous int64 accumulator of {words} words")
    if state.shape != (n_jobs, STATE_WORDS) or state.device != total.device:
        raise ValueError(f"state must be ({n_jobs}, {STATE_WORDS}) on {total.device}")
    out = torch.empty(shape, dtype=torch.float32, device=total.device)
    prog = _program(n_features, n_bins, total.device, n_jobs, "finalize")
    stream = torch.cuda.current_stream(total.device)
    pair = prog.start(stream)
    err = lib.gradient_histogram_finalize(
        _device_index(total), total.data_ptr(), state.data_ptr(), int(scale_rows), n_features,
        n_nodes, n_bins, n_jobs, out.data_ptr(), stream.cuda_stream,
    )
    _raise(lib, err, "launching the finalize pass")
    per_channel = n_jobs * n_nodes * n_features * n_bins
    prog.stop(pair, stream, rows=per_channel, nbytes=3 * per_channel * 12 + 4 * per_channel)
    with _COUNT_LOCK:
        histogram_finalize.launches += 1
    return out


histogram_finalize.launches = 0


def gradient_histogram_sharded(
    parts,
    *,
    n_nodes: int,
    n_bins: int,
    n_rows: int,
    run=None,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (g, h, w) sums of J jobs over every shard's rows, as
    `gradient_histogram_jobs` returns them, on the first part's device.

    ``parts`` holds one ``(bins, node_local, g, h, w)`` per local shard
    (each on its own device, inputs as `gradient_histogram_jobs` takes
    them); ``n_rows`` is the rows of ALL shards, every process's
    (unpadded: padding rows count as rows of no shard); ``run(fn)`` calls
    ``fn(s)`` for each local shard ``s`` on its device and stream
    (`parallel.mesh.RowShards.run`; default one after another) and
    ``group``, when given, the process group of the other processes'
    shards. Four steps: each shard's `histogram_scale_state`, the agreed
    state (`reduce_scale_states`), each shard's `histogram_accumulate`
    under it, the partials summed (`sum_partials`) and finalized once
    (`histogram_finalize`). On the card the result is the bits one
    `gradient_histogram_jobs` launch over all rows gives: the agreed state
    and row count are that launch's, so every value's fixed-point image is
    the same, and the int64 sums add associatively; the plain version adds
    float64 partials and rounds once, within a float32 rounding of the one
    call (the cover, whose sums are integers, bit for bit)."""
    run = run or (lambda fn: [fn(s) for s in range(len(parts))])
    bins0, node0 = parts[0][0], parts[0][1]
    lead = bins0.device
    J, F = node0.shape[0], bins0.shape[1]
    states = run(lambda s: histogram_scale_state(*parts[s][2:]))
    agreed = reduce_scale_states(states, lead, group)
    partials = run(
        lambda s: histogram_accumulate(
            *parts[s], agreed.to(parts[s][0].device), n_nodes=n_nodes, n_bins=n_bins,
            scale_rows=n_rows,
        )
    )
    total = sum_partials(partials, lead, J * n_nodes * F * n_bins, group)
    out = histogram_finalize(
        total, agreed, n_jobs=J, n_nodes=n_nodes, n_features=F, n_bins=n_bins, scale_rows=n_rows
    )
    return out[0], out[1], out[2]
