"""Gradient / hessian / cover histograms — the hot op of histogram GBDT.

`gradient_histogram_channels` is the wrapper of the CUDA kernel
``csrc/gradient_histogram.cu``, which replaces the reference package's
Pallas kernel (``ops/hist_pallas.py::_hist_kernel``) and the XLA
formulations it stands in for. On a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs `gradient_histogram_reference`, the plain
PyTorch version: the reference's ``_hist_segsum``, one joint (node,
feature, bin) segment sum per channel. There is no fallback from one to the
other.

Three channels per bucket: gradient, hessian and the row-weight cover, so a
node's cover falls out as ``hw[k, f, :].sum()`` for any feature ``f``.

Non-finite inputs give the same bins on both: a bin that a NaN reaches, or
both a +inf and a -inf, holds NaN; one that only infinities of one sign
reach holds that infinity; every other bin holds its finite sum.
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
    "gradient_histogram_reference",
    "histogram_cost",
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
) -> tuple[int, int]:
    """(FLOPs, bytes) of one histogram pass, from shapes and the count of
    active rows (those whose g, h or w is nonzero; the others add nothing,
    and the kernel reads no bins for them). ``active_rows=None`` takes
    every row as active: the shape-only upper bound the program registry
    records per launch, since counting active rows is a reduction on the
    card.

    Bytes: node, g, h and w of every row (16 B), the F bins of each active
    row and the (3, K, F, B) f32 output written once. Operations: three
    adds per (active row, feature)."""
    active = n_rows if active_rows is None else active_rows
    nbytes = 16 * n_rows + active * n_features * bin_bytes + 3 * n_nodes * n_features * n_bins * 4
    return 3 * active * n_features, nbytes


def _program(F: int, n_bins: int, device: torch.device):
    return launch_handle(
        "gradient_histogram",
        f"F{F}xB{n_bins}",
        device,
        lambda: _build.take_build_seconds("gradient_histogram"),
        cost_basis="shape-only upper bound: every row counted active",
    )


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
    """The plain version: ``(3, n_nodes, F, n_bins)`` float32 sums of (g, h,
    w), one ``index_add_`` per channel over ``(node*F + f)*B + bin``.

    The sums are taken in float64 and rounded once to float32. A float32
    running sum drifts where one bin takes many equal values: at the
    full-width fit's first level (1.84M rows; g is 0.5 or -1.88 at the
    first tree) float32 atomics miss the float64 sum by ~1e-3 of the bin,
    which no kernel could be held to. A NaN or an infinity reaches only
    the bins of its row, where the float64 sum leaves NaN or the infinity."""
    N, F = bins.shape
    feat = torch.arange(F, dtype=torch.int64, device=bins.device)
    seg = ((node_local.long()[:, None] * F + feat) * n_bins + bins.long()).reshape(-1)
    out = torch.zeros((3, n_nodes * F * n_bins), dtype=torch.float64, device=bins.device)
    for c, v in enumerate((g, h, w)):
        out[c].index_add_(0, seg, v.to(torch.float64)[:, None].expand(N, F).reshape(-1))
    return out.to(torch.float32).reshape(3, n_nodes, F, n_bins)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel, its C signatures declared once."""
    lib = _build.load("gradient_histogram")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gradient_histogram.argtypes = [i, p, i, p, p, p, p, i, i, i, i, p, p, p, p]
    lib.gradient_histogram.restype = i
    lib.gradient_histogram_scratch_words.argtypes = [i, i]
    lib.gradient_histogram_scratch_words.restype = ctypes.c_longlong
    lib.gradient_histogram_acc_words.argtypes = [i, i, i]
    lib.gradient_histogram_acc_words.restype = ctypes.c_longlong
    lib.gradient_histogram_error_string.argtypes = [i]
    lib.gradient_histogram_error_string.restype = ctypes.c_char_p
    return lib


_COUNT_LOCK = threading.Lock()


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
    """The (g, h, w) sums as three ``(n_nodes, F, n_bins)`` float32 views of
    one ``(3, n_nodes, F, n_bins)`` tensor.

    ``bins`` is ``(N, F)`` uint8 or int32, ``node_local`` ``(N,)`` int32 in
    ``[0, n_nodes)`` (rows outside it add nothing), ``g``, ``h``, ``w``
    ``(N,)`` float32. A CPU ``bins`` runs
    `gradient_histogram_reference`; a CUDA ``bins`` launches the kernel once
    on the current stream (counted in ``gradient_histogram_channels.launches``)
    or raises. The launch groups the active rows (node in range, g, h or w
    nonzero) by node on the card, with no copy to the host, so that each
    block sums one node's rows only. Its sums are int64 fixed point: g and h
    agree with the plain version within float32 rounding, the cover bit for
    bit, and two launches on the same inputs, or on the same rows in
    another order, give the same bits. A NaN or infinity in g, h or w leaves
    the bins its row reaches as the plain version leaves them (NaN, or the
    infinity); the other bins keep their fixed-point sums, whose scale is
    taken over the finite values only.

    Each call is recorded on its program handle (`telemetry.programs`,
    ``gradient_histogram/F<F>xB<n_bins>``): CUDA events around the launch
    on the card, wall seconds of the plain version on the CPU, and
    `histogram_cost`'s shape-only FLOPs and bytes."""
    if bins.device.type == "cpu":
        t0 = time.perf_counter()
        out = gradient_histogram_reference(
            bins, node_local, g, h, w, n_nodes=n_nodes, n_bins=n_bins
        )
        N, F = bins.shape
        flops, nbytes = histogram_cost(N, F, n_nodes, n_bins, bins.element_size())
        _program(F, n_bins, bins.device).record_dispatch(
            time.perf_counter() - t0, rows=N, flops=flops, nbytes=nbytes
        )
        return out[0], out[1], out[2]
    if bins.device.type != "cuda":
        raise ValueError(f"gradient_histogram runs on cpu or cuda tensors, got {bins.device}")
    if bins.dim() != 2 or bins.dtype not in (torch.uint8, torch.int32) or not bins.is_contiguous():
        raise ValueError("bins must be a contiguous (N, F) uint8 or int32 tensor")
    N, F = bins.shape
    if node_local.dtype != torch.int32 or node_local.shape != (N,) or not node_local.is_contiguous():
        raise ValueError("node_local must be a contiguous (N,) int32 tensor")
    for name, v in (("g", g), ("h", h), ("w", w)):
        if v.dtype != torch.float32 or v.shape != (N,) or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (N,) float32 tensor")
        if v.device != bins.device:
            raise ValueError(f"{name} is on {v.device}, bins on {bins.device}")
    if node_local.device != bins.device:
        raise ValueError(f"node_local is on {node_local.device}, bins on {bins.device}")
    if N < 1 or F < 1 or n_nodes < 1 or not histogram_supported(n_bins):
        raise ValueError(
            f"gradient_histogram does not take N={N}, F={F}, n_nodes={n_nodes}, n_bins={n_bins}"
        )
    if bins.dtype == torch.uint8 and n_bins > 256:
        raise ValueError(f"uint8 bins cannot index n_bins={n_bins}")
    lib = _library()
    out = torch.empty((3, n_nodes, F, n_bins), dtype=torch.float32, device=bins.device)
    # The int64 sums, then the words of non-finite bits of each bin.
    acc = torch.empty(
        lib.gradient_histogram_acc_words(n_nodes, F, n_bins), dtype=torch.int64, device=bins.device
    )
    # Largest |g|, |h|, |w|, per-node counts and segment offsets, the work
    # table and the row indices grouped by node.
    scratch = torch.empty(
        lib.gradient_histogram_scratch_words(N, n_nodes), dtype=torch.int32, device=bins.device
    )
    dev = bins.device.index if bins.device.index is not None else torch.cuda.current_device()
    prog = _program(F, n_bins, bins.device)
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
        acc.data_ptr(),
        scratch.data_ptr(),
        out.data_ptr(),
        stream.cuda_stream,
    )
    if err != 0:
        msg = lib.gradient_histogram_error_string(err).decode()
        raise RuntimeError(f"gradient_histogram: CUDA error {err} ({msg}) launching the kernel")
    flops, nbytes = histogram_cost(N, F, n_nodes, n_bins, bins.element_size())
    prog.stop(pair, stream, rows=N, flops=flops, nbytes=nbytes)
    with _COUNT_LOCK:
        gradient_histogram_channels.launches += 1
    return out[0], out[1], out[2]


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
