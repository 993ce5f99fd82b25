"""Numeric-safety hooks.

- `nan_guard()` — a context manager that turns on autograd's anomaly
  detection (`torch.autograd.set_detect_anomaly`), so a backward pass that
  produces NaN raises naming the forward operation it came from. It costs a
  check per operation: for debug runs, never the hot path.
- `assert_all_finite(tree, name)` — one batched host fetch of a result tree
  (nested dicts, lists and tuples of tensors or arrays, or a module's
  `state_dict`), raising `FloatingPointError` that names the first leaf with
  NaN or inf.

- `profile_trace(log_dir, device)` — a ``torch.profiler`` session over the
  block, written where TensorBoard's profile plugin reads it (the serve
  CLI's ``--profile-dir``); the port's spans enter
  ``torch.profiler.record_function`` inside it, so stage names and the
  card's kernels share one timeline.

The train loop's per-epoch divergence check (`TrainSettings.check_finite`)
is separate: `models.train_loop.fit_binary` tests each epoch's loss on the
device and raises pointing here.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator

import numpy as np
import torch

__all__ = ["assert_all_finite", "nan_guard", "profile_trace"]


@contextlib.contextmanager
def nan_guard(enable: bool = True) -> Iterator[None]:
    """Anomaly detection inside the block; the prior setting is restored."""
    if not enable:
        yield
        return
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)


def _leaves(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}[{i}]")
    else:
        yield path, tree


def assert_all_finite(tree: Any, name: str = "result") -> None:
    """Raise `FloatingPointError` if any floating leaf of ``tree`` holds NaN
    or inf. The device tensors are flattened into one buffer per device and
    fetched once, not leaf by leaf."""
    leaves = list(_leaves(tree))
    device_leaves: dict[torch.device, list[int]] = {}
    for i, (_, leaf) in enumerate(leaves):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and leaf.device.type != "cpu":
            device_leaves.setdefault(leaf.device, []).append(i)
    host: dict[int, np.ndarray] = {}
    for idx in device_leaves.values():
        flat = torch.cat([leaves[i][1].detach().reshape(-1).float() for i in idx]).cpu().numpy()
        start = 0
        for i in idx:
            n = leaves[i][1].numel()
            host[i] = flat[start : start + n]
            start += n
    for i, (path, leaf) in enumerate(leaves):
        if i in host:
            arr = host[i]
        elif isinstance(leaf, torch.Tensor):
            arr = leaf.detach().float().numpy() if leaf.is_floating_point() else None
        else:
            arr = np.asarray(leaf)
        if arr is None or not np.issubdtype(arr.dtype, np.floating):
            continue
        if not np.isfinite(arr).all():
            shape = tuple(leaf.shape) if hasattr(leaf, "shape") else arr.shape
            raise FloatingPointError(f"{name}{path} contains NaN/inf (shape {shape})")


def _all_threads_config():
    """The profiler option that captures every thread, where this torch
    has it (None otherwise: the session then sees its own thread only)."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def profile_trace(log_dir: str | None, device: torch.device | str = "cuda") -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into ``log_dir`` (a
    no-op for None), as ``torch.profiler.tensorboard_trace_handler`` writes
    it (``<worker>.<ms>.pt.trace.json``, read by TensorBoard's profile
    plugin and Perfetto).

    On a CUDA ``device`` (the default; it raises without a card) the
    session records CPU and CUDA activity, and raises rather than drop the
    CUDA side when this torch cannot trace it; with ``device="cpu"``, the
    CPU only. Every thread is captured where torch allows it, and the
    port's spans on any thread enter ``record_function`` while the session
    is open (`telemetry.tracing.all_thread_session`)."""
    if not log_dir:
        yield
        return
    from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
    from cobalt_smart_lender_ai_tpu_torch.telemetry.tracing import all_thread_session

    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        if torch.profiler.ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("this torch build cannot trace CUDA activity; profile_trace refuses a CPU-only trace of a card run")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    extra = {}
    all_threads = _all_threads_config()
    if all_threads is not None:
        extra["experimental_config"] = all_threads
    session = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
        **extra,
    )
    marker = all_thread_session() if all_threads is not None else contextlib.nullcontext()
    with session, marker:
        yield
