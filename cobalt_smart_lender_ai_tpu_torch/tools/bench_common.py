"""What the port's measurement harnesses share: the record's device fields,
the card block, the best-of-N timer, the one-card mesh and the outputs.

The reference's records carry ``platform`` (JAX's platform string),
``interpret_mode`` and ``devices``; the port's carry ``"gpu"`` or ``"cpu"``,
``false`` (nothing is interpreted: the CPU runs the kernels' plain
versions) and the count of devices the run could use, plus one ``card``
block, ``{"name", "power_limit"}``, as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them (both None
on the CPU). Each tool prints one summary line on stderr with the card's
name and power limit.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time
from typing import Callable, Iterator

import torch

from cobalt_smart_lender_ai_tpu_torch import device as port_device
from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.tools.perf_sentinel import DEFAULT_TREND

__all__ = [
    "DEFAULT_TREND",
    "append_trend",
    "card_block",
    "card_text",
    "device_count",
    "force_devices",
    "host_cpu_cores",
    "platform_tag",
    "summary",
    "time_best",
    "to_host",
    "write_record",
]


@functools.lru_cache(maxsize=None)
def _nvidia_smi_lines() -> tuple[str, ...]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return tuple(line.strip() for line in out.splitlines() if line.strip())


def card_block(device: torch.device) -> dict:
    """``{"name", "power_limit"}`` of the card ``device`` names, as
    ``nvidia-smi`` prints them; both None for the CPU. A card whose
    ``nvidia-smi`` fails raises."""
    if device.type != "cuda":
        return {"name": None, "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    name, _, limit = _nvidia_smi_lines()[index].partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def card_text(device: torch.device) -> str:
    """The card as ``nvidia-smi`` prints it (``"cpu"`` for the CPU)."""
    card = card_block(device)
    return "cpu" if card["name"] is None else f"{card['name']}, {card['power_limit']}"


def platform_tag(device: torch.device) -> str:
    """The record's ``platform``: ``"gpu"`` on the card, ``"cpu"`` off it."""
    return "gpu" if device.type == "cuda" else "cpu"


def device_count(device: torch.device) -> int:
    """The devices a run on ``device`` may use (`device.mesh_devices`:
    every visible card, or the card named ``--force-devices`` times)."""
    return len(port_device.mesh_devices(device))


def host_cpu_cores() -> int:
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


@contextlib.contextmanager
def force_devices(n: int | None, device: torch.device) -> Iterator[dict | None]:
    """``--force-devices n``: `device.mesh_devices` names ``device`` ``n``
    times while inside (each entry one shard, on its own stream), as
    ``chip_smoke.py``'s phase 19 does. It measures no scaling: every shard
    runs on the one physical device. Yields the record's ``force_devices``
    block, or None without ``n``."""
    if not n:
        yield None
        return
    dev = resolve_device(device)
    saved = port_device.mesh_devices
    port_device.mesh_devices = lambda device="cuda": [dev] * n
    try:
        yield {"named": n, "physical_devices": 1}
    finally:
        port_device.mesh_devices = saved


def to_host(*tensors: torch.Tensor) -> None:
    """End a timed window with a value on the host: each tensor is copied
    back (on the card this waits for the launches that made it)."""
    for t in tensors:
        t.cpu()


def time_best(fn: Callable[[], object], repeats: int) -> float:
    """Best wall seconds of ``repeats`` calls, after one untimed warm-up
    call that builds and loads the libraries. ``fn`` must end with its
    result on the host (`to_host`)."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def write_record(record: dict, out: str | None, *, indent: int | None = None,
                 sort_keys: bool = False) -> None:
    """The record as one JSON text, written to ``out`` or, without it,
    printed on stdout."""
    text = json.dumps(record, indent=indent, sort_keys=sort_keys)
    if out:
        with open(out, "w") as fh:
            fh.write(text + "\n")
    else:
        print(text)


def append_trend(path: str | None, record: dict, source: str) -> None:
    """``--trend-out``: append the record's metrics as one trend row."""
    if not path:
        return
    from cobalt_smart_lender_ai_tpu_torch.telemetry.trend import append_record

    append_record(path, record, source=source, stamp=time.time())


def summary(tool: str, text: str, device: torch.device) -> None:
    """The tool's one summary line, on stderr, with the card's name and
    power limit."""
    print(f"[{tool}] {text} [{card_text(device)}]", file=sys.stderr, flush=True)
