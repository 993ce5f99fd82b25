"""The one device rule of the port's entry points: ``cuda`` unless the caller
asks for ``cpu``, and no silent move from one to the other."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on. ``cuda`` without a usable CUDA
    device raises: nothing moves to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' (--device cpu) to run the plain "
                "PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


def mesh_devices(device: torch.device | str = "cuda") -> list[torch.device]:
    """The devices a mesh may use (`parallel.mesh.make_mesh`): every visible
    CUDA device for ``cuda`` (none visible raises, as `resolve_device`
    does), the one ``cpu`` for ``cpu``. Tests and ``chip_smoke.py`` pass
    their own list instead, one device named several times (each entry is
    one shard, on its own CUDA stream)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
