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
