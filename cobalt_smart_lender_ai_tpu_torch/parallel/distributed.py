"""Multi-process runtime: process bootstrap and the global (hp, dp) mesh.

The port's copy of the reference's ``parallel/distributed.py``, over
``torch.distributed`` instead of ``jax.distributed``:

- `init_distributed` wires the processes into one process group, from a
  `DistributedConfig` or the reference's environment contract
  (``COORDINATOR_ADDRESS`` as ``host:port``, ``NUM_PROCESSES``,
  ``PROCESS_ID``): NCCL for processes on cards, gloo on the CPU (and for
  two processes that share one card, which NCCL refuses). It is idempotent,
  and a no-op for one process, so every single-process entry point needs
  no special case. Nothing on a host tells a process of its peers: the
  address, the count and the rank are given.
- `make_global_mesh` lays every process's devices out as one ``(hp, dp)``
  mesh, ``hp`` the outer axis (the search's jobs, which never talk) and
  ``dp`` the inner one (each level's histogram reduction), so dp neighbours
  are a process's own devices first. With one process it is
  `parallel.mesh.make_mesh`. Under NCCL each process lists only the card
  it is bound to, and a card listed by two ranks raises. A process runs its own entries of the mesh
  and reduces with the others by ``all_reduce`` (`parallel.mesh.RowShards`,
  `ops.histogram.gradient_histogram_sharded`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
from typing import Sequence

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch import device as _device
from cobalt_smart_lender_ai_tpu_torch.config import MeshConfig
from cobalt_smart_lender_ai_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = [
    "DistributedConfig",
    "check_device_owners",
    "init_distributed",
    "local_mesh_devices",
    "make_global_mesh",
    "make_mesh",
]

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Process-bootstrap settings; unset means one process."""

    coordinator_address: str | None = None  # "host:port" of process 0
    num_processes: int | None = None
    process_id: int | None = None

    @staticmethod
    def from_env() -> "DistributedConfig":
        def _int(name: str) -> int | None:
            v = os.environ.get(name)
            return int(v) if v else None

        return DistributedConfig(
            coordinator_address=os.environ.get("COORDINATOR_ADDRESS") or None,
            num_processes=_int("NUM_PROCESSES"),
            process_id=_int("PROCESS_ID"),
        )


def init_distributed(
    config: DistributedConfig | None = None,
    *,
    device: torch.device | str = "cuda",
    backend: str | None = None,
    timeout_s: float = 300.0,
) -> bool:
    """Join this process to the process group; returns True if a
    multi-process group is (now) active, False for one process.

    ``backend`` defaults to ``nccl`` for ``device`` on a card and ``gloo``
    on the CPU; pass ``gloo`` for processes that share one card. With NCCL
    each process takes card ``process_id % cards``. Idempotent: a second
    call returns the state of the first."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    cfg = config or DistributedConfig.from_env()
    n = cfg.num_processes or 1
    if not cfg.coordinator_address and n == 1:
        return False
    if not cfg.coordinator_address or cfg.process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator's host:port and this "
            f"process's id, got {cfg}"
        )
    dev = _device.resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(cfg.process_id % torch.cuda.device_count())
    import datetime

    dist.init_process_group(
        backend,
        init_method=f"tcp://{cfg.coordinator_address}",
        world_size=n,
        rank=cfg.process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    logger.info("process group: rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(), backend)
    return dist.get_world_size() > 1


def local_mesh_devices(
    devices: Sequence[torch.device | str] | None, backend: str
) -> list[torch.device]:
    """This process's entries of the global mesh: ``devices`` if given;
    under NCCL the one card `init_distributed` bound the process to (every
    visible card in every rank would put one GPU in two NCCL ranks, which
    NCCL refuses or hangs on); else `device.mesh_devices`."""
    if devices is not None:
        return [_device.resolve_device(d) for d in devices]
    if backend == "nccl":
        return [torch.device("cuda", torch.cuda.current_device())]
    return _device.mesh_devices()


def check_device_owners(owners: Sequence[Sequence[Sequence[str]]], backend: str) -> None:
    """``owners[r]``: rank ``r``'s mesh entries as ``(host, device)``.
    Under NCCL a device of one host listed by two ranks raises ValueError
    (a rank may list its own device several times: one shard a stream)."""
    if backend != "nccl":
        return
    seen: dict[tuple[str, str], int] = {}
    for rank, entries in enumerate(owners):
        for host, dev in entries:
            other = seen.setdefault((host, dev), rank)
            if other != rank:
                raise ValueError(
                    f"{dev} on {host} is listed by ranks {other} and {rank}: "
                    "NCCL needs one card a rank"
                )


def make_global_mesh(
    config: MeshConfig | None = None,
    *,
    devices: Sequence[torch.device | str] | None = None,
) -> Mesh:
    """The ``(hp, dp)`` mesh over every process's devices (``devices``:
    this process's, default `local_mesh_devices`), rank-major, so that
    ``dp`` runs over a process's own devices first and ``hp`` spans the
    processes. ``hp`` must divide the global device count; ``dp = -1``
    takes the rest. Under NCCL no card may be listed by two ranks
    (`check_device_owners`). With one process this is `make_mesh`."""
    import torch.distributed as dist

    cfg = config or MeshConfig()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return make_mesh(cfg, devices=devices)
    backend = str(dist.get_backend())
    host = socket.gethostname()
    local = [(host, str(d)) for d in local_mesh_devices(devices, backend)]
    everyone: list = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, local)
    check_device_owners(everyone, backend)
    devs = [torch.device(d) for entries in everyone for _, d in entries]
    ranks = [r for r, entries in enumerate(everyone) for _ in entries]
    n = len(devs)
    hp = max(1, cfg.hp)
    if n % hp:
        raise ValueError(f"hp={hp} does not divide global device count {n}")
    dp = n // hp if cfg.dp == -1 else cfg.dp
    if hp * dp != n:
        raise ValueError(f"mesh {hp}x{dp} != {n} devices")
    arr = np.empty((hp, dp), dtype=object)
    for k, d in enumerate(devs):
        arr[k // dp, k % dp] = d
    return Mesh(arr, (cfg.axis_hp, cfg.axis_dp), ranks=np.asarray(ranks).reshape(hp, dp))
