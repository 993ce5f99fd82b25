"""Device meshes: the port's copy of the reference's ``parallel/mesh.py``.

The framework's two parallel axes:

- ``dp`` shards the *row* axis. Each shard builds the gradient histograms
  and leaf sums of its rows; the histograms are reduced exactly (int64
  fixed point, `ops.histogram.gradient_histogram_sharded`), the leaf sums
  in float32, and every shard then takes the same split decisions.
- ``hp`` shards the *job* axis: the (candidate, fold) jobs of a search
  bucket, which never talk to each other.

A `Mesh` is an ``(hp, dp)`` array of ``torch.device`` plus the axis names.
A device may be named more than once: each entry is one shard, and on the
card each shard of a mesh of more than one entry runs on its own
``torch.cuda.Stream`` (`Mesh.stream`). That is how the tests (``cpu``
named several times) and ``chip_smoke.py`` (the one card named four times)
stand in for a host with several cards. A one-entry mesh runs on the
caller's current stream, which is the single-device path exactly.

Across processes (`parallel.distributed.make_global_mesh`) the mesh names
every process's devices and `Mesh.ranks` says which process holds each
entry; a process runs only its own entries and reduces with the others
over ``torch.distributed`` (`Mesh.group`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, TypeVar

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.config import MeshConfig
from cobalt_smart_lender_ai_tpu_torch import device as _device

__all__ = ["Mesh", "RowShards", "fork_join", "make_mesh", "pad_rows", "row_bounds"]

T = TypeVar("T")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An ``(hp, dp)`` array of devices. ``ranks`` (same shape) names the
    process that holds each entry, None when this process holds all of
    them; ``group`` is the process group that reduces across processes
    (None: the default group when ``ranks`` is set)."""

    devices: np.ndarray  # (hp, dp) object array of torch.device
    axis_names: tuple[str, str] = ("hp", "dp")
    ranks: np.ndarray | None = None
    group: Any = None

    def __post_init__(self):
        if self.devices.ndim != 2 or self.devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (hp, dp) array, got {self.devices.shape}")
        object.__setattr__(self, "_streams", {})

    @property
    def shape(self) -> dict[str, int]:
        """``{axis_hp: hp, axis_dp: dp}``, as the reference's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def axis_hp(self) -> str:
        return self.axis_names[0]

    @property
    def axis_dp(self) -> str:
        return self.axis_names[1]

    @property
    def multi_process(self) -> bool:
        return self.ranks is not None and len(set(self.ranks.flat)) > 1

    def rank(self) -> int:
        """This process's rank (0 without ``torch.distributed``)."""
        if self.ranks is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank() if dist.is_initialized() else 0

    def local(self, i: int, j: int) -> bool:
        """Whether this process holds entry ``(i, j)``."""
        return self.ranks is None or int(self.ranks[i, j]) == self.rank()

    def stream(self, i: int, j: int) -> torch.cuda.Stream | None:
        """Entry ``(i, j)``'s own CUDA stream, made at first use; None on
        the CPU and for a one-entry mesh (the caller's current stream)."""
        dev = self.devices[i, j]
        if dev.type != "cuda" or self.size == 1:
            return None
        streams = self._streams
        s = streams.get((i, j))
        if s is None:
            s = streams[(i, j)] = torch.cuda.Stream(dev)
        return s

    def run_hp(self, fn: Callable[[int], T], n: int | None = None) -> list[T]:
        """``fn(i)`` for the first ``n`` (default all) hp rows, each on a
        stream of its own on its first device when the mesh has more than
        one hp row on the card, in fork-join order (`fork_join`)."""
        n = self.devices.shape[0] if n is None else n
        devices = [self.devices[i, 0] for i in range(n)]
        streams = []
        for i, dev in enumerate(devices):
            if dev.type != "cuda" or self.devices.shape[0] == 1:
                streams.append(None)
                continue
            if ("hp", i) not in self._streams:
                self._streams[("hp", i)] = torch.cuda.Stream(dev)
            streams.append(self._streams[("hp", i)])
        return fork_join(devices, streams, fn)

    def row_shards(self, hp_index: int, n_rows: int) -> "RowShards":
        """The dp axis of hp row ``hp_index`` over ``n_rows`` rows: this
        process's shards, their streams and row ranges (`row_bounds`)."""
        dp = self.devices.shape[1]
        bounds = row_bounds(n_rows, dp)
        mine = [j for j in range(dp) if self.local(hp_index, j)]
        return RowShards(
            devices=[self.devices[hp_index, j] for j in mine],
            streams=[self.stream(hp_index, j) for j in mine],
            bounds=[bounds[j] for j in mine],
            index=mine,
            n_shards=dp,
            n_rows=int(n_rows),
            group=self.reduce_group() if self.multi_process else None,
        )

    def reduce_group(self) -> Any:
        """The process group of the dp reductions: ``group`` or the default
        group."""
        if self.group is not None:
            return self.group
        import torch.distributed as dist

        return dist.group.WORLD


def fork_join(
    devices: Sequence[torch.device], streams: Sequence[Any], fn: Callable[[int], T]
) -> list[T]:
    """``fn(s)`` for each ``s`` on ``devices[s]`` and ``streams[s]`` (None:
    the current stream, and no fork at all when every stream is None):
    each stream first waits for its device's current stream, and the
    current streams wait for every stream before this returns. Between two
    such calls only the current streams get work, so a tensor made on one
    side and read on the other is never reused early by the allocator."""
    if all(s is None for s in streams):
        return [fn(s) for s in range(len(devices))]
    out = []
    for s, (dev, stream) in enumerate(zip(devices, streams)):
        if stream is None:
            out.append(fn(s))
            continue
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            out.append(fn(s))
    for dev, stream in zip(devices, streams):
        if stream is not None:
            torch.cuda.current_stream(dev).wait_stream(stream)
    return out


def row_bounds(n_rows: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous ``[start, stop)`` row ranges of ``n_shards`` shards, the
    first ``n_rows % n_shards`` one row longer (``torch.tensor_split``'s
    cut). Every shard holds a row: fewer rows than shards raises."""
    if n_rows < n_shards:
        raise ValueError(f"{n_rows} rows cannot fill {n_shards} dp shards")
    base, extra = divmod(n_rows, n_shards)
    out, start = [], 0
    for s in range(n_shards):
        stop = start + base + (1 if s < extra else 0)
        out.append((start, stop))
        start = stop
    return out


@dataclasses.dataclass
class RowShards:
    """The row shards of one fit that this process holds: their devices,
    streams (None: the current stream) and ``[start, stop)`` row ranges of
    the ``n_rows`` rows, their indices on the dp axis (``n_shards`` long),
    and the process group the shards of other processes reduce over (None:
    one process). The first local shard's device is the *lead*: reduced
    values and the split search live there."""

    devices: list[torch.device]
    streams: list[torch.cuda.Stream | None]
    bounds: list[tuple[int, int]]
    index: list[int]
    n_shards: int
    n_rows: int
    group: Any = None

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def run(self, fn: Callable[[int], T]) -> list[T]:
        """``fn(s)`` for each local shard ``s`` on its device and stream, in
        fork-join order (`fork_join`)."""
        return fork_join(self.devices, self.streams, fn)

    def split(self, t: torch.Tensor, dim: int = 0) -> list[torch.Tensor]:
        """This process's row slices of ``t`` (rows along ``dim``), each on
        its shard's device (a view where it already lies there)."""
        return [
            t.narrow(dim, a, b - a).to(dev) for (a, b), dev in zip(self.bounds, self.devices)
        ]

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum over every shard of one tensor per local shard, on the
        lead device: the local parts added in shard order, then across
        processes by ``all_reduce``."""
        total = parts[0].to(self.lead).clone()
        for p in parts[1:]:
            total += p.to(self.lead)
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
        return total

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The local shards' row blocks concatenated on the lead device (a
        process's own rows only; nothing crosses processes)."""
        return torch.cat([p.to(self.lead) for p in parts])


def make_mesh(
    config: MeshConfig | None = None,
    *,
    devices: Sequence[torch.device | str] | None = None,
) -> Mesh:
    """Build an ``(hp, dp)`` mesh over ``devices`` (default: every visible
    card, `device.mesh_devices`). ``dp = -1`` takes all the devices ``hp``
    leaves; ``hp`` must divide the device count."""
    cfg = config or MeshConfig()
    devs = [_device.resolve_device(d) for d in (devices if devices is not None else _device.mesh_devices())]
    n = len(devs)
    hp = max(1, cfg.hp)
    if n % hp != 0:
        raise ValueError(f"hp={hp} does not divide device count {n}")
    dp = n // hp if cfg.dp == -1 else cfg.dp
    if hp * dp != n:
        raise ValueError(f"mesh {hp}x{dp} != {n} devices")
    arr = np.empty((hp, dp), dtype=object)
    for k, d in enumerate(devs):
        arr[k // dp, k % dp] = d
    return Mesh(arr, (cfg.axis_hp, cfg.axis_dp))


def pad_rows(n: int, multiple: int) -> int:
    """Rows to append so the row axis divides ``multiple``."""
    return (-n) % multiple
