"""The devices of a sharded surfel map and the group that reduces over its
shards — counterpart of the reference package's `parallel/sharding.py`.

The reference runs one program over a mesh of S devices (`jax.sharding.Mesh`
with one axis "map").  Here one process — a single controller — holds the S
sub-maps itself, each on a device of a list: the default list is `cuda:0 ..
cuda:S-1`, and a list may name one device S times (`["cpu"] * S`, `["cuda:0"]
* 2`), which is how the tests and the one-card machine run S > 1.  With
`torch.distributed` initialised the S sub-maps are spread over the processes
instead (`distributed.ProcessMapGroup`), S / world of them in each.

Every cross-shard value goes through a `MapGroup`: MIN over int64 raster
keys, SUM over integers, MERGE of float images to which at most one shard
contributes per element, and ALL-GATHER of small per-shard vectors.  Each
call is one collective of the reference's shard region and is counted in
`calls`, so a test can hold the collectives of a frame to the reference's.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Optional, Sequence

import torch

from .._device import DeviceLike, resolve_device
from ..config import EngineConfig


def make_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first `n_devices` CUDA cards (all of them by default); raises
    when fewer are visible, like the reference's `engine_mesh`."""
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n < 1 or n > have:
        raise ValueError(f"a mesh of {n} CUDA devices needs {n}, {have} visible")
    return [torch.device("cuda", i) for i in range(n)]


class MapGroup:
    """The S shards of one map, all held by this process.  Reduced values
    land on the lead device (`devices[0]`), where the replicated frame state
    lives."""

    def __init__(self, devices: Sequence[DeviceLike]):
        self.devices = [resolve_device(d) for d in devices]
        self.S = len(self.devices)
        self.shard_ids = list(range(self.S))   # global index of each local shard
        self.lead = self.devices[0]
        self.calls: Counter = Counter()

    # -- the collectives ------------------------------------------------------
    def min(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Elementwise minimum over every shard's tensor (exact)."""
        self.calls["min"] += 1
        return self._fold(parts, torch.minimum)

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Elementwise sum over every shard's integer tensor (exact)."""
        self.calls["sum"] += 1
        return self._fold(parts, torch.add)

    def merge(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Float32 images to which at most one shard contributes a nonzero
        value per element: their SUM over the int32 bit patterns, which is
        that value bit for bit (a -0.0 included) in any order."""
        self.calls["merge"] += 1
        bits = [p.contiguous().view(torch.int32) for p in parts]
        return self._fold(bits, torch.add).view(torch.float32)

    def all_gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every shard's small tensor, stacked in global shard order."""
        self.calls["all_gather"] += 1
        return self._gather(parts)

    @property
    def total_calls(self) -> int:
        return sum(self.calls.values())

    def gather_objects(self, obj) -> list:
        """Host objects of every process, in rank order (one process here)."""
        return [obj]

    # -- in-process forms (the process-group form overrides these) -----------
    def _fold(self, parts, op):
        out = parts[0].to(self.lead)
        for p in parts[1:]:
            out = op(out, p.to(self.lead))
        return out

    def _gather(self, parts):
        return torch.stack([p.to(self.lead) for p in parts])


def engine_group(cfg: EngineConfig, device: DeviceLike = None) -> Optional[MapGroup]:
    """The group of the engine's sub-maps from `cfg.mesh_shape` (None = one
    device).  Devices: every local shard on `device` when given, else
    `cuda:0 .. cuda:S-1` (raises when fewer are visible).  With
    `torch.distributed` initialised over W > 1 processes, S / W shards live
    in each, on `device` or else on the rank's card."""
    if cfg.mesh_shape is None:
        return None
    S = math.prod(cfg.mesh_shape)
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if S % world:
        raise ValueError(f"mesh_shape={cfg.mesh_shape}: {S} shards do not divide "
                         f"over {world} processes")
    local = S // world
    if device is not None:
        devices = [device] * local
    elif world == 1:
        devices = make_mesh(S)
    else:
        devices = [torch.device("cuda", dist.get_rank() % torch.cuda.device_count())] * local
    if world == 1:
        return MapGroup(devices)
    from .distributed import ProcessMapGroup

    return ProcessMapGroup(devices, S)
