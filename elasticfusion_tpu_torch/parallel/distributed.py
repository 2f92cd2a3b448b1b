"""Multi-process runs — counterpart of the reference package's
`parallel/distributed.py`, over `torch.distributed`.

Model, as in the reference: every process runs the same engine loop over the
same frame stream (SLAM is batch 1: frames are broadcast, work is sharded).

  - With `mesh_shape = (S,)` the surfel map's S sub-maps spread over the W
    processes, S / W in each (`ProcessMapGroup`): the raster merges and
    count gathers of `shard_step` become process-group collectives, so one
    map spans the ranks as the reference's global mesh does.
  - The fern keyframe database is partitioned (`PartitionedFerns`): keyframe
    ownership is `src_time mod W`; retrieval scores each rank's own shard and
    resolves ONE global winner from a host all-gather of (dissimilarity,
    src_time, blockHD); the winner's owner runs the accept branch and its
    verdict is all-gathered, so every rank emits identical constraints.
  - The deformation graph stays replicated (<= 1024 nodes).

`initialize_from_env` brings the group up over gloo: it takes CPU tensors
and, staged through the host (`ProcessMapGroup.host_copies` counts those
copies), CUDA ones — the form in which two ranks share one card, which NCCL
refuses.  A group initialised by the caller over NCCL (ranks on cards of
their own) is used as it is, unstaged; that form is not measured.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .sharding import MapGroup


def initialize_from_env(coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None) -> bool:
    """`torch.distributed.init_process_group` over gloo from the arguments,
    else from the environment (`MASTER_ADDR`:`MASTER_PORT`, `WORLD_SIZE`,
    `RANK`).  A single process (no coordinator, one process) initialises
    nothing.  Returns whether a group is up."""
    import torch.distributed as dist

    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if not coordinator and (num_processes or 1) <= 1:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, the "
                         "number of processes and this process's rank")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def world() -> Tuple[int, int]:
    """(number of processes, this process's rank): (1, 0) without a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def process_allgather(obj) -> list:
    """A host object of every process, in rank order."""
    import torch.distributed as dist

    n, _ = world()
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj)
    return out


class ProcessMapGroup(MapGroup):
    """`MapGroup` over the processes of `torch.distributed`: this process
    holds S / W consecutive shards; every collective reduces over its local
    shards first, then over the processes (`all_reduce` / `all_gather`)."""

    def __init__(self, devices, S: int):
        import torch.distributed as dist

        super().__init__(devices)
        n, rank = world()
        local = len(self.devices)
        if local * n != S:
            raise ValueError(f"{local} shards in each of {n} processes are not {S}")
        self.S = S
        self.shard_ids = list(range(rank * local, (rank + 1) * local))
        self._dist = dist
        self._gloo = dist.get_backend() == "gloo"
        self.host_copies = 0

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """A copy of x to reduce in place (the local fold of one shard is
        that shard's own tensor): on the host where gloo meets a card."""
        if self._gloo and x.device.type != "cpu":
            self.host_copies += 1
            return x.cpu()
        return x.clone()

    def _fold(self, parts, op):
        t = self._staged(super()._fold(parts, op).contiguous())
        rop = self._dist.ReduceOp.MIN if op is torch.minimum else self._dist.ReduceOp.SUM
        self._dist.all_reduce(t, op=rop)
        return t.to(self.lead)

    def _gather(self, parts):
        t = self._staged(super()._gather(parts).contiguous())
        out = [torch.empty_like(t) for _ in range(self._dist.get_world_size())]
        self._dist.all_gather(out, t)
        return torch.cat(out).to(self.lead)

    def gather_objects(self, obj) -> list:
        return process_allgather(obj)


class PartitionedFerns:
    """Host-partitioned fern DB: keyframe ownership is `src_time mod
    n_hosts`, deterministic on every host with no communication.  Retrieval
    scores the local shard; the global winner is resolved from the hosts'
    (dissimilarity, src_time, blockHD) by an all-gather, the winner's owner
    runs the accept branch, and its verdict is all-gathered.

    Drop-in for the engine's `ferns`: everything but the add and find paths
    delegates to the wrapped `Ferns`.  Each round carries the frame tick it
    belongs to, and a round whose hosts disagree on it raises (a desynced
    rank) instead of merging candidates of different frames; a round leaves
    nothing behind."""

    def __init__(self, ferns, n_hosts: int, host_id: int):
        object.__setattr__(self, "ferns", ferns)
        object.__setattr__(self, "n_hosts", n_hosts)
        object.__setattr__(self, "host_id", host_id)
        object.__setattr__(self, "_merged_accept", False)
        object.__setattr__(self, "_merged_src_time", -1)

    def __getattr__(self, name):
        return getattr(self.ferns, name)

    def _host_allgather(self, tag: str, tick: int, arr) -> np.ndarray:
        """[n_hosts, len(arr)] f64: every host's vector of round (tick, tag)."""
        rows = process_allgather((int(tick), tag, np.asarray(arr, np.float64)))
        if any((t, g) != (int(tick), tag) for t, g, _ in rows):
            raise RuntimeError(f"fern merge out of step at tick {tick} ({tag}): "
                               f"{[(t, g) for t, g, _ in rows]}")
        return np.stack([r for _, _, r in rows])

    @property
    def last_closest(self) -> int:
        """-1 = no accepted closure this frame; otherwise the MERGED global
        winner accepted (not a local frame index: the keyframe may live on
        another host — `closest_src_time()` names it)."""
        if self.n_hosts == 1:
            return self.ferns.last_closest
        return 0 if self._merged_accept else -1

    def closest_src_time(self) -> int:
        if self.n_hosts == 1:
            return self.ferns.closest_src_time()
        return self._merged_src_time

    def _owns(self, src_time: int) -> bool:
        return int(src_time) % self.n_hosts == self.host_id

    def add_frame(self, image, vertex, normal, T_wc, src_time, **kw) -> bool:
        if not self._owns(src_time):
            return False
        return self.ferns.add_frame(image, vertex, normal, T_wc, src_time, **kw)

    def add_frame_scored(self, add_min, codes, good, views, T_wc, src_time) -> bool:
        if not self._owns(src_time):
            return False
        return self.ferns.add_frame_scored(add_min, codes, good, views, T_wc, src_time)

    def find_frame_scored(self, best_id, best_d, block_hd, codes, good, views,
                          T_wc, time, lost):
        """Global retrieval (reference: one DB, one winner — Ferns.cpp:162-298):
        the winner's OWNER runs the accept branch (fern ICP and photometric
        check need the keyframe images only it holds); every host then emits
        the same constraints from the shared current views and the merged
        pose."""
        f = self.ferns
        if self.n_hosts == 1:
            return f.find_frame_scored(best_id, best_d, block_hd, codes, good, views,
                                       T_wc, time, lost)
        object.__setattr__(self, "_merged_accept", False)
        object.__setattr__(self, "_merged_src_time", -1)
        f.last_closest = -1

        valid = (bool(f.frames) and good != 0 and np.isfinite(best_d)
                 and 0 <= int(best_id) < len(f.frames))
        local_time = f.frames[int(best_id)].src_time if valid else -1
        payload = [best_d if valid else np.inf, float(local_time),
                   float(block_hd) if valid else 0.0]
        allp = self._host_allgather("cand", time, payload)        # [n_hosts, 3]
        k = int(np.lexsort((allp[:, 1], allp[:, 0]))[0])          # d, then time
        win_d, win_time, win_hd = allp[k]
        if not np.isfinite(win_d) or win_hd <= 0.3:
            return None, []          # every host derives the same reject

        owner = int(win_time) % self.n_hosts
        res = np.zeros((18,), np.float64)
        if owner == self.host_id:
            local_id = next((i for i, fr in enumerate(f.frames)
                             if fr.src_time == int(win_time)), -1)
            if local_id >= 0:
                T_est, _ = f.find_frame_scored(local_id, win_d, win_hd, codes, good,
                                               views, T_wc, time, lost)
                if f.last_closest != -1:
                    res[0] = 1.0
                    res[1:17] = np.asarray(T_est, np.float64).reshape(-1)
                    res[17] = win_time
        merged = self._host_allgather("verdict", time, res)[owner]
        if merged[0] == 0.0:
            f.last_closest = -1
            return None, []

        T_est = merged[1:17].reshape(4, 4)
        object.__setattr__(self, "_merged_accept", True)
        object.__setattr__(self, "_merged_src_time", int(merged[17]))
        from ..ferns import _to_small

        _, vert_s, _ = _to_small(*views)
        return T_est, f._emit_constraints(vert_s, T_wc, T_est)
