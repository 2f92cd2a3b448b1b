"""The per-frame map operations on a sharded surfel map — counterpart of the
reference package's `parallel/shard_step.py` (sub-map sharding, ROADMAP
M11a).

Each shard is a sub-map of `capacity / S` surfels with its own count, and
every per-surfel operation stays shard-local:

  - point raster: each shard rasterises ITS surfels into per-pixel keys
    `quantized depth << 32 | global id` (global id = shard * cap_l + slot);
    one MIN over the shards gives the key the whole map gives, which is the
    reference's two-step rule (min of the 13-bit depth bucket, then of the
    global id, shard_step.py:84-95).  The shard that holds the winner
    gathers its channels and one MERGE (a sum to which one shard contributes
    per pixel) replicates them;
  - splat resolve (K2) runs on the merged channels on the lead device, and
    the fuse window (K3) on the replicated merged prediction in each shard's
    `fuse`, as the reference's shard region does;
  - appends go to the frame's owner shard `tick mod S`, at `owner * cap_l +
    count[owner]`, so every shard derives the same updated prediction;
  - clean and compaction are shard-local; one ALL-GATHER of (count, added)
    per fuse replicates the counts.

The functions here are the one-device map operations of `engine._OneDeviceMap`
over a `ShardedMap`, with the same signatures; the engine reaches them through
`engine._map_ops`, so `engine.slam_step` and `Engine` run a sharded map as they
run a one-device one.

Collectives per frame (`MapGroup.calls`): 2 per raster (predictIndices and
each combinedPredict), 1 for the counts, 1 for the deformation node sample,
1 for the inactive-surfel test — 7 without an inactive prediction, 9 with
one, where the reference's frame section makes 14.  At S = 1 every operation
is the single-device one, bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import CameraConfig, EngineConfig
from ..deformation import _sample_every
from ..ops.fuse import FuseStats, clean, fuse
from ..ops.splat import (
    _EMPTY_KEY,
    INVALID_ID,
    IndexPrediction,
    Prediction,
    _camera_frame,
    _point_keys,
    splat_resolve_images,
    winner_ids,
)
from ..surfels import SurfelMap
from .sharding import MapGroup

_MAP_FIELDS = ("pos", "conf", "color", "init_t", "last_t", "normal", "radius")

# The reference's shard region cleans with cfg.fx16_clean in its frame and
# closure sections (shard_step.py:335,509), where its one-device Engine
# cleans on the exact patch.
FRAME_CLEAN_FX16 = True


class ShardedMap(NamedTuple):
    """This process's sub-maps of one surfel map, the counts of all S of
    them, and the group that reduces over them."""

    shards: Tuple[SurfelMap, ...]   # each [.., cap_l] with its own count
    counts: torch.Tensor            # [S] int32 on the lead device
    group: MapGroup

    @property
    def cap_l(self) -> int:
        return self.shards[0].capacity

    @property
    def capacity(self) -> int:
        return self.group.S * self.cap_l

    @property
    def count(self) -> torch.Tensor:
        """The live surfels of the whole map (0-d int32, lead device)."""
        return self.counts.sum().to(torch.int32)

    def id_base(self, k: int) -> int:
        """The first global id of local shard k."""
        return self.group.shard_ids[k] * self.cap_l


def to_device(x, dev):
    """A tensor, or a NamedTuple of tensors, on `dev` (anything else as is)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, dev) for v in x))
    return x


def _raster(sm: ShardedMap, T_wc, cam: CameraConfig, gate, rows):
    """Shard-local rasters merged over the shards: the winner id image
    `[H,W]` (global ids, INVALID_ID where empty) and the winners' channel
    images `[C,H,W]`, both on the lead device.  `gate(m, pos_c)` and
    `rows(m, pos_c, normal_c)` are a shard's raster gate and the per-surfel
    rows its channels gather."""
    H, W = cam.height, cam.width
    keys, frames = [], []
    for k, m in enumerate(sm.shards):
        pos_c, normal_c = _camera_frame(m, T_wc.to(m.pos.device))
        live = torch.arange(m.capacity, device=m.pos.device) < m.count
        keys.append(_point_keys(pos_c, gate(m, pos_c), cam, live, sm.id_base(k)))
        frames.append((pos_c, normal_c))
    best = sm.group.min(keys)
    parts = []
    for k, m in enumerate(sm.shards):
        b = best.to(m.pos.device)
        mine = (b == keys[k]) & (keys[k] != _EMPTY_KEY)
        slot = torch.where(mine, (b & 0xFFFFFFFF) - sm.id_base(k), torch.zeros_like(b))
        ch = torch.cat(rows(m, *frames[k]))[:, slot]
        parts.append(torch.where(mine[None], ch, 0.0))
    merged = sm.group.merge(parts)
    return winner_ids(best, cam), merged.reshape(-1, H, W)


def predict_indices(sm: ShardedMap, T_wc, cam: CameraConfig, time, time_delta: int,
                    max_depth: float) -> IndexPrediction:
    """`ops.splat.predict_indices` over the sub-maps (ref
    `_predict_indices_local`, shard_step.py:96): the replicated index
    prediction, with global ids."""
    def gate(m, pos_c):
        return (pos_c[2] <= max_depth) & ((to_device(time, m.pos.device) - m.last_t)
                                          <= time_delta)

    def rows(m, pos_c, normal_c):
        return (pos_c, normal_c, m.radius[None], m.conf[None], m.init_t[None],
                m.last_t[None])

    winner, ch = _raster(sm, T_wc, cam, gate, rows)
    return IndexPrediction(
        index=torch.where(winner == INVALID_ID, torch.full_like(winner, -1),
                          winner).to(torch.int32),
        vert=ch[0:3], normal=ch[3:6], radius=ch[6], conf=ch[7],
        init_t=ch[8], last_t=ch[9],
    )


def combined_predict(sm: ShardedMap, T_wc, cam: CameraConfig, time, max_time,
                     time_delta, conf_threshold: float, max_depth: float) -> Prediction:
    """`ops.splat.combined_predict` over the sub-maps (ref
    `_combined_predict_local_td`, shard_step.py:580): merged winner channels,
    then the splat resolve (K2) on the lead device."""
    def gate(m, pos_c):
        dev = m.pos.device
        return ((pos_c[2] <= max_depth) & (m.conf >= conf_threshold)
                & ((to_device(time, dev) - m.last_t) <= time_delta)
                & (m.last_t <= to_device(max_time, dev)))

    def rows(m, pos_c, normal_c):
        return (pos_c, normal_c, m.radius[None], m.conf[None], m.color,
                m.init_t[None])

    winner, ch = _raster(sm, T_wc, cam, gate, rows)
    return splat_resolve_images(ch, winner == INVALID_ID, cam)


def fuse_clean(sm: ShardedMap, T, tick, rgb, raw_m, filt_m, weighting,
               cfg: EngineConfig, do_compact: bool, fx16: bool):
    """predictIndices -> fuse -> clean on the sub-maps (ref `_frame_body`,
    shard_step.py:318-341): each shard fuses against the replicated merged
    prediction, only the owner shard `tick mod S` appends, each cleans its
    own surfels; one all-gather replicates (count, added).  `matched` is
    pixel arithmetic on the replicated prediction, the same on every shard,
    and is reported once, not summed."""
    cam, g = cfg.camera, sm.group
    lead = g.lead
    pidx = predict_indices(sm, T, cam, tick, cfg.time_delta, cfg.max_depth_processed)
    owner = torch.remainder(torch.as_tensor(tick, device=lead).to(torch.int64), g.S)
    owner_count = sm.counts.to(torch.int64)[owner]
    append_base = owner * sm.cap_l + owner_count
    append_free = sm.cap_l - owner_count
    shards, rows, matched = [], [], None
    for k, m in enumerate(sm.shards):
        dev = m.pos.device
        on = lambda x: to_device(x, dev)  # noqa: E731
        m2, st, upd = fuse(
            m, on(pidx), on(T), on(tick), on(rgb), on(raw_m), on(filt_m), cam,
            cfg.max_depth_processed, on(weighting), return_updated_pred=True,
            id_base=sm.id_base(k), append_on=on(owner == g.shard_ids[k]),
            append_base=on(append_base), append_free=on(append_free),
        )
        m3 = clean(m2, upd, on(T), on(tick), cam, cfg.confidence_threshold,
                   cfg.time_delta, cfg.max_depth_processed, cfg.unstable_age,
                   do_compact=do_compact, fx16_patch=fx16)
        shards.append(m3)
        rows.append(torch.stack([m3.count.to(torch.int64), st.added.to(torch.int64)]))
        if matched is None:
            matched = st.matched.to(lead)
    table = g.all_gather(rows)
    counts = table[:, 0].to(torch.int32)
    stats = FuseStats(matched=matched, added=table[:, 1].sum().to(torch.int32),
                      count=counts.sum().to(torch.int32))
    return ShardedMap(tuple(shards), counts, g), stats


def clean_all(sm: ShardedMap, pidx: IndexPrediction, T, tick, cfg: EngineConfig,
              fx16: bool, do_compact: bool = True) -> ShardedMap:
    """`clean` on every sub-map against the replicated index prediction, and
    the counts' all-gather (ref closure section, shard_step.py:504-512)."""
    shards = []
    for m in sm.shards:
        dev = m.pos.device
        shards.append(clean(m, to_device(pidx, dev), T.to(dev), to_device(tick, dev),
                            cfg.camera, cfg.confidence_threshold, cfg.time_delta,
                            cfg.max_depth_processed, cfg.unstable_age,
                            do_compact=do_compact, fx16_patch=fx16))
    counts = sm.group.all_gather([m.count for m in shards]).to(torch.int32)
    return ShardedMap(tuple(shards), counts, sm.group)


def sample_nodes(sm: ShardedMap, rate: int):
    """The deformation node sample (position [M,3], init time [M]): every
    rate-th slot of each sub-map, slots past the local count at init time
    +inf, all-gathered and ordered by init time (ref shard_step.py:359-364
    and `_sorted_nodes`).  One sub-map's slot order is time order already:
    S = 1 takes the single-device sample unchanged."""
    if sm.group.S == 1:
        m = sm.shards[0]
        return _sample_every(m.pos, m.init_t, m.count, rate)[:2]
    parts = []
    for m in sm.shards:
        idx = torch.arange(0, m.capacity, rate, device=m.pos.device)
        live = idx < m.count
        p = torch.where(live[:, None], m.pos[:, idx].T, 0.0)
        t = torch.where(live, m.init_t[idx], float("inf"))
        parts.append(torch.cat([p, t[:, None]], dim=1))
    nodes = sm.group.all_gather(parts).reshape(-1, 4)
    order = torch.argsort(nodes[:, 3], stable=True)
    return nodes[order, :3], nodes[order, 3]


def inactive_count(sm: ShardedMap, tick, cfg: EngineConfig) -> torch.Tensor:
    """Live confident surfels that left the active window, over all shards
    (one SUM)."""
    parts = []
    for m in sm.shards:
        live = torch.arange(m.capacity, device=m.pos.device) < m.count
        parts.append(torch.sum(
            live & (m.conf >= cfg.confidence_threshold)
            & (m.last_t <= to_device(tick, m.pos.device) - cfg.time_delta)))
    return sm.group.sum(parts)


def grow(sm: ShardedMap, new_capacity: int) -> ShardedMap:
    """Every sub-map padded to `new_capacity / S` (ref `grow_sharded`)."""
    pad = new_capacity // sm.group.S - sm.cap_l
    grown = tuple(m._replace(**{f: torch.nn.functional.pad(getattr(m, f), (0, pad))
                                for f in _MAP_FIELDS}) for m in sm.shards)
    return sm._replace(shards=grown)


def make_shardmap_step(cfg: EngineConfig):
    """`engine.slam_step` with `cfg` bound, which takes a `ShardedMap` as it
    takes a one-device map (ref `make_shardmap_step`, shard_step.py:160):
    preprocessing, tracking and fill-in stay on the lead device.  Five
    collectives a frame: two per merged raster and the counts."""
    from ..engine import slam_step

    return functools.partial(slam_step, cfg=cfg)


def max_count(sm: ShardedMap) -> torch.Tensor:
    """The fullest shard's count: what the growth trigger watches."""
    return sm.counts.max()


def each(sm: ShardedMap, fn) -> ShardedMap:
    """`fn` applied to every local sub-map (the counts are unchanged)."""
    return sm._replace(shards=tuple(fn(m) for m in sm.shards))


def distribute_map(m: SurfelMap, group: MapGroup) -> ShardedMap:
    """A one-device map in the sub-map layout, round-robin: global slot j
    goes to shard j mod S, row j div S, so each shard's live rows form a
    dense prefix and the load balances from the first frame (ref
    `distribute_map`, shard_step.py:608).  Capacity must be a multiple of
    S."""
    S, cap = group.S, m.capacity
    if cap % S:
        raise ValueError(f"capacity {cap} is not a multiple of {S} shards")
    cap_l = cap // S
    dev = m.pos.device
    n = m.count.to(torch.int64).to(dev)
    counts = torch.clamp((n - torch.arange(S, device=dev) + S - 1) // S, 0, cap_l)
    shards = []
    for s, sdev in zip(group.shard_ids, group.devices):
        idx = torch.arange(cap_l, device=dev) * S + s
        shards.append(SurfelMap(
            **{f: getattr(m, f)[..., idx].to(sdev) for f in _MAP_FIELDS},
            count=counts[s].to(torch.int32).to(sdev)))
    return ShardedMap(tuple(shards), counts.to(torch.int32).to(group.lead), group)


def shard_empty_map(capacity: int, group: MapGroup,
                    first: Optional[SurfelMap] = None) -> ShardedMap:
    """An empty map of `capacity` surfels in S sub-maps (ref
    `shard_empty_map`, shard_step.py:650).  With `first`, a one-device map,
    its live prefix (as much as one shard holds) is booted into shard 0, so
    the global ids of its surfels are its slot numbers: the start of the
    reference's `tools/scaling_bench.py` (:221-240) and of its sharded-step
    test."""
    from ..surfels import empty_map

    sm = distribute_map(empty_map(capacity, group.lead), group)
    if first is None or 0 not in group.shard_ids:
        return sm
    k = group.shard_ids.index(0)
    n0 = min(int(first.count), sm.cap_l)
    s0 = sm.shards[k]
    dev = s0.pos.device
    booted = s0._replace(
        **{f: torch.cat([getattr(first, f)[..., :n0].to(dev),
                         getattr(s0, f)[..., n0:]], -1) for f in _MAP_FIELDS},
        count=torch.tensor(n0, dtype=torch.int32, device=dev))
    counts = sm.counts.clone()
    counts[0] = n0
    return sm._replace(shards=sm.shards[:k] + (booted,) + sm.shards[k + 1:],
                       counts=counts)


def gather(sm: ShardedMap) -> SurfelMap:
    """The sub-maps as ONE equivalent one-device map on the lead device:
    each shard's live prefix, in shard order, padded to the capacity (ref
    `gather_shard_map`, shard_step.py:673).  Shards of other processes come
    over the host."""
    from .._device import read_back

    counts = read_back(sm.counts)
    local = {sid: {f: getattr(m, f)[..., :int(counts[sid])].cpu().numpy()
                   for f in _MAP_FIELDS}
             for sid, m in zip(sm.group.shard_ids, sm.shards)}
    every = {}
    for part in sm.group.gather_objects(local):
        every.update(part)
    fields = {f: np.concatenate([every[s][f] for s in range(sm.group.S)], axis=-1)
              for f in _MAP_FIELDS}
    total, cap = int(counts.sum()), sm.capacity
    lead = sm.group.lead
    out = {f: torch.nn.functional.pad(torch.from_numpy(a), (0, cap - total)).to(lead)
           for f, a in fields.items()}
    return SurfelMap(**out, count=torch.tensor(total, dtype=torch.int32, device=lead))
