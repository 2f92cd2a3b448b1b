"""Map prediction by surfel splatting — the equivalent of `IndexMap`
(Core/IndexMap.cpp) and its GLSL programs (index_map.vert/frag, splat.vert,
combo_splat.frag).

Two stages, as in the reference package:
  1. *Point pass*: every surfel projects to one pixel; a z-buffer resolves a
     winner-surfel-id image.  The tie-break is semantics: the winner is the
     surfel with the smallest 13-bit quantized depth, ties to the lowest id.
  2. *Splat resolve* (K2, ops/splat_resolve.py): each output pixel examines
     the winners of its 5x5 neighbourhood by ray/disk intersection.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import CameraConfig
from .surfels import SurfelMap
from .splat_resolve import splat_resolve

INVALID_ID = 2147483647
_ZB = 13
_EMPTY_KEY = torch.iinfo(torch.int64).max


class IndexPrediction(NamedTuple):
    """predictIndices output — the original's index/vertConf/colorTime/normRad
    render targets (index_map.frag:31-37) as pixel-domain images."""

    index: torch.Tensor    # [H, W] i32 surfel id, -1 where empty
    vert: torch.Tensor     # [3, H, W] camera-frame surfel position
    normal: torch.Tensor   # [3, H, W] camera-frame surfel normal
    radius: torch.Tensor   # [H, W]
    conf: torch.Tensor     # [H, W]
    init_t: torch.Tensor   # [H, W] creation tick (colorTime.z)
    last_t: torch.Tensor   # [H, W] last-seen tick (colorTime.w)


class Prediction(NamedTuple):
    """combinedPredict output (camera frame), mirroring the 4 render targets
    of combo_splat.frag: image, vertex+conf, normal+radius, init-time."""

    image: torch.Tensor    # [H, W, 3] f32 RGB 0..255
    vertex: torch.Tensor   # [3, H, W] camera-frame positions (0 = empty)
    conf: torch.Tensor     # [H, W]
    normal: torch.Tensor   # [3, H, W]
    radius: torch.Tensor   # [H, W]
    time: torch.Tensor     # [H, W] f32 surfel init time (colTime.z)
    depth: torch.Tensor    # [H, W] perspective-corrected depth


def _camera_frame(m: SurfelMap, T_wc: torch.Tensor):
    T_cw_R = T_wc[:3, :3].T
    t = T_wc[:3, 3]
    pos_c = T_cw_R @ (m.pos - t[:, None])
    normal_c = T_cw_R @ m.normal
    return pos_c, normal_c


def _point_keys(
    pos_c: torch.Tensor,
    valid: torch.Tensor,
    cam: CameraConfig,
    slot_live: torch.Tensor,
    id_base: int = 0,
) -> torch.Tensor:
    """Per-pixel minimum raster key `quantized depth << 32 | (id_base + slot)`
    over the surfels that project there, `[H*W]` int64, `_EMPTY_KEY` where
    none does (see `_point_raster`).  With `id_base` a shard's first global
    id, the minimum over the shards' key images is the key the whole map
    gives."""
    H, W = cam.height, cam.width
    N = pos_c.shape[1]
    z = pos_c[2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    u = torch.floor(pos_c[0] * cam.fx / safe_z + cam.cx).to(torch.int64)
    v = torch.floor(pos_c[1] * cam.fy / safe_z + cam.cy).to(torch.int64)
    ok = valid & slot_live & (z > 0) & (u >= 0) & (v >= 0) & (u < W) & (v < H)
    pix = torch.where(ok, v * W + u, torch.full_like(u, H * W))  # spill slot

    ids = torch.arange(N, dtype=torch.int64, device=z.device) + id_base
    zq = torch.clamp((z * (8192.0 / 20.0)).to(torch.int64), 0, (1 << _ZB) - 1)
    key = (zq << 32) | ids
    best = torch.full((H * W + 1,), _EMPTY_KEY, dtype=torch.int64, device=z.device)
    best.scatter_reduce_(0, pix, key, reduce="amin", include_self=True)
    return best[: H * W]


def winner_ids(best: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Raster keys → winner id image [H,W] (int64, INVALID_ID where empty)."""
    winner = torch.where(best == _EMPTY_KEY,
                         torch.full_like(best, INVALID_ID), best & 0xFFFFFFFF)
    return winner.reshape(cam.height, cam.width)


def _point_raster(
    pos_c: torch.Tensor,
    valid: torch.Tensor,
    cam: CameraConfig,
    slot_live: torch.Tensor,
) -> torch.Tensor:
    """z-buffer of 1-px points → winner id image [H,W] (int64, INVALID_ID
    where empty).  Replaces the GL depth-tested point render of
    index_map.vert.

    Every surfel carries the key `quantized depth << 32 | id`; a per-pixel
    minimum over the keys (`scatter_reduce_(amin)`, exact on integers, so
    independent of the order in which surfels arrive) picks the smallest
    13-bit depth bucket and, inside a bucket, the lowest surfel id — the
    order the reference package's stable sort on (pixel, depth bucket)
    yields.  The quantization (20 m over 2^13 buckets) only coarsens the
    tie-break; all downstream geometry uses exact values."""
    return winner_ids(_point_keys(pos_c, valid, cam, slot_live), cam)


def _gather_rows(rows, winner: torch.Tensor, N: int):
    """Stack per-surfel rows and gather them at the winner image; empty
    pixels read zero.  Returns ([C,H,W], empty [H,W])."""
    H, W = winner.shape
    empty = (winner == INVALID_ID).reshape(-1)
    idx = torch.where(empty, torch.zeros_like(empty, dtype=torch.int64),
                      torch.clamp(winner.reshape(-1), 0, N - 1))
    ch = torch.cat(rows)[:, idx]
    ch = torch.where(empty[None], torch.zeros_like(ch), ch)
    return ch.reshape(-1, H, W), empty.reshape(H, W)


def predict_indices(
    m: SurfelMap,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    time,
    time_delta: int,
    max_depth: float,
) -> IndexPrediction:
    """IndexMap::predictIndices (IndexMap.cpp:190-258 + index_map.vert):
    render every in-time-window surfel as a point; no confidence gate.
    Empty pixels are an explicit -1."""
    pos_c, normal_c = _camera_frame(m, T_wc)
    N = m.capacity
    live = torch.arange(N, device=m.pos.device) < m.count
    # index_map.vert:45: discard if z > maxDepth || z < 0 || time - last > delta
    gate = (pos_c[2] <= max_depth) & ((time - m.last_t) <= time_delta)
    winner = _point_raster(pos_c, gate, cam, live)

    ch, _ = _gather_rows(
        (pos_c, normal_c, m.radius[None], m.conf[None], m.init_t[None],
         m.last_t[None]), winner, N)
    return IndexPrediction(
        index=torch.where(winner == INVALID_ID, torch.full_like(winner, -1),
                          winner).to(torch.int32),
        vert=ch[0:3], normal=ch[3:6], radius=ch[6], conf=ch[7],
        init_t=ch[8], last_t=ch[9],
    )


def combined_predict(
    m: SurfelMap,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    time,
    max_time,
    time_delta: int,
    conf_threshold: float,
    max_depth: float,
) -> Prediction:
    """IndexMap::combinedPredict (IndexMap.cpp:293-393) — splat-render the
    image/vertex/normal/time prediction.  Gates from splat.vert:57:
    z in (0, maxDepth], conf >= confThreshold, time - last <= timeDelta,
    last <= maxTime.  ACTIVE vs INACTIVE model halves are selected purely by
    the (time, maxTime) arguments."""
    pos_c, normal_c = _camera_frame(m, T_wc)
    N = m.capacity
    live = torch.arange(N, device=m.pos.device) < m.count
    gate = (
        (pos_c[2] <= max_depth)
        & (m.conf >= conf_threshold)
        & ((time - m.last_t) <= time_delta)
        & (m.last_t <= max_time)
    )
    pid = _point_raster(pos_c, gate, cam, live)
    # channel order of K2's input: p(3) n(3) rad conf col(3) init_t [valid]
    ch, empty = _gather_rows(
        (pos_c, normal_c, m.radius[None], m.conf[None], m.color,
         m.init_t[None]), pid, N)
    return splat_resolve_images(ch, empty, cam)


def splat_resolve_images(ch: torch.Tensor, empty: torch.Tensor,
                         cam: CameraConfig) -> Prediction:
    """The splat-resolve stage of combinedPredict on the 12 winner channel
    images `[12,H,W]` (p3, n3, rad, conf, col3, init_t) and their empty mask:
    appends the validity plane and runs K2."""
    valid = (~empty & (ch[2] > 0)).to(torch.float32)
    chan = torch.cat([ch, valid[None]])
    out = splat_resolve(chan, cam.fx, cam.fy, cam.cx, cam.cy)
    return Prediction(
        image=out[0:3].permute(1, 2, 0).contiguous(),
        vertex=out[3:6],
        conf=out[6],
        normal=out[7:10],
        radius=out[10],
        time=out[11],
        depth=out[12],
    )


def synthesize_info(
    m: SurfelMap,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    conf_threshold: float,
    max_depth: float,
) -> Prediction:
    """IndexMap::synthesizeInfo (IndexMap.cpp:478-556): splat prediction with
    no time window — every confident surfel renders regardless of age."""
    return combined_predict(
        m, T_wc, cam, time=0.0, max_time=3.4e38, time_delta=2 ** 30,
        conf_threshold=conf_threshold, max_depth=max_depth,
    )


def synthesize_depth(
    m: SurfelMap,
    T_wc: torch.Tensor,
    cam: CameraConfig,
    time,
    max_time,
    time_delta: int,
    conf_threshold: float,
    max_depth: float,
) -> torch.Tensor:
    """IndexMap::synthesizeDepth (IndexMap.cpp:395-476, depth_splat.frag):
    the depth of a splat prediction with combinedPredict's gates, used for
    the timestamp refresh after a deformation."""
    return combined_predict(
        m, T_wc, cam, time, max_time, time_delta, conf_threshold, max_depth,
    ).depth
