"""Surfel map state — the equivalent of `GlobalModel` (Core/GlobalModel.{h,cpp}).

A structure of arrays with the reference package's field names and layouts:
vector fields `[3, N]`, scalar fields `[N]`, `count` a 0-d int32 tensor on the
same device; slots `>= count` are dead and hold zeros.  Colors are planar
float RGB `[3, N]`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .config import CameraConfig


class SurfelMap(NamedTuple):
    """Fixed-capacity surfel store.  Dead slots (index >= count) hold zeros."""

    pos: torch.Tensor      # [3, N] world-frame position, f32
    conf: torch.Tensor     # [N] confidence, f32
    color: torch.Tensor    # [3, N] RGB 0..255, f32
    init_t: torch.Tensor   # [N] creation tick, f32
    last_t: torch.Tensor   # [N] last-seen tick, f32
    normal: torch.Tensor   # [3, N] world-frame unit normal, f32
    radius: torch.Tensor   # [N] surfel disk radius (m), f32
    count: torch.Tensor    # scalar i32, live surfels in [0, count)

    @property
    def capacity(self) -> int:
        return self.pos.shape[1]


def empty_map(capacity: int, device=None) -> SurfelMap:
    dev = torch.device(device or "cpu")
    z1 = lambda: torch.zeros((capacity,), dtype=torch.float32, device=dev)  # noqa: E731
    z3 = lambda: torch.zeros((3, capacity), dtype=torch.float32, device=dev)  # noqa: E731
    return SurfelMap(
        pos=z3(), conf=z1(), color=z3(), init_t=z1(), last_t=z1(),
        normal=z3(), radius=z1(),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def recip32(c: float) -> float:
    """The float32 reciprocal of a constant divisor.  XLA folds `x / c` into
    `x * (1/c)`, and PyTorch does the same for a CUDA tensor; multiplying by
    this makes a CPU tensor round alike (a true division differs by one ulp
    at many values)."""
    return float(np.float32(1.0) / np.float32(c))


def pixel_grid(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, v) float32 pixel coordinate images, each [H, W]."""
    v, u = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return u, v


# ---------------------------------------------------------------------------
# Surfel measurement model (surfels.glsl)
# ---------------------------------------------------------------------------


def surfel_radius(depth: torch.Tensor, norm_z: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Disk radius from depth and view-aligned normal z (surfels.glsl:19-34):
    r = sqrt2 * z / meanFocal, inflated by 1/|n_z| clamped to 2x."""
    mean_focal = (cam.fx + cam.fy) * 0.5
    r = depth * (1.41421356237 / mean_focal)
    rn = r / torch.clamp(torch.abs(norm_z), min=1e-12)
    return torch.minimum(2.0 * r, rn)


def pixel_confidence(x: torch.Tensor, y: torch.Tensor, weighting, cam: CameraConfig) -> torch.Tensor:
    """Gaussian radial-falloff measurement confidence (surfels.glsl:36-46),
    with the maximum radius derived from the intrinsics."""
    max_rad = math.sqrt(cam.cx * cam.cx + cam.cy * cam.cy)
    two_sigma_sq = 0.72  # 2 * 0.6^2, from the paper
    r2 = ((x - cam.cx) ** 2 + (y - cam.cy) ** 2) * recip32(max_rad * max_rad)
    return torch.exp(-r2 * recip32(two_sigma_sq)) * weighting


def central_diff_normals(
    depth_m: torch.Tensor, cam: CameraConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference normal map from a float depth image, matching
    geometry.glsl getNormal(sampler2D): n = normalize(cross(v(x-1)-v(x+1),
    v(y-1)-v(y+1))) — note the backward-minus-forward orientation.

    Returns (normal [3,H,W], valid [H,W]); border/flat pixels invalid."""
    H, W = depth_m.shape
    u, v = pixel_grid(H, W, depth_m.device)

    def vert(du, dv):
        # wrap-around of roll only reaches border pixels, which are invalid
        z = torch.roll(depth_m, shifts=(-dv, -du), dims=(0, 1))
        return torch.stack(
            [(u + du - cam.cx) * z * recip32(cam.fx),
             (v + dv - cam.cy) * z * recip32(cam.fy), z]
        )

    del_x = vert(-1, 0) - vert(1, 0)
    del_y = vert(0, -1) - vert(0, 1)
    n = torch.linalg.cross(del_x * 0.5, del_y * 0.5, dim=0)
    norm = torch.sqrt(torch.sum(n * n, dim=0, keepdim=True))
    n = n / torch.clamp(norm, min=1e-12)
    interior = (u > 0) & (u < W - 1) & (v > 0) & (v < H - 1)
    valid = interior & (norm[0] > 1e-12) & (depth_m > 0)
    return torch.where(valid[None], n, torch.zeros_like(n)), valid


def init_map_from_frame(
    capacity: int,
    depth_raw_m: torch.Tensor,       # [H,W] metric raw depth
    depth_filtered_m: torch.Tensor,  # [H,W] metric bilateral-filtered depth
    rgb: torch.Tensor,               # [H,W,3] u8
    cam: CameraConfig,
    max_depth: float,
) -> SurfelMap:
    """First-frame map bootstrap — GlobalModel::initialise
    (GlobalModel.cpp:229-284, vertex_feedback.vert): position + color from RAW
    depth, normal + radius from FILTERED depth, init time 1, confidence
    weighting 1.  Valid pixels fill slots [0, n) in raster order; pixels beyond
    the capacity are dropped."""
    H, W = depth_raw_m.shape
    dev = depth_raw_m.device
    u, v = pixel_grid(H, W, dev)
    z = depth_raw_m
    pos = torch.stack(
        [(u - cam.cx) * z * recip32(cam.fx), (v - cam.cy) * z * recip32(cam.fy), z]
    ).reshape(3, -1)
    normal, nvalid = central_diff_normals(depth_filtered_m, cam)
    rad = surfel_radius(depth_filtered_m, normal[2], cam)
    conf = pixel_confidence(u, v, 1.0, cam)

    valid = ((z > 0) & (z <= max_depth) & nvalid).reshape(-1)
    n_px = H * W
    one = torch.ones((n_px,), dtype=torch.float32, device=dev)
    rows = torch.cat([
        pos, conf.reshape(1, -1), rgb.reshape(-1, 3).T.to(torch.float32),
        one[None], one[None], normal.reshape(3, -1), rad.reshape(1, -1),
    ])                                                        # [13, n_px]
    # unique destinations for valid pixels; everything else lands in one
    # spill column past the capacity that is cut off again
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    dest = torch.where(valid & (rank < capacity), rank,
                       torch.full_like(rank, capacity))
    packed = torch.zeros((13, capacity + 1), dtype=torch.float32, device=dev)
    packed[:, dest] = rows
    count = torch.clamp(valid.sum(), max=capacity).to(torch.int32)
    return unpack_map(packed[:, :capacity], count)


def pack_map(m: SurfelMap) -> torch.Tensor:
    """The 13 per-surfel channels as one [13, N] tensor (pos3, conf, color3,
    init_t, last_t, normal3, radius)."""
    return torch.cat([
        m.pos, m.conf[None], m.color, m.init_t[None], m.last_t[None],
        m.normal, m.radius[None],
    ])


def unpack_map(p: torch.Tensor, count: torch.Tensor) -> SurfelMap:
    """Inverse of `pack_map`."""
    return SurfelMap(
        pos=p[0:3].contiguous(), conf=p[3].contiguous(),
        color=p[4:7].contiguous(), init_t=p[7].contiguous(),
        last_t=p[8].contiguous(), normal=p[9:12].contiguous(),
        radius=p[12].contiguous(), count=count,
    )


def compact(m: SurfelMap, keep: torch.Tensor) -> SurfelMap:
    """Drop surfels where `keep` is False, preserving order — the equivalent
    of transform-feedback stream compaction (copy_unstable.geom:33-43).

    A stable sort on the dead flag moves kept rows to the front in order; one
    gather of the 13 packed channels follows the permutation.  Dead rows are
    zeroed so downstream masks (`z>0`, `conf>0`) behave as before."""
    cap = m.capacity
    slot = torch.arange(cap, device=keep.device)
    keep = keep & (slot < m.count)
    _, perm = torch.sort((~keep).to(torch.int8), stable=True)
    packed = (pack_map(m) * keep.to(torch.float32)[None])[:, perm]
    return unpack_map(packed, keep.sum().to(torch.int32))
