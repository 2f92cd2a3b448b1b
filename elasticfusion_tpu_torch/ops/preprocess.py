"""Depth/RGB preprocessing ops — equivalents of the original system's GLSL
ComputePacks and CUDA pyramid kernels.

Behaviour being matched:
  - bilateral depth filter: Core/Shaders/depth_bilateral.frag (ops/bilateral.py)
  - metric conversion:      depth_metric.frag (gate <300 mm or >maxD)
  - vmap/nmap creation:     Core/Cuda/cudafuncs.cu:128-229
  - depth pyrDown w/ 3σ rejection, σ=30 mm: cudafuncs.cu:77-121 (ops/pyramid.py)
  - 5×5 Gaussian {1,4,6,4,1} pyrDown: cudafuncs.cu:393-558 (ops/pyramid.py)
  - vmap/nmap 2×2-average resize: cudafuncs.cu:414-505
  - BGR→intensity 0.114/0.299/0.587: cudafuncs.cu:583-595
  - Scharr-like derivatives ±0.52201/±0.79451: cudafuncs.cu:613-667 (ops/pyramid.py)

Invalid pixels are 0-depth / zero vectors (no NaN sentinels); vmaps/nmaps are
channels-first `[3, H, W]` float32.  Stencils are unrolled shifted adds on
zero-padded arrays, taps in the reference's order so that float sums agree.
Borders are zero-filled shifts (not wrap, not replicate), and no convolution
library is involved, so no TF32 path can be taken.
"""

from __future__ import annotations

import torch

from ..config import CameraConfig
from ..surfels import pixel_grid, recip32
from .pyramid import _Padded


def shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Value of x at (y+dy, x+dx) with zero padding, same shape as x."""
    return _Padded(x, max(abs(dy), abs(dx)), with_mask=False).tap(dy, dx)


def metricise_depth(depth_mm: torch.Tensor, max_depth: float = 20.0) -> torch.Tensor:
    """uint16 mm → float32 m, with the same <300 mm / >maxD gate → 0
    (depth_metric.frag)."""
    d = depth_mm.to(torch.float32)
    gate = (d > max_depth * 1000.0) | (d < 300.0)
    return torch.where(gate, torch.zeros_like(d), d * recip32(1000.0))


def compute_vmap(
    depth_m: torch.Tensor, cam: CameraConfig, depth_cutoff: float
) -> torch.Tensor:
    """Back-project metric depth into a camera-frame vertex map [3,H,W]
    (computeVmapKernel, cudafuncs.cu:121-148); invalid (z==0 or z>=cutoff) →
    all-zero column."""
    H, W = depth_m.shape
    u, v = pixel_grid(H, W, depth_m.device)
    z = depth_m
    valid = (z > 0.0) & (z < depth_cutoff)
    vx = z * (u - cam.cx) * (1.0 / cam.fx)
    vy = z * (v - cam.cy) * (1.0 / cam.fy)
    vmap = torch.stack([vx, vy, z])
    return torch.where(valid[None], vmap, torch.zeros_like(vmap))


def vmap_valid(vmap: torch.Tensor) -> torch.Tensor:
    """Validity mask of a [3,H,W] vertex map: z>0."""
    return vmap[2] > 0.0


def compute_nmap(vmap: torch.Tensor) -> torch.Tensor:
    """Normal map from forward differences (computeNmapKernel,
    cudafuncs.cu:170-214): n = normalize(cross(v(x+1)−v, v(y+1)−v)); last
    row/col and any-invalid-neighbour → zero normal."""
    v00 = vmap
    v01 = torch.roll(vmap, -1, dims=2)  # (x+1); the wrapped column is an edge
    v10 = torch.roll(vmap, -1, dims=1)  # (y+1)
    n = torch.linalg.cross(v01 - v00, v10 - v00, dim=0)
    norm = torch.sqrt(torch.sum(n * n, dim=0, keepdim=True))
    n = n / torch.clamp(norm, min=1e-12)
    H, W = vmap.shape[1], vmap.shape[2]
    u, v = pixel_grid(H, W, vmap.device)
    edge = (u == W - 1) | (v == H - 1)
    valid = (
        vmap_valid(v00) & vmap_valid(v01) & vmap_valid(v10) & ~edge & (norm[0] > 1e-12)
    )
    return torch.where(valid[None], n, torch.zeros_like(n))


def resize_vmap(vmap: torch.Tensor) -> torch.Tensor:
    """2×2-average half-res resize of a [3,H,W] vertex map; any invalid source
    → invalid (resizeMapKernel<false>, cudafuncs.cu:414-479)."""
    return _resize_map(vmap, normalize=False)


def resize_nmap(nmap: torch.Tensor) -> torch.Tensor:
    """Same as resize_vmap but renormalized (resizeMapKernel<true>)."""
    return _resize_map(nmap, normalize=True)


def _resize_map(m: torch.Tensor, normalize: bool) -> torch.Tensor:
    H2, W2 = (m.shape[1] // 2) * 2, (m.shape[2] // 2) * 2
    m = m[:, :H2, :W2]
    x00 = m[:, 0::2, 0::2]
    x01 = m[:, 0::2, 1::2]
    x10 = m[:, 1::2, 0::2]
    x11 = m[:, 1::2, 1::2]
    if normalize:
        vs = [torch.sum(x * x, dim=0) > 1e-24 for x in (x00, x01, x10, x11)]
    else:
        vs = [x[2] > 0 for x in (x00, x01, x10, x11)]
    valid = vs[0] & vs[1] & vs[2] & vs[3]
    avg = (x00 + x01 + x10 + x11) * 0.25
    if normalize:
        norm = torch.sqrt(torch.sum(avg * avg, dim=0, keepdim=True))
        avg = avg / torch.clamp(norm, min=1e-12)
    return torch.where(valid[None], avg, torch.zeros_like(avg))


def rgb_to_intensity(rgb: torch.Tensor) -> torch.Tensor:
    """[H,W,3] RGB → float32 intensity, truncated to int like the original
    (bgr2IntensityKernel: 0.114 b + 0.299 r + 0.587 g, cast to u8)."""
    r = rgb[..., 0].to(torch.float32)
    g = rgb[..., 1].to(torch.float32)
    b = rgb[..., 2].to(torch.float32)
    return torch.floor(0.299 * r + 0.587 * g + 0.114 * b)


SOBEL_SCALE = 1.0 / 8.0  # sobelScale = 1/2^sobelSize, RGBDOdometry.cpp:39-40


def vertices_to_depth(vmap: torch.Tensor, cutoff: float = 6.0) -> torch.Tensor:
    """Extract the z channel with a cutoff (verticesToDepthKernel,
    cudafuncs.cu:563-580; maxDepthRGB=6 m)."""
    z = vmap[2]
    return torch.where((z > cutoff) | (z <= 0), torch.zeros_like(z), z)
