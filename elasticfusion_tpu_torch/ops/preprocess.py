"""Depth/RGB preprocessing ops — equivalents of the original system's GLSL
ComputePacks and CUDA pyramid kernels.

Behaviour being matched:
  - bilateral depth filter: Core/Shaders/depth_bilateral.frag (ops/bilateral.py)
  - metric conversion:      depth_metric.frag (gate <300 mm or >maxD)
  - vmap/nmap creation:     Core/Cuda/cudafuncs.cu:128-229
  - depth pyrDown w/ 3σ rejection, σ=30 mm: cudafuncs.cu:77-121
  - 5×5 Gaussian {1,4,6,4,1} pyrDown: cudafuncs.cu:393-558
  - vmap/nmap 2×2-average resize: cudafuncs.cu:414-505
  - BGR→intensity 0.114/0.299/0.587: cudafuncs.cu:583-595
  - Scharr-like derivatives ±0.52201/±0.79451: cudafuncs.cu:613-667

Invalid pixels are 0-depth / zero vectors (no NaN sentinels); vmaps/nmaps are
channels-first `[3, H, W]` float32.  Stencils are unrolled shifted adds on
zero-padded arrays, taps in the reference's order so that float sums agree.
Borders are zero-filled shifts (not wrap, not replicate), and no convolution
library is involved, so no TF32 path can be taken.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..config import CameraConfig
from ..surfels import pixel_grid, recip32

# 5-tap binomial weights used by both pyrDown flavours (cudafuncs.cu:97, 512)
_GAUSS5 = (1.0, 4.0, 6.0, 4.0, 1.0)
# per-|offset| weights of the depth pyrDown (cudafuncs.cu:96)
_DEPTH_W = (0.0625, 0.25, 0.375, 0.25, 0.0625)


class _Padded:
    """An image zero-padded by `r` on each side of its last two dims, plus
    the matching inside-the-image mask; `tap(dy, dx)` is the value at
    (y+dy, x+dx) with zeros outside."""

    def __init__(self, x: torch.Tensor, r: int, with_mask: bool = True):
        self.H, self.W, self.r = x.shape[-2], x.shape[-1], r
        self.xp = F.pad(x, (r, r, r, r))
        self.mp = F.pad(torch.ones_like(x), (r, r, r, r)) if with_mask else None

    def _cut(self, p, dy, dx):
        r = self.r
        return p[..., r + dy:r + dy + self.H, r + dx:r + dx + self.W]

    def tap(self, dy: int, dx: int) -> torch.Tensor:
        return self._cut(self.xp, dy, dx)

    def inside(self, dy: int, dx: int) -> torch.Tensor:
        return self._cut(self.mp, dy, dx)


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


def _subsample2(x: torch.Tensor) -> torch.Tensor:
    """x[::2, ::2] over the even-cropped image."""
    H, W = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    return x[..., :H:2, :W:2].contiguous()


def pyr_down_depth(depth_m: torch.Tensor, sigma_color: float = 0.03) -> torch.Tensor:
    """Depth half-resolution downsample with 3σ rejection (σ=30 mm),
    matching pyrDownGaussKernel (cudafuncs.cu:77-121) but in metres."""
    center = depth_m
    pad = _Padded(depth_m, 2)
    num = torch.zeros_like(center)
    den = torch.zeros_like(center)
    zero = torch.zeros_like(center)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            nb = pad.tap(dy, dx)
            w = _DEPTH_W[dy + 2] * _DEPTH_W[dx + 2]
            keep = (torch.abs(nb - center) < 3.0 * sigma_color) & (pad.inside(dy, dx) > 0)
            num = num + torch.where(keep, nb * w, zero)
            den = den + torch.where(keep, torch.full_like(center, w), zero)
    full = torch.where(den > 0, num / torch.clamp(den, min=1e-12), zero)
    return _subsample2(full)


def pyr_down_gauss(img: torch.Tensor) -> torch.Tensor:
    """5×5 {1,4,6,4,1} Gaussian half-res downsample for float images with
    0-as-invalid masking (pyrDownKernelGaussF, cudafuncs.cu:393-411)."""
    pad = _Padded(img, 2, with_mask=False)
    vpad = _Padded((img > 0).to(torch.float32), 2, with_mask=False)
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            w = _GAUSS5[dy + 2] * _GAUSS5[dx + 2]
            m = vpad.tap(dy, dx)
            num = num + pad.tap(dy, dx) * m * w
            den = den + m * w
    return _subsample2(
        torch.where(den > 0, num / torch.clamp(den, min=1e-12), torch.zeros_like(img))
    )


def pyr_down_intensity(img: torch.Tensor) -> torch.Tensor:
    """Plain 5×5 Gaussian downsample for intensity images
    (pyrDownKernelIntensityGauss, cudafuncs.cu:516-540)."""
    f = img.to(torch.float32)
    pad = _Padded(f, 2)
    num = torch.zeros_like(f)
    den = torch.zeros_like(f)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            w = _GAUSS5[dy + 2] * _GAUSS5[dx + 2]
            inside = pad.inside(dy, dx)
            num = num + pad.tap(dy, dx) * w * inside
            den = den + w * inside
    return _subsample2(num / torch.clamp(den, min=1e-12))


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


def compute_derivatives(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scharr-like image gradients (applyKernel + gsobel constants,
    cudafuncs.cu:613-667); effective correlation kernels
      dx: [[-a,0,a],[-b,0,b],[-a,0,a]],  dy: dxᵀ   (a=0.52201, b=0.79451).
    Out-of-bounds neighbours are skipped.  Returns truncated float32."""
    a, b = 0.52201, 0.79451
    f = img.to(torch.float32)
    pad = _Padded(f, 1)
    dxv = torch.zeros_like(f)
    dyv = torch.zeros_like(f)
    for (dy, dx, wx, wy) in [
        (-1, -1, -a, -a), (-1, 0, 0.0, -b), (-1, 1, a, -a),
        (0, -1, -b, 0.0), (0, 1, b, 0.0),
        (1, -1, -a, a), (1, 0, 0.0, b), (1, 1, a, a),
    ]:
        nb, m = pad.tap(dy, dx), pad.inside(dy, dx)
        dxv = dxv + wx * nb * m
        dyv = dyv + wy * nb * m
    return torch.trunc(dxv), torch.trunc(dyv)


def vertices_to_depth(vmap: torch.Tensor, cutoff: float = 6.0) -> torch.Tensor:
    """Extract the z channel with a cutoff (verticesToDepthKernel,
    cudafuncs.cu:563-580; maxDepthRGB=6 m)."""
    z = vmap[2]
    return torch.where((z > cutoff) | (z <= 0), torch.zeros_like(z), z)
