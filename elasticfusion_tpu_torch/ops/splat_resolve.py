"""K2 — splat resolve: the two-pass 5x5 ray/disk stencil of `combinedPredict`
(combo_splat.frag:37-60 behaviour; design in ops/splat.py).

Replaces the Pallas kernel `splat_resolve`
(elasticfusion_tpu/ops/splat_pallas.py:41-189).  On a CUDA tensor the wrapper
launches the hand-written kernel `csrc/splat_resolve.cu` (one block per image
tile, the haloed 13-channel slab staged once in shared memory, both passes
from there); on a CPU tensor it takes the plain version below.  Bound by
bytes: 13 channels read and 13 written.

Input channels `[13,H,W]`: p(3), n(3), rad, conf, col(3), init_t, valid.
Output channels `[13,H,W]`: col(3), vertex(3), conf, normal(3), rad, time,
depth — all zero where nothing hit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .._build import check_launch, kernel_function

R = 2             # stencil radius (5x5 footprint)
BLEND_EPS = 0.01  # m; occlusion boundaries stay crisp
_BIG = 3.4e38
# chan, out, H, W, fx, fy, cx, cy, stream
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p)


def splat_resolve_plain(chan: torch.Tensor, fx: float, fy: float, cx: float,
                        cy: float) -> torch.Tensor:
    """Plain version: 25 shifted slices of the zero-padded channels per pass,
    the kernel's arithmetic operation for operation."""
    C, H, W = chan.shape
    dev = chan.device
    P = F.pad(chan, (R, R, R, R))
    col = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    row = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    # divide by 0-d tensors: a Python-scalar divisor may be turned into a
    # multiplication by its reciprocal, which rounds differently from the
    # kernel's (and the reference's) true division
    fx_t = torch.tensor(fx, dtype=torch.float32, device=dev)
    fy_t = torch.tensor(fy, dtype=torch.float32, device=dev)
    lx = ((col - cx) / fx_t).expand(H, W)
    ly = ((row - cy) / fy_t).expand(H, W)
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((H, W), dtype=torch.float32, device=dev)

    def tap(c, dy, dx):
        return P[c, dy:dy + H, dx:dx + W]

    def candidate(dy, dx):
        px, py, pz = tap(0, dy, dx), tap(1, dy, dx), tap(2, dy, dx)
        nx, ny, nz = tap(3, dy, dx), tap(4, dy, dx), tap(5, dy, dx)
        rad = tap(6, dy, dx)
        ok = tap(12, dy, dx) > 0
        ln = lx * nx + ly * ny + nz
        pn = px * nx + py * ny + pz * nz
        ln_ok = torch.abs(ln) > 1e-12
        zc = pn / torch.where(ln_ok, ln, one)
        d2 = (zc * lx - px) ** 2 + (zc * ly - py) ** 2 + (zc - pz) ** 2
        hit = ok & ln_ok & (zc > 0) & (d2 <= rad * rad)
        return zc, d2, hit, rad

    offsets = [(dy, dx) for dy in range(2 * R + 1) for dx in range(2 * R + 1)]

    zmin = torch.full((H, W), _BIG, dtype=torch.float32, device=dev)
    for dy, dx in offsets:
        zc, _, hit, _ = candidate(dy, dx)
        zmin = torch.where(hit & (zc < zmin), zc, zmin)

    wsum = zero.clone()
    acc = [zero.clone() for _ in range(9)]
    wbest = zero.clone()
    it_best = zero.clone()
    src = (None, 7, 3, 4, 5, 6, 8, 9, 10)   # channel blended into acc[i]
    for dy, dx in offsets:
        zc, d2, hit, rad = candidate(dy, dx)
        conf = tap(7, dy, dx)
        front = hit & (zc <= zmin + BLEND_EPS)
        gauss = 1.0 - d2 / torch.clamp(rad * rad, min=1e-12)
        w = torch.where(
            front, torch.clamp(conf, min=1e-3) * torch.clamp(gauss, min=0.05),
            zero,
        )
        wsum = wsum + w
        acc[0] = acc[0] + w * zc
        for i in range(1, 9):
            acc[i] = acc[i] + w * tap(src[i], dy, dx)
        take = w > wbest
        it_best = torch.where(take, tap(11, dy, dx), it_best)
        wbest = torch.maximum(w, wbest)

    found = wsum > 0
    inv_w = torch.where(found, 1.0 / torch.clamp(wsum, min=1e-12), zero)
    zed = acc[0] * inv_w
    nx, ny, nz = acc[2] * inv_w, acc[3] * inv_w, acc[4] * inv_w
    nlen = torch.sqrt(nx * nx + ny * ny + nz * nz)
    nscale = torch.where(found & (nlen > 1e-12),
                         1.0 / torch.clamp(nlen, min=1e-12), zero)
    return torch.stack([
        acc[6] * inv_w, acc[7] * inv_w, acc[8] * inv_w,
        zed * lx, zed * ly, zed,
        acc[1] * inv_w,
        nx * nscale, ny * nscale, nz * nscale,
        acc[5] * inv_w,
        it_best,
        zed,
    ])


def splat_resolve(chan: torch.Tensor, fx: float, fy: float, cx: float,
                  cy: float) -> torch.Tensor:
    """chan `[13,H,W]` f32 packed winner channels → `[13,H,W]` packed
    prediction (see module docstring for both channel orders)."""
    if chan.dim() != 3 or chan.shape[0] != 13 or chan.dtype != torch.float32:
        raise ValueError(f"splat_resolve wants [13,H,W] float32, got "
                         f"{tuple(chan.shape)} {chan.dtype}")
    if chan.device.type == "cpu":
        return splat_resolve_plain(chan, fx, fy, cx, cy)
    if chan.device.type != "cuda":
        raise ValueError(f"splat_resolve: unsupported device {chan.device}")
    if not chan.is_contiguous():
        raise ValueError("splat_resolve: chan must be contiguous")

    fn = kernel_function("splat_resolve", "ef_splat_resolve", _ARGTYPES)
    _, H, W = chan.shape
    out = torch.empty_like(chan)
    with torch.cuda.device(chan.device):
        code = fn(chan.data_ptr(), out.data_ptr(), H, W, fx, fy, cx, cy,
                  torch.cuda.current_stream().cuda_stream)
    check_launch(code, "splat_resolve")
    return out
