"""The bilateral filter on raw depth (depth_bilateral.frag): 13x13 window,
sigma_space = 4.5, sigma_colour = 30 mm, gate `value > maxD*1000 || value <
300` -> 0.

Replaces no Pallas kernel: the reference's filter is plain JAX, which XLA
fuses into one loop.  On a CUDA tensor the wrapper launches the hand-written
kernel `csrc/bilateral.cu` (one block per 32x8 image tile, the tile and its
radius halo staged once in shared memory, one thread per output pixel; bound
by operations, one `expf` a tap); on a CPU tensor it takes the plain version
below, an unrolled stencil of shifted slices that is 2,041 elementwise
operations at radius 6.  The kernel repeats the plain version's arithmetic
in its order, so the two are bit-identical on a card.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import check_launch, kernel_function
from .pyramid import _Padded

SIGMA_SPACE2_INV_HALF = 0.024691358   # 1 / (2 * 4.5^2), per squared pixel
SIGMA_COLOR2_INV_HALF = 0.000555556   # 1 / (2 * 30^2), per squared mm
# depth, out, H, W, radius, space factor, colour factor, max depth mm, stream
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_double, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p)


def bilateral_filter_plain(
    depth_mm: torch.Tensor, max_depth: float = 20.0, radius: int = 6
) -> torch.Tensor:
    """Plain version: one shifted slice of the zero-padded image a tap,
    out-of-image taps masked out of the weights (the shader clamps its
    loop)."""
    center = depth_mm.to(torch.float32)
    pad = _Padded(center, radius)
    num = torch.zeros_like(center)
    den = torch.zeros_like(center)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = pad.tap(dy, dx)
            space2 = float(dy * dy + dx * dx)
            color2 = (center - nb) * (center - nb)
            w = torch.exp(-(space2 * SIGMA_SPACE2_INV_HALF
                            + color2 * SIGMA_COLOR2_INV_HALF))
            inside = pad.inside(dy, dx)
            num = num + nb * w * inside
            den = den + w * inside
    out = torch.round(num / torch.clamp(den, min=1e-12))
    gate = (center > max_depth * 1000.0) | (center < 300.0)
    return torch.where(gate, torch.zeros_like(out), out)


def bilateral_filter(
    depth_mm: torch.Tensor, max_depth: float = 20.0, radius: int = 6
) -> torch.Tensor:
    """Raw depth `[H,W]` in millimetres (any real dtype) -> the filtered
    depth, float32 whole millimetres."""
    if depth_mm.dim() != 2:
        raise ValueError(f"bilateral_filter wants [H,W], got {tuple(depth_mm.shape)}")
    if radius < 0:
        raise ValueError(f"bilateral_filter: radius {radius} < 0")
    if depth_mm.device.type == "cpu":
        return bilateral_filter_plain(depth_mm, max_depth, radius)
    if depth_mm.device.type != "cuda":
        raise ValueError(f"bilateral_filter: unsupported device {depth_mm.device}")
    depth = depth_mm.to(torch.float32).contiguous()
    H, W = depth.shape
    fn = kernel_function("bilateral", "ef_bilateral", _ARGTYPES)
    out = torch.empty((H, W), dtype=torch.float32, device=depth.device)
    with torch.cuda.device(depth.device):
        code = fn(depth.data_ptr(), out.data_ptr(), H, W, radius,
                  SIGMA_SPACE2_INV_HALF, SIGMA_COLOR2_INV_HALF, max_depth * 1000.0,
                  torch.cuda.current_stream().cuda_stream)
    check_launch(code, "bilateral_filter")
    return out
