"""The image-pyramid stencils of tracking: the depth pyrDown with 3σ
rejection (σ = 30 mm), the 5×5 {1,4,6,4,1} pyrDown of model depth with 0 as
invalid, the plain 5×5 Gaussian pyrDown of intensity, and the Scharr-like
image derivatives.

Replaces no Pallas kernel: the reference's stencils are plain JAX, which XLA
fuses into one loop each.  On a CUDA tensor each public function launches
one hand-written kernel of `csrc/pyramid.cu` (one block per 32x8 tile of
output pixels, the tile's input footprint and its halo staged once in shared
memory; a pyrDown computes only the pixels it keeps; bound by bytes, and at
these sizes by the launch).  On a CPU tensor it takes its plain version
below, an unrolled stencil of shifted slices of the zero-padded image that
dispatches, at any size, 286 (`pyr_down_depth`), 137 (`pyr_down_gauss`), 133
(`pyr_down_intensity`) and 55 (`compute_derivatives`) elementwise operations
a call.  The kernels repeat the plain versions' arithmetic in their order,
so the two are bit-identical on a card.  Any other device, or an image that
is not 2-D, raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .._build import check_launch, kernel_function

# 5-tap binomial weights used by both pyrDown flavours (cudafuncs.cu:97, 512)
_GAUSS5 = (1.0, 4.0, 6.0, 4.0, 1.0)
# per-|offset| weights of the depth pyrDown (cudafuncs.cu:96)
_DEPTH_W = (0.0625, 0.25, 0.375, 0.25, 0.0625)
# the derivatives' weights (gsobel constants, cudafuncs.cu:613-667)
_SCHARR_A, _SCHARR_B = 0.52201, 0.79451

# image, out, H, W, [3σ threshold,] stream
_PYR_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_DEPTH_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_float, ctypes.c_void_p)
# image, dx, dy, H, W, a, b, stream
_DERIV_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p)


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


def _subsample2(x: torch.Tensor) -> torch.Tensor:
    """x[::2, ::2] over the even-cropped image."""
    H, W = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    return x[..., :H:2, :W:2].contiguous()


def pyr_down_depth_plain(depth_m: torch.Tensor, sigma_color: float = 0.03) -> torch.Tensor:
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


def pyr_down_gauss_plain(img: torch.Tensor) -> torch.Tensor:
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


def pyr_down_intensity_plain(img: torch.Tensor) -> torch.Tensor:
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


def compute_derivatives_plain(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    a, b = _SCHARR_A, _SCHARR_B
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


def _on_cpu(img: torch.Tensor, what: str) -> bool:
    """True for a CPU image (the plain version's), False for a CUDA one (the
    kernel's); raises for an image that is not [H,W] or lies elsewhere."""
    if img.dim() != 2:
        raise ValueError(f"{what} wants [H,W], got {tuple(img.shape)}")
    if img.device.type == "cpu":
        return True
    if img.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {img.device}")
    return False


def _launch(fn, what: str, img: torch.Tensor, outs, *scalars) -> None:
    """`fn(img, *outs, H, W, *scalars, stream)` on the image's card."""
    H, W = img.shape
    with torch.cuda.device(img.device):
        code = fn(img.data_ptr(), *(o.data_ptr() for o in outs), H, W, *scalars,
                  torch.cuda.current_stream().cuda_stream)
    check_launch(code, what)


def _half_res(img: torch.Tensor):
    src = img.to(torch.float32).contiguous()
    H, W = src.shape
    return src, torch.empty((H // 2, W // 2), dtype=torch.float32, device=src.device)


def pyr_down_depth(depth_m: torch.Tensor, sigma_color: float = 0.03) -> torch.Tensor:
    """Depth half-resolution downsample with 3σ rejection (σ=30 mm),
    matching pyrDownGaussKernel (cudafuncs.cu:77-121) but in metres: each
    output pixel (y, x) is the weighted mean of the 5×5 taps around (2y, 2x)
    within 3σ of it, 0 where none is."""
    if _on_cpu(depth_m, "pyr_down_depth"):
        return pyr_down_depth_plain(depth_m, sigma_color)
    fn = kernel_function("pyramid", "ef_pyr_down_depth", _DEPTH_ARGS)
    src, out = _half_res(depth_m)
    _launch(fn, "pyr_down_depth", src, (out,), 3.0 * sigma_color)
    return out


def pyr_down_gauss(img: torch.Tensor) -> torch.Tensor:
    """5×5 {1,4,6,4,1} Gaussian half-res downsample for float images with
    0-as-invalid masking (pyrDownKernelGaussF, cudafuncs.cu:393-411)."""
    if _on_cpu(img, "pyr_down_gauss"):
        return pyr_down_gauss_plain(img)
    fn = kernel_function("pyramid", "ef_pyr_down_gauss", _PYR_ARGS)
    src, out = _half_res(img)
    _launch(fn, "pyr_down_gauss", src, (out,))
    return out


def pyr_down_intensity(img: torch.Tensor) -> torch.Tensor:
    """Plain 5×5 Gaussian downsample for intensity images
    (pyrDownKernelIntensityGauss, cudafuncs.cu:516-540); out-of-image taps
    are masked out of the weights."""
    if _on_cpu(img, "pyr_down_intensity"):
        return pyr_down_intensity_plain(img)
    fn = kernel_function("pyramid", "ef_pyr_down_intensity", _PYR_ARGS)
    src, out = _half_res(img)
    _launch(fn, "pyr_down_intensity", src, (out,))
    return out


def compute_derivatives(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scharr-like image gradients (applyKernel + gsobel constants,
    cudafuncs.cu:613-667); effective correlation kernels
      dx: [[-a,0,a],[-b,0,b],[-a,0,a]],  dy: dxᵀ   (a=0.52201, b=0.79451).
    Out-of-bounds neighbours are skipped.  Returns truncated float32."""
    if _on_cpu(img, "compute_derivatives"):
        return compute_derivatives_plain(img)
    fn = kernel_function("pyramid", "ef_derivatives", _DERIV_ARGS)
    src = img.to(torch.float32).contiguous()
    dx, dy = torch.empty_like(src), torch.empty_like(src)
    _launch(fn, "compute_derivatives", src, (dx, dy), _SCHARR_A, _SCHARR_B)
    return dx, dy
