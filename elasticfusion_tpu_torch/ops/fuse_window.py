"""K3 — fuse window: the 3x3 association search of the data pass
(data.vert:123-158) and the accumulation of the 12 contribution images at the
winning pixel (update.vert:49-92, generalized to all matches).

Replaces the Pallas kernel `fuse_window`
(elasticfusion_tpu/ops/fuse_pallas.py:49-205).  On a CUDA tensor the wrapper
launches the hand-written kernel `csrc/fuse_window.cu` (a persistent grid
walking image tiles whose inputs arrive in shared memory by TMA, the next
tiles' loads in flight while the current one is searched; contributions
gathered by winning offset — no atomics, so sums have a fixed order and the
result is bit-identical to the plain version); on a CPU tensor it takes the
plain version below.  Bound by bytes: 18 channels read, 16 written.  The TMA
loads need row and plane pitches of a multiple of 4 floats: `tma_layout`
passes such a `chan` through (the main path's 640-wide one) and pads any
other into a buffer that has them, so every width runs on a card.

Input channels `[18,H,W]` (f32; ids as exact floats, so capacity < 2^24):
  0 pred index + 1 (0 = empty) · 1-3 pred vert · 4-6 pred normal ·
  7 pred radius · 8 raw depth z · 9-11 measurement normal · 12 measuring ·
  13 conf_new · 14 rad_new · 15-17 rgb.
`params [12]` = R row-major, t (world←camera).
Output channels `[16,H,W]`: best_id (== cap when none), best_off (0..8 dy
outer / dx inner, −1 none), best_rad, matched, then the contribution images
a, a_full, a_full·v_g(3), a_full·rgb(3), a_full·n_g(3), a_full·rad_new.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .._build import check_launch, kernel_function

COS_HALF = 0.87758256189  # cos(0.5 rad), data.vert:148
_OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
# chan, row pitch, plane pitch, params, out, H, W, fx, fy, cx, cy, cap, stream
_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_void_p)
_TMA_ALIGN = 4  # floats: the TMA base and its strides lie on 16 bytes


def tma_layout(chan: torch.Tensor) -> torch.Tensor:
    """`chan` itself when the TMA loads can read it in place (unit column
    stride, row and plane pitches a multiple of 4 floats, base on 16 bytes),
    else a copy into a `[18,H,W]` view of a buffer whose rows are padded to
    a multiple of 4 floats — so the kernel runs at any width."""
    _, H, W = chan.shape
    s_plane, s_row, s_col = chan.stride()
    if (s_col == 1 and s_row >= W and s_plane >= H * s_row
            and s_row % _TMA_ALIGN == 0 and s_plane % _TMA_ALIGN == 0
            and chan.data_ptr() % (4 * _TMA_ALIGN) == 0):
        return chan
    pitch = -(-W // _TMA_ALIGN) * _TMA_ALIGN
    padded = torch.empty((chan.shape[0], H, pitch), dtype=chan.dtype,
                         device=chan.device)[:, :, :W]
    return padded.copy_(chan)


def fuse_window_plain(chan: torch.Tensor, params: torch.Tensor, fx: float,
                      fy: float, cx: float, cy: float, cap: int) -> torch.Tensor:
    """Plain version: 9 shifted slices for the search, 9 shifted slices for
    the gather, the kernel's arithmetic operation for operation."""
    C, H, W = chan.shape
    dev = chan.device
    P = F.pad(chan[:8], (1, 1, 1, 1))      # zero fill: index+1 == 0 is empty

    def tap(c, dy, dx):
        return P[c, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    col = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    row = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    # 0-d tensor divisors keep this a true division, as in the kernel (a
    # Python-scalar divisor may become a multiplication by its reciprocal)
    fx_t = torch.tensor(fx, dtype=torch.float32, device=dev)
    fy_t = torch.tensor(fy, dtype=torch.float32, device=dev)
    xl = ((col - cx) / fx_t).expand(H, W)
    yl = ((row - cy) / fy_t).expand(H, W)
    lam = torch.sqrt(xl * xl + yl * yl + 1.0)

    z = chan[8]
    nlx, nly, nlz = chan[9], chan[10], chan[11]
    nl_norm = torch.sqrt(nlx * nlx + nly * nly + nlz * nlz)

    best_dist = torch.full((H, W), 1000.0, dtype=torch.float32, device=dev)
    best_id = torch.full((H, W), float(cap), dtype=torch.float32, device=dev)
    best_rad = torch.zeros((H, W), dtype=torch.float32, device=dev)
    best_off = torch.full((H, W), -1.0, dtype=torch.float32, device=dev)
    for oi, (dy, dx) in enumerate(_OFFSETS):
        cand1 = tap(0, dy, dx)
        vcx, vcy, vcz = tap(1, dy, dx), tap(2, dy, dx), tap(3, dy, dx)
        ncx, ncy, ncz = tap(4, dy, dx), tap(5, dy, dx), tap(6, dy, dx)
        has = cand1 > 0.0
        depth_ok = torch.abs(vcz * lam - z * lam) < 0.05
        c0 = yl * vcz - vcy
        c1 = vcx - xl * vcz
        c2 = xl * vcy - yl * vcx
        dist = torch.sqrt(c0 * c0 + c1 * c1 + c2 * c2) / lam
        nn = ncx * nlx + ncy * nly + ncz * nlz
        denom = torch.clamp(
            torch.sqrt(ncx * ncx + ncy * ncy + ncz * ncz) * nl_norm, min=1e-12)
        norm_ok = (torch.abs(ncz) < 0.75) | (nn / denom > COS_HALF)
        ok = has & depth_ok & norm_ok & (dist < best_dist)
        best_dist = torch.where(ok, dist, best_dist)
        best_id = torch.where(ok, cand1 - 1.0, best_id)
        best_rad = torch.where(ok, tap(7, dy, dx), best_rad)
        best_off = torch.where(ok, torch.full_like(best_off, float(oi)), best_off)

    matched = (chan[12] > 0.0) & (best_id < float(cap))

    r = [params[i] for i in range(9)]
    t0, t1, t2 = params[9], params[10], params[11]
    vlx, vly = xl * z, yl * z
    vgx = r[0] * vlx + r[1] * vly + r[2] * z + t0
    vgy = r[3] * vlx + r[4] * vly + r[5] * z + t1
    vgz = r[6] * vlx + r[7] * vly + r[8] * z + t2
    ngx = r[0] * nlx + r[1] * nly + r[2] * nlz
    ngy = r[3] * nlx + r[4] * nly + r[5] * nlz
    ngz = r[6] * nlx + r[7] * nly + r[8] * nlz

    conf, rad_new = chan[13], chan[14]
    zero = torch.zeros_like(conf)
    a = torch.where(matched, conf, zero)
    af = torch.where(matched & (rad_new < 1.5 * best_rad), a, zero)
    meas = torch.stack([
        a, af, af * vgx, af * vgy, af * vgz,
        af * chan[15], af * chan[16], af * chan[17],
        af * ngx, af * ngy, af * ngz, af * rad_new,
    ])

    # output pixel w sums meas[q] over the q = w - off with best_off[q] == oi
    Mp = F.pad(meas, (1, 1, 1, 1))
    Op = F.pad(best_off, (1, 1, 1, 1), value=-1.0)
    acc = torch.zeros_like(meas)
    for oi, (dy, dx) in enumerate(_OFFSETS):
        sel = Op[1 - dy:1 - dy + H, 1 - dx:1 - dx + W] == float(oi)
        mq = Mp[:, 1 - dy:1 - dy + H, 1 - dx:1 - dx + W]
        acc = acc + torch.where(sel[None], mq, torch.zeros_like(mq))

    return torch.cat([
        torch.stack([best_id, best_off, best_rad, matched.to(torch.float32)]),
        acc,
    ])


def fuse_window(chan: torch.Tensor, params: torch.Tensor, fx: float, fy: float,
                cx: float, cy: float, cap: int) -> torch.Tensor:
    """chan `[18,H,W]`, params `[12]` (same device) → `[16,H,W]`; see the
    module docstring for the channel orders."""
    if chan.dim() != 3 or chan.shape[0] != 18 or chan.dtype != torch.float32:
        raise ValueError(f"fuse_window wants [18,H,W] float32, got "
                         f"{tuple(chan.shape)} {chan.dtype}")
    if params.shape != (12,) or params.dtype != torch.float32 \
            or params.device != chan.device:
        raise ValueError("fuse_window: params must be float32 [12] on chan's device")
    if not cap < (1 << 24):
        raise ValueError(f"fuse_window: capacity {cap} does not fit an exact "
                         "float32 id (needs < 2^24)")
    if chan.device.type == "cpu":
        return fuse_window_plain(chan, params, fx, fy, cx, cy, cap)
    if chan.device.type != "cuda":
        raise ValueError(f"fuse_window: unsupported device {chan.device}")
    if not params.is_contiguous():
        raise ValueError("fuse_window: params must be contiguous")
    _, H, W = chan.shape
    chan = tma_layout(chan)

    fn = kernel_function("fuse_window", "ef_fuse_window", _ARGTYPES)
    out = torch.empty((16, H, W), dtype=torch.float32, device=chan.device)
    with torch.cuda.device(chan.device):
        code = fn(chan.data_ptr(), chan.stride(1), chan.stride(0),
                  params.data_ptr(), out.data_ptr(), H, W, fx, fy, cx, cy,
                  float(cap), torch.cuda.current_stream().cuda_stream)
    check_launch(code, "fuse_window")
    return out
