"""Dense RGB-D odometry residual/normal-equation ops — equivalents of the
original system's CUDA reduction kernels (Core/Cuda/reduce.cu):
  - icpStep           (reduce.cu:204-401)  point-to-plane projective ICP rows
  - computeRgbResidual(reduce.cu:603-787)  photometric correspondence search
  - rgbStep           (reduce.cu:403-550)  photometric Jacobian rows
  - so3Step           (reduce.cu:789-973)  rotation-only LK pre-alignment

Each step computes per-pixel rows [J | r] over the whole image and forms the
Gram matrix G = rows·rowsᵀ.  G holds the 6×6 normal matrix A = G[:6,:6], the
rhs b = G[:6,6] and Σr² = G[6,6] — the 29 floats of the original two-stage
tree reduction.

`icp_step`, `compute_rgb_residual`, `rgb_step` and `so3_step` are kernel
wrappers: for CUDA tensors each is ONE launch of a hand-written kernel of
`csrc/odometry_steps.cu` that builds the row in registers and reduces it in
the same kernel (the design of reduce.cu), so no per-pixel intermediate
reaches device memory; on the tracker's path they replace the Pallas kernel
`gram_outer_pallas` (elasticfusion_tpu/ops/gram_pallas.py:36) and the
elementwise chain that fed it.  For CPU tensors they run the plain versions
`icp_step_plain`, `compute_rgb_residual_plain`, `rgb_step_plain`,
`so3_step_plain`, which write the rows out and reduce them with `gram_outer`.

Every step takes a device flag `active` (int32 [1]): where it is 0 the
kernel returns before it writes anything, and the plain version (for a CPU
tensor, free to read) returns None.  `so3_update` and `gn_update` are the
tracker's loop bodies on the card (`csrc/tracker_update.cu`, one small block a
launch): they read a step's pack, solve, update the pose and the carry, run
the exit tests, set `active`, and write the next iteration's small matrices,
so a pyramid of iterations is a fixed sequence of launches that reads
nothing back (tracking.py).  No Pallas kernel of the reference does their
work (its XLA program did); their plain versions `so3_update_plain`,
`gn_update_plain` fix the order of every float operation, which the kernel
repeats.

`icp_step` takes the model table in either of the reference's two forms
(`icp_prev_table`): six float32 planes, or with `fx16_tables` the u16
fixed-point words of `gatherpack.pack_fx16` (three 32-bit words of two codes
a pixel, each channel decoded `code * scale + lo` with one rounding).  Both
forms are one kernel, `icp_step_kernel<FX16>`, behind one launcher.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from .._build import check_launch, kernel_function
from ..surfels import pixel_grid
from .gatherpack import gather_fx16, pack_fx16
from .gram import gram_outer, reduction_grid, reduction_scratch
from .preprocess import SOBEL_SCALE

_PIXELS_PER_THREAD = 1
_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
# Every step launcher takes the device flag `active` first (see `_active_ptr`).
# active, T_curr, T_prev, vmap, nmap, prev_table, los, scales (both null: the
# float32 table), H, W, fx, fy, cx, cy, dist, sine, partials, ticket, n_blocks,
# out, stream
_ICP_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F,
                 _P, _P, _I, _P, _P)
# active, gates, next_depth, next_image, last_table, krkinv, kt, H, W,
# max_depth_delta, flat0, diff, partials, ticket, n_blocks, stats, stream
_RGB_RESIDUAL_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                          _P, _P, _P, _P, _I, _P, _P)
# active, flat0, diff, stats, sigma, cloud, dIdx, dIdy, N, fx, fy,
# sobel_scale, partials, ticket, n_blocks, out_Ab, sum_sq, stream
_RGB_STEP_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F,
                      _P, _P, _I, _P, _P, _P)
# active, last_image, next_image, basis, kinv, krlr, H, W, partials, ticket,
# n_blocks, out, stream
_SO3_STEP_ARGTYPES = (_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P)
# stage, pack, carry, active, fx, fy, cx, cy, 1/fx, 1/fy, -cx/fx, -cy/fy, stream
_SO3_UPDATE_ARGTYPES = (_I, _P, _P, _P) + (_F,) * 8 + (_P,)
# stage, pack, carry, active, T_prev, so3_carry, enable, the 8 level floats,
# icp_on, rgb_on, rgb_only, last_of_level, icp_weight, early_exit,
# plateau_exit, translation_sanity, cov_threshold, stream
_GN_UPDATE_ARGTYPES = ((_I, _P, _P, _P, _P, _P, _P) + (_F,) * 8 + (_I,) * 4
                       + (_F,) * 5 + (_P,))


class Gram(NamedTuple):
    """Normal-equation payload of one reduction: A(6,6), b(6,), Σr², count."""

    A: torch.Tensor
    b: torch.Tensor
    sum_sq: torch.Tensor
    count: torch.Tensor


def _gram_from_rows(rows: torch.Tensor, valid: torch.Tensor) -> Gram:
    """rows [7,N] (zeroed where invalid), valid [N] bool → Gram."""
    G = gram_outer(rows.contiguous())
    return Gram(A=G[:6, :6], b=G[:6, 6], sum_sq=G[6, 6],
                count=valid.to(torch.float32).sum())


def _cuda_device(what: str, like: torch.Tensor, **tensors) -> torch.device:
    """The card `like` lives on; raises unless every tensor is a contiguous
    float32 (bool for `gates`) tensor on that same card."""
    dev = like.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    for name, t in tensors.items():
        want = torch.bool if name == "gates" else torch.float32
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous {want} tensor on {dev}, "
                f"got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
    return dev


def _out_buffer(what: str, out: Optional[torch.Tensor], n: int,
                dev: torch.device) -> torch.Tensor:
    """The caller's `[n]` result slice, or a fresh one."""
    if out is None:
        return torch.empty((n,), dtype=torch.float32, device=dev)
    if (out.shape != (n,) or out.dtype != torch.float32 or out.device != dev
            or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous float32 [{n}] on {dev}")
    return out


_ALWAYS: dict = {}


def _active_ptr(active: Optional[torch.Tensor], dev: torch.device) -> int:
    """Device pointer of a step's int32 `active` flag; `None` means always
    active (a flag of 1 kept per card, made outside any graph capture)."""
    if active is None:
        if dev.index not in _ALWAYS:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a step inside a graph capture needs its own "
                                   "`active` flag")
            _ALWAYS[dev.index] = torch.ones((1,), dtype=torch.int32, device=dev)
        return _ALWAYS[dev.index].data_ptr()
    if active.device != dev or active.dtype != torch.int32 or active.numel() != 1:
        raise ValueError(f"active must be one int32 on {dev}, got {active.dtype} "
                         f"{tuple(active.shape)} on {active.device}")
    return active.data_ptr()


def inactive(active: Optional[torch.Tensor]) -> bool:
    """The plain versions' reading of the `active` flag: only a CPU tensor's
    (free to read) decides their control flow on the main path; on a card
    they run only beside their kernels, in checks."""
    return active is not None and not bool(active)


def _store_gram(g: Gram, out: Optional[torch.Tensor], with_stats: bool) -> Gram:
    """Plain path of `out=`: A (36, row-major), b (6) and, `with_stats`,
    Σr² and the count, copied into the caller's slice."""
    if out is not None:
        out[0:36] = g.A.reshape(-1)
        out[36:42] = g.b
        if with_stats:
            out[42] = g.sum_sq
            out[43] = g.count
    return g


def _flat_xy(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    u, v = pixel_grid(H, W, device)
    return u.reshape(-1), v.reshape(-1)


def _round_i(x: torch.Tensor) -> torch.Tensor:
    """round half to even, then truncate toward zero to an integer."""
    return torch.round(x).to(torch.int64)


# ---------------------------------------------------------------------------
# ICP (point-to-plane, projective data association) — reduce.cu:204-329
# ---------------------------------------------------------------------------


def icp_prev_table(vmap_g_prev: torch.Tensor, nmap_g_prev: torch.Tensor,
                   fx16: bool = False):
    """The (loop-invariant) model vertex+normal maps as one [6,N] float32
    gather table, or with `fx16` the reference's u16 fixed-point table
    ("fx16", words [3,N] int32, los [6], scales [6]) of `pack_fx16`: half the
    bytes a correspondence reads, at most scale/2 of decode error (<= 0.1 mm
    over a 10 m range)."""
    if fx16:
        return pack_fx16((vmap_g_prev[0], vmap_g_prev[1], vmap_g_prev[2],
                          nmap_g_prev[0], nmap_g_prev[1], nmap_g_prev[2]))
    return torch.cat([vmap_g_prev.reshape(3, -1), nmap_g_prev.reshape(3, -1)])


def _is_fx16(table) -> bool:
    return isinstance(table, tuple) and table[0] == "fx16"


def rgb_last_table(last_depth: torch.Tensor, last_image: torch.Tensor,
                   cloud: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (loop-invariant) last depth+intensity (+ back-projected last cloud
    when given) as one [2|5, N] gather table: one gather serves both the
    correspondence search and rgb_step's point fetch."""
    rows = [last_depth.reshape(1, -1), last_image.reshape(1, -1)]
    if cloud is not None:
        rows.append(cloud.reshape(3, -1))
    return torch.cat(rows)


def rgb_static_gates(
    min_grad2_scaled: float,
    dIdx: torch.Tensor, dIdy: torch.Tensor,
    next_depth: torch.Tensor, next_image: torch.Tensor,
) -> torch.Tensor:
    """Pose-independent validity gates of compute_rgb_residual
    (reduce.cu:648-659): 4x4 non-zero neighbourhood, bounds, gradient
    magnitude, depth validity.  Loop-invariant — compute once per level."""
    H, W = next_image.shape
    dev = next_image.device
    yi = torch.arange(H, device=dev)[:, None]
    xi = torch.arange(W, device=dev)[None, :]

    nb_ok = torch.ones((H, W), dtype=torch.bool, device=dev)
    nz = next_image > 0
    for du in range(-2, 2):
        for dv in range(-2, 2):
            shifted = torch.roll(nz, shifts=(-du, -dv), dims=(0, 1))
            inb = ((yi + du >= 0) & (yi + du < H)
                   & (xi + dv >= 0) & (xi + dv < W))
            nb_ok = nb_ok & (shifted | ~inb)

    bounds = (xi < W - 5) & (yi < H - 1)
    grad_ok = (dIdx * dIdx + dIdy * dIdy) >= min_grad2_scaled
    return (nb_ok & bounds & grad_ok & (next_depth > 0)).reshape(H * W)


def icp_step_plain(
    T_curr: torch.Tensor,       # (4,4) current world←camera estimate
    vmap_curr: torch.Tensor,    # (3,H,W) current frame camera-space vertices
    nmap_curr: torch.Tensor,    # (3,H,W) current frame normals
    T_prev: torch.Tensor,       # (4,4) previous world←camera pose
    vmap_g_prev: torch.Tensor,  # (3,H,W) model prediction, WORLD frame
    nmap_g_prev: torch.Tensor,  # (3,H,W) model normals, WORLD frame
    fx: float, fy: float, cx: float, cy: float,
    dist_thresh: float = 0.10,
    angle_thresh_sin: float = 0.342020143,
    prev_table=None,            # icp_prev_table(...) of the model maps
    active: Optional[torch.Tensor] = None,
) -> Optional[Gram]:
    """Point-to-plane ICP rows against the predicted model maps; None, and
    nothing computed, when the int32 flag `active` is 0.

    Per-pixel logic mirrors ICPReduction::search/getProducts
    (reduce.cu:228-309): transform current vertex to world with T_curr,
    re-project into the previous camera, gather the model vertex/normal,
    gate on distance ≤0.10 m and normal-cross-product norm < sin 20°, and
    emit the row [n | s×n | n·(s−d)] in the *previous camera* frame.

    A fixed-point table decodes a zero to ±scale/2 of noise, so its model
    pixel counts as valid by its normal alone, |n|² > 1e-2 (a real surfel
    normal is unit length), as in the reference; the float32 table takes
    |v|² > 0 and |n|² > 1e-12."""
    if inactive(active):
        return None
    C, H, W = vmap_curr.shape
    N = H * W
    Rc = T_curr[:3, :3]
    tc = T_curr[:3, 3]
    Rp_inv = T_prev[:3, :3].T
    tp = T_prev[:3, 3]

    v = vmap_curr.reshape(3, N)          # camera frame
    n = nmap_curr.reshape(3, N)
    valid_in = (v[2] > 0) & (torch.sum(n * n, dim=0) > 1e-12)

    v_g = Rc @ v + tc[:, None]           # world
    v_cp = Rp_inv @ (v_g - tp[:, None])  # previous camera frame

    z = v_cp[2]
    safe_z = torch.where(torch.abs(z) > 1e-12, z, torch.ones_like(z))
    u_proj = _round_i(v_cp[0] * fx / safe_z + cx)
    v_proj = _round_i(v_cp[1] * fy / safe_z + cy)
    in_img = (u_proj >= 0) & (v_proj >= 0) & (u_proj < W) & (v_proj < H) & (z >= 0)

    flat = torch.clamp(v_proj, 0, H - 1) * W + torch.clamp(u_proj, 0, W - 1)
    if prev_table is None:
        prev_table = icp_prev_table(vmap_g_prev, nmap_g_prev)
    if _is_fx16(prev_table):
        ch = gather_fx16(prev_table, flat)
        vprev_g, nprev_g = torch.stack(ch[0:3]), torch.stack(ch[3:6])
        prev_valid = torch.sum(nprev_g * nprev_g, dim=0) > 1e-2
    else:
        got = prev_table[:, flat]
        vprev_g, nprev_g = got[0:3], got[3:6]
        prev_valid = (torch.sum(vprev_g * vprev_g, dim=0) > 0) & (
            torch.sum(nprev_g * nprev_g, dim=0) > 1e-12
        )

    n_g = Rc @ n                          # current normal in world
    dist = torch.linalg.vector_norm(vprev_g - v_g, dim=0)
    sine = torch.linalg.vector_norm(torch.linalg.cross(n_g, nprev_g, dim=0), dim=0)

    found = (
        valid_in & in_img & prev_valid
        & (sine < angle_thresh_sin) & (dist <= dist_thresh)
    )

    # rows in previous-camera frame (reduce.cu:283-293)
    s_cp = v_cp
    d_cp = Rp_inv @ (vprev_g - tp[:, None])
    n_cp = Rp_inv @ nprev_g

    sxn = torch.linalg.cross(s_cp, n_cp, dim=0)
    res = torch.sum(n_cp * (s_cp - d_cp), dim=0)
    rows = torch.cat([n_cp, sxn, res[None]])               # [7,N]
    rows = torch.where(found[None, :], rows, torch.zeros_like(rows))
    return _gram_from_rows(rows, found)


def icp_step(
    T_curr: torch.Tensor, vmap_curr: torch.Tensor, nmap_curr: torch.Tensor,
    T_prev: torch.Tensor, vmap_g_prev: torch.Tensor, nmap_g_prev: torch.Tensor,
    fx: float, fy: float, cx: float, cy: float,
    dist_thresh: float = 0.10,
    angle_thresh_sin: float = 0.342020143,
    prev_table=None,
    out: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> Optional[Gram]:
    """`icp_step_plain` for CPU tensors; for CUDA tensors one launch of
    `ef_icp_step`, of the fixed-point form when `prev_table` is a
    `pack_fx16` table.  `out`, when given, is a float32 `[44]` slice that
    receives A (36, row-major), b (6), Σr², count — the returned Gram then
    views it.  `active` (int32 [1], default always): where it is 0 the step
    writes nothing (the CPU path returns None)."""
    if vmap_curr.device.type == "cpu":
        g = icp_step_plain(T_curr, vmap_curr, nmap_curr, T_prev, vmap_g_prev,
                           nmap_g_prev, fx, fy, cx, cy, dist_thresh,
                           angle_thresh_sin, prev_table, active)
        return None if g is None else _store_gram(g, out, True)
    if prev_table is None:
        prev_table = icp_prev_table(vmap_g_prev, nmap_g_prev)
    _, H, W = vmap_curr.shape
    fx16 = _is_fx16(prev_table)
    table, los, scales = prev_table[1:] if fx16 else (prev_table, None, None)
    dev = _cuda_device("icp_step", vmap_curr, T_curr=T_curr, T_prev=T_prev,
                       vmap_curr=vmap_curr, nmap_curr=nmap_curr,
                       **({"los": los, "scales": scales} if fx16 else {"prev_table": table}))
    if fx16 and (table.device != dev or table.dtype != torch.int32
                 or not table.is_contiguous()):
        raise ValueError(f"icp_step: the fixed-point words must be a contiguous int32 "
                         f"tensor on {dev}, got {table.dtype} on {table.device}")
    if (T_curr.shape != (4, 4) or T_prev.shape != (4, 4)
            or nmap_curr.shape != (3, H, W)
            or table.shape != ((3 if fx16 else 6), H * W)
            or (fx16 and not los.shape == scales.shape == (6,))):
        raise ValueError("icp_step: wants (4,4) poses, (3,H,W) maps and a (6,H*W) "
                         "table, or a fixed-point one of (3,H*W) words and (6,) ranges")
    out = _out_buffer("icp_step", out, 44, dev)
    partials, ticket = reduction_scratch("icp_step", dev, 29)
    fn = kernel_function("odometry_steps", "ef_icp_step", _ICP_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(_active_ptr(active, dev), T_curr.data_ptr(), T_prev.data_ptr(),
                  vmap_curr.data_ptr(),
                  nmap_curr.data_ptr(), table.data_ptr(),
                  los.data_ptr() if fx16 else None, scales.data_ptr() if fx16 else None,
                  H, W, fx, fy, cx, cy, dist_thresh, angle_thresh_sin,
                  partials.data_ptr(), ticket.data_ptr(),
                  reduction_grid(H * W, _PIXELS_PER_THREAD), out.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    check_launch(code, "icp_step")
    return Gram(A=out[0:36].view(6, 6), b=out[36:42], sum_sq=out[42], count=out[43])


# ---------------------------------------------------------------------------
# RGB photometric residual + step — reduce.cu:403-550, 603-787
# ---------------------------------------------------------------------------


class RgbCorrespondence(NamedTuple):
    """Vectorized DataTerm image (types.cuh:79-84).  The plain version fills
    `u0`, `v0`, `valid` (and `p`); the kernel leaves the compact record
    `flat0` instead, and its `sigma_sum`, `count` are neighbours in one
    buffer so that `rgb_step` can hand both to its kernel."""

    u0: Optional[torch.Tensor]     # [N] matched pixel x in last image
    v0: Optional[torch.Tensor]     # [N] matched pixel y in last image
    diff: torch.Tensor             # [N] intensity difference next−last, 0 where invalid
    valid: Optional[torch.Tensor]  # [N] bool
    count: torch.Tensor            # scalar
    sigma_sum: torch.Tensor        # scalar Σdiff²
    p: Optional[torch.Tensor] = None      # [3,N] last-cloud point at (v0,u0)
    flat0: Optional[torch.Tensor] = None  # [N] int32 v0·W+u0, −1 where invalid


def rgb_sigma_val(count: torch.Tensor, sigma_sum: torch.Tensor) -> torch.Tensor:
    """σ of `rgb_step`'s weight as the original derives it
    (RGBDOdometry.cpp:441): operator precedence there makes it sqrt(count)
    unless Σdiff² is 0 (then 1) or the count is 0 (then 0)."""
    return torch.sqrt(torch.where(
        count == 0, torch.zeros_like(count),
        torch.where(sigma_sum == 0, torch.ones_like(count), count)))


def compute_rgb_residual_plain(
    min_grad2_scaled: float,
    dIdx: torch.Tensor, dIdy: torch.Tensor,        # (H,W) next-image gradients
    last_depth: torch.Tensor, next_depth: torch.Tensor,  # (H,W) m, 0 invalid
    last_image: torch.Tensor, next_image: torch.Tensor,  # (H,W) intensity
    kt: torch.Tensor,         # (3,) K·t of inverse incremental transform
    krkinv: torch.Tensor,     # (3,3) K·R·K⁻¹
    max_depth_delta: float = 0.07,
    last_table: Optional[torch.Tensor] = None,
    static_gates: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> Optional[RgbCorrespondence]:
    """Dense photometric correspondence via depth-consistent reprojection,
    mirroring RGBResidual::getProducts (reduce.cu:636-716); None when the
    flag `active` is 0."""
    if inactive(active):
        return None
    H, W = next_image.shape
    N = H * W
    x, y = _flat_xy(H, W, next_image.device)

    if static_gates is None:
        static_gates = rgb_static_gates(
            min_grad2_scaled, dIdx, dIdy, next_depth, next_image
        )

    d1 = next_depth.reshape(N)
    td1 = d1 * (krkinv[2, 0] * x + krkinv[2, 1] * y + krkinv[2, 2]) + kt[2]
    safe_td1 = torch.where(torch.abs(td1) > 1e-12, td1, torch.ones_like(td1))
    u0 = _round_i(
        (d1 * (krkinv[0, 0] * x + krkinv[0, 1] * y + krkinv[0, 2]) + kt[0]) / safe_td1
    )
    v0 = _round_i(
        (d1 * (krkinv[1, 0] * x + krkinv[1, 1] * y + krkinv[1, 2]) + kt[1]) / safe_td1
    )
    in_img = (u0 >= 0) & (v0 >= 0) & (u0 < W) & (v0 < H)

    flat0 = torch.clamp(v0, 0, H - 1) * W + torch.clamp(u0, 0, W - 1)
    if last_table is None:
        last_table = rgb_last_table(last_depth, last_image)
    got = last_table[:, flat0]
    d0, last_i = got[0], got[1]
    p = got[2:5] if got.shape[0] >= 5 else None
    match_ok = (d0 > 0) & (torch.abs(td1 - d0) <= max_depth_delta) & (last_i != 0)

    valid = static_gates & in_img & match_ok
    diff = torch.where(valid, next_image.reshape(N) - last_i, torch.zeros_like(d1))
    return RgbCorrespondence(
        u0=u0, v0=v0, diff=diff, valid=valid,
        count=valid.to(torch.float32).sum(),
        sigma_sum=torch.sum(diff * diff),
        p=p,
    )


def compute_rgb_residual(
    min_grad2_scaled: float,
    dIdx: torch.Tensor, dIdy: torch.Tensor,
    last_depth: torch.Tensor, next_depth: torch.Tensor,
    last_image: torch.Tensor, next_image: torch.Tensor,
    kt: torch.Tensor, krkinv: torch.Tensor,
    max_depth_delta: float = 0.07,
    last_table: Optional[torch.Tensor] = None,
    static_gates: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> Optional[RgbCorrespondence]:
    """`compute_rgb_residual_plain` for CPU tensors; for CUDA tensors one
    launch of `ef_rgb_residual`, which sums Σdiff² and the count and leaves
    per pixel only the record `flat0`, `diff` that `rgb_step` reads (8 bytes;
    that kernel then needs neither the pose nor the depth maps again).
    `out`, when given, is a float32 `[2]` slice that receives Σdiff², count.
    Where `active` is 0 nothing is written (the CPU path returns None)."""
    if next_image.device.type == "cpu":
        c = compute_rgb_residual_plain(
            min_grad2_scaled, dIdx, dIdy, last_depth, next_depth, last_image,
            next_image, kt, krkinv, max_depth_delta, last_table, static_gates,
            active)
        if c is not None and out is not None:
            out[0] = c.sigma_sum
            out[1] = c.count
        return c
    if static_gates is None:
        static_gates = rgb_static_gates(
            min_grad2_scaled, dIdx, dIdy, next_depth, next_image)
    if last_table is None:
        last_table = rgb_last_table(last_depth, last_image)
    dev = _cuda_device("compute_rgb_residual", next_image, gates=static_gates,
                       next_depth=next_depth, next_image=next_image,
                       last_table=last_table, krkinv=krkinv, kt=kt)
    H, W = next_image.shape
    N = H * W
    if (static_gates.shape != (N,) or next_depth.shape != (H, W)
            or last_table.dim() != 2 or last_table.shape[0] < 2
            or last_table.shape[1] != N or krkinv.shape != (3, 3)
            or kt.shape != (3,)):
        raise ValueError("compute_rgb_residual: wants (H,W) images, (H*W,) gates, "
                         "a (>=2,H*W) table, (3,3) krkinv and (3,) kt")
    stats = _out_buffer("compute_rgb_residual", out, 2, dev)
    flat0 = torch.empty((N,), dtype=torch.int32, device=dev)
    diff = torch.empty((N,), dtype=torch.float32, device=dev)
    partials, ticket = reduction_scratch("rgb_residual", dev, 2)
    fn = kernel_function("odometry_steps", "ef_rgb_residual", _RGB_RESIDUAL_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(_active_ptr(active, dev), static_gates.data_ptr(),
                  next_depth.data_ptr(),
                  next_image.data_ptr(), last_table.data_ptr(),
                  krkinv.data_ptr(), kt.data_ptr(), H, W, max_depth_delta,
                  flat0.data_ptr(), diff.data_ptr(), partials.data_ptr(),
                  ticket.data_ptr(), reduction_grid(N, _PIXELS_PER_THREAD),
                  stats.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check_launch(code, "compute_rgb_residual")
    return RgbCorrespondence(u0=None, v0=None, diff=diff, valid=None,
                             count=stats[1], sigma_sum=stats[0], flat0=flat0)


def rgb_step_plain(
    corres: RgbCorrespondence,
    sigma: Optional[torch.Tensor],  # scalar (-1.0: rgbOnly even weighting)
    cloud: torch.Tensor,        # (3,H,W) back-projected lastDepth (level intr.)
    fx: float, fy: float,
    dIdx: torch.Tensor, dIdy: torch.Tensor,
    active: Optional[torch.Tensor] = None,
) -> Optional[Gram]:
    """Photometric Jacobian rows, mirroring RGBReduction::getProducts
    (reduce.cu:420-478): gradients read at the *next*-image pixel, the 3D
    point read from the back-projected *last* depth at the matched pixel,
    Huber-like weight w = 1/(σ+|diff|).  `sigma=None` derives σ from the
    correspondence (`rgb_sigma_val`).  None when `active` is 0."""
    if inactive(active):
        return None
    C, H, W = cloud.shape
    N = H * W
    if sigma is None:
        sigma = rgb_sigma_val(corres.count, corres.sigma_sum)

    w = sigma + torch.abs(corres.diff)
    w = torch.where(w > 1.19209290e-07, 1.0 / w, torch.ones_like(w))
    w = torch.where(sigma == -1.0, torch.ones_like(w), w)

    if corres.p is not None:
        p = corres.p
    else:
        flat0 = torch.clamp(corres.v0, 0, H - 1) * W + torch.clamp(corres.u0, 0, W - 1)
        p = cloud.reshape(3, N)[:, flat0]
    safe_z = torch.where(torch.abs(p[2]) > 1e-12, p[2], torch.ones_like(p[2]))
    invz = 1.0 / safe_z

    gx = dIdx.reshape(N) * (w * SOBEL_SCALE)
    gy = dIdy.reshape(N) * (w * SOBEL_SCALE)
    v0r = gx * fx * invz
    v1r = gy * fy * invz
    v2r = -(v0r * p[0] + v1r * p[1]) * invz

    rows = torch.stack(
        [
            v0r,
            v1r,
            v2r,
            -p[2] * v1r + p[1] * v2r,
            p[2] * v0r - p[0] * v2r,
            -p[1] * v0r + p[0] * v1r,
            -w * corres.diff,
        ]
    )  # [7,N]
    rows = torch.where(corres.valid[None, :], rows, torch.zeros_like(rows))
    return _gram_from_rows(rows, corres.valid)


def rgb_step(
    corres: RgbCorrespondence,
    sigma: Optional[torch.Tensor],
    cloud: torch.Tensor,
    fx: float, fy: float,
    dIdx: torch.Tensor, dIdy: torch.Tensor,
    out: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> Optional[Gram]:
    """`rgb_step_plain` for CPU tensors; for CUDA tensors one launch of
    `ef_rgb_step` on the record a CUDA `compute_rgb_residual` left.  With
    `sigma=None` the kernel derives σ from the Σdiff² and count that the
    residual kernel wrote, so nothing runs between the two.  `out`, when
    given, is a float32 `[42]` slice that receives A (36, row-major), b (6).
    Where `active` is 0 nothing is written (the CPU path returns None)."""
    if cloud.device.type == "cpu":
        g = rgb_step_plain(corres, sigma, cloud, fx, fy, dIdx, dIdy, active)
        return None if g is None else _store_gram(g, out, False)
    if corres.flat0 is None:
        raise ValueError("rgb_step: on a card the correspondence must come from "
                         "compute_rgb_residual on that card")
    tensors = dict(cloud=cloud, dIdx=dIdx, dIdy=dIdy, diff=corres.diff)
    if sigma is not None:
        tensors["sigma"] = sigma
    dev = _cuda_device("rgb_step", cloud, **tensors)
    _, H, W = cloud.shape
    N = H * W
    if (dIdx.shape != (H, W) or dIdy.shape != (H, W) or corres.diff.shape != (N,)
            or corres.flat0.shape != (N,) or corres.flat0.device != dev
            or (sigma is not None and sigma.numel() != 1)):
        raise ValueError("rgb_step: wants a (3,H,W) cloud, (H,W) gradients, an "
                         "(H*W,) record and a one-element sigma")
    stats = corres.sigma_sum
    if corres.count.data_ptr() != stats.data_ptr() + 4:
        raise ValueError("rgb_step: corres.sigma_sum and corres.count must be "
                         "neighbours in one buffer")
    out = _out_buffer("rgb_step", out, 42, dev)
    sum_sq = torch.empty((), dtype=torch.float32, device=dev)
    partials, ticket = reduction_scratch("rgb_step", dev, 28)
    fn = kernel_function("odometry_steps", "ef_rgb_step", _RGB_STEP_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(_active_ptr(active, dev), corres.flat0.data_ptr(),
                  corres.diff.data_ptr(),
                  stats.data_ptr(), None if sigma is None else sigma.data_ptr(),
                  cloud.data_ptr(), dIdx.data_ptr(), dIdy.data_ptr(), N,
                  fx, fy, SOBEL_SCALE, partials.data_ptr(), ticket.data_ptr(),
                  reduction_grid(N, _PIXELS_PER_THREAD), out.data_ptr(),
                  sum_sq.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check_launch(code, "rgb_step")
    return Gram(A=out[0:36].view(6, 6), b=out[36:42], sum_sq=sum_sq,
                count=corres.count)


# ---------------------------------------------------------------------------
# SO(3) pre-alignment — reduce.cu:789-973
# ---------------------------------------------------------------------------


class GramSO3(NamedTuple):
    A: torch.Tensor       # (3,3)
    b: torch.Tensor       # (3,)
    sum_sq: torch.Tensor
    count: torch.Tensor


def so3_neighborhood_table(img: torch.Tensor) -> torch.Tensor:
    """(img, x-1, x+1, y-1, y+1) shifted channels as one [5,N] gather table —
    interior-only indices make pixel-domain rolls exact."""
    return torch.stack(
        [
            img,
            torch.roll(img, 1, dims=1), torch.roll(img, -1, dims=1),
            torch.roll(img, 1, dims=0), torch.roll(img, -1, dims=0),
        ]
    ).reshape(5, -1)


def so3_step_plain(
    last_image: torch.Tensor,   # (H,W) float intensity
    next_image: torch.Tensor,
    image_basis: torch.Tensor,  # (3,3) K R K⁻¹
    kinv: torch.Tensor,         # (3,3)
    krlr: torch.Tensor,         # (3,3) K R
    active: Optional[torch.Tensor] = None,
) -> Optional[GramSO3]:
    """Whole-image rotation-only Lucas-Kanade step, mirroring
    SO3Reduction::getProducts (reduce.cu:820-896).  Gradients are central
    differences in the original's (back−fore)/2 form — the NEGATIVE of d/dx.
    None when `active` is 0."""
    if inactive(active):
        return None
    H, W = next_image.shape
    x, y = _flat_xy(H, W, next_image.device)

    ref = torch.stack([x, y, torch.ones_like(x)])             # (3,N)
    warped = image_basis @ ref
    safe_wz = torch.where(torch.abs(warped[2]) > 1e-12, warped[2],
                          torch.ones_like(x))
    wx = _round_i(warped[0] / safe_wz)
    wy = _round_i(warped[1] / safe_wz)

    xi = x.to(torch.int64)
    yi = y.to(torch.int64)
    found = (
        (wx >= 1) & (wx < W - 1) & (wy >= 1) & (wy < H - 1)
        & (xi >= 1) & (xi < W - 1) & (yi >= 1) & (yi < H - 1)
    )

    flat_w = torch.clamp(wy, 1, H - 2) * W + torch.clamp(wx, 1, W - 2)
    n_at, n_xm, n_xp, n_ym, n_yp = so3_neighborhood_table(next_image)[:, flat_w]
    flat_l = torch.clamp(yi, 1, H - 2) * W + torch.clamp(xi, 1, W - 2)
    l_at, l_xm, l_xp, l_ym, l_yp = so3_neighborhood_table(last_image)[:, flat_l]

    gnx = (n_xm - n_xp) * 0.5
    gny = (n_ym - n_yp) * 0.5
    glx = (l_xm - l_xp) * 0.5
    gly = (l_ym - l_yp) * 0.5

    gx = (gnx + glx) * 0.5
    gy = (gny + gly) * 0.5

    point = kinv @ ref                                         # (3,N)
    z2 = point[2] * point[2]
    a, b_, c = krlr[0, 0], krlr[0, 1], krlr[0, 2]
    d, e, f = krlr[1, 0], krlr[1, 1], krlr[1, 2]
    g, h, i_ = krlr[2, 0], krlr[2, 1], krlr[2, 2]

    lp = torch.stack(
        [
            (point[2] * (d * gy + a * gx) - gy * g * y - gx * g * x) / z2,
            (point[2] * (e * gy + b_ * gx) - gy * h * y - gx * h * x) / z2,
            (point[2] * (f * gy + c * gx) - gy * i_ * y - gx * i_ * x) / z2,
        ]
    )
    jac = torch.linalg.cross(lp, point, dim=0)                 # (3,N)
    resid = -(n_at - l_at)

    rows = torch.cat([jac, resid[None]])                       # (4,N)
    rows = torch.where(found[None, :], rows, torch.zeros_like(rows))
    G = gram_outer(rows.contiguous())
    return GramSO3(A=G[:3, :3], b=G[:3, 3], sum_sq=G[3, 3],
                   count=found.to(torch.float32).sum())


def so3_step(
    last_image: torch.Tensor, next_image: torch.Tensor,
    image_basis: torch.Tensor, kinv: torch.Tensor, krlr: torch.Tensor,
    out: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> Optional[GramSO3]:
    """`so3_step_plain` for CPU tensors; for CUDA tensors one launch of
    `ef_so3_step`, which reads each pixel's four neighbours straight from the
    two images.  `out`, when given, is a
    float32 `[14]` slice that receives A (9, row-major), b (3), Σr², count —
    the returned GramSO3 then views it.  Where `active` is 0 nothing is
    written (the CPU path returns None)."""
    if next_image.device.type == "cpu":
        g = so3_step_plain(last_image, next_image, image_basis, kinv, krlr, active)
        if g is not None and out is not None:
            out[0:9] = g.A.reshape(-1)
            out[9:12] = g.b
            out[12] = g.sum_sq
            out[13] = g.count
        return g
    dev = _cuda_device("so3_step", next_image, last_image=last_image,
                       next_image=next_image, image_basis=image_basis,
                       kinv=kinv, krlr=krlr)
    H, W = next_image.shape
    if (last_image.shape != (H, W) or image_basis.shape != (3, 3)
            or kinv.shape != (3, 3) or krlr.shape != (3, 3)):
        raise ValueError("so3_step: wants two (H,W) images and (3,3) matrices")
    out = _out_buffer("so3_step", out, 14, dev)
    partials, ticket = reduction_scratch("so3_step", dev, 11)
    fn = kernel_function("odometry_steps", "ef_so3_step", _SO3_STEP_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(_active_ptr(active, dev), last_image.data_ptr(),
                  next_image.data_ptr(), image_basis.data_ptr(), kinv.data_ptr(), krlr.data_ptr(), H, W,
                  partials.data_ptr(), ticket.data_ptr(),
                  reduction_grid(H * W, _PIXELS_PER_THREAD), out.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    check_launch(code, "so3_step")
    return GramSO3(A=out[0:9].view(3, 3), b=out[9:12], sum_sq=out[12], count=out[13])


def project_to_point_cloud(
    depth: torch.Tensor, fx: float, fy: float, cx: float, cy: float
) -> torch.Tensor:
    """Back-project a depth image without validity gating
    (projectPointsKernel, cudafuncs.cu:670-709): z=0 → zero point."""
    H, W = depth.shape
    u, v = pixel_grid(H, W, depth.device)
    return torch.stack([(u - cx) * depth / fx, (v - cy) * depth / fy, depth])


# ---------------------------------------------------------------------------
# The tracker's update on the card: csrc/tracker_update.cu.  The state of an
# SO(3) pre-alignment or a Gauss-Newton solve is one float32 `carry` tensor
# and one int32 `active` flag on the device; each update reads the step
# kernels' pack, updates the carry and the flag in place, and writes the
# small matrices the next iteration's steps read.  The plain versions below
# are the specification: the kernel repeats their operations in their order
# (every product and sum rounded on its own, matrix products as chains of
# fused multiply-adds as XLA and BLAS compute them, IEEE divisions and square
# roots), so on a card the two agree bit for bit; on the CPU they are the
# tracker's path.
# ---------------------------------------------------------------------------

# SO(3) carry: R (9), the previous R (9), last error, last count, the error
# and count reported, K R K^-1 (9) and K R (9) for the next so3_step, K^-1 (9)
S3_R, S3_LAST_R, S3_LAST_ERR, S3_LAST_CNT, S3_ERR, S3_CNT = 0, 9, 18, 19, 20, 21
S3_BASIS, S3_KRLR, S3_KINV = 22, 31, 40
SO3_CARRY = 49
# Gauss-Newton carry: resultRt (16), T_curr (16), K R K^-1 (9) and K t (3) of
# the next iteration, A (36), b (6), the ICP / RGB errors and counts, the
# rgbOnly divergence reference and the previous total error (per level), then
# the finished pose (16), the covariance gate, and whether the solve runs
GN_RT, GN_TCURR, GN_KRKINV, GN_KT, GN_A, GN_B = 0, 16, 32, 41, 44, 80
GN_ICP_ERR, GN_ICP_CNT, GN_RGB_ERR, GN_RGB_CNT = 86, 87, 88, 89
GN_ERR_BREAK, GN_PREV_ERR, GN_TOUT, GN_COV_OK, GN_ENABLE = 90, 91, 92, 108, 109
GN_CARRY = 110
# the pack the four steps write (tracking.py): ICP A | b | Σr² | count, RGB
# A | b, Σdiff² | count
PACK = 88
SO3_PACK = 14
_BIG_SO3 = 3.4e38 / 2
_BIG_GN = 3.4e38


class LevelK(NamedTuple):
    """K and K⁻¹ of one pyramid level as the float32 entries the tracker
    uses: fx, fy, cx, cy, 1/fx, 1/fy, -cx/fx, -cy/fy (each rounded once)."""

    fx: float
    fy: float
    cx: float
    cy: float
    ifx: float
    ify: float
    ncx: float
    ncy: float


def level_k(cam) -> LevelK:
    """`LevelK` of a (scaled) `CameraConfig`."""
    return LevelK(cam.fx, cam.fy, cam.cx, cam.cy, 1.0 / cam.fx, 1.0 / cam.fy,
                  -cam.cx / cam.fx, -cam.cy / cam.fy)


class GNOptions(NamedTuple):
    """The static switches and limits of a Gauss-Newton solve."""

    icp_on: bool
    rgb_on: bool
    rgb_only: bool
    icp_weight: float
    early_exit: float
    plateau_exit: float
    translation_sanity: float
    cov_threshold: float


# --- plain arithmetic (float32 tensors, each operation rounded on its own) ---

def _c(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on `like`'s device, made by a fill (never a copy
    from the host)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B as the chain of fused multiply-adds in index order that XLA and
    BLAS compile a small float32 matrix product to: out = A0 B0, then
    out = fma(Aq, Bq, out).  Each fma is one float64 product (exact for
    float32 factors) and sum rounded to float32, which is the fused result
    except where the float64 sum lands on a float32 tie (odds ~2^-29)."""
    out = A[:, 0:1] * B[0:1, :]
    for q in range(1, A.shape[1]):
        out = (A[:, q:q + 1].double() * B[q:q + 1, :].double() + out.double()).float()
    return out


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (the kernel's __fsqrt_rn,
    numpy's): the CPU's torch.sqrt is off by an ulp on ~0.7 % of float32
    inputs; a float64 root rounded to float32 is exact."""
    return torch.sqrt(x.double()).float()


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return _mm(A, v.reshape(-1, 1)).reshape(-1)


def _compose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    bottom = torch.zeros((1, 4), dtype=R.dtype, device=R.device)
    bottom[0, 3] = 1.0
    return torch.cat([torch.cat([R, t.reshape(3, 1)], 1), bottom])


def _invert(T: torch.Tensor) -> torch.Tensor:
    Rt = T[:3, :3].T
    return _compose(Rt, -_mv(Rt, T[:3, 3]))


def _k_mats(k: LevelK, like: torch.Tensor):
    K = torch.tensor([[k.fx, 0.0, k.cx], [0.0, k.fy, k.cy], [0.0, 0.0, 1.0]],
                     dtype=torch.float32).to(like.device)
    Kinv = torch.tensor([[k.ifx, 0.0, k.ncx], [0.0, k.ify, k.ncy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32).to(like.device)
    return K, Kinv


def so3_exp_ordered(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues (se3.so3_exp) with the kernel's order of operations; its
    root is torch.sqrt, as se3.so3_exp's (correctly rounded on a card)."""
    t2 = (w[0] * w[0] + w[1] * w[1]) + w[2] * w[2]
    theta = torch.sqrt(t2)
    small = t2 < 1e-8
    one = _c(1.0, w)
    a = torch.where(small, one - t2 / _c(6.0, w),
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, _c(0.5, w) - t2 / _c(24.0, w),
                    (one - torch.cos(theta)) / torch.where(small, one, t2))
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    K = torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                     torch.stack([-w[1], w[0], z])])
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return (eye + a * K) + b * _mm(K, K)


def _damped(A: torch.Tensor) -> torch.Tensor:
    n = A.shape[0]
    return A + torch.eye(n, dtype=A.dtype, device=A.device) * 1e-12


def solve_3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Damped 3×3 solve by Cramer's rule (SO(3) pre-alignment)."""
    A = _damped(A)
    c00 = A[1, 1] * A[2, 2] - A[1, 2] * A[2, 1]
    c01 = A[1, 2] * A[2, 0] - A[1, 0] * A[2, 2]
    c02 = A[1, 0] * A[2, 1] - A[1, 1] * A[2, 0]
    det = (A[0, 0] * c00 + A[0, 1] * c01) + A[0, 2] * c02
    inv_det = _c(1.0, A) / torch.where(torch.abs(det) > 1e-30, det, _c(1e-30, A))
    c10 = A[0, 2] * A[2, 1] - A[0, 1] * A[2, 2]
    c11 = A[0, 0] * A[2, 2] - A[0, 2] * A[2, 0]
    c12 = A[0, 1] * A[2, 0] - A[0, 0] * A[2, 1]
    c20 = A[0, 1] * A[1, 2] - A[0, 2] * A[1, 1]
    c21 = A[0, 2] * A[1, 0] - A[0, 0] * A[1, 2]
    c22 = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    return torch.stack([((c00 * b[0] + c10 * b[1]) + c20 * b[2]) * inv_det,
                        ((c01 * b[0] + c11 * b[1]) + c21 * b[2]) * inv_det,
                        ((c02 * b[0] + c12 * b[1]) + c22 * b[2]) * inv_det])


def _cholesky(A: torch.Tensor):
    """Unrolled Cholesky of the damped SPD matrix: (L below the diagonal,
    the reciprocals of its diagonal), as lists of 0-d tensors."""
    n = A.shape[0]
    A = _damped(A)
    L = [[None] * n for _ in range(n)]
    inv_d = [None] * n
    one = _c(1.0, A)
    for j in range(n):
        s = A[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        inv_d[j] = one / _sqrt(torch.clamp(s, min=1e-30))
        for i in range(j + 1, n):
            s2 = A[i, j]
            for k in range(j):
                s2 = s2 - L[i][k] * L[j][k]
            L[i][j] = s2 * inv_d[j]
    return L, inv_d


def solve_6x6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """6×6 solve of the SPD Gauss-Newton normal equations (the original does
    an Eigen ldlt on the host, RGBDOdometry.cpp:522-537) as an unrolled
    Cholesky; the tiny damping guards rank deficiency when a frame has no
    valid pixels."""
    n = A.shape[0]
    L, inv_d = _cholesky(A)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * inv_d[i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s * inv_d[i]
    return torch.stack(x)


def covariance_ok(A: torch.Tensor, thresh: float) -> torch.Tensor:
    """Every diagonal entry of (A + 1e-12 I)⁻¹ below `thresh` (bool 0-d), the
    tracking gate's covariance test (ElasticFusion.cpp:326-344), through the
    same Cholesky: column c of L⁻¹ by forward substitution, the diagonal as
    the sum of its squares.  A NaN fails."""
    n = A.shape[0]
    L, inv_d = _cholesky(A)
    ok = torch.ones((), dtype=torch.bool, device=A.device)
    for c in range(n):
        X = {c: inv_d[c]}
        diag = X[c] * X[c]
        for r in range(c + 1, n):
            s = L[r][c] * X[c]
            for k in range(c + 1, r):
                s = s + L[r][k] * X[k]
            X[r] = -s * inv_d[r]
            diag = diag + X[r] * X[r]
        ok = ok & (diag < thresh)
    return ok


def _so3_matrices(carry: torch.Tensor, K, Kinv) -> None:
    KR = _mm(K, carry[S3_R:S3_R + 9].reshape(3, 3))
    carry[S3_BASIS:S3_BASIS + 9] = _mm(KR, Kinv).reshape(-1)
    carry[S3_KRLR:S3_KRLR + 9] = KR.reshape(-1)


def _gn_matrices(carry: torch.Tensor, K, Kinv) -> None:
    Ti = _invert(carry[GN_RT:GN_RT + 16].reshape(4, 4))
    carry[GN_KRKINV:GN_KRKINV + 9] = _mm(_mm(K, Ti[:3, :3]), Kinv).reshape(-1)
    carry[GN_KT:GN_KT + 3] = _mv(K, Ti[:3, 3])


def so3_update_plain(stage: int, pack: Optional[torch.Tensor], carry: torch.Tensor,
                     active: torch.Tensor, k: LevelK) -> None:
    """Plain version of `so3_update`: stage 0 starts the carry, stage 1 is
    one pre-alignment iteration's update (RGBDOdometry.cpp:284-369; the
    reference's `_so3_prealign` body), a no-op while `active` is 0."""
    K, Kinv = _k_mats(k, carry)
    if stage == 0:
        eye = torch.eye(3, dtype=torch.float32, device=carry.device).reshape(-1)
        carry[S3_R:S3_R + 9] = eye
        carry[S3_LAST_R:S3_LAST_R + 9] = eye
        carry[S3_KINV:S3_KINV + 9] = Kinv.reshape(-1)
        carry[S3_LAST_ERR] = _BIG_SO3
        carry[S3_LAST_CNT] = _BIG_SO3
        carry[S3_ERR] = 0.0
        carry[S3_CNT] = 0.0
        active.fill_(1)
    elif not inactive(active):
        g_count = pack[13]
        err = _sqrt(pack[12]) / torch.clamp(g_count, min=1.0)
        last_err, last_cnt = carry[S3_LAST_ERR].clone(), carry[S3_LAST_CNT].clone()
        converged = bool((err < last_err) & (last_cnt == g_count))
        diverged = bool(err > last_err + 0.001)
        R = carry[S3_R:S3_R + 9].reshape(3, 3).clone()
        if diverged:
            next_R = carry[S3_LAST_R:S3_LAST_R + 9].reshape(3, 3).clone()
            carry[S3_ERR], carry[S3_CNT] = last_err, last_cnt
        else:
            carry[S3_ERR], carry[S3_CNT] = err, g_count
            if converged:
                next_R = R
            else:
                delta = solve_3x3(pack[0:9].reshape(3, 3), pack[9:12])
                next_R = _mm(so3_exp_ordered(delta), R)
        carry[S3_LAST_R:S3_LAST_R + 9] = R.reshape(-1)
        carry[S3_R:S3_R + 9] = next_R.reshape(-1)
        done = converged or diverged
        if not done:
            carry[S3_LAST_ERR], carry[S3_LAST_CNT] = err, g_count
        active.fill_(0 if done else 1)
    _so3_matrices(carry, K, Kinv)


def _gn_step_plain(P, C, active, T_prev, o: GNOptions) -> None:
    one = _c(1.0, C)
    rgb_error = (_sqrt(P[86]) / torch.where(P[87] != 0, P[87], one)
                 if o.rgb_on else _c(0.0, C))
    icp_error = (_sqrt(P[42]) / torch.clamp(P[43], min=1.0)
                 if o.icp_on else _c(0.0, C))
    # rgbOnly divergence (cpp:448-451): keep the pre-update carry and stop
    if o.rgb_only and bool(rgb_error > C[GN_ERR_BREAK]):
        active.fill_(0)
        return
    Ai, bi = P[0:36].reshape(6, 6), P[36:42]
    Ar, br = P[44:80].reshape(6, 6), P[80:86]
    if o.icp_on and o.rgb_on:
        w = _c(o.icp_weight, C)
        A, b = Ar + (w * w) * Ai, br + w * bi
    elif o.icp_on:
        A, b = Ai, bi
    else:
        A, b = Ar, br
    x = solve_6x6(A, b)
    total_err = icp_error + rgb_error
    sq = x[0] * x[0]
    for i in range(1, 6):
        sq = sq + x[i] * x[i]
    stop = bool(_sqrt(sq) < o.early_exit)
    if o.plateau_exit > 0:
        stop = stop or bool(torch.abs(total_err - C[GN_PREV_ERR])
                            < _c(o.plateau_exit, C) * torch.clamp(total_err, min=1e-12))
    # computeUpdateSE3 (OdometryProvider.h:73-96): left-multiply, then
    # currentT = prevT * rgbOdom^-1 (cpp:553-560)
    rt = _mm(_compose(so3_exp_ordered(x[3:6]), x[0:3]),
             C[GN_RT:GN_RT + 16].reshape(4, 4))
    C[GN_TCURR:GN_TCURR + 16] = _mm(T_prev, _invert(rt)).reshape(-1)
    C[GN_RT:GN_RT + 16] = rt.reshape(-1)
    C[GN_ICP_ERR], C[GN_ICP_CNT] = icp_error, P[43]
    C[GN_RGB_ERR], C[GN_RGB_CNT] = rgb_error, P[87]
    C[GN_A:GN_A + 36] = A.reshape(-1)
    C[GN_B:GN_B + 6] = b
    C[GN_ERR_BREAK], C[GN_PREV_ERR] = rgb_error, total_err
    if stop:
        active.fill_(0)


def _gn_finish_plain(C, T_prev, o: GNOptions) -> None:
    R, t = C[GN_TCURR:GN_TCURR + 16].reshape(4, 4)[:3, :3], C[GN_TCURR:GN_TCURR + 16].reshape(4, 4)[:3, 3]
    d = t - T_prev[:3, 3]
    # sanity clamp, unconditional in the original (cpp:553-558)
    if bool(_sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]) > o.translation_sanity):
        R, t = T_prev[:3, :3], T_prev[:3, 3]
    # three Newton-Schulz steps R <- 1.5 R - 0.5 R (R^T R) (se3.orthonormalize)
    for _ in range(3):
        R = 1.5 * R - 0.5 * _mm(R, _mm(R.T, R))
    C[GN_TOUT:GN_TOUT + 16] = _compose(R, t).reshape(-1)
    C[GN_COV_OK] = covariance_ok(C[GN_A:GN_A + 36].reshape(6, 6),
                                 o.cov_threshold).to(torch.float32)


def gn_update_plain(stage: int, pack: Optional[torch.Tensor], carry: torch.Tensor,
                    active: torch.Tensor, T_prev: torch.Tensor,
                    so3_carry: Optional[torch.Tensor], enable: Optional[torch.Tensor],
                    k: LevelK, o: GNOptions, last_of_level: bool = False) -> None:
    """Plain version of `gn_update`.  Stage 0 starts the carry from the SO(3)
    rotation (`so3_carry`, or the identity) and the previous pose, active
    where `enable` (int32, default on) is nonzero; stage 1 is one iteration's
    update (the reference's `gn_iter`), a no-op while `active` is 0, and on
    a level's last iteration resets the flag and the per-level references
    (cpp:406); stage 2 finishes: the sanity clamp, orthonormalisation, and
    the covariance gate.  Stages 0 and 1 end with the next iteration's small
    matrices at the level `k`."""
    C = carry
    if stage == 0:
        R = (so3_carry[S3_R:S3_R + 9].reshape(3, 3) if so3_carry is not None
             else torch.eye(3, dtype=torch.float32, device=C.device))
        C[GN_RT:GN_RT + 16] = _compose(R, torch.zeros(3, device=C.device)).reshape(-1)
        C[GN_TCURR:GN_TCURR + 16] = _compose(T_prev[:3, :3], T_prev[:3, 3]).reshape(-1)
        C[GN_A:GN_ERR_BREAK] = 0.0
        C[GN_ERR_BREAK] = _BIG_GN
        C[GN_PREV_ERR] = _BIG_GN
        on = enable is None or bool(enable != 0)
        C[GN_ENABLE] = 1.0 if on else 0.0
        active.fill_(1 if on else 0)
    elif stage == 1:
        if not inactive(active):
            _gn_step_plain(pack, C, active, T_prev, o)
        if last_of_level:
            active.fill_(1 if bool(C[GN_ENABLE] != 0) else 0)
            C[GN_ERR_BREAK] = _BIG_GN
            C[GN_PREV_ERR] = _BIG_GN
    else:
        _gn_finish_plain(C, T_prev, o)
        return
    K, Kinv = _k_mats(k, C)
    _gn_matrices(C, K, Kinv)


def _update_tensors(what: str, carry: torch.Tensor, n: int, active: torch.Tensor,
                    pack: Optional[torch.Tensor], n_pack: int, **others) -> torch.device:
    dev = carry.device
    if (carry.dtype != torch.float32 or carry.shape != (n,) or not carry.is_contiguous()
            or active.dtype != torch.int32 or active.shape != (1,) or active.device != dev):
        raise ValueError(f"{what}: wants a float32 [{n}] carry and an int32 [1] flag "
                         f"on one device")
    if pack is not None and (pack.shape != (n_pack,) or pack.dtype != torch.float32
                             or pack.device != dev or not pack.is_contiguous()):
        raise ValueError(f"{what}: wants a contiguous float32 [{n_pack}] pack on {dev}")
    for name, t in others.items():
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous on {dev}")
    return dev


def so3_update(stage: int, pack: Optional[torch.Tensor], carry: torch.Tensor,
               active: torch.Tensor, k: LevelK) -> None:
    """One launch of `ef_so3_update` for CUDA tensors (`so3_update_plain`
    for CPU ones): updates `carry` [SO3_CARRY] and `active` in place."""
    dev = _update_tensors("so3_update", carry, SO3_CARRY, active, pack, SO3_PACK)
    if stage not in (0, 1) or (stage == 1 and pack is None):
        raise ValueError("so3_update: stage 0, or stage 1 with the step's pack")
    if dev.type == "cpu":
        return so3_update_plain(stage, pack, carry, active, k)
    if dev.type != "cuda":
        raise ValueError(f"so3_update: unsupported device {dev}")
    fn = kernel_function("tracker_update", "ef_so3_update", _SO3_UPDATE_ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(stage, None if pack is None else pack.data_ptr(), carry.data_ptr(),
                  active.data_ptr(), *k, torch.cuda.current_stream().cuda_stream)
    check_launch(code, "so3_update")


def gn_update(stage: int, pack: Optional[torch.Tensor], carry: torch.Tensor,
              active: torch.Tensor, T_prev: torch.Tensor,
              so3_carry: Optional[torch.Tensor], enable: Optional[torch.Tensor],
              k: LevelK, o: GNOptions, last_of_level: bool = False) -> None:
    """One launch of `ef_gn_update` for CUDA tensors (`gn_update_plain` for
    CPU ones): updates `carry` [GN_CARRY] and `active` in place."""
    dev = _update_tensors("gn_update", carry, GN_CARRY, active, pack, PACK,
                          T_prev=T_prev, so3_carry=so3_carry, enable=enable)
    if stage not in (0, 1, 2) or (stage == 1 and pack is None) \
            or T_prev.shape != (4, 4) or T_prev.dtype != torch.float32 \
            or (enable is not None and (enable.dtype != torch.int32 or enable.numel() != 1)):
        raise ValueError("gn_update: stage 0, 1 (with the pack) or 2, a float32 (4,4) "
                         "T_prev and an int32 [1] enable")
    if dev.type == "cpu":
        return gn_update_plain(stage, pack, carry, active, T_prev, so3_carry, enable,
                               k, o, last_of_level)
    if dev.type != "cuda":
        raise ValueError(f"gn_update: unsupported device {dev}")
    fn = kernel_function("tracker_update", "ef_gn_update", _GN_UPDATE_ARGTYPES)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        code = fn(stage, ptr(pack), carry.data_ptr(), active.data_ptr(),
                  T_prev.data_ptr(), ptr(so3_carry), ptr(enable), *k,
                  int(o.icp_on), int(o.rgb_on), int(o.rgb_only), int(last_of_level),
                  o.icp_weight, o.early_exit, o.plateau_exit, o.translation_sanity,
                  o.cov_threshold, torch.cuda.current_stream().cuda_stream)
    check_launch(code, "gn_update")
