"""Frame-to-model RGB-D odometry — the equivalent of
`RGBDOdometry::getIncrementalTransformation` (Core/Utils/RGBDOdometry.cpp:
259-571): SO(3) pre-alignment, then a 3-level coarse-to-fine Gauss-Newton on
the joint ICP + RGB normal equations.

The whole solve runs on the tensors' device and never reads it back: the
reference package's `lax.while_loop`s become a fixed sequence of launches.
Each loop keeps its state in one float32 carry tensor and one int32 `active`
flag on the device (ops/odometry.py `SO3_CARRY`, `GN_CARRY`).  An SO(3)
iteration is `so3_step` (which writes A, b, Σr², count into a 14-float pack)
then `so3_update`; a Gauss-Newton iteration is `compute_rgb_residual`,
`rgb_step` and `icp_step` (each writing its slice of one 88-float pack) then
`gn_update`, which solves the 6×6 system, updates the pose, runs the exit
tests and writes the next iteration's small matrices.  Every step is
predicated on `active`, so a level runs its whole budget
(`so3_iterations`, `gn_iterations`) and the iterations after the exit change
nothing, as the reference's carry after its `cond` fails.  One `gn_update`
starts the Gauss-Newton carry and one finishes it (sanity clamp,
orthonormalisation, the covariance gate).

Layout of the pack: `[0:36]` ICP A, `[36:42]` ICP b, `[42]` ICP Σr², `[43]`
ICP count, `[44:80]` RGB A, `[80:86]` RGB b, `[86]` Σdiff², `[87]` RGB
count; a half whose term is switched off stays zero.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .config import CameraConfig, EngineConfig
from .ops.odometry import (
    GN_A,
    GN_B,
    GN_CARRY,
    GN_COV_OK,
    GN_ICP_CNT,
    GN_ICP_ERR,
    GN_KRKINV,
    GN_KT,
    GN_RGB_CNT,
    GN_RGB_ERR,
    GN_TCURR,
    GN_TOUT,
    PACK,
    S3_BASIS,
    S3_CNT,
    S3_ERR,
    S3_KINV,
    S3_KRLR,
    SO3_CARRY,
    SO3_PACK,
    GNOptions,
    compute_rgb_residual,
    gn_update,
    icp_prev_table,
    icp_step,
    level_k,
    project_to_point_cloud,
    rgb_last_table,
    rgb_static_gates,
    rgb_step,
    so3_step,
    so3_update,
)
from .ops.preprocess import (
    SOBEL_SCALE,
    compute_nmap,
    compute_vmap,
    resize_nmap,
    resize_vmap,
    rgb_to_intensity,
    vertices_to_depth,
)
from .ops.pyramid import (
    compute_derivatives,
    pyr_down_depth,
    pyr_down_gauss,
    pyr_down_intensity,
)


class OdometryInputs(NamedTuple):
    """Everything `getIncrementalTransformation` reads.  All tuples are
    per-pyramid-level (level 0 = full resolution)."""

    vmaps_curr: Tuple[torch.Tensor, ...]    # (3,H,W) camera frame
    nmaps_curr: Tuple[torch.Tensor, ...]
    vmaps_prev_g: Tuple[torch.Tensor, ...]  # (3,H,W) WORLD frame (model pred.)
    nmaps_prev_g: Tuple[torch.Tensor, ...]
    last_images: Tuple[torch.Tensor, ...]   # (H,W) f32 intensity (model pred.)
    next_images: Tuple[torch.Tensor, ...]   # (H,W) f32 intensity (current)
    last_depths: Tuple[torch.Tensor, ...]   # (H,W) f32 m
    next_depths: Tuple[torch.Tensor, ...]
    so3_last_image: torch.Tensor            # prev frame intensity at coarsest lvl
    T_prev: torch.Tensor                    # (4,4) f32 world←camera


class TrackingResult(NamedTuple):
    """Every field a tensor on the inputs' device (views of the solve's
    carries)."""

    T_curr: torch.Tensor          # (4,4)
    icp_error: torch.Tensor       # sqrt(Σr²)/inliers  (lastICPError)
    icp_count: torch.Tensor
    rgb_error: torch.Tensor
    rgb_count: torch.Tensor
    so3_error: torch.Tensor
    so3_count: torch.Tensor
    A: torch.Tensor               # (6,6) last combined normal matrix (lastA)
    b: torch.Tensor
    cov_ok: torch.Tensor          # bool: every diag of (A + 1e-12 I)^-1 under
                                  # cfg.reloc_cov_threshold


def _so3_prealign(cam: CameraConfig, last_img: torch.Tensor,
                  next_img: torch.Tensor, iters: int) -> torch.Tensor:
    """SO(3) pre-alignment loop (RGBDOdometry.cpp:284-369) with the
    convergence/divergence guards, `iters` predicated iterations on the
    device.  Returns the SO(3) carry (ops/odometry.py `S3_*`)."""
    dev = next_img.device
    k = level_k(cam.scaled(2))
    carry = torch.empty((SO3_CARRY,), dtype=torch.float32, device=dev)
    active = torch.empty((1,), dtype=torch.int32, device=dev)
    pack = torch.zeros((SO3_PACK,), dtype=torch.float32, device=dev)
    so3_update(0, None, carry, active, k)
    basis = carry[S3_BASIS:S3_BASIS + 9].view(3, 3)
    kinv = carry[S3_KINV:S3_KINV + 9].view(3, 3)
    krlr = carry[S3_KRLR:S3_KRLR + 9].view(3, 3)
    for _ in range(iters):
        so3_step(last_img, next_img, basis, kinv, krlr, out=pack, active=active)
        so3_update(1, pack, carry, active, k)
    return carry


def gn_options(cfg: EngineConfig) -> GNOptions:
    return GNOptions(
        icp_on=(not cfg.rgb_only) and cfg.icp_weight > 0,
        rgb_on=cfg.rgb_only or cfg.icp_weight < 100,
        rgb_only=cfg.rgb_only, icp_weight=float(cfg.icp_weight),
        early_exit=float(cfg.gn_early_exit), plateau_exit=float(cfg.gn_plateau_exit),
        translation_sanity=float(cfg.translation_sanity),
        cov_threshold=float(cfg.reloc_cov_threshold))


def get_incremental_transformation(
    inputs: OdometryInputs, cfg: EngineConfig,
    enable: Optional[torch.Tensor] = None,
) -> TrackingResult:
    """One full tracking solve.  Mirrors RGBDOdometry.cpp:259-571; see the
    module docstring for where the work runs.  `enable` (a 0-d bool or int
    tensor on the device, default on) predicates every iteration: where it
    is false the solve launches its kernels and they change nothing, the
    result being the previous pose.  Every result is a tensor on the inputs'
    device; nothing is read back."""
    cam = cfg.camera
    dev = inputs.vmaps_curr[0].device
    o = gn_options(cfg)
    icp_on, rgb_on = o.icp_on, o.rgb_on
    T_prev = inputs.T_prev.to(device=dev, dtype=torch.float32).contiguous()
    if enable is not None:
        enable = enable.to(torch.int32).reshape(1)

    n_lvls = cfg.num_pyramid_levels
    if rgb_on:
        derivs = [compute_derivatives(img) for img in inputs.next_images]
    else:
        derivs = [(torch.zeros_like(img), torch.zeros_like(img))
                  for img in inputs.next_images]

    # --- SO(3) pre-alignment at the coarsest level (cpp:284-369) ---
    so3 = (_so3_prealign(cam, inputs.so3_last_image, inputs.next_images[2],
                         cfg.so3_iterations) if cfg.so3 else None)

    iters = list(cfg.fast_odom_iterations if cfg.fast_odom else cfg.gn_iterations)
    if not cfg.pyramid:
        iters[1] = iters[2] = 0
    # the iterations in order, each with its level
    schedule = [lvl for lvl in range(n_lvls - 1, -1, -1) for _ in range(iters[lvl])]
    ks = [level_k(cam.scaled(lvl)) for lvl in range(n_lvls)]

    carry = torch.empty((GN_CARRY,), dtype=torch.float32, device=dev)
    active = torch.empty((1,), dtype=torch.int32, device=dev)
    # every step overwrites its slice of the pack while active
    pack = torch.zeros((PACK,), dtype=torch.float32, device=dev)
    gn_update(0, None, carry, active, T_prev, so3, enable,
              ks[schedule[0] if schedule else 0], o)
    T_curr = carry[GN_TCURR:GN_TCURR + 16].view(4, 4)
    krkinv = carry[GN_KRKINV:GN_KRKINV + 9].view(3, 3)
    kt = carry[GN_KT:GN_KT + 3]
    # rgbOnly weighs every pixel evenly (sigma = -1); otherwise rgb_step derives
    # sigma from what compute_rgb_residual counted
    sigma_arg = (torch.full((), -1.0, dtype=torch.float32, device=dev)
                 if cfg.rgb_only else None)

    j = 0
    for lvl in range(n_lvls - 1, -1, -1):
        if iters[lvl] == 0:
            continue
        c = cam.scaled(lvl)
        cloud = (
            project_to_point_cloud(inputs.last_depths[lvl], c.fx, c.fy, c.cx, c.cy)
            if rgb_on else None
        )
        dIdx, dIdy = derivs[lvl]
        min_grad2 = (cfg.rgb_grad_thresholds[lvl]) / (SOBEL_SCALE * SOBEL_SCALE)

        # loop-invariant gather tables, hoisted out of the GN body (the model
        # table in u16 fixed point with `fx16_tables`)
        prev_table = (
            icp_prev_table(inputs.vmaps_prev_g[lvl], inputs.nmaps_prev_g[lvl],
                           fx16=cfg.fx16_tables)
            if icp_on else None
        )
        last_table = (
            rgb_last_table(inputs.last_depths[lvl], inputs.last_images[lvl], cloud)
            if rgb_on else None
        )
        static_gates = (
            rgb_static_gates(min_grad2, dIdx, dIdy,
                             inputs.next_depths[lvl], inputs.next_images[lvl])
            if rgb_on else None
        )

        for _ in range(iters[lvl]):
            if rgb_on:
                corres = compute_rgb_residual(
                    min_grad2, dIdx, dIdy,
                    inputs.last_depths[lvl], inputs.next_depths[lvl],
                    inputs.last_images[lvl], inputs.next_images[lvl],
                    kt, krkinv,
                    last_table=last_table, static_gates=static_gates,
                    out=pack[86:88], active=active,
                )
                rgb_step(corres, sigma_arg, cloud, c.fx, c.fy, dIdx, dIdy,
                         out=pack[44:86], active=active)
            if icp_on:
                icp_step(
                    T_curr,
                    inputs.vmaps_curr[lvl], inputs.nmaps_curr[lvl],
                    T_prev,
                    inputs.vmaps_prev_g[lvl], inputs.nmaps_prev_g[lvl],
                    c.fx, c.fy, c.cx, c.cy,
                    cfg.dist_threshold, cfg.angle_threshold_sin,
                    prev_table=prev_table, out=pack[0:44], active=active,
                )
            j += 1
            last = j == len(schedule) or schedule[j] != lvl
            gn_update(1, pack, carry, active, T_prev, None, None,
                      ks[schedule[j] if j < len(schedule) else lvl], o,
                      last_of_level=last)

    gn_update(2, None, carry, active, T_prev, None, None, ks[0], o)
    if so3 is not None:
        so3e, so3c = so3[S3_ERR], so3[S3_CNT]
    else:
        so3e = so3c = torch.zeros((), dtype=torch.float32, device=dev)
    return TrackingResult(
        T_curr=carry[GN_TOUT:GN_TOUT + 16].view(4, 4),
        icp_error=carry[GN_ICP_ERR], icp_count=carry[GN_ICP_CNT],
        rgb_error=carry[GN_RGB_ERR], rgb_count=carry[GN_RGB_CNT],
        so3_error=so3e, so3_count=so3c,
        A=carry[GN_A:GN_A + 36].view(6, 6), b=carry[GN_B:GN_B + 6],
        cov_ok=carry[GN_COV_OK] != 0,
    )


# ---------------------------------------------------------------------------
# Pyramid construction (initICP / initRGB equivalents)
# ---------------------------------------------------------------------------


def _intensity_pyramid(rgb: torch.Tensor, levels: int):
    intens = [rgb_to_intensity(rgb)]
    for _ in range(1, levels):
        intens.append(pyr_down_intensity(intens[-1]))
    return tuple(intens)


def build_current_frame_pyramids(
    filtered_depth_m: torch.Tensor,
    rgb: torch.Tensor,
    cfg: EngineConfig,
):
    """initICP(filteredDepth)+initRGB equivalent for the CURRENT frame
    (RGBDOdometry.cpp:121-147, 240-244): depth pyramid w/ 3σ rejection,
    vmaps/nmaps per level, intensity pyramid.

    Returns (vmaps, nmaps, images, depth_pyr) tuples, level 0 first."""
    cam = cfg.camera
    depths = [filtered_depth_m]
    for _ in range(1, cfg.num_pyramid_levels):
        depths.append(pyr_down_depth(depths[-1]))
    vmaps = tuple(
        compute_vmap(d, cam.scaled(lvl), cfg.max_depth_processed)
        for lvl, d in enumerate(depths)
    )
    nmaps = tuple(compute_nmap(v) for v in vmaps)
    return vmaps, nmaps, _intensity_pyramid(rgb, cfg.num_pyramid_levels), tuple(depths)


def build_current_model_pyramids(
    pred_vmap: torch.Tensor,     # (3,H,W) predicted vertices, CAMERA frame
    pred_nmap: torch.Tensor,
    pred_image: torch.Tensor,    # (H,W,3) predicted RGB
    cfg: EngineConfig,
):
    """initICP(predictedVertices, predictedNormals) + initRGB equivalent for
    the CURRENT side of model-to-model odometry (RGBDOdometry.cpp:149-173,
    212-244): the 'current frame' is itself a map prediction, so the vmaps
    come from resize (not a depth pyrDown) and the depths from
    verticesToDepth."""
    vmaps = [pred_vmap]
    nmaps = [pred_nmap]
    for _ in range(1, cfg.num_pyramid_levels):
        vmaps.append(resize_vmap(vmaps[-1]))
        nmaps.append(resize_nmap(nmaps[-1]))
    depths = [vertices_to_depth(pred_vmap)]
    for _ in range(1, cfg.num_pyramid_levels):
        depths.append(pyr_down_gauss(depths[-1]))
    return (tuple(vmaps), tuple(nmaps),
            _intensity_pyramid(pred_image, cfg.num_pyramid_levels), tuple(depths))


def build_model_pyramids(
    pred_vmap: torch.Tensor,     # (3,H,W) predicted vertices, CAMERA frame
    pred_nmap: torch.Tensor,
    pred_image: torch.Tensor,    # (H,W,3) predicted RGB
    T_wc: torch.Tensor,          # (4,4) pose used to lift prediction to world
    cfg: EngineConfig,
):
    """initICPModel + initRGBModel equivalent (RGBDOdometry.cpp:149-244):
    resize the predicted maps per level, transform to world frame, derive the
    model depth (verticesToDepth, 6 m cutoff) and intensity pyramids."""
    vmaps_c = [pred_vmap]
    nmaps_c = [pred_nmap]
    for _ in range(1, cfg.num_pyramid_levels):
        vmaps_c.append(resize_vmap(vmaps_c[-1]))
        nmaps_c.append(resize_nmap(nmaps_c[-1]))

    T_wc = T_wc.to(pred_vmap.device)
    R = T_wc[:3, :3]
    t = T_wc[:3, 3]

    def to_world(v, n):
        valid = v[2] > 0
        C, H, W = v.shape
        vg = (R @ v.reshape(3, -1) + t[:, None]).reshape(3, H, W)
        nvalid = torch.sum(n * n, dim=0) > 1e-12
        ng = (R @ n.reshape(3, -1)).reshape(3, H, W)
        return (
            torch.where(valid[None], vg, torch.zeros_like(vg)),
            torch.where(nvalid[None], ng, torch.zeros_like(ng)),
        )

    world = [to_world(v, n) for v, n in zip(vmaps_c, nmaps_c)]
    vmaps_g = tuple(w[0] for w in world)
    nmaps_g = tuple(w[1] for w in world)

    # model depth from the camera-frame prediction (maxDepthRGB=6 m cutoff)
    depths = [vertices_to_depth(pred_vmap)]
    for _ in range(1, cfg.num_pyramid_levels):
        depths.append(pyr_down_gauss(depths[-1]))

    return (vmaps_g, nmaps_g,
            _intensity_pyramid(pred_image, cfg.num_pyramid_levels), tuple(depths))
