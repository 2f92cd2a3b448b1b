"""Frame-to-model RGB-D odometry — the equivalent of
`RGBDOdometry::getIncrementalTransformation` (Core/Utils/RGBDOdometry.cpp:
259-571): SO(3) pre-alignment, then a 3-level coarse-to-fine Gauss-Newton on
the joint ICP + RGB normal equations.

The per-pixel work of every iteration runs on the tensors' device.  The
reference package's `lax.while_loop`s are Python loops here.  A Gauss-Newton
iteration on a card is one small upload (pose, K·R·K⁻¹, K·t), three kernel
launches (`compute_rgb_residual`, `rgb_step`, `icp_step`, each of which builds
its rows in registers and writes its normal equations straight into its slice
of one 88-float pack buffer) and ONE read of that buffer
(`_device.read_back`); the 6×6 solve, the pose update and the exit tests then
run on the host in float32 with the reference's arithmetic.  An SO(3)
pre-alignment iteration is likewise one upload (K·R·K⁻¹, K·R), ONE launch
(`so3_step`, which writes A, b, Σr², count into a 14-float pack buffer) and
one read.  So a frame costs at most `so3_iterations + sum(gn_iterations) + 1`
reads here (10 + 19 + 1 by default).

Layout of the pack buffer: `[0:36]` ICP A, `[36:42]` ICP b, `[42]` ICP Σr²,
`[43]` ICP count, `[44:80]` RGB A, `[80:86]` RGB b, `[86]` Σdiff², `[87]` RGB
count; a half whose term is switched off stays zero.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ._device import read_back
from .config import CameraConfig, EngineConfig
from .ops.odometry import (
    compute_rgb_residual,
    icp_prev_table,
    icp_step,
    project_to_point_cloud,
    rgb_last_table,
    rgb_static_gates,
    rgb_step,
    so3_step,
    solve_3x3,
    solve_6x6,
)
from .ops.preprocess import (
    SOBEL_SCALE,
    compute_derivatives,
    compute_nmap,
    compute_vmap,
    pyr_down_depth,
    pyr_down_gauss,
    pyr_down_intensity,
    resize_nmap,
    resize_vmap,
    rgb_to_intensity,
    vertices_to_depth,
)
from .se3 import _compose, invert, orthonormalize, so3_exp


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


class TrackingHost(NamedTuple):
    """What the tracker already holds on the host after its last read (numpy
    float32): gates on a solve read these instead of the device tensors."""

    T: np.ndarray                 # (4,4)
    icp_error: np.float32
    icp_count: np.float32
    A: np.ndarray                 # (6,6)


class TrackingResult(NamedTuple):
    T_curr: torch.Tensor          # (4,4)
    icp_error: torch.Tensor       # sqrt(Σr²)/inliers  (lastICPError)
    icp_count: torch.Tensor
    rgb_error: torch.Tensor
    rgb_count: torch.Tensor
    so3_error: torch.Tensor
    so3_count: torch.Tensor
    A: torch.Tensor               # (6,6) last combined normal matrix (lastA)
    b: torch.Tensor
    host: Optional[TrackingHost] = None


_F32 = np.float32


def _K_mats(cam: CameraConfig, level: int):
    """(K, K⁻¹) of a pyramid level as host float32 tensors."""
    c = cam.scaled(level)
    K = torch.tensor(
        [[c.fx, 0.0, c.cx], [0.0, c.fy, c.cy], [0.0, 0.0, 1.0]], dtype=torch.float32
    )
    Kinv = torch.tensor(
        [
            [1.0 / c.fx, 0.0, -c.cx / c.fx],
            [0.0, 1.0 / c.fy, -c.cy / c.fy],
            [0.0, 0.0, 1.0],
        ],
        dtype=torch.float32,
    )
    return K, Kinv


def _upload(device, *host_tensors):
    """Several small host tensors → the device in ONE copy; returns views
    with the original shapes."""
    flat = torch.cat([t.reshape(-1) for t in host_tensors]).to(device)
    out, o = [], 0
    for t in host_tensors:
        out.append(flat[o:o + t.numel()].reshape(t.shape))
        o += t.numel()
    return out


def _so3_prealign(cam: CameraConfig, last_img: torch.Tensor,
                  next_img: torch.Tensor, iters: int):
    """SO(3) pre-alignment loop (RGBDOdometry.cpp:284-369) with the
    convergence/divergence guards.  Returns (R host (3,3), error, count)."""
    dev = next_img.device
    K, Kinv = _K_mats(cam, 2)
    (Kinv_d,) = _upload(dev, Kinv)
    big = _F32(3.4e38 / 2)
    # A(9) | b(3) | Σr² | count, overwritten by every iteration's step; the
    # read at the end of an iteration orders the reuse
    pack = torch.zeros((14,), dtype=torch.float32, device=dev)

    resultR = torch.eye(3, dtype=torch.float32)
    lastResultR = resultR
    lastError, lastCount = big, big
    so3e, so3c = _F32(0.0), _F32(0.0)
    for _ in range(iters):
        basis_d, krlr_d = _upload(dev, K @ resultR @ Kinv, K @ resultR)
        so3_step(last_img, next_img, basis_d, Kinv_d, krlr_d, out=pack)
        got = read_back(pack)
        A, b = got[0:9].reshape(3, 3), got[9:12]
        sum_sq, g_count = got[12], got[13]
        count = max(g_count, _F32(1.0))
        err = np.sqrt(sum_sq) / count

        converged = bool(err < lastError) and bool(lastCount == g_count)
        diverged = bool(err > lastError + _F32(0.001))
        done = converged or diverged

        if diverged:
            next_R, so3e, so3c = lastResultR, lastError, lastCount
        else:
            so3e, so3c = err, g_count
            if converged:
                next_R = resultR
            else:
                delta = torch.from_numpy(solve_3x3(A, b))
                next_R = so3_exp(delta) @ resultR
        lastResultR, resultR = resultR, next_R
        if done:
            break
        lastError, lastCount = err, g_count
    return resultR, so3e, so3c


def get_incremental_transformation(
    inputs: OdometryInputs, cfg: EngineConfig
) -> TrackingResult:
    """One full tracking solve.  Mirrors RGBDOdometry.cpp:259-571; see the
    module docstring for where the work runs.  All results are tensors on the
    inputs' device."""
    cam = cfg.camera
    dev = inputs.vmaps_curr[0].device
    icp_on = (not cfg.rgb_only) and cfg.icp_weight > 0
    rgb_on = cfg.rgb_only or cfg.icp_weight < 100

    T_prev = torch.from_numpy(read_back(inputs.T_prev).astype(np.float32))
    (T_prev_d,) = _upload(dev, T_prev)
    Rprev, tprev = T_prev[:3, :3], T_prev[:3, 3]

    n_lvls = cfg.num_pyramid_levels
    if rgb_on:
        derivs = [compute_derivatives(img) for img in inputs.next_images]
    else:
        derivs = [(torch.zeros_like(img), torch.zeros_like(img))
                  for img in inputs.next_images]

    # --- SO(3) pre-alignment at the coarsest level (cpp:284-369) ---
    if cfg.so3:
        resultR, so3e, so3c = _so3_prealign(
            cam, inputs.so3_last_image, inputs.next_images[2], cfg.so3_iterations
        )
    else:
        resultR = torch.eye(3, dtype=torch.float32)
        so3e = so3c = _F32(0.0)

    resultRt = torch.eye(4, dtype=torch.float32)
    resultRt[:3, :3] = resultR

    iters = list(cfg.fast_odom_iterations if cfg.fast_odom else cfg.gn_iterations)
    if not cfg.pyramid:
        iters[1] = iters[2] = 0

    carry = dict(
        resultRt=resultRt, Rcurr=Rprev, tcurr=tprev,
        icp_error=_F32(0.0), icp_count=_F32(0.0),
        rgb_error=_F32(0.0), rgb_count=_F32(0.0),
        A=np.zeros((6, 6), np.float32), b=np.zeros((6,), np.float32),
    )
    # every step overwrites its slice in every iteration; the read at the end
    # of an iteration orders the reuse
    pack = torch.zeros((88,), dtype=torch.float32, device=dev)
    # rgbOnly weighs every pixel evenly (sigma = -1); otherwise rgb_step derives
    # sigma from what compute_rgb_residual counted
    sigma_arg = (torch.full((), -1.0, dtype=torch.float32, device=dev)
                 if cfg.rgb_only else None)

    for lvl in range(n_lvls - 1, -1, -1):
        if iters[lvl] == 0:
            continue
        c = cam.scaled(lvl)
        K, Kinv = _K_mats(cam, lvl)
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

        # per-level divergence reference (cpp:406: reset to FLT_MAX)
        rgb_err_break = _F32(3.4e38)
        prev_err = _F32(3.4e38)

        for _ in range(iters[lvl]):
            Rt = invert(carry["resultRt"])
            T_curr = _compose(carry["Rcurr"], carry["tcurr"])
            T_curr_d, krkinv_d, kt_d = _upload(
                dev, T_curr, K @ Rt[:3, :3] @ Kinv, K @ Rt[:3, 3])

            if rgb_on:
                corres = compute_rgb_residual(
                    min_grad2, dIdx, dIdy,
                    inputs.last_depths[lvl], inputs.next_depths[lvl],
                    inputs.last_images[lvl], inputs.next_images[lvl],
                    kt_d, krkinv_d,
                    last_table=last_table, static_gates=static_gates,
                    out=pack[86:88],
                )
                rgb_step(corres, sigma_arg, cloud, c.fx, c.fy, dIdx, dIdy,
                         out=pack[44:86])

            if icp_on:
                icp_step(
                    T_curr_d,
                    inputs.vmaps_curr[lvl], inputs.nmaps_curr[lvl],
                    T_prev_d,
                    inputs.vmaps_prev_g[lvl], inputs.nmaps_prev_g[lvl],
                    c.fx, c.fy, c.cx, c.cy,
                    cfg.dist_threshold, cfg.angle_threshold_sin,
                    prev_table=prev_table, out=pack[0:44],
                )

            # the iteration's one device→host read
            got = read_back(pack)
            Ai, bi = got[0:36].reshape(6, 6), got[36:42]
            icp_sum_sq, icp_count = got[42], got[43]
            Ar, br = got[44:80].reshape(6, 6), got[80:86]
            sigma_h, rgb_size = got[86], got[87]

            rgb_error = (np.sqrt(sigma_h) / (rgb_size if rgb_size != 0 else _F32(1.0))
                         if rgb_on else _F32(0.0))
            icp_error = (np.sqrt(icp_sum_sq) / max(icp_count, _F32(1.0))
                         if icp_on else _F32(0.0))

            # rgbOnly divergence break (cpp:448-451): REVERT to the pre-update
            # state.  Distinct from the convergence exits below, which keep
            # this iteration's freshly computed stats and update.
            if cfg.rgb_only and rgb_error > rgb_err_break:
                break

            if icp_on and rgb_on:
                w = _F32(cfg.icp_weight)
                A = Ar + (w * w) * Ai
                b = br + w * bi
            elif icp_on:
                A, b = Ai, bi
            else:
                A, b = Ar, br

            result = solve_6x6(A, b)
            total_err = icp_error + rgb_error
            stop = bool(np.linalg.norm(result) < cfg.gn_early_exit)
            if cfg.gn_plateau_exit > 0:
                stop = stop or bool(
                    abs(total_err - prev_err)
                    < cfg.gn_plateau_exit * max(total_err, _F32(1e-12)))

            # computeUpdateSE3 (OdometryProvider.h:73-96): left-multiply
            res_t = torch.from_numpy(result)
            Rt_up = _compose(so3_exp(res_t[3:6]), res_t[:3])
            new_resultRt = Rt_up @ carry["resultRt"]
            # currentT = prevT * rgbOdom⁻¹ (cpp:553-560)
            currentT = T_prev @ invert(new_resultRt)

            carry = dict(
                resultRt=new_resultRt,
                Rcurr=currentT[:3, :3], tcurr=currentT[:3, 3],
                icp_error=icp_error, icp_count=icp_count,
                rgb_error=rgb_error, rgb_count=rgb_size,
                A=A.astype(np.float32), b=b.astype(np.float32),
            )
            rgb_err_break = rgb_error
            prev_err = total_err
            if stop:
                break

    Rcurr, tcurr = carry["Rcurr"], carry["tcurr"]

    # sanity clamp — unconditional in the original (cpp:553-558)
    if float(torch.linalg.vector_norm(tcurr - tprev)) > cfg.translation_sanity:
        Rcurr, tcurr = Rprev, tprev

    T_curr = orthonormalize(_compose(Rcurr, tcurr))

    stats = torch.tensor(
        [carry["icp_error"], carry["icp_count"], carry["rgb_error"],
         carry["rgb_count"], so3e, so3c], dtype=torch.float32)
    T_d, stats_d, A_d, b_d = _upload(
        dev, T_curr, stats, torch.from_numpy(carry["A"]),
        torch.from_numpy(carry["b"]))
    return TrackingResult(
        T_curr=T_d,
        icp_error=stats_d[0], icp_count=stats_d[1],
        rgb_error=stats_d[2], rgb_count=stats_d[3],
        so3_error=stats_d[4], so3_count=stats_d[5],
        A=A_d, b=b_d,
        host=TrackingHost(T=T_curr.numpy(), icp_error=carry["icp_error"],
                          icp_count=carry["icp_count"], A=carry["A"]),
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
