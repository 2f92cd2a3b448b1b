"""Engine facade — the `ElasticFusion` class (Core/ElasticFusion.{h,cpp}) of
the PyTorch/CUDA port.

`process_frame` mirrors the original pipeline (ElasticFusion.cpp:270-607)
without loop closure: preprocess -> frame-to-model tracking -> predictIndices
-> fuse -> clean -> predict + fill-in.  Frames are finished synchronously
inside `process_frame`: one packed device→host read per frame on top of the
tracker's one read per Gauss-Newton iteration (`_device.host_reads` counts
them).

Not ported yet — each raises `NotImplementedError` when asked for: loop
closure (`closeLoops`), multi-device maps (`mesh_shape`), host/device
pipelining (`pipeline_depth > 0`), relocalization (`reloc_mode`), externally
supplied poses after the first frame (`in_T_wc`), the u16 fixed-point tables
(`fx16_tables`) and checkpoint restore.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ._device import DeviceLike, read_back, resolve_device
from .config import EngineConfig
from .ops.fillin import fill_all
from .ops.fuse import FuseStats, clean, fuse
from .ops.preprocess import (
    bilateral_filter,
    metricise_depth,
    pyr_down_intensity,
    rgb_to_intensity,
)
from .ops.splat import Prediction, combined_predict, predict_indices
from .se3 import invert, np_orthonormalize, se3_log_norm
from .surfels import SurfelMap, init_map_from_frame
from .tracking import (
    OdometryInputs,
    TrackingResult,
    build_current_frame_pyramids,
    build_model_pyramids,
    get_incremental_transformation,
)
from .utils.stopwatch import Stopwatch

# ---------------------------------------------------------------------------
# per-frame stages
# ---------------------------------------------------------------------------


def _preprocess(depth_mm: torch.Tensor, cfg: EngineConfig):
    """filterDepth + metriciseDepth (ElasticFusion.cpp:655-673)."""
    d = depth_mm.to(torch.float32)
    filt = bilateral_filter(d, cfg.max_depth_processed, cfg.bilateral_radius)
    return (
        metricise_depth(d, cfg.depth_cutoff),
        metricise_depth(filt, cfg.depth_cutoff),
    )


def _init_map(depth_raw_m, depth_filt_m, rgb, cfg: EngineConfig,
              capacity: int) -> SurfelMap:
    return init_map_from_frame(
        capacity, depth_raw_m, depth_filt_m, rgb, cfg.camera, cfg.depth_cutoff,
    )


def _next_bucket(n: int, cap: int) -> int:
    """Capacity buckets: per-surfel ops cost O(array size), so the map lives
    in the smallest bucketed arrays that fit, growing toward cfg.max_surfels
    in steps of ~x1.25 (8192-aligned)."""
    b = 1 << 16
    while b < n:
        b = -(-(b + (b >> 2)) // 8192) * 8192
    return min(b, cap)


def _grow_map(m: SurfelMap, capacity: int) -> SurfelMap:
    pad = capacity - m.capacity
    grow = lambda x: torch.nn.functional.pad(x, (0, pad))  # noqa: E731
    return SurfelMap(
        pos=grow(m.pos), conf=grow(m.conf), color=grow(m.color),
        init_t=grow(m.init_t), last_t=grow(m.last_t), normal=grow(m.normal),
        radius=grow(m.radius), count=m.count,
    )


def _dense_fraction(pred: Prediction) -> torch.Tensor:
    """The denseEnough statistic (cpp:256-268): share of predicted pixels."""
    return (torch.sum(pred.image, dim=-1) > 0).to(torch.float32).mean()


def _predict(m: SurfelMap, T_wc, time, max_time, depth_filt_m, rgb, lost,
             cfg: EngineConfig):
    """predict() (ElasticFusion.cpp:621-653): ACTIVE combinedPredict + the
    three fill-in passes + the denseEnough statistic."""
    pred = combined_predict(
        m, T_wc, cfg.camera, time, max_time, cfg.time_delta,
        cfg.confidence_threshold, cfg.max_depth_processed,
    )
    vtx, nrm, img = fill_all(
        pred, depth_filt_m, rgb, cfg.camera, cfg.max_depth_processed,
        lost, cfg.frame_to_frame_rgb,
    )
    return pred, vtx, nrm, img, _dense_fraction(pred)


def _track(
    m_pred_vertex, m_pred_normal, m_pred_image,
    depth_filt_m, rgb, so3_last_pyr2, T_prev, cfg: EngineConfig,
):
    """frameToModel init + getIncrementalTransformation (cpp:308-324)."""
    vmaps_c, nmaps_c, images_c, depths_c = build_current_frame_pyramids(
        depth_filt_m, rgb, cfg
    )
    vmaps_g, nmaps_g, images_m, depths_m = build_model_pyramids(
        m_pred_vertex, m_pred_normal, m_pred_image, T_prev, cfg
    )
    inputs = OdometryInputs(
        vmaps_curr=vmaps_c, nmaps_curr=nmaps_c,
        vmaps_prev_g=vmaps_g, nmaps_prev_g=nmaps_g,
        last_images=images_m, next_images=images_c,
        last_depths=depths_m, next_depths=depths_c,
        so3_last_image=so3_last_pyr2, T_prev=T_prev,
    )
    res = get_incremental_transformation(inputs, cfg)
    return res, images_c[cfg.num_pyramid_levels - 1]


def _fuse_clean(m, T, tick, rgb, raw_m, filt_m, weighting, cfg: EngineConfig,
                do_compact: bool):
    """predictIndices -> fuse -> clean (cpp:536-585).  The post-fuse index
    prediction clean consumes is derived in the pixel domain by fuse."""
    cam = cfg.camera
    pidx = predict_indices(m, T, cam, tick, cfg.time_delta, cfg.max_depth_processed)
    m2, stats, pidx2 = fuse(
        m, pidx, T, tick, rgb, raw_m, filt_m, cam,
        cfg.max_depth_processed, weighting, return_updated_pred=True,
    )
    m3 = clean(
        m2, pidx2, T, tick, cam, cfg.confidence_threshold, cfg.time_delta,
        cfg.max_depth_processed, cfg.unstable_age, do_compact=do_compact,
    )
    return m3, stats


@torch.no_grad()
def slam_step(
    m: SurfelMap,
    T_prev,            # (4,4) f32
    so3_hist,          # coarsest-level intensity of previous frame
    pred_vertex, pred_normal, pred_image,   # last frame's (filled) prediction
    depth_mm, rgb,     # current raw frame
    tick,              # f32 scalar
    weighting,         # f32 scalar fusion weight
    cfg: EngineConfig,
):
    """One whole SLAM frame: preprocess -> track -> fuse -> clean ->
    predict(+fill-in), every tensor on the inputs' device.

    Returns (map', T_curr, so3_hist', (vertex, normal, image) fill-in,
    prediction, dense_frac, tracking stats).  The reference `slam_step`
    hands `cfg.fx16_clean` to `clean`; this port has the exact float32 patch
    only and raises when the flag is set rather than ignore it."""
    if cfg.fx16_clean:
        raise NotImplementedError(
            "slam_step: fx16_clean is not ported yet (ROADMAP M12); pass "
            "cfg.with_(fx16_clean=False)")
    raw_m, filt_m = _preprocess(depth_mm, cfg)
    res, so3_cur = _track(
        pred_vertex, pred_normal, pred_image, filt_m, rgb, so3_hist, T_prev, cfg,
    )
    T = res.T_curr
    m, _stats = _fuse_clean(m, T, tick, rgb, raw_m, filt_m, weighting, cfg, True)
    pred, vtx, nrm, img, dense = _predict(m, T, tick, tick, filt_m, rgb, False, cfg)
    return m, T, so3_cur, (vtx, nrm, img), pred, dense, res


def _frame_main(
    m: SurfelMap,
    T_prev,                                  # (4,4) f32 carried pose
    so3_hist,                                # prev frame coarsest intensity
    pred_vertex, pred_normal, pred_image,    # carried end-of-frame prediction
    fill_vertex, fill_normal, fill_image,    # its fill-in
    dense_prev,                              # f32: carried predict coverage
    depth_mm, rgb,                           # current raw frame
    tick, max_time,                          # f32 scalars
    lost: bool,
    weight_mult: float,
    cfg: EngineConfig,
    do_compact: bool = True,
):
    """The whole closure-free SLAM frame (ElasticFusion.cpp:270-607):

      preprocess -> frame-to-model tracking (against the carried prediction
      or its fill-in, selected on the device by denseEnough, cpp:256-268,
      303-315) -> velocity fusion weight (cpp:371-383) -> fuse -> clean ->
      end-of-frame combinedPredict + FillIn (cpp:599).

    Like the reference `_frame_main` it runs `clean` on the exact float32
    patch whatever `cfg.fx16_clean` says."""
    raw_m, filt_m = _preprocess(depth_mm, cfg)

    use_fill = (dense_prev < 0.75) | bool(cfg.frame_to_frame_rgb)
    pv = torch.where(use_fill, fill_vertex, pred_vertex)
    pn = torch.where(use_fill, fill_normal, pred_normal)
    pi = torch.where(use_fill, fill_image, pred_image)

    res, so3_cur = _track(pv, pn, pi, filt_m, rgb, so3_hist, T_prev, cfg)
    T = res.T_curr

    # velocity-adaptive fusion weight (cpp:371-383)
    T_cp = invert(T) @ T_prev.to(T.device)
    w = torch.clamp(
        torch.maximum(torch.linalg.vector_norm(T_cp[:3, 3]), se3_log_norm(T_cp)),
        max=0.01,
    )
    weighting = torch.clamp(1.0 - w / 0.01, min=0.5) * weight_mult

    if cfg.rgb_only or lost:
        z = torch.zeros((), dtype=torch.int32, device=T.device)
        stats = FuseStats(matched=z, added=z, count=m.count)
    else:
        m, stats = _fuse_clean(
            m, T, tick, rgb, raw_m, filt_m, weighting, cfg, do_compact)

    # end-of-frame predict (cpp:599) — next frame's tracking target
    pred, vtx, nrm, img, dense = _predict(
        m, T, tick, max_time, filt_m, rgb, lost, cfg)

    # everything `_finish` reads, as ONE f32 vector (counts < 2^24 are exact)
    finish_vec = torch.cat([
        T.reshape(-1), res.icp_error[None], res.icp_count[None],
        stats.count.to(torch.float32)[None],
    ])
    return dict(
        map=m, T=T, so3=so3_cur, res=res, pred=pred, fill=(vtx, nrm, img),
        dense=dense, stats=stats, finish_vec=finish_vec,
    )


def _predict_only(m: SurfelMap, T_wc, tick, max_time, depth_filt_m, rgb, lost,
                  cfg: EngineConfig):
    """predict() + fill-in without fusion (first frame)."""
    pred, vtx, nrm, img, dense = _predict(
        m, T_wc, tick, max_time, depth_filt_m, rgb, lost, cfg)
    return pred, (vtx, nrm, img), dense


def _coarse_intensity(rgb, cfg: EngineConfig):
    """Coarsest-level intensity pyramid of a frame (for next frame's SO3
    pre-alignment history, RGBDOdometry initFirstRGB + image swap)."""
    img = rgb_to_intensity(rgb)
    for _ in range(1, cfg.num_pyramid_levels):
        img = pyr_down_intensity(img)
    return img


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@dataclass
class FrameResult:
    """Per-frame summary of the frame just processed."""

    T_wc: np.ndarray
    tracking_ok: bool
    lost: bool
    icp_error: float
    icp_count: float
    fused: bool
    count_dev: object = None   # i32 scalar tensor; reading it synchronizes

    @property
    def surfel_count(self) -> int:
        """Live surfel count — lazy, because reading it synchronizes."""
        return 0 if self.count_dev is None else int(self.count_dev)


def _unported(flag: str, item: str):
    return NotImplementedError(
        f"{flag} is not ported to elasticfusion_tpu_torch yet (ROADMAP {item})")


class Engine:
    """Dense RGB-D SLAM engine with the ElasticFusion surface (construct,
    process_frame per frame).  Runs on the CUDA card unless `device` names
    something else; `device=None` raises when there is no card."""

    def __init__(self, cfg: EngineConfig = EngineConfig(),
                 device: DeviceLike = None):
        if cfg.closeLoops:
            raise _unported("closeLoops=True (ferns, model-to-model, deformation)",
                            "M8-M9")
        if cfg.mesh_shape is not None:
            raise _unported("mesh_shape (multi-device map)", "M11")
        if cfg.pipeline_depth > 0:
            raise _unported("pipeline_depth > 0", "M7")
        if cfg.reloc_mode:
            raise _unported("reloc_mode", "M7")
        if cfg.fx16_tables:
            raise _unported("fx16_tables", "M12")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tick = 1                             # starts at 1 (EF.cpp:55)
        self.T_wc = np.eye(4)                     # f64 host pose
        self.lost = False
        # tick-keyed pose log + the parallel timestamp log (EF.cpp:588-589)
        self.tick_poses: List[Tuple[int, np.ndarray]] = []
        self.pose_times: List[int] = []
        self.map: Optional[SurfelMap] = None
        self.stopwatch = Stopwatch()
        # carried device state
        self._T_f32 = None          # (4,4) f32 pose, kept on the host: the
                                    # tracker reads it there and uploads it
        self._so3_hist = None       # prev frame coarsest intensity
        self._pred = None           # Prediction from end-of-last-frame predict()
        self._fill = None           # (vertex, normal, image) fill-in maps
        self._dense_dev = None      # f32 scalar: last predict coverage
        self._count_finished = 0    # exact count of the last finished frame
        self._last_icp_error = 0.0
        self._last_icp_count = 0.0
        self._last_fused = False

    # -- public knobs ---------------------------------------------------------
    @property
    def surfel_count(self) -> int:
        return 0 if self.map is None else int(self.map.count)

    @property
    def poses(self) -> List[Tuple[int, np.ndarray]]:
        """Timestamped trajectory."""
        return [(ts, T) for ts, (_, T) in zip(self.pose_times, self.tick_poses)]

    def flush(self) -> None:
        """Frames finish inside `process_frame`; nothing is ever in flight."""

    def restore_checkpoint(self, path: str) -> None:
        raise _unported("checkpoint restore", "M10")

    @torch.no_grad()
    def process_frame(
        self,
        rgb: np.ndarray,           # [H,W,3] u8
        depth_mm: np.ndarray,      # [H,W] u16 millimetres
        timestamp: int = 0,
        weight_multiplier: float = 1.0,
        in_T_wc: Optional[np.ndarray] = None,
    ) -> FrameResult:
        cfg = self.cfg
        sw = self.stopwatch
        sw.tick("Run")
        sw.tick("Preprocess")
        rgb_d = torch.from_numpy(np.ascontiguousarray(rgb)).to(self.device)
        depth_d = torch.from_numpy(
            np.asarray(depth_mm).astype(np.float32)).to(self.device)
        sw.tock("Preprocess")

        if self.tick == 1:
            self._first_frame(depth_d, rgb_d, timestamp, in_T_wc)
            sw.tock("Run")
            return self._result()

        if in_T_wc is not None:
            raise _unported("in_T_wc after the first frame (external poses)", "M7")

        self._maybe_grow()

        sw.tick("frame")
        tick_dev = torch.tensor(float(self.tick), device=self.device)
        out = _frame_main(
            self.map, self._T_f32, self._so3_hist,
            self._pred.vertex, self._pred.normal, self._pred.image,
            self._fill[0], self._fill[1], self._fill[2],
            self._dense_dev, depth_d, rgb_d,
            tick_dev, tick_dev, self.lost, float(weight_multiplier), cfg,
            do_compact=(self.tick % cfg.compact_every == 0),
        )
        sw.tock("frame")

        self.map = out["map"]
        self._so3_hist = out["so3"]
        self._pred = out["pred"]
        self._fill = out["fill"]
        self._dense_dev = out["dense"]

        sw.tick("finish")
        self._finish(self.tick, timestamp, out)
        sw.tock("finish")
        self.tick += 1
        sw.tock("Run")
        return self._result()

    # -- frame variants -------------------------------------------------------

    def _first_frame(self, depth_d, rgb_d, timestamp, in_T_wc):
        cfg = self.cfg
        raw_m, filt_m = _preprocess(depth_d, cfg)
        n_px = cfg.camera.width * cfg.camera.height
        # initial bucket: the first frame fills at most n_px slots and every
        # per-surfel op costs O(capacity) — start tight, grow on demand (or
        # start at the caller-pinned bucket)
        cap0 = _next_bucket(
            max(n_px + n_px // 4, cfg.initial_surfels or 0), cfg.max_surfels
        )
        self.map = _init_map(raw_m, filt_m, rgb_d, cfg, cap0)
        self._so3_hist = _coarse_intensity(rgb_d, cfg)  # initFirstRGB
        if in_T_wc is not None:
            self.T_wc = np.asarray(in_T_wc, np.float64)
        self._T_f32 = torch.from_numpy(self.T_wc.astype(np.float32))
        one = torch.tensor(1.0, device=self.device)
        self._pred, self._fill, self._dense_dev = _predict_only(
            self.map, self._T_f32.to(self.device), one, one, filt_m, rgb_d, False, cfg,
        )
        self._count_finished = int(read_back(self.map.count))
        self.tick_poses.append((1, self.T_wc.copy()))
        self.pose_times.append(int(timestamp))
        self.tick = 2

    def _maybe_grow(self):
        """Grow to the next capacity bucket before the tail can overflow,
        judged on the last finished frame's exact count.  Worst case a
        full-novel-view burst saturates fuse's append clamp for one frame;
        the dropped measurements re-enter on the following frames."""
        cfg = self.cfg
        cap = self.map.capacity
        hw4 = (cfg.camera.width * cfg.camera.height) // 4
        est = self._count_finished
        if cap < cfg.max_surfels and est > 0.8 * cap:
            # 1.35 > 1/0.8 so the new bucket sits below its own trigger
            self.map = _grow_map(
                self.map, _next_bucket(int(1.35 * est) + hw4, cfg.max_surfels))

    def _result(self) -> FrameResult:
        return FrameResult(
            T_wc=self.T_wc.copy(),
            tracking_ok=True,
            lost=self.lost,
            icp_error=self._last_icp_error,
            icp_count=self._last_icp_count,
            fused=self._last_fused,
            count_dev=None if self.map is None else self.map.count,
        )

    def _finish(self, tick: int, timestamp: int, out) -> None:
        """Host-side completion of one frame: one packed device read, pose log."""
        vec32 = read_back(out["finish_vec"])
        self._T_f32 = torch.from_numpy(vec32[0:16].reshape(4, 4).copy())
        vec = vec32.astype(np.float64)
        self.T_wc = np_orthonormalize(vec[0:16].reshape(4, 4))
        self._last_icp_error = float(vec[16])
        self._last_icp_count = float(vec[17])
        self._count_finished = int(vec[18])
        self._last_fused = (not self.cfg.rgb_only) and not self.lost
        self.tick_poses.append((tick, self.T_wc.copy()))
        self.pose_times.append(int(timestamp))
