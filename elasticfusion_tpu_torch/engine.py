"""Engine facade — the `ElasticFusion` class (Core/ElasticFusion.{h,cpp}) of
the PyTorch/CUDA port.

`process_frame` mirrors the original pipeline (ElasticFusion.cpp:270-607):
preprocess -> frame-to-model tracking -> [tracking gates] -> predictIndices
-> fuse -> clean -> predict + fill-in, then, with `closeLoops`, fern encoding
and retrieval scoring, the deformation node sample and — while the map holds
an inactive surfel — the INACTIVE prediction and the model-to-model solve.
The loop-closure *decisions* (fern retrieval, deformation Gauss-Newton
acceptance) and the relocalization state machine run on the host, and an
accepted closure is applied by `_apply_closure`.

The frame's control flow is on the device, as in the reference package: the
tracker's loops are predicated launches (tracking.py), the tracking gate is
computed on the device, and where the reference branches with `lax.cond`
(fuse + clean under the gate, the inactive prediction and model-to-model
solve while an inactive surfel exists) `_cond` runs both branches and
selects on the device.  So a frame reads the host once: its packed finish
vector.  A one-device frame runs on the static tensors of a `FrameRunner`
(graphs.py), which on a card captures it as a CUDA graph per static key and
replays it.

With `pipeline_depth = d > 0` up to d frames are in flight: a frame is
dispatched (its whole device program, and the copy of its finish vector to
pinned host memory) and the next frame carries on from its pose on the
device, and is finished — its finish vector read, its pose logged, its
loop-closure decisions made — d frames later (`flush` finishes them all).
A closure or teleport applied at the finish of frame N rewrites the carried
map and pose while frames N+1..N+d are in flight; those frames get the same
rigid fix when they finish (`_pose_fixes`).  At depth 0 every frame
finishes inside `process_frame`.  Device→host reads (`_device.host_reads`
counts them): one a frame, plus what an accepted keyframe or a loop-closure
decision reads.

Externally supplied poses (`in_T_wc` after the first frame) fuse without
tracking or loop closure, synchronously.

With `cfg.mesh_shape = (S,)` the map is S sub-maps (`parallel/shard_step.py`:
a `ShardedMap` held by this one process, or spread over the processes of
`torch.distributed`); every map operation of the frame, of the closure
repair, of growth and of export goes through `_map_ops`, and the
frame state (tracking, predictions, fill-in, ferns, the deformation graph)
stays replicated on the lead device.

`cfg.fx16_tables` reaches every solve of the tracker (the frame's,
model-to-model and the fern ICP): each pyramid level's model table is packed
to u16 fixed point and `icp_step` reads that form.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ._device import DeviceLike, PendingRead, read_back, resolve_device
from .config import EngineConfig
from .deformation import Deformation, _sample_every, apply_graph_to_surfels
from .ferns import Ferns, decimate_views, fern_encode_device, fern_score_device
from .graphs import FrameRunner, copy_into
from .ops.bilateral import bilateral_filter
from .ops.fillin import fill_all
from .ops.fuse import FuseStats, clean, fuse
from .ops.preprocess import metricise_depth, rgb_to_intensity
from .ops.pyramid import pyr_down_intensity
from .ops.splat import Prediction, combined_predict, predict_indices
from .parallel import shard_step
from .parallel.shard_step import ShardedMap, to_device
from .parallel.sharding import engine_group
from .se3 import invert, np_orthonormalize, se3_log_norm
from .surfels import SurfelMap, init_map_from_frame, recip32
from .tracking import (
    OdometryInputs,
    TrackingResult,
    build_current_frame_pyramids,
    build_current_model_pyramids,
    build_model_pyramids,
    get_incremental_transformation,
)
from .utils.stopwatch import Stopwatch

CONS_SAMPLE = 20  # constraint-source subsampling (ElasticFusion.cpp:62)

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


class _OneDeviceMap:
    """The map operations the engine calls, on a one-device `SurfelMap`.
    `parallel.shard_step` offers the same functions over a `ShardedMap`, and
    `_map_ops` picks one of the two: the engine's only test of the map's
    type."""

    # The reference's one-device Engine cleans on the exact float32 patch in
    # its frame and closure sections (only `slam_step` and the external-pose
    # path honour cfg.fx16_clean); its sharded map honours the flag there.
    FRAME_CLEAN_FX16 = False

    predict_indices = staticmethod(predict_indices)
    combined_predict = staticmethod(combined_predict)

    @staticmethod
    def max_count(m: SurfelMap) -> torch.Tensor:
        return m.count

    @staticmethod
    def each(m: SurfelMap, fn) -> SurfelMap:
        return fn(m)

    @staticmethod
    def gather(m: SurfelMap) -> SurfelMap:
        return m

    @staticmethod
    def grow(m: SurfelMap, capacity: int) -> SurfelMap:
        pad = capacity - m.capacity
        grow = lambda x: torch.nn.functional.pad(x, (0, pad))  # noqa: E731
        return SurfelMap(
            pos=grow(m.pos), conf=grow(m.conf), color=grow(m.color),
            init_t=grow(m.init_t), last_t=grow(m.last_t), normal=grow(m.normal),
            radius=grow(m.radius), count=m.count,
        )

    @staticmethod
    def fuse_clean(m: SurfelMap, T, tick, rgb, raw_m, filt_m, weighting,
                   cfg: EngineConfig, do_compact: bool, fx16: bool):
        """predictIndices -> fuse -> clean (cpp:536-585).  The post-fuse
        index prediction clean consumes is derived in the pixel domain by
        fuse; `fx16` runs clean's u16 fixed-point window patch."""
        cam = cfg.camera
        pidx = predict_indices(m, T, cam, tick, cfg.time_delta, cfg.max_depth_processed)
        m2, stats, pidx2 = fuse(
            m, pidx, T, tick, rgb, raw_m, filt_m, cam,
            cfg.max_depth_processed, weighting, return_updated_pred=True,
        )
        m3 = _OneDeviceMap.clean_all(m2, pidx2, T, tick, cfg, fx16, do_compact)
        return m3, stats

    @staticmethod
    def clean_all(m: SurfelMap, pidx, T, tick, cfg: EngineConfig, fx16: bool,
                  do_compact: bool = True) -> SurfelMap:
        return clean(
            m, pidx, T, tick, cfg.camera, cfg.confidence_threshold, cfg.time_delta,
            cfg.max_depth_processed, cfg.unstable_age, do_compact=do_compact,
            fx16_patch=fx16,
        )

    @staticmethod
    def sample_nodes(m: SurfelMap, rate: int):
        """Every rate-th surfel's (position [M,3], init time [M]) — the
        deformation-graph node sample (sample.geom:33-39)."""
        return _sample_every(m.pos, m.init_t, m.count, rate)[:2]

    @staticmethod
    def inactive_count(m: SurfelMap, tick, cfg: EngineConfig) -> torch.Tensor:
        """Live confident surfels that have left the active time window."""
        live = torch.arange(m.capacity, device=m.pos.device) < m.count
        return torch.sum(live & (m.conf >= cfg.confidence_threshold)
                         & (m.last_t <= tick - cfg.time_delta))


def _map_ops(m):
    """The map operations of a one-device or a sharded map."""
    return shard_step if isinstance(m, ShardedMap) else _OneDeviceMap


def _dense_fraction(pred: Prediction) -> torch.Tensor:
    """The denseEnough statistic (cpp:256-268): share of predicted pixels."""
    return (torch.sum(pred.image, dim=-1) > 0).to(torch.float32).mean()


def _combined_predict(m, T_wc, time, max_time, time_delta, cfg: EngineConfig
                      ) -> Prediction:
    """combinedPredict of a one-device or a sharded map."""
    return _map_ops(m).combined_predict(
        m, T_wc, cfg.camera, time, max_time, time_delta,
        cfg.confidence_threshold, cfg.max_depth_processed)


def _predict(m: SurfelMap, T_wc, time, max_time, depth_filt_m, rgb, lost,
             cfg: EngineConfig):
    """predict() (ElasticFusion.cpp:621-653): ACTIVE combinedPredict + the
    three fill-in passes + the denseEnough statistic."""
    pred = _combined_predict(m, T_wc, time, max_time, cfg.time_delta, cfg)
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
                do_compact: bool, fx16: bool):
    """predictIndices -> fuse -> clean of a one-device or a sharded map."""
    return _map_ops(m).fuse_clean(m, T, tick, rgb, raw_m, filt_m, weighting, cfg,
                                  do_compact, fx16)


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
    prediction, dense_frac, tracking stats).  Like the reference `slam_step`
    it hands `cfg.fx16_clean` to `clean`."""
    raw_m, filt_m = _preprocess(depth_mm, cfg)
    res, so3_cur = _track(
        pred_vertex, pred_normal, pred_image, filt_m, rgb, so3_hist, T_prev, cfg,
    )
    T = res.T_curr
    m, _stats = _fuse_clean(m, T, tick, rgb, raw_m, filt_m, weighting, cfg, True,
                            cfg.fx16_clean)
    pred, vtx, nrm, img, dense = _predict(m, T, tick, tick, filt_m, rgb, False, cfg)
    return m, T, so3_cur, (vtx, nrm, img), pred, dense, res


def _empty_tracking_result(device) -> TrackingResult:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return TrackingResult(
        T_curr=torch.eye(4, device=device),
        icp_error=z, icp_count=z, rgb_error=z, rgb_count=z,
        so3_error=z, so3_count=z,
        A=torch.zeros((6, 6), device=device), b=torch.zeros((6,), device=device),
        cov_ok=torch.zeros((), dtype=torch.bool, device=device),
    )


def _where(pred: torch.Tensor, a, b):
    """`a` where the 0-d bool `pred` holds, else `b`, leaf by leaf over
    equal nests of tuples / NamedTuples of tensors."""
    if isinstance(a, torch.Tensor):
        return torch.where(pred, a, b)
    vals = [_where(pred, x, y) for x, y in zip(a, b)]
    return type(a)(*vals) if hasattr(a, "_fields") else type(a)(vals)


def _cond(pred: torch.Tensor, run, skip, on_host: bool):
    """`lax.cond(pred, run, skip)` of the reference package.  Both branches
    run and `pred` selects on the device — a captured frame cannot branch —
    and where it is false every output is `skip`'s bit for bit; `run` is
    handed the predicate to predicate its own tracker solves.  With
    `on_host` (a sharded frame, which stays eager) the predicate is read and
    only the chosen branch runs (`run(None)`)."""
    if on_host:
        return run(None) if bool(read_back(pred)) else skip()
    return _where(pred, run(pred), skip())


def _branches_on_host(m) -> bool:
    """Where `_cond` reads its predicate and runs one branch: a sharded map,
    whose frame is eager."""
    return isinstance(m, ShardedMap)


def _model_to_model(
    new_vertex, new_normal, new_image,
    old_vertex, old_normal, old_image,
    T_wc, cfg: EngineConfig, enable: Optional[torch.Tensor] = None,
) -> TrackingResult:
    """modelToModel odometry: align the ACTIVE prediction against the INACTIVE
    one (ElasticFusion.cpp:462-471; icpWeight=10, no SO3); `enable`
    predicates the solve (`get_incremental_transformation`)."""
    m2m_cfg = cfg.with_(so3=False, icp_weight=10.0)
    vmaps_c, nmaps_c, images_c, depths_c = build_current_model_pyramids(
        new_vertex, new_normal, new_image, m2m_cfg
    )
    vmaps_g, nmaps_g, images_m, depths_m = build_model_pyramids(
        old_vertex, old_normal, old_image, T_wc, m2m_cfg
    )
    inputs = OdometryInputs(
        vmaps_curr=vmaps_c, nmaps_curr=nmaps_c,
        vmaps_prev_g=vmaps_g, nmaps_prev_g=nmaps_g,
        last_images=images_m, next_images=images_c,
        last_depths=depths_m, next_depths=depths_c,
        so3_last_image=images_c[m2m_cfg.num_pyramid_levels - 1], T_prev=T_wc,
    )
    return get_incremental_transformation(inputs, m2m_cfg, enable)


def _tracking_ok(res: TrackingResult, cfg: EngineConfig) -> torch.Tensor:
    """Tracking-failure gates (cpp:326-344) on the device (0-d bool), in
    float32 as the reference evaluates them: the ICP error under its limit
    and every diagonal entry of (A + 1e-12 I)^-1 under the covariance limit
    (`res.cov_ok`, from the tracker's finishing `gn_update`)."""
    return (res.icp_error < cfg.reloc_icp_error) & res.cov_ok


def _closure_inputs(m: SurfelMap, T, pred: Prediction, fill, tick, fern,
                    cfg: EngineConfig, on_host: bool):
    """What the host's loop-closure decisions read of a frame: the fern views,
    their codes and retrieval scores against the keyframe DB
    (Ferns.cpp:108-228), the deformation node sample (cpp:591-597) and — under
    `_cond` on "an inactive surfel exists" — the INACTIVE prediction and the
    model-to-model solve against it (cpp:447-511)."""
    cam = cfg.camera
    vtx, nrm, img = fill
    fern_flat, fern_rgbd, db_codes, db_good, db_time, db_count = fern
    views = decimate_views(img, vtx, nrm, cfg.fern_pyramid_factor)
    codes, good = fern_encode_device(views[0], views[1], fern_flat, fern_rgbd)
    scores = fern_score_device(codes, good, db_codes, db_good, db_time, db_count,
                               tick, cfg.fern_min_age)
    ops = _map_ops(m)
    node_pos, node_t = ops.sample_nodes(m, cfg.def_graph_sample_rate)

    hs, ws = -(-cam.height // CONS_SAMPLE), -(-cam.width // CONS_SAMPLE)

    def run(enable):
        old_pred = _combined_predict(m, T, 0.0, tick - cfg.time_delta,
                                     cfg.time_delta, cfg)
        m2m = _model_to_model(
            pred.vertex, pred.normal, pred.image,
            old_pred.vertex, old_pred.normal, old_pred.image, T, cfg, enable,
        )
        return (m2m, torch.sum(old_pred.depth > 0).to(torch.int32),
                old_pred.time[::CONS_SAMPLE, ::CONS_SAMPLE])

    def skip():
        return (_empty_tracking_result(T.device),
                torch.zeros((), dtype=torch.int32, device=T.device),
                torch.zeros((hs, ws), device=T.device))

    m2m, inact_px, cons_ot = _cond(ops.inactive_count(m, tick, cfg) > 0, run, skip,
                                   on_host)
    return dict(
        views=views, codes=codes, good=good, scores=scores,
        node_pos=node_pos, node_t=node_t, m2m=m2m, inact_px=inact_px,
        cons_pv=pred.vertex[:, ::CONS_SAMPLE, ::CONS_SAMPLE], cons_ot=cons_ot,
    )


def _frame_main(
    m: SurfelMap,
    T_prev,                                  # (4,4) f32 carried pose
    so3_hist,                                # prev frame coarsest intensity
    pred_vertex, pred_normal, pred_image,    # carried end-of-frame prediction
    fill_vertex, fill_normal, fill_image,    # its fill-in
    dense_prev,                              # f32: carried predict coverage
    depth_mm, rgb,                           # current raw frame
    tick, max_time,                          # 0-d f32 tensors
    lost: bool,
    weight_mult,                             # 0-d f32 tensor
    fern,                                    # fern tables + keyframe DB, or None
    cfg: EngineConfig,
    do_compact: bool = True,
):
    """The whole SLAM frame (ElasticFusion.cpp:270-607 minus the host-decided
    loop-closure applications):

      preprocess -> frame-to-model tracking (against the carried prediction
      or its fill-in, selected on the device by denseEnough, cpp:256-268,
      303-315) -> velocity fusion weight (cpp:371-383) -> tracking gates
      (cpp:326-344, reloc_mode, on the device) -> fuse -> clean (unless
      lost; under `_cond` on the gates) -> end-of-frame combinedPredict +
      FillIn (cpp:599) -> with `fern`: `_closure_inputs`.

    Nothing in it reads the device: every per-frame value is a tensor, every
    Python value static (`lost`, `do_compact`, the configuration), so a
    one-device frame can be captured as a CUDA graph.

    Like the reference `_frame_main`, a one-device map's `clean` runs on the
    exact float32 patch whatever `cfg.fx16_clean` says, and a sharded map's
    honours the flag (ref `frame_map_section`, shard_step.py:335).  The
    closure inputs consume the END-of-frame prediction, as in the reference
    package."""
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
    weighting = torch.clamp(1.0 - w * recip32(0.01), min=0.5) * weight_mult

    track_ok = (_tracking_ok(res, cfg) if cfg.reloc_mode
                else torch.ones((), dtype=torch.bool, device=T.device))

    ops = _map_ops(m)
    on_host = _branches_on_host(m)

    def no_fuse():
        z = torch.zeros((), dtype=torch.int32, device=T.device)
        return m, FuseStats(matched=z, added=z, count=m.count)

    def with_fuse(_):
        return _fuse_clean(m, T, tick, rgb, raw_m, filt_m, weighting, cfg, do_compact,
                           ops.FRAME_CLEAN_FX16 and cfg.fx16_clean)

    if cfg.rgb_only or lost:
        m, stats = no_fuse()
    elif cfg.reloc_mode:
        m, stats = _cond(track_ok, with_fuse, no_fuse, on_host)
    else:
        m, stats = with_fuse(None)

    # end-of-frame predict (cpp:599) — next frame's tracking target
    pred, vtx, nrm, img, dense = _predict(
        m, T, tick, max_time, filt_m, rgb, lost, cfg)
    out = dict(
        map=m, T=T, so3=so3_cur, res=res, pred=pred, fill=(vtx, nrm, img),
        dense=dense, stats=stats, filt=filt_m, track_ok=track_ok,
    )

    # everything `_finish` reads, as ONE f32 vector in the reference package's
    # layout (counts < 2^24 and 4-bit codes are exact in f32)
    f32 = torch.float32
    fin = [
        T.reshape(-1), res.icp_error[None], res.icp_count[None],
        track_ok.to(f32)[None],
        stats.count.to(f32)[None], ops.max_count(m).to(f32)[None],
    ]
    if fern is not None:
        c = _closure_inputs(m, T, pred, (vtx, nrm, img), tick, fern, cfg, on_host)
        out.update(c)
        add_min, best_id, best_d, block_hd = c["scores"]
        m2m = c["m2m"]
        fin += [
            c["codes"].to(f32), c["good"].to(f32)[None],
            m2m.T_curr.reshape(-1), m2m.icp_error[None], m2m.icp_count[None],
            m2m.A.reshape(-1), c["inact_px"].to(f32)[None],
            c["cons_pv"].reshape(-1), c["cons_ot"].reshape(-1),
            add_min[None], best_id.to(f32)[None], best_d[None], block_hd[None],
        ]
    out["finish_vec"] = torch.cat(fin)
    return out


def _deform(m: SurfelMap, graph, T_fix, closure_tick: float):
    """A (sub-)map's surfels after a closure: those older than the closure
    frame deformed through the optimised graph, those fused at or after it
    rigidly corrected by T_fix.  Returns the map and the `recent` mask."""
    deformed_pos, deformed_nrm = apply_graph_to_surfels(m, graph)
    recent = m.init_t >= closure_tick
    Rf, tf = T_fix[:3, :3], T_fix[:3, 3]
    new_pos = torch.where(recent[None], Rf @ m.pos + tf[:, None], deformed_pos)
    new_nrm = torch.where(recent[None], Rf @ m.normal, deformed_nrm)
    return m._replace(pos=new_pos, normal=new_nrm), recent


def _refresh_last_seen(m1: SurfelMap, recent, depth_synth, T_new, tick_now: float,
                       cfg: EngineConfig) -> SurfelMap:
    """Timestamp refresh of deformed surfels against the synthesized
    inactive depth (copy_unstable.vert:305-321)."""
    cam = cfg.camera
    H, W = cam.height, cam.width
    t = T_new[:3, 3]
    lp2 = T_new[:3, :3].T @ (m1.pos - t[:, None])
    sz = torch.where(torch.abs(lp2[2]) > 1e-12, lp2[2], torch.ones_like(lp2[2]))
    x2 = lp2[0] * cam.fx / sz + cam.cx
    y2 = lp2[1] * cam.fy / sz + cam.cy
    inb = ((lp2[2] > 0) & (lp2[2] < cfg.max_depth_processed)
           & (x2 > 0) & (y2 > 0) & (x2 < W) & (y2 < H))
    flat = (torch.clamp(y2.to(torch.int32), 0, H - 1).to(torch.int64) * W
            + torch.clamp(x2.to(torch.int32), 0, W - 1))
    d = depth_synth.reshape(-1)[flat]
    refresh = ((m1.conf > cfg.confidence_threshold) & ~recent & inb
               & (d > 0) & (lp2[2] < d + 0.1))
    return m1._replace(last_t=torch.where(
        refresh, torch.full_like(m1.last_t, tick_now), m1.last_t))


def _apply_closure(
    m: SurfelMap,
    graph,                 # deformation.GraphState (optimised)
    T_fix,                 # (4,4) f32 world-frame left-correction
    closure_tick: float,   # surfels with init_t >= this get the rigid fix
    T_new,                 # (4,4) f32 corrected pose, T_fix @ carried pose
    tick_now: float, max_time: float, lost: bool,
    filt_m, rgb,           # latest frame (for the re-predict fill-in)
    cfg: EngineConfig,
    fern_accepted: bool,
):
    """Loop-closure repair (ElasticFusion.cpp:410-534 + clean's graph
    application, copy_unstable.vert:132-321): (a) deform every surfel older
    than the closure frame through the optimised graph and apply the rigid
    correction to those fused at or after it, (b) unless a fern closed the
    loop, refresh timestamps against the synthesized inactive depth
    (cpp:561-570), (c) re-clean, (d) regenerate the carried prediction at
    the corrected pose (the next frame encodes its own fern view).

    A sharded map is repaired sub-map by sub-map (ref
    `_apply_closure_sharded`).  The synthesized depth is rendered from the
    map before the deformation at any S, as the reference's one-device
    repair does (its sharded one renders the deformed map), so S = 1 is the
    one-device repair bit for bit; the sharded re-clean honours
    `cfg.fx16_clean` as the reference's sharded one does."""
    cam = cfg.camera
    depth_synth = None
    if not fern_accepted:
        # time=tick, maxTime=tick-timeDelta, timeDelta=uint16-max (cpp:561-569)
        depth_synth = _combined_predict(
            m, T_new, tick_now, tick_now - cfg.time_delta, 65535, cfg).depth

    def repair(mk):
        dev = mk.pos.device
        m1, recent = _deform(mk, to_device(graph, dev), T_fix.to(dev), closure_tick)
        if depth_synth is None:
            return m1
        return _refresh_last_seen(m1, recent, depth_synth.to(dev), T_new.to(dev),
                                  tick_now, cfg)

    ops = _map_ops(m)
    m1 = ops.each(m, repair)
    pidx = ops.predict_indices(
        m1, T_new, cam, tick_now, cfg.time_delta, cfg.max_depth_processed)
    m2 = ops.clean_all(m1, pidx, T_new, tick_now, cfg,
                       ops.FRAME_CLEAN_FX16 and cfg.fx16_clean)
    pred, vtx, nrm, img, dense = _predict(
        m2, T_new, tick_now, max_time, filt_m, rgb, lost, cfg)
    return dict(map=m2, pred=pred, fill=(vtx, nrm, img), dense=dense)


def _predict_only(m: SurfelMap, T_wc, tick, max_time, depth_filt_m, rgb, lost,
                  cfg: EngineConfig):
    """predict() + fill-in + fern views without fusion (first frame,
    relocalization teleport)."""
    pred, vtx, nrm, img, dense = _predict(
        m, T_wc, tick, max_time, depth_filt_m, rgb, lost, cfg)
    views = decimate_views(img, vtx, nrm, cfg.fern_pyramid_factor)
    return pred, (vtx, nrm, img), dense, views


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


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A frame array as a CPU tensor (copied when read-only, as a decoded
    log's buffers are)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


class Engine:
    """Dense RGB-D SLAM engine with the ElasticFusion surface (construct,
    process_frame per frame).  Runs on the CUDA card unless `device` names
    something else; `device=None` raises when there is no card.

    With `cfg.mesh_shape = (S,)` the map is S sub-maps: all on `device`
    when given, else on `cuda:0 .. cuda:S-1` (`parallel.sharding.engine_group`); the
    frame state lives on the first of them."""

    def __init__(self, cfg: EngineConfig = EngineConfig(),
                 device: DeviceLike = None):
        self.cfg = cfg
        self.group = engine_group(cfg, device)
        self.device = self.group.lead if self.group else resolve_device(device)
        self.tick = 1                             # starts at 1 (EF.cpp:55)
        self.T_wc = np.eye(4)                     # f64 host pose
        self.lost = False
        self.tracking_count = 0
        self.last_frame_recovery = False
        # tick-keyed pose log (deformations rewrite it) + the parallel
        # timestamp log (EF.cpp:588-589)
        self.tick_poses: List[Tuple[int, np.ndarray]] = []
        self.pose_times: List[int] = []
        self.map: Optional[SurfelMap] = None
        self.stopwatch = Stopwatch()
        self.deforms = 0
        self.fern_deforms = 0
        # carried device state
        self._T_f32 = None          # (4,4) f32 pose of the latest dispatched
                                    # frame, on the device
        self._so3_hist = None       # prev frame coarsest intensity
        self._pred = None           # Prediction from end-of-last-frame predict()
        self._fill = None           # (vertex, normal, image) fill-in maps
        self._dense_dev = None      # f32 scalar: last predict coverage
        self._last_frame = None     # (filtered depth, rgb) of the latest frame
        # a one-device map's frames run on static tensors, captured as CUDA
        # graphs on a card (graphs.py); a sharded map's frames run eagerly
        self.runner = (FrameRunner(self.device, cfg.pipeline_depth)
                       if self.group is None else None)
        self._count_finished = 0    # exact count of the last finished frame
        self._count_max_finished = 0  # and of its fullest shard
        self._last_icp_error = 0.0
        self._last_icp_count = 0.0
        self._last_tracking_ok = True
        self._last_fused = False
        # pipeline
        self._inflight: deque = deque()
        self._seq = 0  # monotone dispatch counter (ticks repeat while lost)
        # Pose corrections for frames that were IN FLIGHT when a closure (or
        # teleport) rewrote the carried pose: (closure_seq, last_inflight_seq,
        # 4x4 f64).  A finished frame's pose needs fix F iff it was dispatched
        # after F's closure frame but before F was applied
        # (closure_seq < seq <= last_inflight_seq); frames dispatched later
        # carry the corrected pose already.  A fix applied outside its window
        # double-corrects every later pose.
        self._pose_fixes: List[Tuple[int, int, np.ndarray]] = []
        # loop-closure subsystems (ferns.py / deformation.py)
        self.ferns: Optional[Ferns] = None
        self.local_deformation: Optional[Deformation] = None
        self.global_deformation: Optional[Deformation] = None
        self.relative_cons: list = []
        if cfg.closeLoops:
            self.enable_loop_closure()

    def enable_loop_closure(self) -> None:
        """Construct the fern DB and the two deformations (local graph sampled
        from the map, global resampled 1/5 — ElasticFusion.h:259-266)."""
        cfg, dev = self.cfg, self.device
        self.ferns = Ferns(cfg, dev)
        self.local_deformation = Deformation(
            node_capacity=cfg.max_deformation_nodes,
            sample_rate=cfg.def_graph_sample_rate, device=dev)
        self.global_deformation = Deformation(
            node_capacity=cfg.max_deformation_nodes,
            sample_rate=cfg.def_graph_sample_rate, device=dev)

    # -- public knobs ---------------------------------------------------------
    @property
    def surfel_count(self) -> int:
        self.flush()
        return 0 if self.map is None else int(self.map.count)

    @property
    def poses(self) -> List[Tuple[int, np.ndarray]]:
        """Timestamped (possibly deformation-corrected) trajectory."""
        self.flush()
        return [(ts, T) for ts, (_, T) in zip(self.pose_times, self.tick_poses)]

    def flush(self) -> None:
        """Finish every in-flight frame (host reads + loop-closure logic)."""
        while self._inflight:
            self._finish(self._inflight.popleft())

    def _fern_inputs(self):
        """Fern tables and keyframe DB handed to the frame, or None."""
        if self.ferns is None:
            return None
        return (*self.ferns.encode_tables(), *self.ferns.device_db())

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
        rgb_d = _host_tensor(rgb).to(self.device)
        depth_d = torch.from_numpy(
            np.asarray(depth_mm).astype(np.float32)).to(self.device)
        sw.tock("Preprocess")

        if self.tick == 1:
            self._first_frame(depth_d, rgb_d, timestamp, in_T_wc)
            sw.tock("Run")
            return self._result()

        if in_T_wc is not None:
            self._external_pose_frame(depth_d, rgb_d, timestamp,
                                      weight_multiplier, in_T_wc)
            sw.tock("Run")
            return self._result()

        # after a checkpoint restore there is no carried prediction yet:
        # regenerate it from the restored map at the restored pose
        if self._pred is None or self._T_f32 is None:
            self._regenerate_carried(_preprocess(depth_d, cfg)[1], rgb_d)

        self._maybe_grow()

        # the recovery flag belongs to this frame: _reloc_update reads it when
        # the frame finishes (the whole-map render it asks for already
        # happened in _teleport's _regenerate_carried)
        rec = dict(tick=self.tick, timestamp=timestamp, lost_at_dispatch=self.lost,
                   recovery=self.last_frame_recovery, seq=self._seq)
        self.last_frame_recovery = False

        # "dispatch": the frame's device program and the start of its finish
        # vector's copy to the host; "drain": finishing the frames older than
        # pipeline_depth
        sw.tick("dispatch")
        do_compact = self.tick % cfg.compact_every == 0
        if self.runner is not None:
            out = self._run_frame(depth_d, rgb_d, float(weight_multiplier), do_compact)
        else:
            f32 = dict(dtype=torch.float32, device=self.device)
            tick_dev = torch.full((), float(self.tick), **f32)
            out = _frame_main(
                self.map, self._T_f32, self._so3_hist,
                self._pred.vertex, self._pred.normal, self._pred.image,
                self._fill[0], self._fill[1], self._fill[2],
                self._dense_dev, depth_d, rgb_d, tick_dev, tick_dev, self.lost,
                torch.full((), float(weight_multiplier), **f32),
                self._fern_inputs(), cfg, do_compact=do_compact,
            )
            # the carried state advances at once, so nothing waits for this
            # frame's finish
            self.map = out["map"]
            self._T_f32 = out["T"]
            self._so3_hist = out["so3"]
            self._pred = out["pred"]
            self._fill = out["fill"]
            self._dense_dev = out["dense"]
            out.update(rgb=rgb_d, count=out["stats"].count)
        self._last_frame = (out["filt"], out["rgb"])
        rec["out"] = out
        rec["finish"] = PendingRead(out["finish_vec"])
        sw.tock("dispatch")
        self._inflight.append(rec)
        self._seq += 1
        # the tick does not advance while lost
        if not self.lost:
            self.tick += 1

        sw.tick("drain")
        while len(self._inflight) > cfg.pipeline_depth:
            self._finish(self._inflight.popleft())
        sw.tock("drain")
        sw.tock("Run")
        return self._result()

    def _run_frame(self, depth_d, rgb_d, weight_multiplier: float,
                   do_compact: bool) -> dict:
        """A one-device frame through the `FrameRunner`: the carried state
        and the inputs into its static tensors, the frame run (eagerly, or
        replayed as a CUDA graph), the carried state read back from the
        static tensors it updated.  Returns the frame's finish slot."""
        cfg = self.cfg
        fern = self._fern_inputs()
        S = self.runner.load(
            dict(map=self.map, T=self._T_f32, so3=self._so3_hist, pred=self._pred,
                 fill=self._fill, dense=self._dense_dev),
            dict(depth=depth_d, rgb=rgb_d),
            dict(tick=float(self.tick), max_time=float(self.tick),
                 weight=weight_multiplier))
        lost = self.lost

        def frame() -> dict:
            out = _frame_main(
                S["map"], S["T"], S["so3"], S["pred"].vertex, S["pred"].normal,
                S["pred"].image, *S["fill"], S["dense"], S["depth"], S["rgb"],
                S["tick"], S["max_time"], lost, S["weight"], fern, cfg,
                do_compact=do_compact)
            # the new carried state, in place (the reference donates its map)
            copy_into([S["map"], S["T"], S["so3"], S["pred"], S["fill"], S["dense"]],
                      [out["map"], out["T"], out["so3"], out["pred"], out["fill"],
                       out["dense"]])
            keep = dict(finish_vec=out["finish_vec"], count=out["stats"].count,
                        filt=out["filt"], rgb=S["rgb"])
            if fern is not None:
                keep.update(views=out["views"], node_pos=out["node_pos"],
                            node_t=out["node_t"])
            return keep

        key = (self.map.capacity, do_compact, lost,
               None if fern is None else fern[2].shape[0])
        out = self.runner.run(key, frame)
        self.map, self._T_f32, self._so3_hist = S["map"], S["T"], S["so3"]
        self._pred, self._fill, self._dense_dev = S["pred"], S["fill"], S["dense"]
        return out

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
        if self.group is not None:
            cap0 = -(-cap0 // self.group.S) * self.group.S   # capacity % S == 0
        m_single = _init_map(raw_m, filt_m, rgb_d, cfg, cap0)
        self._adopt_map(m_single, int(read_back(m_single.count)))
        self._so3_hist = _coarse_intensity(rgb_d, cfg)  # initFirstRGB
        if in_T_wc is not None:
            self.T_wc = np.asarray(in_T_wc, np.float64)
        self._T_f32 = self._device_pose()
        one = torch.tensor(1.0, device=self.device)
        self._pred, self._fill, self._dense_dev, _ = _predict_only(
            self.map, self._T_f32, one, one, filt_m, rgb_d, False, cfg,
        )
        self._last_frame = (filt_m, rgb_d)
        self.tick_poses.append((1, self.T_wc.copy()))
        self.pose_times.append(int(timestamp))
        if self.local_deformation is not None:
            # sampled from the one-device layout, whose slot order is time
            # order (as the reference does)
            self.local_deformation.set_sampled(
                *_OneDeviceMap.sample_nodes(m_single, cfg.def_graph_sample_rate),
                m_single.count)
            self.global_deformation.sample_graph_from(self.local_deformation)
        self.tick = 2

    def _external_pose_frame(self, depth_d, rgb_d, timestamp, weight_multiplier,
                             in_T_wc):
        """The ground-truth-pose path: no tracking, no loop closures (they
        are pointless under supplied poses) — synchronous.  Like the
        reference's external-pose path it honours `cfg.fx16_clean`."""
        cfg = self.cfg
        self.flush()
        self._maybe_grow()
        raw_m, filt_m = _preprocess(depth_d, cfg)
        T_prev = self.T_wc.copy()
        self.T_wc = np.asarray(in_T_wc, np.float64)
        self._T_f32 = self._device_pose()
        self._so3_hist = _coarse_intensity(rgb_d, cfg)
        # velocity-adaptive fusion weight on the host (cpp:371-383)
        T_cp = np.linalg.inv(self.T_wc) @ T_prev
        w = min(max(float(np.linalg.norm(T_cp[:3, 3])), _np_se3_log_norm(T_cp)), 0.01)
        weighting = torch.tensor(max(1.0 - w / 0.01, 0.5) * weight_multiplier,
                                 dtype=torch.float32, device=self.device)

        tick_dev = torch.tensor(float(self.tick), device=self.device)
        T_d = self._T_f32
        self.map, stats = _fuse_clean(
            self.map, T_d, tick_dev, rgb_d, raw_m, filt_m, weighting, cfg, True,
            cfg.fx16_clean)
        self._pred, self._fill, self._dense_dev, _ = _predict_only(
            self.map, T_d, tick_dev, tick_dev, filt_m, rgb_d, False, cfg)
        self._last_frame = (filt_m, rgb_d)
        self._count_finished, self._count_max_finished = (int(c) for c in read_back(
            torch.stack([stats.count, _map_ops(self.map).max_count(self.map)]).to(torch.int64)))
        self._last_fused = True
        self.tick_poses.append((self.tick, self.T_wc.copy()))
        self.pose_times.append(int(timestamp))
        self.tick += 1

    def _regenerate_carried(self, filt_m, rgb_d):
        """Re-render the carried prediction at the host pose from a frame's
        filtered depth and colour: after a fern teleport (the latest frame)
        and after a checkpoint restore (the frame about to be tracked).
        Right after a teleport the reference renders the WHOLE map
        (combinedPredict time=0, maxTime=tick, ElasticFusion.cpp:624-631), so
        the confirming frame has a full prediction to track against."""
        cfg = self.cfg
        self._T_f32 = self._device_pose()
        tick = float(self.tick)
        pred_time = 0.0 if self.last_frame_recovery else tick
        self._pred, self._fill, self._dense_dev, _ = _predict_only(
            self.map, self._T_f32, pred_time, tick, filt_m, rgb_d, self.lost, cfg,
        )
        if self._so3_hist is None:
            self._so3_hist = _coarse_intensity(rgb_d, cfg)

    def _device_pose(self) -> torch.Tensor:
        """The host pose as the carried float32 pose on the device."""
        return torch.from_numpy(self.T_wc.astype(np.float32)).to(self.device)

    def _maybe_grow(self):
        """Grow to the next capacity bucket before the tail can overflow,
        judged on the last finished frame's exact count (the first frame's
        is read when the map is made, so no estimate is needed before the
        first finish).  The frames in flight may each append up to H*W/4
        more (fuse's measurement subsample); worst case a full-novel-view
        burst saturates fuse's append clamp for them, and the dropped
        measurements re-enter on the following frames."""
        cfg = self.cfg
        cap = self.map.capacity
        hw4 = (cfg.camera.width * cfg.camera.height) // 4
        est = self._count_finished
        if self.group is not None:
            # the trigger watches the FULLEST shard (each overflows on its
            # own); every shard grows to the new capacity / S
            S = self.group.S
            est_max = self._count_max_finished
            if cap < cfg.max_surfels and est_max > 0.8 * (cap // S):
                target = _next_bucket(int(1.35 * est_max) * S + hw4, cfg.max_surfels)
                self.map = shard_step.grow(self.map, -(-target // S) * S)
            return
        if cap < cfg.max_surfels and est > 0.8 * cap:
            # 1.35 > 1/0.8 so the new bucket sits below its own trigger
            self.map = _OneDeviceMap.grow(
                self.map, _next_bucket(int(1.35 * est) + hw4, cfg.max_surfels))

    def _result(self) -> FrameResult:
        return FrameResult(
            T_wc=self.T_wc.copy(),
            tracking_ok=self._last_tracking_ok,
            lost=self.lost,
            icp_error=self._last_icp_error,
            icp_count=self._last_icp_count,
            fused=self._last_fused,
            count_dev=None if self.map is None else self.map.count.clone(),
        )

    def _finish(self, rec) -> None:
        """Host-side completion of one frame: one packed device read, pose log,
        relocalization state machine, fern DB, loop-closure decisions."""
        sw = self.stopwatch
        sw.tick("finish")
        self._finish_frame(rec)
        # frames finish in dispatch order: fixes fully behind us are drained
        self._pose_fixes = [e for e in self._pose_fixes if rec["seq"] < e[1]]
        sw.tock("finish")

    def _finish_frame(self, rec) -> None:
        cfg = self.cfg
        out = rec["out"]
        vec = rec["finish"].get().astype(np.float64)
        self.T_wc = self._fixed_pose(rec, vec[0:16].reshape(4, 4))
        self._last_icp_error = float(vec[16])
        self._last_icp_count = float(vec[17])
        tok = vec[18] != 0.0
        self._count_finished = int(vec[19])
        self._count_max_finished = int(vec[20])

        tracking_ok = True
        if cfg.reloc_mode:
            tracking_ok = self._reloc_update(bool(tok), rec["recovery"])
        self._last_tracking_ok = tracking_ok
        self._last_fused = (
            (not cfg.rgb_only) and bool(tok) and not rec["lost_at_dispatch"])

        self.tick_poses.append((rec["tick"], self.T_wc.copy()))
        self.pose_times.append(int(rec["timestamp"]))

        if self.local_deformation is None:
            return
        # deformation node sample of this frame's map state (cpp:591-597)
        self.local_deformation.set_sampled(out["node_pos"], out["node_t"], out["count"])
        self.global_deformation.sample_graph_from(self.local_deformation)

        F = self.ferns.num
        H, W = cfg.camera.height, cfg.camera.width
        hs, ws = -(-H // CONS_SAMPLE), -(-W // CONS_SAMPLE)
        o = 21
        codes = vec[o:o + F].astype(np.int32); o += F
        good = int(vec[o]); o += 1
        m2m_T = vec[o:o + 16].reshape(4, 4); o += 16
        m2m_err, m2m_cnt = vec[o], vec[o + 1]; o += 2
        m2m_A = vec[o:o + 36].reshape(6, 6); o += 36
        inact_px = int(vec[o]); o += 1
        cons_pv = vec[o:o + 3 * hs * ws].reshape(3, hs, ws); o += 3 * hs * ws
        cons_ot = vec[o:o + hs * ws].reshape(hs, ws); o += hs * ws
        add_min, best_id, best_d, block_hd = vec[o:o + 4]
        self._close_loops(
            rec, float(best_id), float(best_d), float(block_hd), codes, good,
            m2m_T, float(m2m_err), float(m2m_cnt), m2m_A, inact_px,
            cons_pv, cons_ot,
        )
        # Ferns::addFrame at the end of the frame (cpp:601-604), not while lost
        if not rec["lost_at_dispatch"] and not self.lost:
            self.ferns.add_frame_scored(
                float(add_min), codes, good, out["views"], self.T_wc, rec["tick"])

    def _reloc_update(self, tracking_ok: bool, was_recovery: bool) -> bool:
        """Relocalization state machine (ElasticFusion.cpp:326-365).
        `was_recovery` marks the frame right after a fern teleport: one
        further well-conditioned frame confirms recovery (cpp:348-364)."""
        if not self.lost:
            if not tracking_ok:
                self.tracking_count += 1
                if self.tracking_count > 10:
                    self.lost = True
                return False
            self.tracking_count = 0
            return True
        if was_recovery and tracking_ok:
            self.lost = False
            self.tracking_count = 0
        return tracking_ok

    def _fixed_pose(self, rec, T: np.ndarray) -> np.ndarray:
        """Apply (in closure order) every outstanding pose fix whose in-flight
        window holds this frame's dispatch seq.  No pruning here: a frame
        needs the same fixes for its own pose and its model-to-model
        estimate; `_finish` prunes once the frame is done."""
        seq = rec["seq"]
        for cs, us, fix in self._pose_fixes:
            if cs < seq <= us:
                T = fix @ T
        return np_orthonormalize(T)

    # -- loop closures ---------------------------------------------------------

    def _close_loops(self, rec, best_id, best_d, block_hd, codes, good,
                     m2m_T, m2m_err, m2m_cnt, m2m_A, inact_px, cons_pv,
                     cons_ot) -> None:
        """Global (fern) + local (model-to-model) loop closure decisions
        (ElasticFusion.cpp:391-534) on the finished frame's outputs; an
        accepted one is applied by `_dispatch_closure`."""
        cfg = self.cfg
        sw = self.stopwatch

        # --- global: fern retrieval, scored on the device (cpp:394-404) ---
        sw.tick("Ferns::findFrame")
        recovery, constraints = self.ferns.find_frame_scored(
            int(best_id), best_d, block_hd, codes, good,
            rec["out"]["views"], self.T_wc, rec["tick"], rec["lost_at_dispatch"],
        )
        sw.tock("Ferns::findFrame")

        if self.ferns.last_closest != -1:
            if rec["lost_at_dispatch"]:
                # teleport relocalization (cpp:411-413)
                self._teleport(rec, np_orthonormalize(np.asarray(recovery, np.float64)))
                return
            gd = self.global_deformation
            fern_time = self.ferns.closest_src_time()
            for c in constraints:
                gd.add_constraint(
                    c.source_point, c.target_point, rec["tick"], fern_time, pin=True)
            gd.constraints.extend(self.relative_cons)
            fern_poses = [(f.src_time, f.T_wc) for f in self.ferns.frames]
            ok, new_fern_poses, new_hist, _ = gd.constrain(
                fern_poses, rec["tick"], fern_match=True,
                pose_history=self.tick_poses, relax_graph=True,
            )
            if ok:
                T_rec = np_orthonormalize(np.asarray(recovery, np.float64))
                for f, (_, T) in zip(self.ferns.frames, new_fern_poses):
                    f.T_wc = T
                self.tick_poses = new_hist
                self.fern_deforms += 1
                self._dispatch_closure(rec, T_rec, gd.graph, fern_accepted=True)
                return

        # --- local: active-to-inactive model alignment (cpp:447-534) ---
        if rec["lost_at_dispatch"] or inact_px < 1:
            return
        if not _covariance_ok(m2m_A, cfg.cov_threshold):
            return
        if not (m2m_cnt > cfg.icp_count_threshold
                and m2m_err < cfg.icp_error_threshold):
            return
        # the estimate was made at dispatch: bring it into the corrected frame
        # exactly like the frame's own pose
        T_est = self._fixed_pose(rec, np.asarray(m2m_T, np.float64))

        # constraints from consSample-subsampled pixels (cpp:485-511)
        pv, ot = cons_pv, cons_ot
        z_ok = (pv[2] > 0) & (pv[2] < cfg.max_depth_processed) & (ot > 0)
        ld = self.local_deformation
        pin = ld.deforms == 0
        srcs = self.T_wc[:3, :3] @ pv.reshape(3, -1) + self.T_wc[:3, 3:4]
        tgts = T_est[:3, :3] @ pv.reshape(3, -1) + T_est[:3, 3:4]
        flat_ot = ot.reshape(-1)
        for i in np.nonzero(z_ok.reshape(-1))[0]:
            ld.add_constraint(
                srcs[:, i], tgts[:, i], rec["tick"], int(flat_ot[i]), pin=pin)
        if not ld.constraints:
            return

        fern_poses = [(f.src_time, f.T_wc) for f in self.ferns.frames]
        ok, new_fern_poses, _, new_rel = ld.constrain(
            fern_poses, rec["tick"], fern_match=False,
            pose_history=self.tick_poses, relax_graph=False,
            collect_relative=True,
        )
        if ok:
            for f, (_, T) in zip(self.ferns.frames, new_fern_poses):
                f.T_wc = T
            self.deforms += 1
            self._dispatch_closure(rec, T_est, ld.graph, fern_accepted=False)
            # carry forward a third of the new relative constraints (cpp:529-531)
            if new_rel:
                step = max(len(new_rel) // 3, 1)
                self.relative_cons.extend(new_rel[::step])

    def _dispatch_closure(self, rec, T_target: np.ndarray, graph,
                          fern_accepted: bool) -> None:
        """Apply an accepted closure: the rigid pose correction T_fix
        (world-frame left-multiply taking the closure frame's pose to its
        corrected one) plus the map deformation, via `_apply_closure` on the
        LATEST carried state (frames dispatched after the closure frame
        included)."""
        T_fix = T_target @ np.linalg.inv(self.T_wc)
        self.T_wc = np_orthonormalize(T_target)
        # the closure frame's own logged pose becomes the corrected one
        # (currPose = estPose before the pose log, ElasticFusion.cpp:534+588)
        if self.tick_poses and self.tick_poses[-1][0] == rec["tick"]:
            self.tick_poses[-1] = (rec["tick"], self.T_wc.copy())
        # frames still in flight were dispatched at pre-correction poses and
        # get the same rigid fix when they finish; frames dispatched from now
        # on carry the corrected pose (no fix — see _pose_fixes)
        if self._inflight:
            self._pose_fixes.append(
                (rec["seq"], self._inflight[-1]["seq"], T_fix.copy()))

        filt_m, rgb_d = self._last_frame
        tick_now = float(max(self.tick - 1, rec["tick"]))
        T_fix32 = torch.from_numpy(T_fix.astype(np.float32)).to(self.device)
        T_new = T_fix32 @ self._T_f32
        out = _apply_closure(
            self.map, graph, T_fix32, float(rec["tick"]), T_new,
            tick_now, tick_now, self.lost, filt_m, rgb_d, self.cfg, fern_accepted,
        )
        self.map = out["map"]
        self._T_f32 = T_new
        self._pred = out["pred"]
        self._fill = out["fill"]
        self._dense_dev = out["dense"]

    def _teleport(self, rec, T_rec: np.ndarray) -> None:
        """Lost-mode fern relocalization: jump to the recovery pose and
        regenerate the carried prediction there (ElasticFusion.cpp:411-413);
        the next well-conditioned frame confirms (cpp:348-364)."""
        fix = T_rec @ np.linalg.inv(self.T_wc)
        if self._inflight:
            self._pose_fixes.append((rec["seq"], self._inflight[-1]["seq"], fix))
        self.T_wc = T_rec
        self.last_frame_recovery = True
        self._regenerate_carried(*self._last_frame)

    # -- outputs ---------------------------------------------------------------

    def save_trajectory(self, path, iclnuim: bool = False) -> None:
        """The timestamped trajectory as a `.freiburg` file (flushes first)."""
        from .io.trajectory import write_freiburg

        write_freiburg(path, self.poses, iclnuim=iclnuim)

    def _adopt_map(self, m: SurfelMap, count: int) -> None:
        """Make a one-device map of `count` live surfels (the first frame's,
        a restored checkpoint's) the engine's: redistributed into S sub-maps
        when the engine is sharded, the fullest of which then holds
        ceil(count / S) surfels."""
        self._count_finished = self._count_max_finished = count
        if self.group is not None:
            S = self.group.S
            self._count_max_finished = min(-(-count // S), m.capacity // S)
            m = shard_step.distribute_map(m, self.group)
        self.map = m

    def export_map(self) -> Optional[SurfelMap]:
        """The map after every in-flight frame has finished, as ONE
        one-device map (sub-maps are gathered shard by shard: exports,
        checkpoints)."""
        self.flush()
        return _map_ops(self.map).gather(self.map)

    def save_ply(self, path) -> int:
        """The confident surfels as a binary PLY; returns the vertex count."""
        from .io.ply import save_ply

        return save_ply(path, self.export_map(), self.cfg.confidence_threshold)


def _np_se3_log_norm(T: np.ndarray) -> float:
    """|log SE3| used by the fusion weight (Sophus log norm), on the host in
    float64 — the external-pose path's variant."""
    R = T[:3, :3]
    cos_t = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = float(np.arccos(cos_t))
    if theta < 1e-8:
        w = np.zeros(3)
        V_inv = np.eye(3)
    else:
        w = (
            theta
            / (2.0 * np.sin(theta))
            * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        )
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / theta
        half = theta * 0.5
        cot = half / np.tan(half)
        V_inv = np.eye(3) - 0.5 * theta * K + (1.0 - cot) * (K @ K)
    v = V_inv @ T[:3, 3]
    return float(np.sqrt(np.dot(v, v) + np.dot(w, w)))


def _covariance_ok(A: np.ndarray, thresh: float = 1e-4) -> bool:
    """Covariance gate: diag of A^-1 all below thresh (cpp:330-344)."""
    try:
        cov = np.linalg.inv(A)
    except np.linalg.LinAlgError:
        return False
    return bool((np.diag(cov) < thresh).all())
