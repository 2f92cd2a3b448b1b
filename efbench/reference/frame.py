"""The reference frame: ElasticFusion's per-frame main path in plain PyTorch.

Preprocess -> frame-to-model tracking -> velocity fusion weight ->
predictIndices -> fuse -> clean -> end-of-frame combinedPredict + fill-in
(ElasticFusion.cpp:270-599 without the loop-closure decisions), written
after the port's `engine._frame_main` with the frozen plain modules of this
package: no kernel, no CUDA graph, no pipelining.  It imports nothing of
the program.

`frame` takes a carried state (the map, the pose, the SO(3) history, the
carried prediction and its fill-in, the coverage) and a raw frame and
returns the next carried state.  `first_frame` is the start: the map made
from the first frame and its prediction.

`q` is applied to every stage's output (identity for the reference); the
control passes a rounding to a lower precision there.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .config import EngineConfig
from .fillin import fill_all
from .fuse import clean, fuse
from .preprocess import (
    bilateral_filter,
    metricise_depth,
    pyr_down_intensity,
    rgb_to_intensity,
)
from .se3 import invert, se3_log_norm
from .splat import combined_predict, predict_indices
from .surfels import SurfelMap, init_map_from_frame, recip32
from .tracking import (
    OdometryInputs,
    build_current_frame_pyramids,
    build_model_pyramids,
    get_incremental_transformation,
)


class Carried(NamedTuple):
    """What one frame hands the next (the port's `FrameRunner` state)."""

    map: SurfelMap
    T: torch.Tensor            # (4,4) f32 world <- camera
    so3: torch.Tensor          # coarsest-level intensity of the last frame
    pred_vertex: torch.Tensor
    pred_normal: torch.Tensor
    pred_image: torch.Tensor
    fill_vertex: torch.Tensor
    fill_normal: torch.Tensor
    fill_image: torch.Tensor
    dense: torch.Tensor        # 0-d f32 coverage of the prediction


def _ident(x):
    return x


def _tree(q: Callable, x):
    if isinstance(x, torch.Tensor):
        return q(x) if x.is_floating_point() else x
    if hasattr(x, "_fields"):
        return type(x)(*(_tree(q, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(q, v) for v in x)
    return x


def preprocess(depth_mm: torch.Tensor, cfg: EngineConfig):
    """filterDepth + metriciseDepth (ElasticFusion.cpp:655-673)."""
    d = depth_mm.to(torch.float32)
    filt = bilateral_filter(d, cfg.max_depth_processed, cfg.bilateral_radius)
    return (metricise_depth(d, cfg.depth_cutoff),
            metricise_depth(filt, cfg.depth_cutoff))


def coarse_intensity(rgb, cfg: EngineConfig):
    img = rgb_to_intensity(rgb)
    for _ in range(1, cfg.num_pyramid_levels):
        img = pyr_down_intensity(img)
    return img


def predict(m: SurfelMap, T, time, max_time, filt_m, rgb, cfg: EngineConfig):
    """predict() (ElasticFusion.cpp:621-653): ACTIVE combinedPredict, the
    three fill-in passes and the denseEnough statistic."""
    pred = combined_predict(m, T, cfg.camera, time, max_time, cfg.time_delta,
                            cfg.confidence_threshold, cfg.max_depth_processed)
    vtx, nrm, img = fill_all(pred, filt_m, rgb, cfg.camera, cfg.max_depth_processed,
                             False, cfg.frame_to_frame_rgb)
    dense = (torch.sum(pred.image, dim=-1) > 0).to(torch.float32).mean()
    return pred, (vtx, nrm, img), dense


def first_frame(depth_mm, rgb, capacity: int, cfg: EngineConfig,
                q: Callable = _ident) -> Carried:
    """The first frame (ElasticFusion.cpp:283-301): the map initialised from
    it at the identity pose, then predicted."""
    raw_m, filt_m = _tree(q, preprocess(depth_mm, cfg))
    m = _tree(q, init_map_from_frame(capacity, raw_m, filt_m, rgb, cfg.camera,
                                     cfg.depth_cutoff))
    T = torch.eye(4, dtype=torch.float32, device=depth_mm.device)
    one = torch.tensor(1.0, device=depth_mm.device)
    pred, fill, dense = _tree(q, predict(m, T, one, one, filt_m, rgb, cfg))
    return Carried(m, T, q(coarse_intensity(rgb, cfg)), pred.vertex, pred.normal,
                   pred.image, *fill, dense)


def frame(c: Carried, depth_mm, rgb, tick, max_time, weight_mult, do_compact: bool,
          cfg: EngineConfig, q: Callable = _ident) -> Carried:
    """One tracked and fused frame from the carried state `c` (the port's
    `_frame_main` on one device, without relocalisation and fern inputs)."""
    c = _tree(q, c)
    raw_m, filt_m = _tree(q, preprocess(depth_mm, cfg))

    use_fill = (c.dense < 0.75) | bool(cfg.frame_to_frame_rgb)
    pv = torch.where(use_fill, c.fill_vertex, c.pred_vertex)
    pn = torch.where(use_fill, c.fill_normal, c.pred_normal)
    pi = torch.where(use_fill, c.fill_image, c.pred_image)

    vmaps_c, nmaps_c, images_c, depths_c = _tree(
        q, build_current_frame_pyramids(filt_m, rgb, cfg))
    vmaps_g, nmaps_g, images_m, depths_m = _tree(
        q, build_model_pyramids(pv, pn, pi, c.T, cfg))
    res = get_incremental_transformation(OdometryInputs(
        vmaps_curr=vmaps_c, nmaps_curr=nmaps_c, vmaps_prev_g=vmaps_g,
        nmaps_prev_g=nmaps_g, last_images=images_m, next_images=images_c,
        last_depths=depths_m, next_depths=depths_c, so3_last_image=c.so3,
        T_prev=c.T), cfg)
    T = q(res.T_curr)

    # velocity-adaptive fusion weight (cpp:371-383)
    T_cp = invert(T) @ c.T
    w = torch.clamp(
        torch.maximum(torch.linalg.vector_norm(T_cp[:3, 3]), se3_log_norm(T_cp)),
        max=0.01)
    weighting = torch.clamp(1.0 - w * recip32(0.01), min=0.5) * weight_mult

    cam = cfg.camera
    pidx = predict_indices(c.map, T, cam, tick, cfg.time_delta, cfg.max_depth_processed)
    m, _stats, pidx2 = fuse(c.map, pidx, T, tick, rgb, raw_m, filt_m, cam,
                            cfg.max_depth_processed, weighting, return_updated_pred=True)
    m = _tree(q, m)
    m = _tree(q, clean(m, pidx2, T, tick, cam, cfg.confidence_threshold,
                       cfg.time_delta, cfg.max_depth_processed, cfg.unstable_age,
                       do_compact=do_compact, fx16_patch=False))
    pred, fill, dense = _tree(q, predict(m, T, tick, max_time, filt_m, rgb, cfg))
    return Carried(m, T, q(images_c[cfg.num_pyramid_levels - 1]), pred.vertex,
                   pred.normal, pred.image, *fill, dense)
