"""Gap fill-in — the equivalent of `FillIn` (Core/Shaders/FillIn.{h,cpp};
fill_vertex.frag, fill_normal.frag, fill_rgb.frag).

Combines predicted model maps with raw-frame data: wherever the prediction is
empty (vertex z == 0 / RGB sum == 0) or `passthrough` is forced (tracking
lost, or frameToFrameRGB for the image — ElasticFusion.cpp:647-649), the raw
back-projection is substituted.  The fill-in outputs are what tracking
consumes (ElasticFusion.cpp:311-315)."""

from __future__ import annotations

import torch

from .config import CameraConfig
from .preprocess import compute_nmap, compute_vmap
from .splat import Prediction


def _as_flag(flag, like: torch.Tensor) -> torch.Tensor:
    """A Python bool or 0-d bool tensor → 0-d bool tensor on `like`'s device
    (a Python bool by a fill on the device, never a copy from the host)."""
    if isinstance(flag, torch.Tensor):
        return flag.to(device=like.device, dtype=torch.bool)
    return torch.full((), bool(flag), dtype=torch.bool, device=like.device)


def fill_vertex(pred_vertex, depth_filtered_m, cam: CameraConfig, max_depth: float, passthrough):
    """fill_vertex.frag:44-52: substitute the raw back-projection where the
    predicted vertex has no depth."""
    raw = compute_vmap(depth_filtered_m, cam, max_depth)
    use_raw = (pred_vertex[2] == 0) | _as_flag(passthrough, pred_vertex)
    return torch.where(use_raw[None], raw, pred_vertex)


def fill_normal(pred_normal, depth_filtered_m, cam: CameraConfig, max_depth: float, passthrough):
    """fill_normal.frag:41-49: forward-difference raw normals where the
    prediction is empty (keyed off the normal's z; empty predictions are
    all-zero)."""
    raw = compute_nmap(compute_vmap(depth_filtered_m, cam, max_depth))
    use_raw = (pred_normal[2] == 0) | _as_flag(passthrough, pred_normal)
    return torch.where(use_raw[None], raw, pred_normal)


def fill_image(pred_image, rgb, passthrough):
    """fill_rgb.frag: substitute raw RGB where the predicted color sums to 0."""
    rgbf = rgb.to(torch.float32)
    use_raw = (torch.sum(pred_image, dim=-1) == 0) | _as_flag(passthrough, pred_image)
    return torch.where(use_raw[..., None], rgbf, pred_image)


def fill_all(pred: Prediction, depth_filtered_m, rgb, cam: CameraConfig,
             max_depth: float, lost, frame_to_frame_rgb: bool):
    """The three fill passes as called from predict() (EF.cpp:646-650)."""
    lost = _as_flag(lost, pred.vertex)
    return (
        fill_vertex(pred.vertex, depth_filtered_m, cam, max_depth, lost),
        fill_normal(pred.normal, depth_filtered_m, cam, max_depth, lost),
        fill_image(pred.image, rgb, lost | bool(frame_to_frame_rgb)),
    )
