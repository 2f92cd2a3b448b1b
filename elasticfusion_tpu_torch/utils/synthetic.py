"""Synthetic RGB-D scene generation for tests and benchmarks.

The reference repo has no tests (SURVEY.md §4); our verification strategy
uses closed-form synthetic scenes with known SE(3) camera motion.  A scene is
a dense textured point cloud; frames are rendered by point projection with
scatter-min z-buffering — the same primitive the splat predictor uses.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import CameraConfig


def make_scene(n_side: int = 900, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A bumpy, textured wall ~2 m in front of the origin plus a side wall
    and floor, as a dense point cloud.  Returns (points [N,3], colors [N,3] u8)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-2.0, 2.0, n_side)
    ys = np.linspace(-1.5, 1.5, n_side)
    X, Y = np.meshgrid(xs, ys)
    Z = (
        2.0
        + 0.25 * np.sin(2.1 * X) * np.cos(1.7 * Y)
        + 0.10 * np.sin(7.3 * X + 1.0)
        + 0.05 * np.cos(11.0 * Y)
    )
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    # procedural texture shared with render_analytic (multi-octave — see
    # _texture for why the high frequencies matter)
    cols = _texture(X, Y).reshape(-1, 3).astype(np.uint8)

    # jitter to avoid aliasing artifacts
    pts += rng.normal(scale=1e-4, size=pts.shape)
    return pts.astype(np.float32), cols


def render_frame(
    points: np.ndarray,
    colors: np.ndarray,
    T_wc: np.ndarray,
    cam: CameraConfig,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render (depth_mm uint16 [H,W], rgb uint8 [H,W,3]) from pose T_wc
    (world←camera) by nearest-point z-buffering."""
    T_cw = np.linalg.inv(T_wc)
    p_cam = points @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = p_cam[:, 2]
    ok = z > 0.05
    u = np.round(p_cam[:, 0] * cam.fx / z + cam.cx).astype(np.int64)
    v = np.round(p_cam[:, 1] * cam.fy / z + cam.cy).astype(np.int64)
    ok &= (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)

    flat = v[ok] * cam.width + u[ok]
    zo = z[ok]
    co = colors[ok]

    order = np.argsort(-zo)  # far-to-near: near points overwrite
    flat, zo, co = flat[order], zo[order], co[order]

    depth = np.zeros(cam.height * cam.width, np.float32)
    rgb = np.zeros((cam.height * cam.width, 3), np.uint8)
    depth[flat] = zo
    rgb[flat] = co

    depth_mm = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
    return depth_mm.reshape(cam.height, cam.width), rgb.reshape(
        cam.height, cam.width, 3
    )


def _height_field(X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Analytic z(x, y) of the bumpy wall used by make_scene."""
    return (
        2.0
        + 0.25 * np.sin(2.1 * X) * np.cos(1.7 * Y)
        + 0.10 * np.sin(7.3 * X + 1.0)
        + 0.05 * np.cos(11.0 * Y)
    )


def _texture(X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """Multi-octave procedural texture.  The high-frequency octaves matter:
    photometric tracking gates on gradient magnitude (reduce.cu:657-659,
    thresholds {5,3,1}), and a smooth texture leaves so few correspondences
    that the RGB normal equations go ill-conditioned (observed: 1k of 307k
    pixels pass, and the solve bleeds x-translation into y/z)."""
    # orientation-balanced octaves: every oblique component has its mirrored
    # partner, otherwise the aperture problem turns globally-correlated
    # gradient directions into a systematic cross-axis flow bias
    tex = (
        128
        + 45 * np.sin(3.0 * X) * np.cos(4.0 * Y)
        + 15 * np.sin(13.0 * X + 2.0 * Y) + 15 * np.sin(13.0 * X - 2.0 * Y)
        + 10 * np.sin(29.0 * (X + Y)) + 10 * np.sin(29.0 * (X - Y))
        + 18 * np.sin(71.0 * X + 0.7) * np.cos(53.0 * Y)
        + 6 * np.sin(131.0 * X - 61.0 * Y) + 6 * np.sin(131.0 * X + 61.0 * Y)
        + 28 * np.sin(293.0 * X + 1.3) * np.cos(271.0 * Y)
        + 11 * np.sin(407.0 * X - 389.0 * Y + 0.5)
        + 11 * np.sin(407.0 * X + 389.0 * Y + 0.5)
    )
    # channels must CORRELATE in luminance: with g = 255 - 0.7 tex the
    # 0.299r+0.587g+0.114b intensity cancels to a nearly flat ~[133,157]
    # band and photometric tracking starves (measured: 2k of 307k pixels
    # pass the gradient gate, invariant to texture amplitude)
    r = np.clip(tex, 1, 255)
    g = np.clip(tex * 0.85 + 20, 1, 255)
    b = np.clip(255 - tex * 0.4, 1, 255)
    return np.stack([r, g, b], axis=-1)


def render_analytic(T_wc: np.ndarray, cam: CameraConfig,
                    iters: int = 30) -> Tuple[np.ndarray, np.ndarray]:
    """Exact per-pixel ray/surface intersection with the analytic bumpy-wall
    surface z = h(x, y): depth is noise-free up to the uint16-mm
    quantization, unlike `render_frame`'s point-splat z-buffer (which
    carries ~mm sampling noise).  Use for tight odometry accuracy bounds
    (SURVEY.md §4: closed-form scenes for open-loop odometry)."""
    H, W = cam.height, cam.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    d_cam = np.stack(
        [(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], axis=-1
    )
    R, t = T_wc[:3, :3], T_wc[:3, 3]
    d = d_cam @ R.T                      # world-frame ray directions
    c = t[None, None, :]

    # solve c_z + s*d_z = h(c_x + s*d_x, c_y + s*d_y) by damped fixed-point /
    # secant iteration in the ray parameter s (the surface is a mild height
    # field over z≈2, so this converges fast for near-frontal views)
    dz = d[..., 2]
    safe_dz = np.where(np.abs(dz) > 1e-6, dz, 1e-6)
    s = (2.0 - c[..., 2]) / safe_dz

    def g(s):
        p = c + s[..., None] * d
        return p[..., 2] - _height_field(p[..., 0], p[..., 1])

    s1 = s + 1e-3
    g0, g1 = g(s), g(s1)
    for _ in range(iters):
        denom = g1 - g0
        denom = np.where(np.abs(denom) > 1e-12, denom, 1e-12)
        s2 = s1 - g1 * (s1 - s) / denom
        s, g0 = s1, g1
        s1 = s2
        g1 = g(s1)

    p = c + s1[..., None] * d
    p_cam = (p - t[None, None, :]) @ R   # world -> camera
    z = p_cam[..., 2]
    # in-bounds surface extent (make_scene covers x in [-2,2], y in [-1.5,1.5])
    valid = (
        (np.abs(g1) < 1e-6) & (z > 0.3)
        & (np.abs(p[..., 0]) < 2.0) & (np.abs(p[..., 1]) < 1.5)
    )
    depth_mm = np.where(valid, np.clip(z * 1000.0, 0, 65535), 0).astype(np.uint16)
    rgb = np.where(
        valid[..., None], _texture(p[..., 0], p[..., 1]), 0
    ).astype(np.uint8)
    return depth_mm, rgb


def synthetic_trajectory(kind: str, n_frames: int) -> list:
    """Ground-truth camera trajectories over the bumpy-wall scene for the
    synthetic benchmark battery (eval_suite.py).  All trajectories keep the
    wall (z≈2, x∈[-2,2], y∈[-1.5,1.5]) in view.

    kinds:
      sweep        — monotone lateral sweep (open-loop odometry; config 1/2)
      there_back   — sweep out and return to the start (local loop closure
                     once the revisit falls outside the timeDelta window)
      orbit        — slow yaw pan + lateral motion, two passes over the same
                     wall section (global loop closure / fern retrieval)
    """
    Ts = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        if kind == "sweep":
            Ts.append(pose_from_xyzrpy(
                x=1.2 * s, y=-0.15 * s, z=0.25 * s, yaw=0.22 * s,
                pitch=0.06 * s,
            ))
        elif kind == "there_back":
            # triangle wave: out for the first 60%, back for the rest
            u = s / 0.6 if s < 0.6 else (1.0 - s) / 0.4
            Ts.append(pose_from_xyzrpy(
                x=1.0 * u, z=0.15 * u, yaw=0.18 * u, y=-0.08 * u,
            ))
        elif kind == "orbit":
            import math

            ph = 2.0 * math.pi * s
            Ts.append(pose_from_xyzrpy(
                x=0.8 * math.sin(ph), z=0.12 * (1 - math.cos(ph)),
                yaw=0.20 * math.sin(ph), y=0.06 * math.sin(2 * ph),
            ))
        else:
            raise ValueError(f"unknown trajectory kind {kind!r}")
    return Ts


def pose_from_xyzrpy(
    x=0.0, y=0.0, z=0.0, roll=0.0, pitch=0.0, yaw=0.0
) -> np.ndarray:
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy_, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy_, -sy, 0], [sy, cy_, 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = [x, y, z]
    return T
