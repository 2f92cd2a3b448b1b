"""The benchmark's traffic source: a synthetic desk-scale RGB-D scene, a
periodic handheld camera path over it, and a renderer on the card.

Frozen copy of `make_scene` and `_texture` of
`elasticfusion_tpu_torch/utils/synthetic.py` (a bumpy textured wall 4 x 3 m
at ~2 m), with the scene's jitter drawn by a `torch.Generator` on the
rendering device, and its nearest-point z-buffer renderer rewritten in plain
torch: a scatter-min over one int64 key per point (depth bits, then the
higher point index on a tie), so the same seed renders the same frames.
Frames leave as a sensor or a log decoder hands them over: uint16 depth in
millimetres and uint8 RGB, on the host.  Everything here is the traffic
file's: the run's seed draws only which frames the check compares.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

_IDX_BITS = 21          # point index field of the z-buffer key


def make_scene(n_side: int, gen: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bumpy textured wall: (points [N,3] f32, colours [N,3] u8) on
    `device`, jittered by 0.1 mm normal noise from `gen`."""
    f64 = dict(dtype=torch.float64, device=device)
    xs = torch.linspace(-2.0, 2.0, n_side, **f64)
    ys = torch.linspace(-1.5, 1.5, n_side, **f64)
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    Z = (2.0 + 0.25 * torch.sin(2.1 * X) * torch.cos(1.7 * Y)
         + 0.10 * torch.sin(7.3 * X + 1.0) + 0.05 * torch.cos(11.0 * Y))
    pts = torch.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], dim=1)
    cols = texture(X, Y).reshape(-1, 3).to(torch.uint8)
    pts = pts + 1e-4 * torch.randn(pts.shape, generator=gen, **f64)
    return pts.to(torch.float32), cols


def texture(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Multi-octave procedural texture, orientation-balanced, channels
    correlated in luminance (photometric tracking gates on gradients)."""
    sin, cos = torch.sin, torch.cos
    tex = (128
           + 45 * sin(3.0 * X) * cos(4.0 * Y)
           + 15 * sin(13.0 * X + 2.0 * Y) + 15 * sin(13.0 * X - 2.0 * Y)
           + 10 * sin(29.0 * (X + Y)) + 10 * sin(29.0 * (X - Y))
           + 18 * sin(71.0 * X + 0.7) * cos(53.0 * Y)
           + 6 * sin(131.0 * X - 61.0 * Y) + 6 * sin(131.0 * X + 61.0 * Y)
           + 28 * sin(293.0 * X + 1.3) * cos(271.0 * Y)
           + 11 * sin(407.0 * X - 389.0 * Y + 0.5)
           + 11 * sin(407.0 * X + 389.0 * Y + 0.5))
    r = torch.clamp(tex, 1, 255)
    g = torch.clamp(tex * 0.85 + 20, 1, 255)
    b = torch.clamp(255 - tex * 0.4, 1, 255)
    return torch.stack([r, g, b], dim=-1)


def pose(x=0.0, y=0.0, z=0.0, roll=0.0, pitch=0.0, yaw=0.0) -> np.ndarray:
    """world <- camera from a position and Rz(yaw) Ry(pitch) Rx(roll)."""
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = [x, y, z]
    return T


def trajectory(path: dict) -> List[np.ndarray]:
    """One period of a closed camera path in the plane parallel to the wall:
    an ellipse of semi-axes `ax` x `ay` metres over `period` frames, with a
    yaw and pitch sway of `sway_deg` degrees at `sway_cycles` cycles a
    period and phases `sway_phase` (radians).  The path is the traffic's
    alone: a seed that moved it would change the work (which views become
    fern keyframes, and so how often a later view retrieves one)."""
    n = int(path["period"])
    amp = [math.radians(a) for a in path["sway_deg"]]
    cyc, ph = path["sway_cycles"], path["sway_phase"]
    out = []
    for i in range(n):
        th = 2.0 * math.pi * i / n
        out.append(pose(
            x=path["ax"] * math.cos(th), y=path["ay"] * math.sin(th),
            yaw=amp[0] * math.sin(cyc[0] * th + ph[0]),
            pitch=amp[1] * math.sin(cyc[1] * th + ph[1])))
    return out


def render(points: torch.Tensor, colours: torch.Tensor, T_wc: np.ndarray,
           cam) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth in mm int32 [H,W], rgb u8 [H,W,3]) seen from `T_wc` by nearest
    point: each pixel keeps the point of least depth (the higher index on a
    tie); depth is truncated to whole millimetres, as the sensor's uint16."""
    n = points.shape[0]
    if n >= 1 << _IDX_BITS:
        raise ValueError(f"{n} points do not fit the z-buffer key")
    dev = points.device
    T_cw = torch.from_numpy(np.linalg.inv(T_wc).astype(np.float32)).to(dev)
    p = points @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = p[:, 2]
    safe = torch.where(z > 0.05, z, torch.ones_like(z))
    u = torch.round(p[:, 0] * cam.fx / safe + cam.cx).to(torch.int64)
    v = torch.round(p[:, 1] * cam.fy / safe + cam.cy).to(torch.int64)
    ok = (z > 0.05) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    H, W = cam.height, cam.width
    flat = torch.where(ok, v * W + u, torch.full_like(u, H * W))
    idx = torch.arange(n, device=dev, dtype=torch.int64)
    key = (z.view(torch.int32).to(torch.int64) << _IDX_BITS) | ((1 << _IDX_BITS) - 1 - idx)
    best = torch.full((H * W + 1,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                      device=dev)
    best.scatter_reduce_(0, flat, key, reduce="amin")
    best = best[:H * W]
    hit = best != torch.iinfo(torch.int64).max
    win = torch.where(hit, (1 << _IDX_BITS) - 1 - (best & ((1 << _IDX_BITS) - 1)),
                      torch.zeros_like(best))
    depth = torch.where(hit, torch.clamp(z[win] * 1000.0, 0, 65535).to(torch.int32),
                        torch.zeros_like(win, dtype=torch.int32))
    rgb = torch.where(hit[:, None], colours[win], torch.zeros_like(colours[win]))
    return depth.reshape(H, W), rgb.reshape(H, W, 3)


def render_period(traffic: dict, cam, device) -> Tuple[list, list]:
    """The frames of one period of the cell's path, rendered on `device`
    from the scene the traffic's `jitter_seed` jitters: ([(depth_mm u16
    [H,W], rgb u8 [H,W,3])] numpy on the host, [T_wc f64]).  The run's own
    seed changes nothing here: a 0.1 mm jitter of the scene is enough to
    change which views become fern keyframes and how often a later view
    retrieves one, and so the work (measured: 23-36 frames/s over 9 jitters
    of `default-scan`, where two runs of one jitter agree within 6 %)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(traffic["scene"]["jitter_seed"]))
    pts, cols = make_scene(traffic["scene"]["n_side"], gen, device)
    poses = trajectory(traffic["path"])
    frames = []
    for T in poses:
        d, c = render(pts, cols, T, cam)
        frames.append((d.cpu().numpy().astype(np.uint16), c.cpu().numpy()))
    return frames, poses
