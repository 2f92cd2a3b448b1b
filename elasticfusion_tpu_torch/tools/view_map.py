"""Offline map/trajectory viewer (own copy of the reference package's
`tools/view_map.py`) — replaces the original Pangolin GUI (Tools/GUI.h,
the MainController draw path) with headless rendering: loads a .ply map (and
optionally a .freiburg trajectory) and renders a point-splat view to PNG
(PIL, imported when run).

Usage:
  python -m elasticfusion_tpu_torch.tools.view_map map.ply -o view.png
  python -m elasticfusion_tpu_torch.tools.view_map map.ply -traj out.freiburg \
      -pose 0.5,0.2,-1.0 -yaw 20 -o view.png
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def render_points(
    pts: np.ndarray, cols: np.ndarray, T_wc: np.ndarray,
    width=960, height=720, fx=700.0, splat=1,
) -> np.ndarray:
    """Nearest-point z-buffer render of a coloured cloud from pose T_wc."""
    T_cw = np.linalg.inv(T_wc)
    p = pts @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = p[:, 2]
    ok = z > 0.05
    u = np.round(p[ok, 0] * fx / z[ok] + width / 2).astype(np.int64)
    v = np.round(p[ok, 1] * fx / z[ok] + height / 2).astype(np.int64)
    zo, co = z[ok], cols[ok]
    img = np.zeros((height, width, 3), np.uint8)
    order = np.argsort(-zo)
    u, v, co = u[order], v[order], co[order]
    for dy in range(-splat, splat + 1):
        for dx in range(-splat, splat + 1):
            uu, vv = u + dx, v + dy
            inb = (uu >= 0) & (uu < width) & (vv >= 0) & (vv < height)
            img[vv[inb], uu[inb]] = co[inb]
    return img


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="offline surfel map viewer")
    p.add_argument("ply", help=".ply map (from Engine.save_ply)")
    p.add_argument("-traj", help=".freiburg trajectory to overlay (drawn red)")
    p.add_argument("-o", dest="out", default="view.png")
    p.add_argument("-pose", default="0,0,-1.5", help="camera position x,y,z")
    p.add_argument("-yaw", type=float, default=0.0, help="degrees")
    p.add_argument("-pitch", type=float, default=0.0)
    p.add_argument("-size", default="960x720")
    args = p.parse_args(argv)

    from PIL import Image

    from ..io.ply import load_ply
    from ..utils.synthetic import pose_from_xyzrpy

    rec = load_ply(args.ply)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float64)
    cols = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1)

    x, y, z = (float(v) for v in args.pose.split(","))
    T = pose_from_xyzrpy(
        x=x, y=y, z=z, yaw=np.deg2rad(args.yaw), pitch=np.deg2rad(args.pitch)
    )
    w, h = (int(v) for v in args.size.split("x"))

    if args.traj:
        from ..io.trajectory import read_freiburg

        traj = read_freiburg(args.traj)
        tp = np.stack([T_[:3, 3] for _, T_ in traj])
        pts = np.concatenate([pts, tp])
        cols = np.concatenate(
            [cols, np.tile([255, 0, 0], (len(tp), 1))]
        ).astype(np.uint8)

    img = render_points(pts, cols, T, width=w, height=h)
    Image.fromarray(img).save(args.out)
    print(f"wrote {args.out} ({len(rec)} surfels)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
