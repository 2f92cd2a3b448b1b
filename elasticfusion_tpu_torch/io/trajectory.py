"""Trajectory logging + ATE evaluation (own copy of the reference package's
`io/trajectory.py`, pure numpy).

The `.freiburg` writer is line-compatible with the original system's
destructor dump (ElasticFusion.cpp:112-139): one line per frame
`timestamp tx ty tz qx qy qz qw`, timestamps in seconds (microseconds / 1e6)
except for ICL-NUIM where the raw frame counter is written — so the TUM
`evaluate_ate.py` tooling works unchanged.  `ate_rmse` is the TUM
absolute-trajectory-error metric (closest-timestamp association + Horn
alignment).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from ..se3 import np_quaternion_to_rotation, np_rotation_to_quaternion


def write_freiburg(
    path: str | Path,
    poses: Sequence[Tuple[int, np.ndarray]],
    iclnuim: bool = False,
) -> None:
    """poses: [(timestamp_us, T_wc 4x4)] -> .freiburg file."""
    with open(path, "w") as f:
        for ts, T in poses:
            t = float(ts) if iclnuim else float(ts) / 1e6
            q = np_rotation_to_quaternion(np.asarray(T)[:3, :3])
            tr = np.asarray(T)[:3, 3]
            f.write(
                f"{t:.6f} {tr[0]} {tr[1]} {tr[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n"
            )


def read_freiburg(path: str | Path) -> List[Tuple[float, np.ndarray]]:
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(x) for x in line.split()]
        t, tx, ty, tz, qx, qy, qz, qw = vals[:8]
        T = np.eye(4)
        T[:3, :3] = np_quaternion_to_rotation(np.array([qx, qy, qz, qw]))
        T[:3, 3] = [tx, ty, tz]
        out.append((t, T))
    return out


def _associate_times(
    ta: np.ndarray, tb: np.ndarray, max_difference: float
) -> List[Tuple[int, int]]:
    pairs = []
    for i, t in enumerate(ta):
        j = int(np.searchsorted(tb, t))
        best, bd = -1, max_difference
        for k in (j - 1, j):
            if 0 <= k < len(tb) and abs(tb[k] - t) < bd:
                best, bd = k, abs(tb[k] - t)
        if best >= 0:
            pairs.append((i, best))
    return pairs


def horn_align(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares rigid alignment y ~ R x + t (Horn's method, no scale) —
    the alignment step of TUM evaluate_ate."""
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    W = (y - my) @ (x - mx).T
    U, _, Vt = np.linalg.svd(W)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ S @ Vt
    t = my - R @ mx
    return R, t


def ate_rmse(
    gt: Sequence[Tuple[float, np.ndarray]],
    est: Sequence[Tuple[float, np.ndarray]],
    max_difference: float = 0.02,
    align: bool = True,
) -> float:
    """Absolute trajectory error RMSE (m) after timestamp association and
    optional rigid alignment."""
    tg = np.array([t for t, _ in gt])
    te = np.array([t for t, _ in est])
    pairs = _associate_times(te, tg, max_difference)
    if len(pairs) < 2:
        raise ValueError(f"only {len(pairs)} associated poses")
    pe = np.stack([est[i][1][:3, 3] for i, _ in pairs], axis=1)
    pg = np.stack([gt[j][1][:3, 3] for _, j in pairs], axis=1)
    if align:
        R, t = horn_align(pe, pg)
        pe = R @ pe + t
    err = pe - pg
    return float(np.sqrt((err * err).sum(axis=0).mean()))
