"""TUM RGB-D / ICL-NUIM dataset directory reader (own copy of the reference
package's `io/tum.py`).

Reads the published directory layout (rgb.txt / depth.txt / groundtruth.txt
with 16-bit PNG depth at 1/5000 m per unit) directly.  Association follows
the TUM `associate.py` policy: greedy nearest-timestamp matching within
`max_difference`.  PNG decoding needs PIL, imported when a frame is read.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

from ..se3 import np_quaternion_to_rotation
from .klg import Frame

TUM_DEPTH_FACTOR = 5000.0  # png units per metre (TUM + ICL-NUIM TUM-format)


def _read_file_list(path: Path) -> List[Tuple[float, str]]:
    out = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        out.append((float(parts[0]), parts[1]))
    return out


def associate(
    a: List[Tuple[float, str]],
    b: List[Tuple[float, str]],
    max_difference: float = 0.02,
) -> List[Tuple[float, str, float, str]]:
    """Greedy closest-timestamp association (TUM associate.py semantics)."""
    pairs = sorted(
        (abs(ta - tb), ia, ib)
        for ia, (ta, _) in enumerate(a)
        for ib, (tb, _) in enumerate(b)
        if abs(ta - tb) < max_difference
    )
    used_a, used_b, out = set(), set(), []
    for _, ia, ib in pairs:
        if ia not in used_a and ib not in used_b:
            used_a.add(ia)
            used_b.add(ib)
            out.append((a[ia][0], a[ia][1], b[ib][0], b[ib][1]))
    out.sort()
    return out


@dataclass
class TumAssociation:
    ts: float
    rgb_path: Path
    depth_path: Path


class TumLogReader:
    """Frame source over a TUM-format dataset directory, presenting the same
    surface as KlgLogReader."""

    def __init__(self, root: str | Path, max_difference: float = 0.02):
        self.root = Path(root)
        rgb = _read_file_list(self.root / "rgb.txt")
        depth = _read_file_list(self.root / "depth.txt")
        assoc = associate(rgb, depth, max_difference)
        self.items = [
            TumAssociation(ts=t_rgb, rgb_path=self.root / f_rgb, depth_path=self.root / f_d)
            for t_rgb, f_rgb, t_d, f_d in assoc
        ]
        self.num_frames = len(self.items)
        self._i = 0

    def has_more(self) -> bool:
        return self._i < self.num_frames

    def get_next(self) -> Frame:
        from PIL import Image

        it = self.items[self._i]
        self._i += 1
        rgb = np.asarray(Image.open(it.rgb_path).convert("RGB"))
        depth_raw = np.asarray(Image.open(it.depth_path))
        # png units (1/5000 m) -> millimetres, saturating u16
        depth_mm = np.clip(
            depth_raw.astype(np.float64) * (1000.0 / TUM_DEPTH_FACTOR), 0, 65535
        ).astype(np.uint16)
        return Frame(
            timestamp=int(round(it.ts * 1e6)), depth_mm=depth_mm, rgb=rgb
        )

    def rewind(self) -> None:
        self._i = 0

    def fast_forward(self, frame: int) -> None:
        self._i = min(frame, self.num_frames)

    def __iter__(self) -> Iterator[Frame]:
        while self.has_more():
            yield self.get_next()


def read_groundtruth(root: str | Path) -> List[Tuple[float, np.ndarray]]:
    """groundtruth.txt -> [(t, T_wc 4x4)] in TUM convention
    (tx ty tz qx qy qz qw)."""
    out = []
    for line in (Path(root) / "groundtruth.txt").read_text().splitlines():
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
