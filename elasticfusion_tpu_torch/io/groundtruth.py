"""Ground-truth odometry feed (own copy of the reference package's
`io/groundtruth.py`) — equivalent of `GroundTruthOdometry`
(Tools/GroundTruthOdometry.{h,cpp} of the original system): loads a
`utime,x,y,z,qx,qy,qz,qw` CSV, un-does the iSAM camera basis with the fixed
M matrix (GroundTruthOdometry.cpp:64-68), and serves poses by timestamp for
`Engine.process_frame(..., in_T_wc=...)`."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..se3 import np_quaternion_to_rotation

# iSAM basis change (GroundTruthOdometry.cpp:64-68)
_M = np.array(
    [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]
)


class GroundTruthOdometry:
    def __init__(self, filename: str | Path):
        self.camera_trajectory: Dict[int, np.ndarray] = {}
        for line in Path(filename).read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.replace(",", " ").split()
            utime = int(vals[0])
            x, y, z, qx, qy, qz, qw = (float(v) for v in vals[1:8])
            T = np.eye(4)
            T[:3, :3] = np_quaternion_to_rotation(np.array([qx, qy, qz, qw]))
            T[:3, 3] = [x, y, z]
            self.camera_trajectory[utime] = T

        self._times = np.array(sorted(self.camera_trajectory), np.int64)
        if len(self._times):
            # first pose defines the origin, basis-corrected (cpp:44-79)
            T0 = self._basis(self.camera_trajectory[int(self._times[0])])
            self._T0_inv = np.linalg.inv(T0)
        else:
            self._T0_inv = np.eye(4)

    @staticmethod
    def _basis(T: np.ndarray) -> np.ndarray:
        out = np.eye(4)
        out[:3, :3] = _M @ T[:3, :3] @ _M.T
        out[:3, 3] = _M @ T[:3, 3]
        return out

    def get_transformation(self, utime: int) -> Optional[np.ndarray]:
        """Pose at the nearest logged time, relative to the first pose."""
        if not len(self._times):
            return None
        i = int(np.searchsorted(self._times, utime))
        i = min(max(i, 0), len(self._times) - 1)
        if i > 0 and abs(int(self._times[i - 1]) - utime) < abs(int(self._times[i]) - utime):
            i -= 1
        T = self._basis(self.camera_trajectory[int(self._times[i])])
        return self._T0_inv @ T
