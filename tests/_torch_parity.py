"""Helpers shared by the tests of the PyTorch port (`tests/test_torch_*.py`).

The same numpy inputs go through a function of the JAX reference package and
its counterpart in `elasticfusion_tpu_torch`; the port runs with tensors on
the CPU, where every kernel wrapper takes its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

# the suite runs several worker processes side by side; one intra-op thread
# each keeps the port's small CPU tensors from oversubscribing the cores
torch.set_num_threads(1)


def tt(x) -> torch.Tensor:
    """numpy / jax array → CPU tensor (float arrays as float32)."""
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def nn(x) -> np.ndarray:
    """tensor / jax array → numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def frac_differing(a, b, rtol: float, atol: float) -> float:
    """Share of elements outside rtol/atol."""
    return 1.0 - float(np.isclose(nn(a), nn(b), rtol=rtol, atol=atol).mean())


def both_cams(d: dict):
    """One dict of camera fields → (reference CameraConfig, port CameraConfig)."""
    from elasticfusion_tpu.config import CameraConfig as RefCam
    from elasticfusion_tpu_torch.config import CameraConfig as PortCam

    return RefCam(**d), PortCam(**d)


SMALL_CAM = dict(width=160, height=120, fx=132.0, fy=132.0, cx=80.0, cy=60.0)
TILE_CAM = dict(width=128, height=40, fx=110.0, fy=110.0, cx=64.0, cy=20.0)


def rot_err(Ta: np.ndarray, Tb: np.ndarray) -> float:
    """Angle (rad) between the rotation blocks of two 4x4 transforms, from
    the chord ‖Ra − Rb‖_F = 2√2·sin(θ/2) (arccos of a trace loses half the
    digits near θ = 0)."""
    Ra = np.asarray(Ta, np.float64)[:3, :3]
    Rb = np.asarray(Tb, np.float64)[:3, :3]
    chord = np.linalg.norm(Ra - Rb) / (2.0 * np.sqrt(2.0))
    return float(2.0 * np.arcsin(min(chord, 1.0)))
