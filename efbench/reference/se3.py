"""SE(3) / SO(3) utilities.

Tensor versions (float32, any device) are used by tracking and the engine;
host-side numpy float64 versions accumulate the global pose, mirroring the
original system's precision split (CUDA kernels f32, host Eigen double).

Reference math: OdometryProvider.h:34-96 (Rodrigues exp + projective
jacobians), RGBDOdometry.cpp:539-570 (left-multiplied incremental update +
re-orthonormalization).
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Tensor side (f32)
# ---------------------------------------------------------------------------


def skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack(
        [
            torch.stack([z, -w[2], w[1]]),
            torch.stack([w[2], z, -w[0]]),
            torch.stack([-w[1], w[0], z]),
        ]
    )


def _exp_coeffs(theta2: torch.Tensor):
    """sin(θ)/θ, (1-cos θ)/θ² and (1 - sin(θ)/θ)/θ², Taylor below θ²=1e-8."""
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-8
    one = torch.ones_like(theta2)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - a) / torch.where(small, one, theta2))
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: axis-angle (3,) → rotation matrix (3,3), with a
    Taylor branch near θ=0."""
    K = skew(w)
    a, b, _ = _exp_coeffs(torch.dot(w, w))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def _compose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(6,) twist [v, w] → 4×4 transform.  v = translation part, w = rotation."""
    v, w = xi[:3], xi[3:]
    K = skew(w)
    K2 = K @ K
    a, b, c = _exp_coeffs(torch.dot(w, w))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * K + b * K2
    V = eye + b * K + c * K2
    return _compose(R, V @ v)


def apply_update(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiply incremental update, as RGBDOdometry.cpp:543-551:
    resultR = rotUpdate * resultR ; resultT = rotUpdate * resultT + transUpdate."""
    R_up = so3_exp(xi[3:])
    return _compose(R_up @ T[:3, :3], R_up @ T[:3, 3] + xi[:3])


def invert(T: torch.Tensor) -> torch.Tensor:
    R = T[:3, :3]
    return _compose(R.T, -(R.T @ T[:3, 3]))


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block to SO(3) by three Newton–Schulz steps
    R <- 1.5 R - 0.5 R RᵀR (the reference's choice; converges cubically to
    the polar factor for the near-orthogonal input this sees)."""
    R = T[:3, :3]
    for _ in range(3):
        R = 1.5 * R - 0.5 * (R @ (R.T @ R))
    out = T.clone()
    out[:3, :3] = R
    return out


def se3_log_norm(T: torch.Tensor) -> torch.Tensor:
    """‖log T‖ over the full SE(3), used by the velocity-adaptive fusion
    weight (ElasticFusion.cpp:371-383)."""
    R = T[:3, :3]
    cos_t = torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    small = theta < 1e-8
    coeff = torch.where(
        small, torch.full_like(theta, 0.5),
        theta / torch.clamp(2.0 * torch.sin(theta), min=1e-12),
    )
    w = coeff * torch.stack(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )
    K = skew(w / torch.clamp(theta, min=1e-12))
    half = theta * 0.5
    cot = torch.where(small, torch.ones_like(theta),
                      half / torch.tan(torch.clamp(half, min=1e-12)))
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    V_inv = torch.where(small, eye, eye - 0.5 * theta * K + (1.0 - cot) * (K @ K))
    v = V_inv @ T[:3, 3]
    return torch.sqrt(torch.dot(v, v) + torch.dot(w, w))


def se3_log_rot_norm(T: torch.Tensor) -> torch.Tensor:
    """‖log R‖ (ElasticFusion.cpp:371-383: rodrigues2(rot).norm())."""
    cos_theta = torch.clamp((torch.trace(T[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
    return torch.arccos(cos_theta)


# ---------------------------------------------------------------------------
# Host-side (numpy f64)
# ---------------------------------------------------------------------------


def np_orthonormalize(T: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(T[:3, :3])
    d = np.linalg.det(U @ Vt)
    R = U @ np.diag([1.0, 1.0, d]) @ Vt
    out = T.copy()
    out[:3, :3] = R
    return out


def np_rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (qx, qy, qz, qw), TUM ordering."""
    t = np.trace(R)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        qw = 0.25 / s
        qx = (R[2, 1] - R[1, 2]) * s
        qy = (R[0, 2] - R[2, 0]) * s
        qz = (R[1, 0] - R[0, 1]) * s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2.0
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        q[3] = (R[k, j] - R[j, k]) / s
        qx, qy, qz, qw = q
    q = np.array([qx, qy, qz, qw])
    return q / np.linalg.norm(q)


def np_quaternion_to_rotation(q: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) → rotation matrix."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )
