"""SO(3) / SE(3) operations, numerically stable near the identity.

Port of ``tpusfm/core/lie.py``: rotations are 3x3 matrices or axis-angle
3-vectors (the BA parameterisation).  Every function broadcasts over leading
batch dimensions and is safe under ``torch.func`` forward-mode transforms
(the small-angle branches use safe denominators).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-9


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: axis-angle (..., 3) -> rotation matrix (..., 3, 3),
    with Taylor fallbacks of sin(t)/t and (1-cos t)/t^2 near t = 0."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta_safe) / theta_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta_safe)) / theta2_safe)
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3); valid on [0, pi),
    with the axis taken from the symmetric part near pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    small = theta < 1e-5
    near_pi = theta > math.pi - 1e-3
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.clamp(sin_t, min=_EPS)))
    w_generic = scale[..., None] * v
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    sx = torch.ones_like(axis_abs[..., 0])
    sy = torch.where(R[..., 0, 1] + R[..., 1, 0] >= 0, 1.0, -1.0).to(R.dtype)
    sz = torch.where(R[..., 0, 2] + R[..., 2, 0] >= 0, 1.0, -1.0).to(R.dtype)
    axis_pi = axis_abs * torch.stack([sx, sy, sz], dim=-1)
    norm = torch.linalg.norm(axis_pi, dim=-1, keepdim=True)
    axis_pi = axis_pi / torch.clamp(norm, min=_EPS)
    w_pi = theta[..., None] * axis_pi
    return torch.where(near_pi[..., None], w_pi, w_generic)


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3) at axis-angle w: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta_safe)) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta_safe - torch.sin(theta_safe)) / (theta2_safe * theta_safe))
    W = hat(w)
    return _eye_like(W) - b[..., None, None] * W + c[..., None, None] * (W @ W)


def rotate_aa(aa: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rotate points by an axis-angle vector without forming the matrix
    (Ceres AngleAxisRotatePoint semantics). aa, x: (..., 3) -> (..., 3)."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    cos_t = torch.where(small, 1.0 - theta2 / 2.0, torch.cos(theta_safe))
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta_safe) / theta_safe)
    ccos = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / theta2_safe)
    aa_b, x_b = torch.broadcast_tensors(aa, x)
    cross = torch.linalg.cross(aa_b, x_b, dim=-1)
    dot = torch.sum(aa * x, dim=-1, keepdim=True)
    return cos_t * x + sinc * cross + ccos * dot * aa


def se3_apply(R: torch.Tensor, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform: (..., 3, 3) @ (..., 3) + (..., 3)."""
    return torch.einsum("...ij,...j->...i", R, x) + t


def se3_inv(R: torch.Tensor, t: torch.Tensor):
    """Inverse rigid transform: (R, t) -> (R^T, -R^T t)."""
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_compose(Ra: torch.Tensor, ta: torch.Tensor, Rb: torch.Tensor, tb: torch.Tensor):
    """(Ra, ta) o (Rb, tb): first apply b, then a."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def pose_to_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Stack (R | t) into a (..., 3, 4) matrix."""
    return torch.cat([R, t[..., None]], dim=-1)


def camera_center(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """World-frame camera center C = -R^T t for world->camera pose (R, t)."""
    return -torch.einsum("...ji,...j->...i", R, t)
