"""Homography estimation (normalized DLT), transfer error and the
closed-form decomposition into rigid motions.

Port of ``tpusfm/core/homography.py``; batched over leading dimensions.
"""

from __future__ import annotations

import torch

from .epipolar import _normalize_points, svd
from .triangulate import smallest_eigvec_sym


def homography_dlt(x0: torch.Tensor, x1: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized DLT homography from >= 4 correspondences (..., N, 2) with
    x1h ~ H x0h.  Returns (..., 3, 3) scaled so H[2, 2] = 1."""
    if w is None:
        w = torch.ones(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    x0n, T0 = _normalize_points(x0, w)
    x1n, T1 = _normalize_points(x1, w)
    u, v = x0n[..., 0], x0n[..., 1]
    up, vp = x1n[..., 0], x1n[..., 1]
    zeros = torch.zeros_like(u)
    ones = torch.ones_like(u)
    r1 = torch.stack([-u, -v, -ones, zeros, zeros, zeros, up * u, up * v, up], dim=-1)
    r2 = torch.stack([zeros, zeros, zeros, -u, -v, -ones, vp * u, vp * v, vp], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    AtA = A.transpose(-1, -2) @ A
    h = smallest_eigvec_sym(AtA, iters=8)
    Hn = h.reshape(*h.shape[:-1], 3, 3)
    H = torch.linalg.inv_ex(T1)[0] @ Hn @ T0
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h22) < 1e-12, torch.full_like(h22, 1e-12), h22)


def decompose_homography(Hn: torch.Tensor):
    """Decompose a normalized-coordinate homography (..., 3, 3) into the
    four physical solutions of H = R + t n^T / d (Ma-Soatto-Kosecka-Sastry
    Thm 5.19).  Returns (R (..., 4, 3, 3), t (..., 4, 3), n (..., 4, 3));
    the caller disambiguates by cheirality."""
    _, S, _ = svd(Hn)
    s2 = torch.clamp(S[..., 1], min=1e-12)
    Hb = Hn / s2[..., None, None]
    sgn = torch.sign(torch.linalg.det(Hb))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)[..., None, None]
    Hb = Hb * sgn
    _, Sb, Vbt = svd(Hb)
    s1 = Sb[..., 0]
    s3 = Sb[..., 2]
    v1 = Vbt[..., 0, :]
    v2 = Vbt[..., 1, :]
    v3 = Vbt[..., 2, :]

    denom = torch.sqrt(torch.clamp(s1 * s1 - s3 * s3, min=1e-12))[..., None]
    a = torch.sqrt(torch.clamp(1.0 - s3 * s3, min=0.0))[..., None]
    b = torch.sqrt(torch.clamp(s1 * s1 - 1.0, min=0.0))[..., None]
    u1 = (a * v1 + b * v3) / denom
    u2 = (a * v1 - b * v3) / denom

    def frame(x, y):
        return torch.stack([x, y, torch.linalg.cross(x, y, dim=-1)], dim=-1)

    Hv2 = torch.einsum("...ij,...j->...i", Hb, v2)

    def solution(u):
        Hu = torch.einsum("...ij,...j->...i", Hb, u)
        R = frame(Hv2, Hu) @ frame(v2, u).transpose(-1, -2)
        n = torch.linalg.cross(v2, u, dim=-1)
        t = torch.einsum("...ij,...j->...i", Hb - R, n)
        return R, t, n

    Ra, ta, na = solution(u1)
    Rb, tb, nb = solution(u2)
    R = torch.stack([Ra, Ra, Rb, Rb], dim=-3)
    t = torch.stack([ta, -ta, tb, -tb], dim=-2)
    n = torch.stack([na, -na, nb, -nb], dim=-2)
    return R, t, n


def homography_transfer_error(H: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Forward transfer squared error |x1 - proj(H x0)|^2.  Returns (..., N)."""
    ones = torch.ones(x0.shape[:-1] + (1,), dtype=x0.dtype, device=x0.device)
    p0 = torch.cat([x0, ones], dim=-1)
    q = torch.einsum("...ij,...nj->...ni", H, p0)
    zq = q[..., 2:3]
    zq = torch.where(torch.abs(zq) < 1e-12, torch.full_like(zq, 1e-12), zq)
    d = q[..., :2] / zq - x1
    return torch.sum(d * d, dim=-1)
