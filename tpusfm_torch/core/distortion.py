"""Additional distortion models: Brown-Conrady and equidistant fisheye.

Port of ``tpusfm/core/distortion.py``.  All transforms are fixed-iteration
and broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch


def distort_brown(params: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """params (..., 5) = [k1, k2, k3, t1, t2]; ideal normalized coords
    (..., 2) -> distorted normalized coords (Brown-T2)."""
    k1, k2, k3, t1, t2 = (params[..., i, None] for i in range(5))
    x = xn[..., 0:1]
    y = xn[..., 1:2]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dx = 2.0 * t1 * x * y + t2 * (r2 + 2.0 * x * x)
    dy = t1 * (r2 + 2.0 * y * y) + 2.0 * t2 * x * y
    return xn * radial + torch.cat([dx, dy], dim=-1)


def undistort_brown(params: torch.Tensor, xd: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Invert Brown-Conrady by fixed-point iteration."""
    xn = xd
    for _ in range(iters):
        delta = distort_brown(params, xn) - xn
        xn = xd - delta
    return xn


def distort_fisheye(params: torch.Tensor, xn: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """params (..., 4) = [k1..k4]; ideal normalized coords -> equidistant
    fisheye, r = theta (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8)."""
    k1, k2, k3, k4 = (params[..., i, None] for i in range(4))
    r = torch.sqrt(torch.clamp(torch.sum(xn * xn, dim=-1, keepdim=True), min=eps * eps))
    theta = torch.arctan(r)
    th2 = theta * theta
    theta_d = theta * (1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
    return xn * (theta_d / r)


def undistort_fisheye(params: torch.Tensor, xd: torch.Tensor, iters: int = 12,
                      eps: float = 1e-9) -> torch.Tensor:
    """Invert the theta polynomial by fixed-iteration Newton, then undo the
    equidistant mapping."""
    k1, k2, k3, k4 = (params[..., i, None] for i in range(4))
    theta_d = torch.sqrt(torch.clamp(torch.sum(xd * xd, dim=-1, keepdim=True), min=eps * eps))
    theta = theta_d
    for _ in range(iters):
        th2 = theta * theta
        poly = 1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4)))
        dpoly = 2.0 * theta * (k1 + th2 * (2.0 * k2 + th2 * (3.0 * k3 + th2 * 4.0 * k4)))
        f = theta * poly - theta_d
        df = poly + theta * dpoly
        theta = theta - f / torch.where(torch.abs(df) < 1e-9, torch.full_like(df, 1e-9), df)
    r = torch.tan(theta)
    return xd * (r / theta_d)
