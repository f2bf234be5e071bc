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


MODELS = ("pinhole", "radial1", "radial3", "brown", "fisheye")


def undistort_to_pinhole(model: str, dist_params, xd: torch.Tensor) -> torch.Tensor:
    """Distorted normalized coords (..., 2) of any model in MODELS to ideal
    pinhole ones.  dist_params: [k1] / [k1, k2, k3] / [k1, k2, k3, t1, t2] /
    [k1..k4] by model (None for pinhole, or zeros for radial)."""
    from . import camera

    if model == "pinhole":
        return xd
    if model in ("radial1", "radial3"):
        if dist_params is None:
            k = torch.zeros(xd.shape[:-2] + (3,), dtype=xd.dtype, device=xd.device)
        else:
            k = torch.as_tensor(dist_params, dtype=xd.dtype, device=xd.device)
        if model == "radial1":  # [k1] or [k1, k2, k3]: k1 alone counts
            k = torch.cat([k[..., :1], k.new_zeros(k.shape[:-1] + (2,))], dim=-1)
        intr = torch.cat([torch.ones(k.shape[:-1] + (2,), dtype=k.dtype, device=k.device),
                          torch.zeros(k.shape[:-1] + (2,), dtype=k.dtype, device=k.device), k],
                         dim=-1)
        return camera.undistort_radial(intr, xd)
    params = torch.as_tensor(dist_params, dtype=xd.dtype, device=xd.device)
    if model == "brown":
        return undistort_brown(params, xd)
    if model == "fisheye":
        return undistort_fisheye(params, xd)
    raise ValueError(f"unknown camera model {model!r} (supported: {MODELS})")
