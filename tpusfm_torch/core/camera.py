"""Camera models: pinhole + 3-coefficient radial (RADIAL3), Brown-T2,
fisheye and spherical.

Port of ``tpusfm/core/camera.py``.  Intrinsics are a flat vector
``[fx, fy, cx, cy, k1, k2, k3]`` (7 lanes, RADIAL3) or 9 lanes (Brown-T2);
fisheye and spherical must be named explicitly.  All functions broadcast over
leading batch dimensions.
"""

from __future__ import annotations

import torch

from . import distortion

FX, FY, CX, CY, K1, K2, K3 = range(7)
NUM_INTR = 7


def distort_radial(intr: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Apply radial distortion to normalized coords xn (..., 2)."""
    r2 = torch.sum(xn * xn, dim=-1, keepdim=True)
    k1 = intr[..., K1, None]
    k2 = intr[..., K2, None]
    k3 = intr[..., K3, None]
    scale = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    return xn * scale


def undistort_radial(intr: torch.Tensor, xd: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Invert radial distortion by fixed-point iteration."""
    xn = xd
    k1 = intr[..., K1, None]
    k2 = intr[..., K2, None]
    k3 = intr[..., K3, None]
    for _ in range(iters):
        r2 = torch.sum(xn * xn, dim=-1, keepdim=True)
        scale = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xn = xd / torch.clamp(scale, min=1e-8)
    return xn


def _resolve_model(intr: torch.Tensor, model: str) -> str:
    """"auto": 7 lanes = RADIAL3, 9 lanes = Brown-T2."""
    if model != "auto":
        return model
    return "brown" if intr.shape[-1] >= 9 else "radial3"


def _focal_pp(intr: torch.Tensor):
    f = torch.stack([intr[..., FX], intr[..., FY]], dim=-1)
    c = torch.stack([intr[..., CX], intr[..., CY]], dim=-1)
    return f, c


def camera_to_pixel(intr: torch.Tensor, x_cam: torch.Tensor, eps: float = 1e-8,
                    model: str = "auto") -> torch.Tensor:
    """Project camera-frame points (..., 3) to pixels (..., 2): perspective
    divide -> distortion -> focal/principal point."""
    model = _resolve_model(intr, model)
    f, c = _focal_pp(intr)
    if model == "spherical":
        x, y, z = x_cam[..., 0], x_cam[..., 1], x_cam[..., 2]
        nrm = torch.sqrt(torch.clamp(x * x + y * y + z * z, min=eps * eps))
        az = torch.atan2(x, z)
        el = torch.arcsin(torch.clamp(y / nrm, -1.0, 1.0))
        return torch.stack([az, el], dim=-1) * f + c
    z = x_cam[..., 2:3]
    den = torch.where(torch.abs(z) < eps, torch.sign(z) * eps + (z == 0) * eps, z)
    xn = x_cam[..., :2] / den
    if model == "fisheye":
        xd = distortion.distort_fisheye(intr[..., 4:8], xn)
    elif model == "brown":
        xd = distortion.distort_brown(intr[..., 4:9], xn)
    else:  # pinhole / radial1 / radial3 via the k coefficients
        xd = distort_radial(intr, xn)
    return xd * f + c


def pixel_to_normal(intr: torch.Tensor, uv: torch.Tensor, undistort: bool = True,
                    model: str = "auto") -> torch.Tensor:
    """Pixels (..., 2) -> undistorted normalized camera coords (..., 2)."""
    model = _resolve_model(intr, model)
    f, c = _focal_pp(intr)
    xd = (uv - c) / f
    if not undistort:
        return xd
    if model == "spherical":
        az, el = xd[..., 0], xd[..., 1]
        tx = torch.tan(az)
        ty = torch.tan(el) / torch.clamp(torch.cos(az), min=1e-6)
        return torch.stack([tx, ty], dim=-1)
    if model == "fisheye":
        return distortion.undistort_fisheye(intr[..., 4:8], xd)
    if model == "brown":
        return distortion.undistort_brown(intr[..., 4:9], xd)
    return undistort_radial(intr, xd)


def project(intr: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
            x_world: torch.Tensor) -> torch.Tensor:
    """Full world -> pixel projection."""
    x_cam = torch.einsum("...ij,...j->...i", R, x_world) + t
    return camera_to_pixel(intr, x_cam)
