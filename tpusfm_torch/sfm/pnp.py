"""Camera resection (PnP): batched DLT and P3P hypotheses, RANSAC, and a
Gauss-Newton polish.

Port of ``tpusfm/sfm/pnp.py``.  ``pnp_ransac`` resects a batch of views at
once (the reference ``vmap``s it over the register batch); the polish's
Jacobian comes from ``torch.func.jacfwd`` as the reference's from
``jax.jacfwd``, and its ``lax.scan`` is a Python loop.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from ..core import lie
from ..core.epipolar import svd
from ..core.p3p import p3p_grunert
from ..core.triangulate import smallest_eigvec_sym
from .ransac import ransac

MIN_PNP_SAMPLE = 6
_BEHIND = 3.4e38


def pnp_dlt(X: torch.Tensor, xn: torch.Tensor, w: torch.Tensor | None = None):
    """DLT pose from 2D-3D correspondences in normalized camera coords.
    X (..., N >= 6, 3), xn (..., N, 2).  Returns (R, t) world -> camera."""
    if w is None:
        w = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    ones = torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([X, ones], dim=-1)
    zeros = torch.zeros_like(Xh)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    r1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    p = smallest_eigvec_sym(A.transpose(-1, -2) @ A, iters=8)
    P = p.reshape(*p.shape[:-1], 3, 4)
    M = P[..., :, :3]
    t = P[..., :, 3]
    sgn = torch.sign(torch.linalg.det(M))[..., None, None]
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    M = M * sgn
    t = t * sgn[..., 0]
    U, S, Vt = svd(M)
    R = U @ Vt
    scale = torch.mean(S, dim=-1)
    return R, t / torch.clamp(scale[..., None], min=1e-12)


def pnp_reproj_error(model, X: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Squared reprojection error in normalized coords; points behind the
    camera get the 3.4e38 sentinel."""
    R, t = model
    Xc = torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z = Xc[..., 2]
    zs = z[..., None]
    proj = Xc[..., :2] / torch.where(torch.abs(zs) < 1e-9, torch.full_like(zs, 1e-9), zs)
    d = proj - xn
    err = torch.sum(d * d, dim=-1)
    return torch.where(z > 1e-6, err, torch.full_like(err, _BEHIND))


def _p3p_solver(X, xn):
    R, t, ok = p3p_grunert(X, xn)
    return (R, t), ok


def _residual(params, X, xn, w):
    """Inlier-weighted normalized reprojection residual (2N,) of one view."""
    Xc = lie.rotate_aa(params[:3][None], X) + params[3:][None]
    z = Xc[..., 2:3]
    proj = Xc[..., :2] / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return ((proj - xn) * w[:, None]).reshape(-1)


_batched_residual = vmap(_residual)
_batched_jacobian = vmap(jacfwd(_residual))


def pnp_ransac(generator, X: torch.Tensor, xn: torch.Tensor, valid: torch.Tensor,
               n_iters: int = 256, thresh_norm=8.0 / 800.0, refine_steps: int = 10,
               minimal: str = "dlt", idx: torch.Tensor | None = None):
    """Robust resection of a batch of views.  X (B, N, 3), xn (B, N, 2)
    normalized coords, valid (B, N), thresh_norm a float or (B,) tensor.

    Returns (aa (B, 3), t (B, 3), inliers (B, N), n_inliers (B,)).
    minimal="p3p" samples 3-point Grunert hypotheses (4 candidates each)."""
    if minimal == "p3p":
        (R, t), inl, _ = ransac(generator, X, xn, valid, solver=_p3p_solver,
                                scorer=pnp_reproj_error, sample_size=3, n_iters=n_iters,
                                inlier_thresh=thresh_norm, n_candidates=4,
                                refit_solver=pnp_dlt, idx=idx)
    else:
        (R, t), inl, _ = ransac(generator, X, xn, valid, solver=pnp_dlt,
                                scorer=pnp_reproj_error, sample_size=MIN_PNP_SAMPLE,
                                n_iters=n_iters, inlier_thresh=thresh_norm, idx=idx)
    aa = lie.so3_log(R)

    # Fixed-iteration Gauss-Newton polish on the inliers.
    w = inl.to(X.dtype)
    params = torch.cat([aa, t], dim=-1)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(refine_steps):
        r = _batched_residual(params, X, xn, w)
        J = _batched_jacobian(params, X, xn, w)  # (B, 2N, 6)
        Jt = J.transpose(-1, -2)
        step = torch.linalg.solve_ex(Jt @ J + 1e-8 * eye6, (Jt @ r[..., None]))[0][..., 0]
        new = params - step
        better = (torch.sum(_batched_residual(new, X, xn, w) ** 2, -1)
                  <= torch.sum(r ** 2, -1))
        params = torch.where(better[:, None], new, params)
    aa, t = params[:, :3], params[:, 3:]
    errs = pnp_reproj_error((lie.so3_exp(aa), t), X, xn)
    th = thresh_norm if torch.is_tensor(thresh_norm) else torch.full(
        (X.shape[0],), thresh_norm, dtype=X.dtype, device=X.device)
    inl = (errs < (th * th)[:, None]) & valid
    return aa, t, inl, torch.sum(inl, -1)
