"""Batched closed-form P3P (Grunert / Haralick) absolute-pose minimal solver.

Port of ``tpusfm/core/p3p.py``: the quartic in the distance ratio is solved
for the whole hypothesis batch with the Durand-Kerner sweeps of
``core.polynomial``; each 3-point sample yields up to four candidate poses.
"""

from __future__ import annotations

import torch

from .polynomial import real_roots


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _triad(P: torch.Tensor) -> torch.Tensor:
    """Orthonormal frame (rows) from 3 points (..., 3, 3)."""
    u = P[..., 1, :] - P[..., 0, :]
    v = P[..., 2, :] - P[..., 0, :]
    e1 = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=1e-12)
    n = _cross(e1, v)
    e3 = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    e2 = _cross(e3, e1)
    return torch.stack([e1, e2, e3], dim=-2)


def align_3pts(Xw: torch.Tensor, Xc: torch.Tensor):
    """Rigid (R, t) with Xc_i = R Xw_i + t from three point pairs (..., 3, 3)."""
    R = _triad(Xc).transpose(-1, -2) @ _triad(Xw)
    t = Xc[..., 0, :] - torch.einsum("...ij,...j->...i", R, Xw[..., 0, :])
    return R, t


def p3p_grunert(X: torch.Tensor, xn: torch.Tensor):
    """Grunert's P3P.  X (..., 3, 3) world points, xn (..., 3, 2) normalized
    image coords.  Returns (R (..., 4, 3, 3), t (..., 4, 3), ok (..., 4))."""
    ones = torch.ones(xn.shape[:-1] + (1,), dtype=xn.dtype, device=xn.device)
    f = torch.cat([xn, ones], dim=-1)
    f = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True), min=1e-12)
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    X1, X2, X3 = X[..., 0, :], X[..., 1, :], X[..., 2, :]

    a2 = torch.sum((X2 - X3) ** 2, dim=-1)
    b2 = torch.clamp(torch.sum((X1 - X3) ** 2, dim=-1), min=1e-12)
    c2 = torch.sum((X1 - X2) ** 2, dim=-1)
    ca = torch.sum(f2 * f3, dim=-1)
    cb = torch.sum(f1 * f3, dim=-1)
    cg = torch.sum(f1 * f2, dim=-1)

    ab = a2 / b2
    cbb = c2 / b2
    q = (a2 - c2) / b2
    s = (a2 + c2) / b2

    A4 = (q - 1.0) ** 2 - 4.0 * cbb * ca**2
    A3 = 4.0 * (q * (1.0 - q) * cb - (1.0 - s) * ca * cg + 2.0 * cbb * ca**2 * cb)
    A2 = 2.0 * (
        q**2
        - 1.0
        + 2.0 * q**2 * cb**2
        + 2.0 * (1.0 - cbb) * ca**2
        - 4.0 * s * ca * cb * cg
        + 2.0 * (1.0 - ab) * cg**2
    )
    A1 = 4.0 * (-q * (1.0 + q) * cb + 2.0 * ab * cg**2 * cb - (1.0 - s) * ca * cg)
    A0 = (1.0 + q) ** 2 - 4.0 * ab * cg**2

    v, real_ok = real_roots(torch.stack([A4, A3, A2, A1, A0], dim=-1), iters=60)

    qv = q[..., None]
    denom_u = 2.0 * (cg[..., None] - v * ca[..., None])
    denom_u = torch.where(torch.abs(denom_u) < 1e-9, torch.full_like(denom_u, 1e-9), denom_u)
    u = ((-1.0 + qv) * v**2 - 2.0 * qv * cb[..., None] * v + 1.0 + qv) / denom_u

    s1_den = 1.0 + v**2 - 2.0 * v * cb[..., None]
    s1 = torch.sqrt(b2[..., None] / torch.clamp(s1_den, min=1e-12))
    s2 = u * s1
    s3 = v * s1
    ok = real_ok & (s1 > 0) & (s2 > 0) & (s3 > 0) & (s1_den > 1e-12)

    # Newton polish of the law-of-cosines system in distance space.
    dists = torch.stack([s1, s2, s3], dim=-1)  # (..., 4, 3)
    cosv = torch.stack([x[..., None].expand(s1.shape) for x in (ca, cb, cg)], dim=-1)
    rhs = torch.stack([x[..., None].expand(s1.shape) for x in (a2, b2, c2)], dim=-1)

    def _locos_resid(d):
        d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2]
        r1 = d2 * d2 + d3 * d3 - 2.0 * d2 * d3 * cosv[..., 0] - rhs[..., 0]
        r2 = d1 * d1 + d3 * d3 - 2.0 * d1 * d3 * cosv[..., 1] - rhs[..., 1]
        r3 = d1 * d1 + d2 * d2 - 2.0 * d1 * d2 * cosv[..., 2] - rhs[..., 2]
        return torch.stack([r1, r2, r3], dim=-1)

    eye3 = torch.eye(3, dtype=dists.dtype, device=dists.device)
    for _ in range(3):
        d1, d2, d3 = dists[..., 0], dists[..., 1], dists[..., 2]
        zero = torch.zeros_like(d1)
        J = torch.stack(
            [
                torch.stack([zero, 2 * d2 - 2 * d3 * cosv[..., 0], 2 * d3 - 2 * d2 * cosv[..., 0]], dim=-1),
                torch.stack([2 * d1 - 2 * d3 * cosv[..., 1], zero, 2 * d3 - 2 * d1 * cosv[..., 1]], dim=-1),
                torch.stack([2 * d1 - 2 * d2 * cosv[..., 2], 2 * d2 - 2 * d1 * cosv[..., 2], zero], dim=-1),
            ],
            dim=-2,
        )
        r = _locos_resid(dists)
        JtJ = J.transpose(-1, -2) @ J + 1e-9 * eye3
        g = torch.einsum("...ji,...j->...i", J, r)
        step = torch.linalg.solve_ex(JtJ, g[..., None])[0][..., 0]
        new = dists - torch.clamp(step, -0.5, 0.5)
        better = torch.sum(_locos_resid(new) ** 2, -1) <= torch.sum(r * r, -1)
        dists = torch.where(better[..., None], new, dists)
    Xc = dists[..., :, None] * f[..., None, :, :]
    Xw = X[..., None, :, :].expand(Xc.shape)
    R, t = align_3pts(Xw, Xc)
    return R, t, ok
