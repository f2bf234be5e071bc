"""Batched polynomial root finding for minimal solvers (Durand-Kerner).

Port of ``tpusfm/core/polynomial.py``: a fixed number of branch-free sweeps
finds all roots of every polynomial in a batch at once; complex arithmetic is
carried as explicit (real, imag) pairs.  The reference's ``lax.scan`` over
sweeps is a Python loop here.
"""

from __future__ import annotations

import numpy as np
import torch


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = torch.clamp(br * br + bi * bi, min=1e-30)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def poly_eval_c(coeffs: torch.Tensor, zr: torch.Tensor, zi: torch.Tensor):
    """Horner evaluation at complex points. coeffs (..., d+1) real,
    highest-degree first; zr/zi (..., R).  Returns (pr, pi)."""
    d = coeffs.shape[-1] - 1
    pr = coeffs[..., 0:1].expand(zr.shape)
    pi = torch.zeros_like(zr)
    for i in range(1, d + 1):
        pr, pi = _cmul(pr, pi, zr, zi)
        pr = pr + coeffs[..., i: i + 1]
    return pr, pi


def poly_roots(coeffs: torch.Tensor, iters: int = 80):
    """All roots of each real polynomial in a batch.

    coeffs (..., d+1), highest degree first.  Returns (roots_re (..., d),
    roots_im (..., d)) after `iters` Durand-Kerner sweeps from the standard
    (0.4 + 0.9i)^k start scaled by the Cauchy bound."""
    d = coeffs.shape[-1] - 1
    scale = torch.amax(torch.abs(coeffs), dim=-1, keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    c = coeffs / scale
    lead = c[..., 0:1]
    tiny = torch.where(lead >= 0, 1e-12, -1e-12).to(c.dtype)
    lead = torch.where(torch.abs(lead) < 1e-12, tiny, lead)
    monic = c / lead

    bound = 1.0 + torch.amax(torch.abs(monic[..., 1:]), dim=-1)
    w = np.power(0.4 + 0.9j, np.arange(1, d + 1))
    w = w / np.abs(w) ** 0.5
    wr = torch.as_tensor(w.real, dtype=coeffs.dtype, device=coeffs.device)
    wi = torch.as_tensor(w.imag, dtype=coeffs.dtype, device=coeffs.device)
    zr = bound[..., None] * wr
    zi = bound[..., None] * wi
    eye = torch.eye(d, dtype=coeffs.dtype, device=coeffs.device)
    lim = 10.0 * bound[..., None]

    for _ in range(iters):
        pr, pi = poly_eval_c(monic, zr, zi)
        dr = zr[..., :, None] - zr[..., None, :] + eye
        di = zi[..., :, None] - zi[..., None, :]
        qr = dr[..., 0]
        qi = di[..., 0]
        for k in range(1, d):
            qr, qi = _cmul(qr, qi, dr[..., k], di[..., k])
        sr, si = _cdiv(pr, pi, qr, qi)
        # Trust-region clip keeps divergent iterates finite.
        mag = torch.sqrt(sr * sr + si * si)
        f = torch.where(mag > lim, lim / torch.clamp(mag, min=1e-30), torch.ones_like(mag))
        zr, zi = zr - sr * f, zi - si * f
    return zr, zi


def real_roots(coeffs: torch.Tensor, iters: int = 80, imag_tol: float = 1e-3,
               polish_iters: int = 3):
    """poly_roots + realness mask.  Returns (roots_real (..., d), is_real
    (..., d) bool); real roots get a few clipped Newton steps."""
    zr, zi = poly_roots(coeffs, iters=iters)
    ok = torch.abs(zi) <= imag_tol * (1.0 + torch.abs(zr))
    d = coeffs.shape[-1] - 1
    dcoeffs = coeffs[..., :-1] * torch.arange(d, 0, -1, dtype=coeffs.dtype,
                                              device=coeffs.device)
    zero = torch.zeros_like(zr)
    okf = ok.to(zr.dtype)
    for _ in range(polish_iters):
        p, _ = poly_eval_c(coeffs, zr, zero)
        dp, _ = poly_eval_c(dcoeffs, zr, zero)
        step = p / torch.where(torch.abs(dp) < 1e-20, torch.full_like(dp, 1e-20), dp)
        zr = zr - torch.clamp(step, -0.5, 0.5) * okf
    return zr, ok
