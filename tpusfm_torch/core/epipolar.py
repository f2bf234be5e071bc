"""Two-view epipolar geometry: normalized 8-point F/E, the 7-point F and
5-point E minimal solvers, E decomposition, pose recovery and the Sampson
error.

Port of ``tpusfm/core/epipolar.py``.  Solvers batch over leading dimensions:
a leading hypothesis axis on the correspondence arrays yields one model per
row.  Small SVDs, determinants and solves go to ``torch.linalg``; singular
vectors may differ in sign from the reference's, which every caller absorbs
(models are defined up to sign and scale).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .polynomial import real_roots
from .triangulate import smallest_eigvec_sym, triangulate_two_view


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A float64 numpy constant as a float32 tensor on `like`'s device (the
    reference runs with x64 disabled, so its constants are float32 too)."""
    return torch.as_tensor(np.asarray(a, np.float32), device=like.device).to(like.dtype)


def svd(A: torch.Tensor, full_matrices: bool = False):
    """Batched SVD that tolerates degenerate hypotheses: non-finite entries
    are zeroed first (``torch.linalg.svd`` raises on them, where the
    reference's XLA SVD returns NaNs that simply lose the RANSAC vote)."""
    A = torch.where(torch.isfinite(A), A, torch.zeros_like(A))
    return torch.linalg.svd(A, full_matrices=full_matrices)


def _normalize_points(x: torch.Tensor, w: torch.Tensor | None = None):
    """Hartley normalization of (..., N, 2) with optional weights (..., N).
    Returns (x_norm, T) with T (..., 3, 3) such that x_norm_h = T @ x_h."""
    if w is None:
        w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    mean = torch.sum(x * w[..., None], dim=-2, keepdim=True) / wsum[..., None]
    centered = x - mean
    dist = torch.sqrt(torch.sum(centered * centered, dim=-1) + 1e-18)
    mean_dist = torch.sum(dist * w, dim=-1, keepdim=True) / wsum
    scale = math.sqrt(2.0) / torch.clamp(mean_dist, min=1e-9)
    xn = centered * scale[..., None]
    s = scale[..., 0]
    mx = mean[..., 0, 0]
    my = mean[..., 0, 1]
    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    T = torch.stack(
        [
            torch.stack([s, zeros, -s * mx], dim=-1),
            torch.stack([zeros, s, -s * my], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    return xn, T


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)], dim=-1)


def _epipolar_rows(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    p0 = _homog(x0)
    p1 = _homog(x1)
    return (p1[..., :, None] * p0[..., None, :]).reshape(*x0.shape[:-1], 9)


def _solve_epipolar_lstsq(x0n, x1n, w):
    """Null vector of the weighted 9x9 A^T A of the epipolar constraint."""
    A = _epipolar_rows(x0n, x1n) * w[..., None]
    AtA = A.transpose(-1, -2) @ A
    f = smallest_eigvec_sym(AtA, iters=8)
    return f.reshape(*f.shape[:-1], 3, 3)


def _drop_smallest_singular(F: torch.Tensor) -> torch.Tensor:
    """Rank-2 projection F - sigma3 u3 v3^T from inverse iteration on
    F F^T / F^T F (no SVD)."""
    Ft = F.transpose(-1, -2)
    v3 = smallest_eigvec_sym(Ft @ F, iters=6)
    u3 = smallest_eigvec_sym(F @ Ft, iters=6)
    Fv = torch.einsum("...ij,...j->...i", F, v3)
    sigma3 = torch.einsum("...i,...i->...", u3, Fv)
    return F - sigma3[..., None, None] * (u3[..., :, None] * v3[..., None, :])


def _trace(A: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)


def _enforce_essential(E: torch.Tensor) -> torch.Tensor:
    """Project onto the essential manifold (singular values -> (s, s, 0))
    by dropping the smallest singular value and whitening the other two with
    a linear polynomial in E2^T E2."""
    E2 = _drop_smallest_singular(E)
    A = E2.transpose(-1, -2) @ E2
    t1 = _trace(A)
    t2 = _trace(A @ A)
    disc = torch.sqrt(torch.clamp(2.0 * t2 - t1 * t1, min=0.0))
    a = torch.clamp(0.5 * (t1 + disc), min=1e-30)
    b = torch.minimum(torch.maximum(0.5 * (t1 - disc), 1e-6 * a), a)
    sa = torch.sqrt(a)
    sb = torch.sqrt(b)
    c1 = -1.0 / (sa * sb * (sa + sb))
    c0 = 1.0 / sa - c1 * a
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    W = c0[..., None, None] * eye + c1[..., None, None] * A
    return E2 @ W


def _unit_frobenius(M: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(M.reshape(*M.shape[:-2], 9), dim=-1)[..., None, None]
    return M / torch.clamp(norm, min=1e-12)


def fundamental_8pt(x0: torch.Tensor, x1: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized 8-point fundamental matrix. x0, x1: (..., N>=8, 2) pixels.
    Returns F (..., 3, 3) with x1h^T F x0h = 0."""
    if w is None:
        w = torch.ones(x0.shape[:-1], dtype=x0.dtype, device=x0.device)
    x0n, T0 = _normalize_points(x0, w)
    x1n, T1 = _normalize_points(x1, w)
    Fn = _drop_smallest_singular(_solve_epipolar_lstsq(x0n, x1n, w))
    return _unit_frobenius(T1.transpose(-1, -2) @ Fn @ T0)


def essential_8pt(x0n: torch.Tensor, x1n: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """Essential matrix from >= 8 normalized-coordinate correspondences,
    projected onto the essential manifold."""
    if w is None:
        w = torch.ones(x0n.shape[:-1], dtype=x0n.dtype, device=x0n.device)
    x0h, T0 = _normalize_points(x0n, w)
    x1h, T1 = _normalize_points(x1n, w)
    En = _solve_epipolar_lstsq(x0h, x1h, w)
    E = _enforce_essential(T1.transpose(-1, -2) @ En @ T0)
    return _unit_frobenius(E)


# ---------------------------------------------------------------------------
# Minimal solvers: 7-point F (3 roots) and 5-point E (10 roots)
# ---------------------------------------------------------------------------

def _epipolar_nullspace(x0: torch.Tensor, x1: torch.Tensor, k: int):
    """Last-k right singular vectors of the (..., N, 9) constraint matrix,
    reshaped to k candidate 3x3s."""
    A = _epipolar_rows(x0, x1)
    _, _, Vh = svd(A, full_matrices=True)
    null = Vh[..., 9 - k:, :]
    return null.reshape(*null.shape[:-1], 3, 3)


_L7 = np.array([-1.5, -0.5, 0.5, 1.5])
_V7INV = np.linalg.inv(np.stack([_L7**3, _L7**2, _L7, np.ones(4)], axis=1))


def fundamental_7pt(x0: torch.Tensor, x1: torch.Tensor):
    """7-point fundamental solver.  x0, x1: (..., 7, 2) pixels.  Returns
    (F (..., 3, 3, 3), ok (..., 3)): up to three real candidates."""
    x0n, T0 = _normalize_points(x0)
    x1n, T1 = _normalize_points(x1)
    null = _epipolar_nullspace(x0n, x1n, 2)
    F2, F1 = null[..., 0, :, :], null[..., 1, :, :]
    lam = _const(_L7, x0)
    Fl = F1[..., None, :, :] + lam[:, None, None] * F2[..., None, :, :]
    dets = torch.linalg.det(Fl)
    coeffs = torch.einsum("ij,...j->...i", _const(_V7INV, x0), dets)
    roots, ok = real_roots(coeffs, iters=40)
    F = F1[..., None, :, :] + roots[..., :, None, None] * F2[..., None, :, :]
    F = T1.transpose(-1, -2)[..., None, :, :] @ F @ T0[..., None, :, :]
    return _unit_frobenius(F), ok


def _cross_rows(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _e_constraints(E: torch.Tensor) -> torch.Tensor:
    """det(E) and the nine entries of 2 E E^T E - tr(E E^T) E: (..., 10)."""
    det = torch.linalg.det(E)
    EEt = E @ E.transpose(-1, -2)
    tr = _trace(EEt)[..., None, None]
    C = 2.0 * (EEt @ E) - tr * E
    return torch.cat([det[..., None], C.reshape(*C.shape[:-2], 9)], dim=-1)


def _e_constraints_dir(E: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Directional derivative of _e_constraints at E along D."""
    cof = torch.stack(
        [
            _cross_rows(E[..., 1, :], E[..., 2, :]),
            _cross_rows(E[..., 2, :], E[..., 0, :]),
            _cross_rows(E[..., 0, :], E[..., 1, :]),
        ],
        dim=-2,
    )
    ddet = torch.sum(cof * D, dim=(-1, -2))
    Et = E.transpose(-1, -2)
    Dt = D.transpose(-1, -2)
    EEt = E @ Et
    trEEt = _trace(EEt)[..., None, None]
    trEDt = _trace(E @ Dt)[..., None, None]
    dC = 2.0 * (D @ Et @ E + E @ Dt @ E + EEt @ D) - 2.0 * trEDt * E - trEEt * D
    return torch.cat([ddet[..., None], dC.reshape(*dC.shape[:-2], 9)], dim=-1)


def _mono20(p: np.ndarray) -> np.ndarray:
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    one = np.ones_like(x)
    return np.stack(
        [
            x**3, x**2 * y, x * y**2, y**3, x**2 * z, x * y * z, y**2 * z,
            x * z**2, y * z**2, z**3,
            x**2, x * y, y**2, x * z, y * z, z**2, x, y, z, one,
        ],
        axis=1,
    )


# The same generic interpolation nodes and basis rotation as the reference
# (identical seeds), inverted once in float64 and used in float32.
_P5 = np.random.default_rng(7).uniform(-1.0, 1.0, (20, 3))
_V5INV = np.linalg.inv(_mono20(_P5))
_Q5 = np.linalg.qr(np.random.default_rng(11).normal(size=(4, 4)))[0]


def essential_5pt(x0n: torch.Tensor, x1n: torch.Tensor):
    """Nister/Stewenius 5-point essential solver, batched.  x0n, x1n:
    (..., 5, 2).  Returns (E (..., 10, 3, 3), ok (..., 10))."""
    nulls = _epipolar_nullspace(x0n, x1n, 4)  # (..., 4, 3, 3)
    flat = nulls.reshape(*nulls.shape[:-3], 4, 9)
    nulls = torch.einsum("ab,...bj->...aj", _const(_Q5, x0n), flat).reshape(nulls.shape)
    X_, Y_, Z_, W_ = (nulls[..., i, :, :] for i in range(4))

    pts = _const(_P5, x0n)
    Ep = (
        pts[:, 0, None, None] * X_[..., None, :, :]
        + pts[:, 1, None, None] * Y_[..., None, :, :]
        + pts[:, 2, None, None] * Z_[..., None, :, :]
        + W_[..., None, :, :]
    )
    vals = _e_constraints(Ep)  # (..., 20, 10)
    M = torch.einsum("mp,...pe->...em", _const(_V5INV, x0n), vals)  # (..., 10, 20)

    M10 = M[..., :, :10]
    eye10 = torch.eye(10, dtype=M.dtype, device=M.device)
    tr = _trace(M10.transpose(-1, -2) @ M10)
    reg = (1e-9 * tr + 1e-20)[..., None, None] * eye10
    B = torch.linalg.solve_ex(M10 + reg, M[..., :, 10:])[0]

    ebr = eye10.expand(B.shape)
    At = torch.stack(
        [
            -B[..., 0, :], -B[..., 1, :], -B[..., 2, :],
            -B[..., 4, :], -B[..., 5, :], -B[..., 7, :],
            ebr[..., 0, :], ebr[..., 1, :], ebr[..., 3, :], ebr[..., 6, :],
        ],
        dim=-2,
    )

    # Faddeev-LeVerrier on a spectrally scaled copy (coefficients stay O(1)).
    n = 10
    s = torch.amax(torch.sum(torch.abs(At), dim=-1), dim=-1)
    s = torch.clamp(s, min=1e-6)
    Ats = At / s[..., None, None]
    coeffs = [torch.ones(At.shape[:-2], dtype=At.dtype, device=At.device)]
    Mk = torch.zeros_like(At)
    for k in range(1, n + 1):
        Mk = Ats @ Mk + coeffs[-1][..., None, None] * eye10
        coeffs.append(-_trace(Ats @ Mk) / k)
    charpoly = torch.stack(coeffs, dim=-1)

    xr, ok = real_roots(charpoly, iters=100)
    xr = xr * s[..., None]

    Mx = At[..., None, :, :] - xr[..., :, None, None] * eye10
    G = Mx.transpose(-1, -2) @ Mx
    v = smallest_eigvec_sym(G, iters=8)
    denom = v[..., 9]
    denom = torch.where(torch.abs(denom) < 1e-8, torch.full_like(denom, 1e-8), denom)
    ys = v[..., 7] / denom
    zs = v[..., 8] / denom

    def build_E(x, y, z):
        return (
            x[..., None, None] * X_[..., None, :, :]
            + y[..., None, None] * Y_[..., None, :, :]
            + z[..., None, None] * Z_[..., None, :, :]
            + W_[..., None, :, :]
        )

    # Levenberg-Marquardt polish on the ten constraints from each start.
    x, y, z = xr, ys, zs
    lam_lm = torch.full(x.shape, 1e-4, dtype=x.dtype, device=x.device)
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
    for _ in range(8):
        E = build_E(x, y, z)
        r = _e_constraints(E)
        J = torch.stack([
            _e_constraints_dir(E, X_[..., None, :, :].expand(E.shape)),
            _e_constraints_dir(E, Y_[..., None, :, :].expand(E.shape)),
            _e_constraints_dir(E, Z_[..., None, :, :].expand(E.shape)),
        ], dim=-1)
        JtJ = J.transpose(-1, -2) @ J
        diag = torch.clamp(torch.diagonal(JtJ, dim1=-2, dim2=-1), min=1e-12)
        H = JtJ + lam_lm[..., None, None] * (diag[..., :, None] * eye3)
        g = torch.einsum("...ri,...r->...i", J, r)
        step = torch.linalg.solve_ex(H, g[..., None])[0][..., 0]
        xn_, yn_, zn_ = x - step[..., 0], y - step[..., 1], z - step[..., 2]
        rn = _e_constraints(build_E(xn_, yn_, zn_))
        better = torch.sum(rn * rn, -1) <= torch.sum(r * r, -1)
        x = torch.where(better, xn_, x)
        y = torch.where(better, yn_, y)
        z = torch.where(better, zn_, z)
        lam_lm = torch.clamp(torch.where(better, lam_lm * 0.3, lam_lm * 8.0), 1e-7, 1e3)

    E = build_E(x, y, z)
    norm = torch.linalg.norm(E.reshape(*E.shape[:-2], 9), dim=-1)
    ok = norm > 1e-9
    E = E / torch.clamp(norm, min=1e-12)[..., None, None]
    resid = torch.linalg.norm(_e_constraints(E), dim=-1)
    return E, ok & (resid < 1e-3)


def sampson_error(F: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) squared error of x1^T F x0.
    F (..., 3, 3), x0/x1 (..., N, 2) -> (..., N)."""
    p0 = _homog(x0)
    p1 = _homog(x1)
    Fx0 = torch.einsum("...ij,...nj->...ni", F, p0)
    Ftx1 = torch.einsum("...ji,...nj->...ni", F, p1)
    num = torch.einsum("...ni,...ni->...n", p1, Fx0)
    denom = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    return num * num / torch.clamp(denom, min=1e-12)


def decompose_essential(E: torch.Tensor):
    """E -> the four (R, t) candidates (R1,t), (R1,-t), (R2,t), (R2,-t).
    Returns (R (..., 4, 3, 3), t (..., 4, 3)) with unit-norm t."""
    U, _, Vt = svd(E)
    U = U * torch.where(torch.linalg.det(U) < 0, -1.0, 1.0).to(E.dtype)[..., None, None]
    Vt = Vt * torch.where(torch.linalg.det(Vt) < 0, -1.0, 1.0).to(E.dtype)[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return torch.stack([R1, R1, R2, R2], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def pose_from_candidates(Rs: torch.Tensor, ts: torch.Tensor, x0n: torch.Tensor,
                         x1n: torch.Tensor, w: torch.Tensor | None = None):
    """Choose, per batch row, the (R, t) candidate with maximal cheirality
    support.  Rs (..., K, 3, 3), ts (..., K, 3), x0n/x1n (..., N, 2), w
    (..., N).  Returns (R, t, n_good, front_mask (..., N), X (..., N, 3))
    with camera 0 at identity."""
    if w is None:
        w = torch.ones(x0n.shape[:-1], dtype=x0n.dtype, device=x0n.device)
    K = Rs.shape[-3]
    P0 = torch.cat([torch.eye(3, dtype=Rs.dtype, device=Rs.device),
                    torch.zeros((3, 1), dtype=Rs.dtype, device=Rs.device)], dim=1)
    P1 = torch.cat([Rs, ts[..., None]], dim=-1)  # (..., K, 3, 4)
    X = triangulate_two_view(P0, P1, x0n[..., None, :, :], x1n[..., None, :, :])  # (..., K, N, 3)
    z0 = X[..., 2]
    z1 = torch.einsum("...kj,...knj->...kn", Rs[..., 2, :], X) + ts[..., 2:3]
    front = (z0 > 1e-4) & (z1 > 1e-4) & (z0 < 1e4)
    counts = torch.sum(front * w[..., None, :], dim=-1)  # (..., K)
    best = torch.argmax(counts, dim=-1)

    def pick(v):
        idx = best.reshape(best.shape + (1,) * (v.dim() - best.dim()))
        idx = idx.expand(best.shape + (1,) + v.shape[best.dim() + 1:])
        return torch.gather(v, best.dim(), idx).squeeze(best.dim())

    del K
    return pick(Rs), pick(ts), pick(counts), pick(front), pick(X)


def recover_pose(E: torch.Tensor, x0n: torch.Tensor, x1n: torch.Tensor,
                 w: torch.Tensor | None = None):
    """Choose the (R, t) candidate of E with maximal cheirality support
    (cv::recoverPose parity).  Returns (R, t, n_good, front_mask, X)."""
    Rs, ts = decompose_essential(E)
    return pose_from_candidates(Rs, ts, x0n, x1n, w)
