"""Triangulation: two-view DLT and masked N-view DLT.

Port of ``tpusfm/core/triangulate.py``.  The bottom eigenvector of the small
normal matrices comes from shifted inverse iteration with an unrolled
Cholesky factor, as in the reference, so RANSAC hypotheses see the same
numerics on every backend.
"""

from __future__ import annotations

import torch


def _chol_small(A: torch.Tensor):
    """Unrolled batched Cholesky of a small SPD matrix (..., n, n).  Returns
    the lower factor as an (n, n) Python grid of (...,) tensors."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve_small(L, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b with the unrolled factor; b (..., n)."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def smallest_eigvec_sym(A: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of a symmetric PSD matrix
    (..., n, n) by shifted inverse iteration from a fixed generic start."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    B = A + (1e-7 * tr + 1e-20) * eye
    L = _chol_small(B)
    start = torch.ones(B.shape[:-1], dtype=A.dtype, device=A.device)
    start[..., -1] += 0.25
    v = _chol_solve_small(L, start)
    for _ in range(iters):
        v = _chol_solve_small(L, v)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    return v


def _dehomogenize(Xh: torch.Tensor) -> torch.Tensor:
    w = Xh[..., 3:4]
    w = torch.where(torch.abs(w) < 1e-12, torch.sign(w) * 1e-12 + (w == 0) * 1e-12, w)
    return Xh[..., :3] / w


def triangulate_two_view(P0: torch.Tensor, P1: torch.Tensor, x0: torch.Tensor,
                         x1: torch.Tensor) -> torch.Tensor:
    """DLT triangulation from two cameras.  P0, P1 (..., 3, 4); x0, x1
    (..., N, 2) measurements.  Returns (..., N, 3)."""
    rows = []
    for P, x in ((P0, x0), (P1, x1)):
        P0r = P[..., None, 0, :]
        P1r = P[..., None, 1, :]
        P2r = P[..., None, 2, :]
        rows.append(x[..., :, 0:1] * P2r - P0r)
        rows.append(x[..., :, 1:2] * P2r - P1r)
    A = torch.stack(torch.broadcast_tensors(*rows), dim=-2)  # (..., N, 4, 4)
    AtA = A.transpose(-1, -2) @ A
    return _dehomogenize(smallest_eigvec_sym(AtA))


def triangulate_n_view(P: torch.Tensor, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked N-view DLT, batched: P (..., V, 3, 4), x (..., V, 2), mask
    (..., V) -> (..., 3).  Invalid views contribute zero rows."""
    r0 = x[..., 0:1, None] * P[..., 2:3, :] - P[..., 0:1, :]  # (..., V, 1, 4)
    r1 = x[..., 1:2, None] * P[..., 2:3, :] - P[..., 1:2, :]
    A = torch.cat([r0, r1], dim=-2) * mask[..., None, None]  # (..., V, 2, 4)
    A2 = A.reshape(*A.shape[:-3], -1, 4)
    AtA = A2.transpose(-1, -2) @ A2
    return _dehomogenize(smallest_eigvec_sym(AtA))


def triangulation_angle(C0: torch.Tensor, C1: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Parallax angle (radians) at X subtended by camera centers C0, C1."""
    a = C0 - X
    b = C1 - X
    cos = torch.sum(a * b, dim=-1) / torch.clamp(
        torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1), min=1e-12)
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))
