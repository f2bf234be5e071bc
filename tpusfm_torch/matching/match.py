"""Descriptor matching: brute-force L2 top-2 with the Lowe ratio test.

Port of ``tpusfm/matching/match.py`` — the plain path over the full
distance matrix.  On the card the pipeline matches through the fused top-2
kernel instead (``ops/topk2_match.py``), which never stores the matrix.
"""

from __future__ import annotations

import torch

INF = 3.4e38


def distance_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Squared-L2 distance matrix |a|^2 + |b|^2 - 2 a.b, clamped at 0.
    (..., Na, D) x (..., Nb, D) -> (..., Na, Nb)."""
    a2 = torch.sum(da * da, dim=-1, keepdim=True)
    b2 = torch.sum(db * db, dim=-1, keepdim=True)
    ab = da @ db.transpose(-1, -2)
    return torch.clamp(a2 + b2.transpose(-1, -2) - 2.0 * ab, min=0.0)


def match_descriptors(da: torch.Tensor, db: torch.Tensor, mask_a: torch.Tensor,
                      mask_b: torch.Tensor, ratio: float = 0.8, cross_check: bool = True):
    """Ratio-test matching for one or a batch of descriptor pairs.

    da (..., Na, D), db (..., Nb, D), masks (..., Na)/(..., Nb).  Returns
    (idx_b (..., Na) int32, valid (..., Na) bool): each valid A feature's
    nearest B feature when d1 < ratio^2 d2 and, with cross_check, the match
    is mutual.  Ties go to the lowest index."""
    d = distance_matrix(da, db)
    d = torch.where(mask_b[..., None, :], d, torch.full_like(d, INF))
    d1 = torch.amin(d, dim=-1)
    i1 = torch.argmin(d, dim=-1)
    d2 = torch.min(d.scatter(-1, i1[..., None], INF), dim=-1).values
    ok = mask_a & (d1 < (ratio * ratio) * d2) & (d1 < INF)
    if cross_check:
        d_t = torch.where(mask_a[..., :, None], d, torch.full_like(d, INF))
        j1 = torch.argmin(d_t, dim=-2)  # best A for each B
        arange = torch.arange(da.shape[-2], device=da.device)
        ok = ok & (torch.gather(j1, -1, i1) == arange)
    return i1.to(torch.int32), ok


def gather_matched_points(kp_a: torch.Tensor, kp_b: torch.Tensor, idx_b: torch.Tensor,
                          valid: torch.Tensor):
    """kp_a (..., Na, K), kp_b (..., Nb, K), idx_b (..., Na) -> matched
    coordinates (x0, x1) of shape (..., Na, 2), plus `valid`."""
    x0 = kp_a[..., :2]
    idx = idx_b.long()[..., None].expand(*idx_b.shape, 2)
    x1 = torch.gather(kp_b[..., :2], -2, idx)
    return x0, x1, valid
