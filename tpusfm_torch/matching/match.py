"""Descriptor matching: brute-force L2 top-2 with the Lowe ratio test.

Port of ``tpusfm/matching/match.py`` — the plain path over the full
distance matrix — plus ``match_on_device``, the one matcher every caller
on a device uses: on the card it runs the fused top-2 kernel K1
(``ops/topk2_match.py``), which never stores the matrix, and on the CPU
the plain path.
"""

from __future__ import annotations

import torch

from ..ops import topk2_match

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


def match_on_device(da: torch.Tensor, db: torch.Tensor, mask_a: torch.Tensor,
                    mask_b: torch.Tensor, ratio: float = 0.8, cross_check: bool = True):
    """``match_descriptors`` on the tensors' device.  A CUDA batch of
    128-wide descriptors goes through kernel K1's bf16 variant (two
    launches with the cross-check), as the reference passes quantized=True
    for SIFT's descriptors, which lie on the u8 grid where the bf16
    product is exact; a CPU batch takes the plain matcher; any other device
    raises."""
    if da.device.type == "cuda":
        if da.shape[-1] != topk2_match.D:
            raise ValueError(f"the CUDA matcher takes {topk2_match.D}-wide descriptors, "
                             f"got {da.shape[-1]}")
        return topk2_match.match_descriptors_topk2(da, db, mask_a, mask_b, ratio=ratio,
                                                   cross_check=cross_check, quantized=True)
    if da.device.type != "cpu":
        raise ValueError(f"no matcher for device {da.device}")
    return match_descriptors(da, db, mask_a, mask_b, ratio=ratio, cross_check=cross_check)


def match_counts(idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Number of accepted matches per pair: (..., Na) -> (...,) int32."""
    del idx
    return torch.sum(valid.to(torch.int32), dim=-1, dtype=torch.int32)


def gather_matched_points(kp_a: torch.Tensor, kp_b: torch.Tensor, idx_b: torch.Tensor,
                          valid: torch.Tensor):
    """kp_a (..., Na, K), kp_b (..., Nb, K), idx_b (..., Na) -> matched
    coordinates (x0, x1) of shape (..., Na, 2), plus `valid`."""
    x0 = kp_a[..., :2]
    idx = idx_b.long()[..., None].expand(*idx_b.shape, 2)
    x1 = torch.gather(kp_b[..., :2], -2, idx)
    return x0, x1, valid
