"""Sharded pairwise matching: the view-pair list split over the mesh (port
of ``tpusfm/parallel/dist_matching.py``).

Each rank matches its contiguous block of the chunk's pairs through
``matching.match.match_on_device`` (kernel K1's bf16 variant on the card,
the plain matcher on the CPU) with no collective on the hot path; one
all_gather returns the whole chunk's table to every rank.  Pairs are
independent, so the table equals the single-device match bit for bit.
"""

from __future__ import annotations

import torch

from ..matching import match
from . import mesh as mesh_mod


def match_pairs_sharded(mesh: mesh_mod.Mesh, desc_a: torch.Tensor, desc_b: torch.Tensor,
                        mask_a: torch.Tensor, mask_b: torch.Tensor, ratio: float = 0.8,
                        cross_check: bool = True, axis: str = "shard"):
    """desc_a/desc_b (Pr, N, D), mask_a/mask_b (Pr, N); Pr must be divisible
    by the mesh's size (pad with pairs.pad_pairs).  Returns (idx (Pr, N)
    int32, valid (Pr, N) bool) on every rank."""
    n = mesh.shape[axis]
    Pr = desc_a.shape[0]
    if Pr % n:
        raise ValueError(f"{Pr} pairs must be divisible by mesh axis {n} (pad with "
                         "pairs.pad_pairs)")
    mesh_mod.check_same(mesh, "match_pairs_sharded", pairs=Pr, features=desc_a.shape[1])
    rows = slice(mesh.rank * (Pr // n), (mesh.rank + 1) * (Pr // n))
    idx, ok = match.match_on_device(desc_a[rows], desc_b[rows], mask_a[rows], mask_b[rows],
                                    ratio=ratio, cross_check=cross_check)
    return mesh_mod.all_gather(mesh, idx), mesh_mod.all_gather(mesh, ok)
