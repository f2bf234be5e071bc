"""Ring all-pairs matching: descriptors sharded by view, rotated over the
mesh (port of ``tpusfm/parallel/ring_match.py``).

Each rank keeps its resident shard of V/world views and a visiting buffer
that starts as a copy of it.  At each of `world` steps the rank matches
every (resident, visiting) view pair as one batch through
``matching.match.match_on_device`` with ``cross_check=False`` (K1's bf16
variant on the card), then passes the visiting buffer to rank + 1 and
takes rank - 1's (``batch_isend_irecv``; through host memory under gloo).
Per-rank memory stays O(V/world * N * D) whatever the collection's size.
This replaces the reference's ``lax.scan`` over ``ppermute`` and its
``argsort(srcs)`` reorder: the block a step's result belongs to is known
from the step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..matching import match as match_mod
from . import mesh as mesh_mod


def ring_match_all_pairs(mesh: mesh_mod.Mesh, desc: torch.Tensor, mask: torch.Tensor,
                         ratio: float = 0.8, axis: str = "shard"):
    """desc (V, N, D) and mask (V, N) of every view (V divisible by the
    mesh's size; every rank passes the same).  Returns this rank's rows
    (idx (V/world, V, N) int32, ok (V/world, V, N) bool): for the rank's
    resident views a and every view b, a's features matched into b (a->b's
    ratio test only).  ``mesh.all_gather`` of both gives the reference's
    full (V, V, N) table."""
    n = mesh.shape[axis]
    V, N, D = desc.shape
    if V % n:
        raise ValueError(f"V={V} must divide the mesh axis {n}")
    mesh_mod.check_same(mesh, "ring_match_all_pairs", views=V, features=N)
    Vl = V // n
    res = slice(mesh.rank * Vl, (mesh.rank + 1) * Vl)
    d_res, m_res = desc[res].contiguous(), mask[res].contiguous()
    idx = torch.empty((Vl, V, N), dtype=torch.int32, device=desc.device)
    ok = torch.empty((Vl, V, N), dtype=torch.bool, device=desc.device)
    vis_d, vis_m = d_res, m_res
    ia = torch.arange(Vl, device=desc.device).repeat_interleave(Vl)
    ib = torch.arange(Vl, device=desc.device).repeat(Vl)
    for k in range(n):
        # The visiting block started on rank (rank - k) mod world.
        src = (mesh.rank - k) % n
        i, o = match_mod.match_on_device(d_res[ia], vis_d[ib], m_res[ia], vis_m[ib],
                                         ratio=ratio, cross_check=False)
        idx[:, src * Vl:(src + 1) * Vl] = i.reshape(Vl, Vl, N)
        ok[:, src * Vl:(src + 1) * Vl] = o.reshape(Vl, Vl, N)
        if k + 1 < n:
            vis_d, vis_m = mesh_mod.ring_shift(mesh, [vis_d, vis_m])
    return idx, ok


def pairs_from_ring_table(idx, ok, min_matches: int = 1):
    """Ordered-pair table (V, V, N) -> (pair_list (P, 2), match_idx (P, N),
    match_valid (P, N)) for the i < j pairs with at least `min_matches`
    matches (build_tracks' input)."""
    idx = np.asarray(idx)
    ok = np.asarray(ok)
    V = idx.shape[0]
    iu, ju = np.triu_indices(V, 1)
    keep = ok[iu, ju].sum(axis=-1) >= min_matches
    iu, ju = iu[keep], ju[keep]
    if len(iu) == 0:
        n = idx.shape[-1]
        return (np.zeros((0, 2), np.int32), np.zeros((0, n), np.int32),
                np.zeros((0, n), bool))
    pl = np.stack([iu, ju], axis=1).astype(np.int32)
    return pl, idx[iu, ju], ok[iu, ju]
