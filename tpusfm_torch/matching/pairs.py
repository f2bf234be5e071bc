"""View-pair generation (port of ``tpusfm/matching/pairs.py``).

Pair lists are host-side numpy: they parameterize batching, not device
compute.  ``retrieval_pairs`` proposes loop-closure (revisit) pairs from a
pooled-descriptor similarity computed on the descriptors' device; only the
(V, k) top-k values and indices come to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _retrieval_topk(desc: torch.Tensor, mask: torch.Tensor, top_k: int, exclude: int,
                    pool_k: int):
    """Per-view top-k most similar other views by pooled-descriptor cosine.
    desc (V, N, D) score-sorted descriptors, mask (V, N).  Views within
    `exclude` of the query score -1.  Ties go to the lower view index, as
    jax.lax.top_k breaks them: a stable descending sort, then the first k."""
    d = desc[:, :pool_k].to(torch.float32)
    m = mask[:, :pool_k].to(torch.float32)[..., None]
    g = torch.sum(d * m, dim=1)
    g = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-8)
    s = torch.matmul(g, g.T)
    i = torch.arange(s.shape[0], device=s.device)
    near = torch.abs(i[:, None] - i[None, :]) <= exclude
    s = torch.where(near, torch.full_like(s, -1.0), s)
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals[:, :top_k], idx[:, :top_k]


def retrieval_pairs(desc, mask, exclude: int, top_k: int = 3, min_sim: float = 0.5) -> np.ndarray:
    """Loop-closure / revisit candidate pairs from pooled-descriptor
    retrieval: the first min(256, N) descriptors of each view summed over
    its mask, L2-normalised, compared by cosine; each view's top_k others
    at least min_sim similar and more than `exclude` views away.  Returns
    (K, 2) int32 with i < j, deduplicated.  Candidates are proposals that
    matching and the geometric filter verify downstream."""
    desc = torch.as_tensor(desc)
    mask = torch.as_tensor(mask, device=desc.device)
    vals, idx = _retrieval_topk(desc, mask, int(top_k), int(exclude), min(256, desc.shape[1]))
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    v = vals.shape[0]
    qi = np.repeat(np.arange(v), vals.shape[1])
    qj = idx.reshape(-1)
    keep = vals.reshape(-1) >= min_sim
    a = np.minimum(qi, qj)[keep]
    b = np.maximum(qi, qj)[keep]
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    pairs = pairs[pairs[:, 1] - pairs[:, 0] > exclude]
    return pairs.astype(np.int32).reshape(-1, 2)


def exhaustive_pairs(n_views: int) -> np.ndarray:
    """All (i, j) with i < j."""
    i, j = np.triu_indices(n_views, k=1)
    return np.stack([i, j], axis=1).astype(np.int32)


def contiguous_pairs(n_views: int, window: int = 5) -> np.ndarray:
    """(i, j) with 0 < j - i <= window."""
    out = [(i, j) for i in range(n_views) for j in range(i + 1, min(i + 1 + window, n_views))]
    return np.asarray(out, dtype=np.int32).reshape(-1, 2)


def shard_pairs(pairs: np.ndarray, n_shards: int) -> list[np.ndarray]:
    """Split a pair list into near-equal shards, round-robin (balanced when
    contiguous pairs cluster by view)."""
    return [pairs[s::n_shards] for s in range(n_shards)]


def pad_pairs(pairs: np.ndarray, multiple: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad the pair list to a multiple of `multiple`; returns (padded_pairs,
    valid_mask).  Padding repeats pair 0 and is masked out."""
    n = len(pairs)
    if n == 0:
        return np.zeros((multiple, 2), np.int32), np.zeros((multiple,), bool)
    m = ((n + multiple - 1) // multiple) * multiple
    pad = np.repeat(pairs[:1], m - n, axis=0)
    return np.concatenate([pairs, pad]), np.arange(m) < n
