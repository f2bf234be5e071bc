"""View-pair generation (port of ``tpusfm/matching/pairs.py``).

Pair lists are host-side numpy: they parameterize batching, not device
compute.
"""

from __future__ import annotations

import numpy as np


def exhaustive_pairs(n_views: int) -> np.ndarray:
    """All (i, j) with i < j."""
    i, j = np.triu_indices(n_views, k=1)
    return np.stack([i, j], axis=1).astype(np.int32)


def contiguous_pairs(n_views: int, window: int = 5) -> np.ndarray:
    """(i, j) with 0 < j - i <= window."""
    out = [(i, j) for i in range(n_views) for j in range(i + 1, min(i + 1 + window, n_views))]
    return np.asarray(out, dtype=np.int32).reshape(-1, 2)


def retrieval_pairs(desc, mask, exclude: int, top_k: int = 3, min_sim: float = 0.5) -> np.ndarray:
    """Loop-closure candidate pairs by pooled-descriptor retrieval: not
    ported yet."""
    raise NotImplementedError("retrieval_pairs (matching.loop_closure) is not ported yet")
