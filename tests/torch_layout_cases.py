"""The edge cases of the segment layout (ObsLayout in
tpusfm_torch/ops/obs_table.py) and their answer from numpy's stable
argsort: tests/test_torch_layout.py holds the plain twin to them on the CPU
and tests/test_torch_cuda.py the kernel on the card.  Imports neither jax
nor the reference package."""

import numpy as np

from tpusfm_torch.ops import obs_table as tot


def layout_cases():
    """(name, ids, n) of each edge case."""
    r = np.random.default_rng(16)
    mixed = r.integers(-3, 10, 5001).astype(np.int32)  # O not a multiple of any tile
    ordered = np.sort(r.integers(0, 40, 3000)).astype(np.int32)
    swapped = ordered.copy()
    swapped[[1000, 1500]] = swapped[[1500, 1000]]
    assert swapped[1000] != swapped[1500]
    trailing = np.concatenate([np.zeros(2500, np.int32), np.full(7, 5, np.int32)])
    inner = np.zeros(2500, np.int32)
    inner[1200] = -4
    return [("mixed", mixed, 7),
            ("one segment", np.zeros(5000, np.int32), 1),
            ("n = 1, some ids outside", np.where(mixed > 0, 0, mixed).astype(np.int32), 1),
            ("every id invalid", np.where(r.random(700) < 0.5, -r.integers(1, 9, 700),
                                          r.integers(5, 20, 700)).astype(np.int32), 5),
            ("already sorted", ordered, 40),
            ("sorted but one swap", swapped, 40),
            ("invalid ids trailing", trailing, 1),
            ("an invalid id inside", inner, 1),
            ("fewer than 32 rows", r.integers(-1, 4, 20).astype(np.int32), 3),
            ("no rows", np.zeros(0, np.int32), 4)]


def numpy_layout(ids, n):
    """The layout from numpy's stable argsort (see ObsLayout)."""
    key = np.where((ids >= 0) & (ids < n), ids, n)
    perm = np.argsort(key, kind="stable")
    seg_start = np.searchsorted(key[perm], np.arange(n + 1), side="left")
    chunks = (np.diff(seg_start) + tot.CHUNK_ROWS - 1) // tot.CHUNK_ROWS
    chunk_start = np.concatenate([[0], np.cumsum(chunks)])
    return perm, seg_start, chunk_start, np.zeros(n), [int(np.all(np.diff(key) >= 0))]
