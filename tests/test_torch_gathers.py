"""Twins of the gathers K8 (`gather_table`) and K9 (`gather_sorted`) of
tpusfm_torch/ops/obs_table.py against the reference's Pallas kernels in
interpret mode, on the same seeded numpy inputs.

The reference rebuilds each float32 value from three bf16 terms of a
one-hot matrix product (`_oh_dot`); the twins index.  Tolerance: rtol 1e-6
(the three-term split is exact to float32 round-off), with out-of-range
rows exactly zero on both sides.  Where the two differ by design (a rank
jumping past the reference's two-block window), the test pins it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusfm.ops import obs_table as jot
from tpusfm_torch.ops import obs_table as tot

torch.set_num_threads(2)


def _table(n, d, seed):
    return np.random.default_rng(seed).normal(scale=100.0, size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("d", [3, 6, 7, 9])
def test_gather_table_twin_matches_reference(d):
    """Ids in range and in any order, past the table, in the pad to a
    multiple of 8 (the reference pads the table with zero rows), far past
    it, and negative: every one outside [0, N) gives a zero row.  308 ids:
    the last of the kernel's 32-row tiles is ragged."""
    n = 13  # padded to 16 by the reference
    tab = _table(n, d, seed=d)
    rng = np.random.default_rng(100 + d)
    idx = np.concatenate([rng.integers(0, n, 300), [n, n + 1, n + 2, 15, 16, 4096, -1, -7]])
    idx = rng.permutation(idx).astype(np.int32)
    want = np.asarray(jot.gather_table(jnp.asarray(tab), jnp.asarray(idx), interpret=True))
    got = tot.gather_table(torch.as_tensor(tab), torch.as_tensor(idx))
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(idx), d)
    got = got.numpy()
    out = (idx < 0) | (idx >= n)
    assert out.sum() == 8 and not got[out].any() and not want[out].any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[~out], tab[idx[~out]])


def _dense_ranks(n_rows, p, seed, n_invalid):
    """Non-decreasing ranks covering [0, p) (every rank has a row) and
    n_invalid invalid rows at INVALID_RANK at the end."""
    rng = np.random.default_rng(seed)
    ranks = np.sort(np.concatenate([np.arange(p), rng.integers(0, p, n_rows - p)]))
    return np.concatenate([ranks, np.full(n_invalid, tot.INVALID_RANK)]).astype(np.int32)


@pytest.mark.parametrize("d", [3, 6, 7, 9])
def test_gather_sorted_twin_matches_reference_at_dense_ranks(d):
    """700 ranks (several of the reference's 256-rank windows) over 2,000
    rows, and 40 invalid rows at rank 2^30, which give zero rows (2,040
    rows: a ragged last tile of 24)."""
    p = 700
    tab = _table(p, d, seed=20 + d)
    ranks = _dense_ranks(2000, p, seed=d, n_invalid=40)
    want = np.asarray(jot.gather_sorted(jnp.asarray(tab), jnp.asarray(ranks), interpret=True))
    got = tot.gather_sorted(torch.as_tensor(tab), torch.as_tensor(ranks)).numpy()
    assert got.shape == (len(ranks), d)
    assert not got[-40:].any() and not want[-40:].any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[:-40], tab[ranks[:-40]])


def test_gather_sorted_twin_reads_past_a_rank_gap():
    """Ranks that jump from 49 to 600 inside one 256-row block: the
    reference's window (the block's first rank's 256-rank block and the
    next, ranks [0, 512) here) no longer reaches the rows past the jump
    and gives zeros there; the port gives table[rank].  Rows before the
    jump agree."""
    p = 700
    tab = _table(p, 3, seed=30)
    ranks = np.concatenate([np.repeat(np.arange(50), 2), np.repeat(np.arange(600, 650), 2)])
    ranks = ranks.astype(np.int32)  # 200 rows: one block
    want = np.asarray(jot.gather_sorted(jnp.asarray(tab), jnp.asarray(ranks), interpret=True))
    got = tot.gather_sorted(torch.as_tensor(tab), torch.as_tensor(ranks)).numpy()
    past = ranks >= 600
    np.testing.assert_allclose(got[~past], want[~past], rtol=1e-6, atol=0)
    assert not want[past].any()                       # the reference drops them
    np.testing.assert_array_equal(got[past], tab[ranks[past]])  # the port reads them
    assert np.abs(got[past]).min() > 0


def test_gather_wrappers_take_the_twin_on_the_cpu():
    """On CPU tensors the wrappers return their twins (no launch counted),
    in the table's dtype: a float64 call is the oracle."""
    before = dict(tot.LAUNCHES)
    tab = torch.as_tensor(_table(5, 4, seed=40)).double()
    idx = torch.tensor([4, 0, 5, -1, 2], dtype=torch.int32)
    for fn in (tot.gather_table, tot.gather_sorted):
        got = fn(tab, idx)
        assert got.dtype == torch.float64
        assert torch.equal(got[[0, 1, 4]], tab[[4, 0, 2]]) and not got[[2, 3]].any()
    assert tot.LAUNCHES == before
