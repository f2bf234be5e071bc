"""K6 (`segsum_table_t`) takes its (k, O) table in two storage layouts:
row-major, the (k, O) view `x.T` of a contiguous (O, k) table, which the
BA path's producers hold, and lane-major, a contiguous (k, O) table, which
K2's unreduced mode writes.  Both go through the port's wrapper and are held
against the reference's `segsum_table_t` (Pallas in interpret mode) on the
same numpy values, with ids outside [0, n) (-1 and n + 3) and an empty
segment.  The layout rule the card path applies is checked on its own.

Tolerance: that of test_torch_obs_table.py's
test_segsum_table_twin_matches_reference_with_out_of_range_ids: both sides
sum float32 values in different orders, so rtol 2e-5 plus 1e-4 of the
output's largest entry."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusfm.ops import obs_table as jot
from tpusfm_torch.ops import obs_table as tot

torch.set_num_threads(2)

O, N, EMPTY = 700, 9, 4  # rows, segments, the segment no row belongs to


@functools.lru_cache(maxsize=None)
def _case(k):
    """(vals (k, O) float32, idx (O,) int32, the reference's sums (N, k))."""
    r = np.random.default_rng(20 + k)
    vals = r.normal(size=(k, O)).astype(np.float32)
    idx = r.integers(0, N, O).astype(np.int32)
    idx[idx == EMPTY] = EMPTY + 1
    idx[r.random(O) < 0.05] = -1
    idx[r.random(O) < 0.05] = N + 3
    want = np.asarray(jot.segsum_table_t(jnp.asarray(vals), jnp.asarray(idx), N, interpret=True))
    return vals, idx, want


def _table(vals, layout):
    """vals (k, O) as a torch table stored row-major (a view) or lane-major."""
    if layout == "row-major":
        return torch.as_tensor(np.ascontiguousarray(vals.T)).T
    return torch.as_tensor(vals)


@pytest.mark.parametrize("layout", ["row-major", "lane-major"])
@pytest.mark.parametrize("k", [1, 33, 96])
def test_segsum_table_layouts_match_reference(k, layout):
    vals, idx, want = _case(k)
    t = _table(vals, layout)
    assert tot.segsum_lane_major(t) == (layout == "lane-major" and k > 1)
    got = tot.segsum_table_t(t, torch.as_tensor(idx), N).numpy()
    assert got.shape == (N, k)
    assert not np.any(got[EMPTY]) and not np.any(want[EMPTY])
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=2e-5,
                               atol=1e-4 * scale, err_msg=f"segsum_table_t k={k} {layout}")


def _strided(name):
    x = torch.zeros((50, 96))
    return {"sliced row-major view": x.T[:36],       # strides (1, 96) for k = 36
            "every other row": x.T[:, ::2],         # strides (1, 192)
            "every other lane": x.T.contiguous()[::2]}[name]  # strides (2 * 50, 1)


@pytest.mark.parametrize("name", ["sliced row-major view", "every other row",
                                  "every other lane"])
def test_segsum_layout_rule_refuses_other_strides(name):
    with pytest.raises(ValueError, match="strides"):
        tot.segsum_lane_major(_strided(name))


def test_segsum_layout_rule_reads_single_row_and_single_lane_tables_in_place():
    """A table of one value per row, or of one row, has one memory order for
    both layouts, so the card reads it in place."""
    for t in (torch.zeros((1, 50)), torch.zeros((50, 1)).T, torch.zeros((7, 1)),
              torch.zeros((1, 7)).T):
        assert not tot.segsum_lane_major(t)
