"""The segment layout of the BA kernel path (tpusfm_torch/ops/obs_table.py
seg_layout and obs_layout; csrc/ba_layout.cu on the card): its plain twin
against numpy's stable argsort on edge cases, the kernel's block plan, the
rank parts of obs_layout, and the sublane segsum_table and schur_bwd,
which build their own layout, against the reference's at interpret=True.

The layout is exact (a permutation and integer scans).  The sublane sums
use test_torch_obs_table.py's tolerance: float32 sums in different orders
agree to rtol 2e-5 plus 1e-4 of the output's largest entry.  The kernel
itself runs only on the card: tests/test_torch_cuda.py holds it bit-equal
to this twin on the same cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_obs_table import _close, _dense_ranks, _schur_inputs, tables  # noqa: F401
from torch_layout_cases import layout_cases, numpy_layout
from tpusfm.ops import obs_table as jot
from tpusfm_torch.ops import obs_table as tot

torch.set_num_threads(2)


@pytest.mark.parametrize("case", range(len(layout_cases())),
                         ids=[c[0] for c in layout_cases()])
def test_twin_matches_numpy_stable_argsort(case):
    name, ids, n = layout_cases()[case]
    got = tot.seg_layout(torch.as_tensor(ids), n)
    want = numpy_layout(ids, n)
    shapes = [(len(ids),), (n + 1,), (n + 1,), (n,), (1,)]
    for g, w, shape, part in zip(got, want, shapes, ("seg_perm", "seg_start", "chunk_start",
                                                      "arrivals", "in_order")):
        assert g.dtype == torch.int32 and tuple(g.shape) == shape, (name, part)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{name}: {part}")
    lay = tot.obs_layout(torch.as_tensor(ids), n)
    assert torch.equal(lay.seg_perm, got[0]) and torch.equal(lay.in_seg_order, got[4])


def test_the_flag_of_a_chunked_segment():
    """A segment of more than CHUNK_ROWS rows: three chunks; the flag is
    the identity test, whatever the chunks."""
    ids = np.zeros(2 * tot.CHUNK_ROWS + 5, np.int32)
    perm, seg_start, chunk_start, _, flag = tot.seg_layout(torch.as_tensor(ids), 2)
    assert chunk_start.tolist() == [0, 3, 3] and seg_start.tolist() == [0, len(ids), len(ids)]
    assert flag.tolist() == [1] and torch.equal(perm, torch.arange(len(ids), dtype=torch.int32))


def test_obs_layout_carries_ranks_in_segment_order(tables):
    """seg_ranks = ranks[seg_perm] and rank_start by searchsorted, as
    before, beside the twin's segments."""
    ranks = torch.as_tensor(tables["ranks"])
    cam = torch.as_tensor(tables["obs_cam"])
    lay = tot.obs_layout(cam, tables["C"], ranks, tables["P"])
    for got, want in zip((lay.seg_perm, lay.seg_start, lay.chunk_start, lay.arrivals,
                          lay.in_seg_order), tot.seg_layout_reference(cam, tables["C"])):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(lay.seg_ranks.numpy(), tables["ranks"][lay.seg_perm.numpy()])
    np.testing.assert_array_equal(lay.rank_start.numpy(),
                                  np.searchsorted(tables["ranks"], np.arange(tables["P"] + 1)))
    assert not bool(lay.in_seg_order)


@pytest.mark.parametrize("n", [0, 1, 7, 500, 1535, 1536, 5000, 12287, 32767, 32768])
@pytest.mark.parametrize("O", [1, 31, 32768, 1484375])
def test_layout_plan_fits_the_block_and_counts_no_more_than_the_rows(n, O):
    """The kernel's blocks: 1-8 warps whose offsets fit 48 KB of shared
    memory (one warp may take up to 128 KB), rows a warp a multiple of 32,
    and at least n + 1 rows a block, so the per-block counts number at most
    O + n + 1; the tile is staged in shared memory when the offsets, the
    bucket starts and two ints a row fit in 160 KB (always up to n = 1535),
    and the kernel's limit of 200 KB holds either way."""
    warps, warp_rows, tiles, staged = tot._layout_plan(n, O)
    m = n + 1
    assert 1 <= warps <= 8 and warp_rows % 32 == 0
    assert warps * m * 4 <= max(48 * 1024, m * 4) <= 200 * 1024
    assert warps == 8 or warps * m * 4 > 48 * 1024 - m * 4
    assert warps * warp_rows >= m and tiles == -(-O // (warps * warp_rows))
    assert tiles * m <= O + m
    smem = 4 * ((warps + 1) * m + 2 * warps * warp_rows) if staged else 4 * warps * m
    assert smem <= 200 * 1024 and (staged or n > 1535)


@pytest.mark.parametrize("ids", ["sorted", "one segment"])
@pytest.mark.parametrize("d", [6, 9])
def test_sublane_segsum_table_on_ordered_ids_matches_reference(tables, ids, d):
    """segsum_table when the ids are already in segment order (the layout's
    flag set), camera-sorted or all one segment, against the reference's
    sublane segsum_table at interpret=True."""
    n = tables["C"] if ids == "sorted" else 1
    idx = np.sort(tables["obs_cam"]) if ids == "sorted" else np.zeros_like(tables["obs_cam"])
    assert bool(tot.obs_layout(torch.as_tensor(idx), n).in_seg_order)
    vals = np.random.default_rng(130 + d).normal(size=(len(idx), d)).astype(np.float32)
    want = jot.segsum_table(jnp.asarray(vals), jnp.asarray(idx), n, interpret=True)
    got = tot.segsum_table(torch.as_tensor(vals), torch.as_tensor(idx), n)
    assert tuple(got.shape) == (n, d)
    _close(got, want, f"segsum_table {ids} D={d}")


@pytest.mark.parametrize("w_bf16", [False, True])
@pytest.mark.parametrize("d", [6, 7])
def test_sublane_schur_bwd_on_one_group_matches_reference(tables, d, w_bf16):
    """schur_bwd over one group (every id 0 but a few outside, dropped),
    the self-calibrating BA's group table, against the reference's sublane
    schur_bwd at interpret=True."""
    s = _schur_inputs(tables, d=d, seed=140 + d)
    ranks = _dense_ranks(tables)
    Pz = int(ranks[ranks < 2 ** 30].max()) + 1
    grp = np.zeros(len(ranks), np.int32)
    grp[::37] = 1
    ztab = np.random.default_rng(150 + d).normal(size=(Pz, 3)).astype(np.float32)
    w = torch.as_tensor(s["wT"].T.copy())
    if w_bf16:
        w = w.to(torch.bfloat16)
    jw = jnp.asarray(w.float().numpy())  # bf16 -> f32 -> bf16 is exact
    jw = jw.astype(jnp.bfloat16) if w_bf16 else jw
    want = jot.schur_bwd(jw, jnp.asarray(grp), jnp.asarray(ranks), jnp.asarray(ztab), 1,
                         interpret=True)
    got = tot.schur_bwd(w, torch.as_tensor(grp), torch.as_tensor(ranks), torch.as_tensor(ztab), 1)
    assert tuple(got.shape) == (1, d)
    _close(got, want, f"schur_bwd one group D={d}")
