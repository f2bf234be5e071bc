"""The segment order of the BA kernel path (tpusfm_torch/ops/obs_table.py):
the layout's ranks in segment order and its identity flag, K4's twin fed W
in segment order, K2's camera-ordered copy of W, and K2's rows of weight 0,
on the seeded tables of test_torch_obs_table.py (masked rows, invalid rows
at rank 2^30, a rank gap of 200) and on those tables padded as the engine
pads them.  Tolerances as in test_torch_obs_table.py: float32 sums in
different orders agree to rtol 2e-5 plus 1e-4 of the output's largest
entry; a permutation of W and the ordered copy are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_obs_table import _close, _engine_padded, _k2_args, _schur_inputs, tables  # noqa: F401
from tpusfm.ops import obs_table as jot
from tpusfm_torch.ops import obs_table as tot

torch.set_num_threads(2)


def _layout(t, ids=None, n=None):
    return tot.obs_layout(torch.as_tensor(t["obs_cam"] if ids is None else ids),
                          t["C"] if n is None else n, torch.as_tensor(t["ranks"]), t["P"])


def test_layout_holds_ranks_in_segment_order_and_flags_the_identity(tables):
    """seg_ranks = ranks[seg_perm] on a table with invalid rows and a rank
    gap; the camera permutation is not the identity, one group's is, and
    so is one whose out-of-range ids trail the table, but not one with an
    out-of-range id among its rows; the arrival counters start at zero."""
    lay = _layout(tables)
    perm = lay.seg_perm.numpy()
    np.testing.assert_array_equal(lay.seg_ranks.numpy(), tables["ranks"][perm])
    assert (lay.seg_ranks.numpy() == 2 ** 30).sum() > 10
    assert not lay.in_seg_order
    assert lay.arrivals.dtype == torch.int32 and tuple(lay.arrivals.shape) == (tables["C"],)
    assert not lay.arrivals.any()
    O = len(tables["ranks"])
    one = _layout(tables, np.zeros(O, np.int32), 1)
    assert one.in_seg_order
    np.testing.assert_array_equal(one.seg_perm.numpy(), np.arange(O))
    np.testing.assert_array_equal(one.seg_ranks.numpy(), tables["ranks"])
    trailing = np.zeros(O, np.int32)
    trailing[-5:] = 3
    assert _layout(tables, trailing, 1).in_seg_order
    inner = np.zeros(O, np.int32)
    inner[O // 2] = -1
    assert not _layout(tables, inner, 1).in_seg_order


@pytest.mark.parametrize("storage", ["lane-major", "row-major"])
@pytest.mark.parametrize("table", ["orbit", "engine_padded"])
@pytest.mark.parametrize("d", [6, 7])
def test_schur_bwd_in_segment_order_matches_permuted_and_reference(tables, d, table, storage):
    """K4 fed W in camera order (lane-major, or the (3D, O) view of a
    row-major table) with the layout's seg_ranks equals K4 on the table's
    own order and the reference's schur_bwd_t (interpret path), at the
    tolerance of test_schur_bwd_twin_matches_reference."""
    t = _engine_padded(tables) if table == "engine_padded" else tables
    s = _schur_inputs(t, d=d, seed=d)
    wT, cam, ranks = (torch.as_tensor(s["wT"]), torch.as_tensor(t["obs_cam"]),
                      torch.as_tensor(t["ranks"]))
    z = torch.as_tensor(s["ztab"])
    lay = _layout(t)
    perm = lay.seg_perm.long()
    w_seg = wT[:, perm].contiguous() if storage == "lane-major" else wT.T[perm].contiguous().T
    got = tot.schur_bwd_t(wT, cam, ranks, z, t["C"], layout=lay, w_seg=w_seg)
    permuted = tot.schur_bwd_t(wT, cam, ranks, z, t["C"], layout=lay)
    want = jot.schur_bwd_t(jnp.asarray(s["wT"]), jnp.asarray(t["obs_cam"]),
                           jnp.asarray(t["ranks"]), jnp.asarray(s["ztab"]), t["C"],
                           interpret=True)
    assert tuple(got.shape) == (t["C"], d)
    _close(got, permuted, f"schur_bwd D={d} ordered vs permuted")
    _close(got, want, f"schur_bwd D={d} ordered vs reference")


def test_schur_bwd_refuses_an_ordered_w_without_its_layout(tables):
    s = _schur_inputs(tables)
    wT = torch.as_tensor(s["wT"])
    args = (wT, torch.as_tensor(tables["obs_cam"]), torch.as_tensor(tables["ranks"]),
            torch.as_tensor(s["ztab"]), tables["C"])
    with pytest.raises(ValueError, match="w_seg"):
        tot.schur_bwd_t(*args, w_seg=wT)
    lay = tot.obs_layout(torch.as_tensor(tables["obs_cam"]), tables["C"])
    with pytest.raises(ValueError, match="w_seg"):
        tot.schur_bwd_t(*args, layout=lay, w_seg=wT)


_MODES = {"held": dict(refine=False, refine_mask=(0.0,) * 7),
          "refine": dict(refine=True, refine_mask=(1.0,) * 7)}


@pytest.mark.parametrize("w_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("mode", list(_MODES))
def test_linearize_reduce_segment_ordered_copy_is_wct_permuted(tables, mode, w_dtype):
    """K2 with seg_ordered_w returns its outputs unchanged and then wcT in
    camera order, wcT[:, seg_perm], exactly."""
    kw = dict(_MODES[mode], huber_delta=4.0, w_dtype=w_dtype)
    args = _k2_args(tables, tot)
    plain = tot.linearize_reduce_radial3_t(*args, **kw)
    got = tot.linearize_reduce_radial3_t(*args, **kw, seg_ordered_w=True)
    assert len(got) == len(plain) + 1
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    perm = _layout(tables).seg_perm.long()
    assert got[-1].dtype == got[2].dtype and torch.equal(got[-1], got[2][:, perm])


@pytest.mark.parametrize("mode", list(_MODES))
def test_zero_weight_rows_change_no_linearize_reduce_output(tables, mode):
    """A row of weight exactly 0 gives exact zeros in every per-row value
    (Jacobian products, residual products, cost, W), which is why K2's
    passes may skip its math; so the tables without those rows give the
    same sums, and the same W for the rows that stay."""
    kw = dict(_MODES[mode], huber_delta=4.0, w_dtype="f32")
    args = _k2_args(tables, tot)
    w = tables["obs_w"]
    zero = w == 0
    assert zero.sum() > 10 and ((w == 0) & (tables["ranks"] < 2 ** 30)).sum() > 10
    rows = tot._linearize_rows(*args, kw["refine"], kw["refine_mask"], 4.0, packed=True)
    for vals in rows:
        assert not bool(vals[torch.as_tensor(zero)].any())
    keep = torch.as_tensor(~zero)
    kept = args[:3] + tuple(a[keep] for a in args[3:6]) + (args[6][:, keep], args[7][keep])
    full = tot.linearize_reduce_radial3_t(*args, **kw)
    less = tot.linearize_reduce_radial3_t(*kept, **kw)
    for i, (a, b) in enumerate(zip(full, less)):
        if i in (2, 4):  # W tables: the kept rows' columns
            assert torch.equal(a[:, keep], b)
        else:
            assert torch.equal(a, b), i
