"""Twins of the BA kernels K2-K4 (tpusfm_torch/ops/obs_table.py) and the
per-solve sort against the reference's tpusfm/ops/obs_table.py on the same
numpy inputs: a small geometrically valid BA table (orbit scene, 7
cameras), rank-sorted, with masked rows, invalid rows at rank 2^30 and a
rank gap of 200 (> 127, which the reference's span kernels could not
cover; its interpret=True delegates, the sublane kernels, cover it inside
their 512-row windows, so they are the comparison here).

Tolerances: both sides compute in float32 and sum in different orders, so
reductions agree to rtol 2e-5 plus 1e-4 of the output's largest entry
(the reference's own tests of these kernels use the same); W in float32
to the same, W in bf16 within one bf16 ulp (at most 2^-7 relative: the
float32 products differ in the last bits and may round to neighbouring
bf16 values).  The sort is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import orbit_scene
from tpusfm.core import lie as jlie
from tpusfm.ops import obs_table as jot
from tpusfm_torch.ops import obs_table as tot

torch.set_num_threads(2)

GAP = 200  # added to every rank from the 30th on


def _close(got, want, what, rtol=2e-5, atol_frac=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * scale, err_msg=what)


def _bf16_close(got, want, what):
    """Within one bf16 ulp of the larger magnitude (tiny values: 1e-6 of the scale)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ulp = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7
    tol = np.maximum(ulp, 1e-6 * np.abs(want).max())
    assert np.all(np.abs(got - want) <= tol), (what, np.abs(got - want).max())


@pytest.fixture(scope="module")
def tables():
    """K2 inputs in numpy: camtab (C, 21), intr (C, 7), pts_rank (Pt, 3),
    obs_cam, ranks (O,), obs_uvT (2, O), obs_w (O,)."""
    C, P = 7, 60
    rng = np.random.default_rng(5)
    s = orbit_scene(n_cams=C, n_points=P, noise_px=0.5, seed=5, arc_deg=200.0, vis_prob=0.9)
    o = len(s["obs_cam"])
    valid = rng.random(o) > 0.1
    key = np.where(valid, s["obs_pt"], 2 ** 30)
    order = np.argsort(key, kind="stable")
    _, dense = np.unique(s["obs_pt"][order][valid[order]], return_inverse=True)
    ranks = np.full(o, 2 ** 30, np.int64)
    ranks[: valid.sum()] = dense + np.where(dense >= 30, GAP, 0)
    n_rank = int(ranks[: valid.sum()].max()) + 1
    r2p = np.zeros(n_rank, np.int64)
    r2p[ranks[: valid.sum()]] = s["obs_pt"][order][valid[order]]
    live = np.zeros(n_rank, bool)
    live[ranks[: valid.sum()]] = True
    pose = np.concatenate([s["aa"], s["t"]], 1).astype(np.float32)
    pose[:, 3:] += rng.normal(scale=0.01, size=(C, 3)).astype(np.float32)  # off the optimum
    R = np.asarray(jlie.so3_exp(jnp.asarray(pose[:, :3])))
    Jr = np.asarray(jlie.so3_right_jacobian(jnp.asarray(pose[:, :3])))
    camtab = np.concatenate([pose[:, 3:6], R.reshape(C, 9), Jr.reshape(C, 9)], 1)
    pts_rank = np.where(live[:, None], s["points"][r2p], 0.0).astype(np.float32)
    w = valid[order].astype(np.float32)
    w[: valid.sum()][rng.random(valid.sum()) < 0.1] = 0.0  # masked rows inside the ranks
    return dict(camtab=camtab.astype(np.float32), intr=np.tile(s["intr"], (C, 1)),
                pts_rank=pts_rank, obs_cam=s["obs_cam"][order].astype(np.int32),
                ranks=ranks.astype(np.int32), obs_uvT=s["obs_uv"][order].T.copy(),
                obs_w=w, C=C, P=n_rank)


def _k2_args(t, mod):
    conv = jnp.asarray if mod is jot else torch.as_tensor
    return tuple(conv(t[k]) for k in ("camtab", "intr", "pts_rank", "obs_cam", "obs_cam",
                                      "ranks", "obs_uvT", "obs_w"))


def test_tables_have_a_rank_gap_and_invalid_rows(tables):
    r = tables["ranks"]
    live = r[r < 2 ** 30]
    assert np.diff(live).max() > 127 and (r == 2 ** 30).sum() > 10
    assert ((tables["obs_w"] == 0) & (r < 2 ** 30)).sum() > 10


@pytest.mark.parametrize("w_dtype", ["bf16", "f32"])
def test_linearize_reduce_twin_matches_reference(tables, w_dtype):
    kw = dict(refine=False, refine_mask=(0.0,) * 7, huber_delta=4.0, w_dtype=w_dtype)
    want = jot.linearize_reduce_radial3_t(*_k2_args(tables, jot), interpret=True, **kw)
    got = tot.linearize_reduce_radial3_t(*_k2_args(tables, tot), **kw)
    assert got[2].dtype == (torch.bfloat16 if w_dtype == "bf16" else torch.float32)
    camred, ptred = np.asarray(want[0]), np.asarray(want[1])
    _close(got[0][:, :21], camred[:, :21], "Hcc")
    _close(got[0][:, 21:27], camred[:, 21:27], "gc")
    _close(got[0][:, 27], camred[:, 27], "cost")
    _close(got[1][:, :6], ptred[:, :6], "Hpp")
    _close(got[1][:, 6:], ptred[:, 6:], "gp")
    live = tables["ranks"][tables["ranks"] < 2 ** 30]
    assert np.abs(ptred[live[-1]]).max() > 0  # a rank past the gap was summed
    w_want = np.asarray(jnp.asarray(want[2], jnp.float32))
    if w_dtype == "bf16":
        _bf16_close(got[2].float(), w_want, "W bf16")
    else:
        _close(got[2], w_want, "W f32")


def test_linearize_reduce_float64_twin_is_the_oracle(tables):
    """The same twin in float64 (the oracle the card's kernel is held to)
    agrees with the float32 reference at the stated tolerance."""
    kw = dict(refine=False, refine_mask=(0.0,) * 7, huber_delta=4.0, w_dtype="f32")
    want = jot.linearize_reduce_radial3_t(*_k2_args(tables, jot), interpret=True, **kw)
    args = tuple(a.double() if a.is_floating_point() else a for a in _k2_args(tables, tot))
    got = tot.linearize_reduce_radial3_t(*args, **kw)
    assert got[0].dtype == torch.float64
    _close(got[0], want[0], "camred")
    _close(got[1], want[1], "ptred")


def test_linearize_reduce_refine_mode_raises(tables):
    with pytest.raises(NotImplementedError, match="K5"):
        tot.linearize_reduce_radial3_t(*_k2_args(tables, tot), refine=True,
                                       refine_mask=(1.0,) * 7, huber_delta=4.0)


def _schur_inputs(tables, d=6, seed=0):
    r = np.random.default_rng(seed)
    O, C, P = len(tables["ranks"]), tables["C"], tables["P"]
    wT = r.normal(size=(3 * d, O)).astype(np.float32)
    wT[:, tables["obs_w"] == 0] = 0.0
    return dict(wT=wT, vtab=r.normal(size=(C, 6)).astype(np.float32),
                hinv=(0.1 * r.normal(size=(P, 3, 3))).astype(np.float32),
                hcc=r.normal(size=(C, 6, 6)).astype(np.float32),
                ztab=r.normal(size=(P, 3)).astype(np.float32))


@pytest.mark.parametrize("with_hcc", [False, True])
@pytest.mark.parametrize("w_bf16", [False, True])
def test_schur_mv_twin_matches_reference(tables, with_hcc, w_bf16):
    s = _schur_inputs(tables)
    wT = torch.as_tensor(s["wT"])
    if w_bf16:
        wT = wT.to(torch.bfloat16)
    hcc = s["hcc"] if with_hcc else None
    j_w = jnp.asarray(wT.float().numpy())  # bf16 -> f32 -> bf16 is exact
    want = jot.schur_mv_t(j_w.astype(jnp.bfloat16) if w_bf16 else j_w,
                          jnp.asarray(tables["obs_cam"]), jnp.asarray(tables["ranks"]),
                          jnp.asarray(s["vtab"]), jnp.asarray(s["hinv"]), tables["P"],
                          hcc_d=None if hcc is None else jnp.asarray(hcc), interpret=True)
    got = tot.schur_mv_t(wT, torch.as_tensor(tables["obs_cam"]), torch.as_tensor(tables["ranks"]),
                         torch.as_tensor(s["vtab"]), torch.as_tensor(s["hinv"]), tables["P"],
                         hcc_d=None if hcc is None else torch.as_tensor(hcc))
    _close(got[1], want[1], "y")
    _close(got[0], want[0], "S v" if with_hcc else "bc")


@pytest.mark.parametrize("d", [6, 7])
def test_schur_bwd_twin_matches_reference(tables, d):
    s = _schur_inputs(tables, d=d, seed=d)
    want = jot.schur_bwd_t(jnp.asarray(s["wT"]), jnp.asarray(tables["obs_cam"]),
                           jnp.asarray(tables["ranks"]), jnp.asarray(s["ztab"]), tables["C"],
                           interpret=True)
    got = tot.schur_bwd_t(torch.as_tensor(s["wT"]), torch.as_tensor(tables["obs_cam"]),
                          torch.as_tensor(tables["ranks"]), torch.as_tensor(s["ztab"]),
                          tables["C"])
    assert tuple(got.shape) == (tables["C"], d)
    _close(got, want, f"schur_bwd D={d}")


def test_schur_bwd_twin_matches_reference_kernel_body(tables):
    """Against the reference's real T-layout kernel body (interpret="kernel",
    about 5 s here), on the table's ranks made dense: its span one-hots
    cannot reach across a gap wider than 127 ranks."""
    s = _schur_inputs(tables, seed=1)
    ranks = tables["ranks"].copy()
    ranks[ranks >= 30 + GAP] -= GAP
    ranks[ranks == 2 ** 30 - GAP] = 2 ** 30
    want = jot.schur_bwd_t(jnp.asarray(s["wT"]), jnp.asarray(tables["obs_cam"]),
                           jnp.asarray(ranks), jnp.asarray(s["ztab"]), tables["C"],
                           interpret="kernel")
    got = tot.schur_bwd_t(torch.as_tensor(s["wT"]), torch.as_tensor(tables["obs_cam"]),
                          torch.as_tensor(ranks), torch.as_tensor(s["ztab"]), tables["C"])
    _close(got, want, "schur_bwd vs kernel body")


def test_sort_and_rank_payload_matches_reference():
    r = np.random.default_rng(3)
    O, P = 500, 120
    seg = r.integers(0, P, O).astype(np.int32)
    rep = r.random(O) < 0.3
    seg[rep] = r.integers(0, 40, rep.sum())  # long runs of a few ids
    valid = r.random(O) > 0.15
    pay = (r.integers(0, 1 << 20, O).astype(np.int32), r.normal(size=O).astype(np.float32))
    want = jot.sort_and_rank_payload(jnp.asarray(seg), jnp.asarray(valid), P,
                                     tuple(jnp.asarray(p) for p in pay))
    got = tot.sort_and_rank_payload(torch.as_tensor(seg), torch.as_tensor(valid), P,
                                    tuple(torch.as_tensor(p) for p in pay))
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w, name in zip(got[1:], want[1:], ("seg_sorted", "ranks", "rank_to_seg",
                                              "rank_valid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (got[2].numpy() == 2 ** 30).sum() == (~valid).sum()


def test_layout_covers_every_row_once(tables):
    ranks = torch.as_tensor(tables["ranks"])
    lay = tot.obs_layout(torch.as_tensor(tables["obs_cam"]), tables["C"], ranks, tables["P"])
    rs = lay.rank_start.numpy()
    for p in (0, 29, 30 + GAP, tables["P"] - 1):
        np.testing.assert_array_equal(tables["ranks"][rs[p]:rs[p + 1]], p)
    assert rs[tables["P"]] == (tables["ranks"] < 2 ** 30).sum()
    perm, st = lay.seg_perm.numpy(), lay.seg_start.numpy()
    assert sorted(perm.tolist()) == list(range(len(perm)))
    for c in range(tables["C"]):
        rows = perm[st[c]:st[c + 1]]
        assert (np.diff(rows) > 0).all() and (tables["obs_cam"][rows] == c).all()
