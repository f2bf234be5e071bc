"""Twins of the BA kernels K2-K7 (tpusfm_torch/ops/obs_table.py) and the
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


@pytest.mark.parametrize("mask", ["all", "focal"])
def test_linearize_reduce_refine_twin_matches_reference(tables, mask):
    """Refine mode: camred (C, 70), grpred (G, 35), W and Wg against the
    reference's refine=True delegate; with the "focal" mask every lane past
    fy is exactly zero in Hcg, Hgg, gg and Wg, as the reference's multiply
    by the mask makes it."""
    rm = (1.0,) * 7 if mask == "all" else (1.0, 1.0) + (0.0,) * 5
    kw = dict(refine=True, refine_mask=rm, huber_delta=4.0, w_dtype="f32")
    want = jot.linearize_reduce_radial3_t(*_k2_args(tables, jot), interpret=True, **kw)
    got = tot.linearize_reduce_radial3_t(*_k2_args(tables, tot), **kw)
    assert tuple(got[0].shape) == (tables["C"], 70) and tuple(got[3].shape) == (tables["C"], 35)
    for g, w, name in zip(got, want, ("camred", "ptred", "wcT", "grpred", "wgT")):
        _close(g, w, name)
    if mask == "focal":
        hcg = got[0][:, 27:69].reshape(-1, 6, 7)
        assert torch.all(hcg[:, :, 2:] == 0) and torch.any(hcg[:, :, :2] != 0)
        hgg_free = [k for k, (i, j) in enumerate((i, j) for i in range(7) for j in range(i, 7))
                    if i < 2 and j < 2]
        assert torch.all(torch.cat([got[3][:, [k for k in range(28) if k not in hgg_free]],
                                    got[3][:, 30:]], 1) == 0)
        assert torch.all(got[4][6:] == 0)


def test_linearize_reduce_refine_float64_twin_is_the_oracle(tables):
    kw = dict(refine=True, refine_mask=(1.0,) * 7, huber_delta=4.0, w_dtype="f32")
    want = jot.linearize_reduce_radial3_t(*_k2_args(tables, jot), interpret=True, **kw)
    args = tuple(a.double() if a.is_floating_point() else a for a in _k2_args(tables, tot))
    got = tot.linearize_reduce_radial3_t(*args, **kw)
    assert got[3].dtype == torch.float64
    for i, name in ((0, "camred"), (3, "grpred")):
        _close(got[i], want[i], name)


def _schur_inputs(tables, d=6, seed=0):
    r = np.random.default_rng(seed)
    O, C, P = len(tables["ranks"]), tables["C"], tables["P"]
    wT = r.normal(size=(3 * d, O)).astype(np.float32)
    wT[:, tables["obs_w"] == 0] = 0.0
    return dict(wT=wT, vtab=r.normal(size=(C, 6)).astype(np.float32),
                hinv=(0.1 * r.normal(size=(P, 3, 3))).astype(np.float32),
                hcc=r.normal(size=(C, 6, 6)).astype(np.float32),
                ztab=r.normal(size=(P, 3)).astype(np.float32))


def _engine_padded(tables, n_pad=tot.CHUNK_ROWS + 100):
    """The tables with n_pad rows appended on camera 0 at rank 2^30, as the
    engine pads its observation table: camera 0's segment then spans more
    than one CHUNK_ROWS chunk, and its rows past the first chunk sit in the
    invalid-rank tail.  Their weight is 1, so W is not zero there."""
    t = dict(tables)
    t["obs_cam"] = np.concatenate([tables["obs_cam"], np.zeros(n_pad, np.int32)])
    t["ranks"] = np.concatenate([tables["ranks"], np.full(n_pad, 2 ** 30, np.int32)])
    t["obs_w"] = np.concatenate([tables["obs_w"], np.ones(n_pad, np.float32)])
    assert (t["obs_cam"] == 0).sum() > tot.CHUNK_ROWS
    return t


# The orbit table's cases keep their ids; the engine-padded ones add a suffix.
_SCHUR_MV_CASES = [pytest.param(w_bf16, with_hcc, table, id=f"{w_bf16}-{with_hcc}{suffix}")
                   for table, suffix in (("orbit", ""), ("engine_padded", "-engine_padded"))
                   for w_bf16 in (False, True) for with_hcc in (False, True)]


@pytest.mark.parametrize("w_bf16,with_hcc,table", _SCHUR_MV_CASES)
def test_schur_mv_twin_matches_reference(tables, with_hcc, w_bf16, table):
    if table == "engine_padded":
        tables = _engine_padded(tables)
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


def _dense_ranks(tables):
    """The table's ranks with the gap closed: the reference's span kernels
    (interpret=True runs them for K5) cannot reach across a gap wider than
    127 ranks."""
    ranks = tables["ranks"].copy()
    ranks[ranks >= 30 + GAP] -= GAP
    ranks[ranks == 2 ** 30 - GAP] = 2 ** 30
    return ranks


@pytest.mark.parametrize("d", [6, 7, 9])
def test_schur_fwd_twin_against_reference(tables, d):
    """K5's twin sums W^T v over all D rows of W.  The reference's kernel
    sums only the first six (tpusfm/ops/obs_table.py:1811-1815): at D = 6
    the two agree; at D = 7 and 9 the port equals the reference plus the
    lanes it drops, computed here in float64, which pins the deviation.
    Tolerance: float32 sums in different orders (module docstring)."""
    s = _schur_inputs(tables, d=d, seed=10 + d)
    ranks = _dense_ranks(tables)
    P = int(ranks[ranks < 2 ** 30].max()) + 1
    vtab = np.random.default_rng(d).normal(size=(tables["C"], d)).astype(np.float32)
    want = np.asarray(jot.schur_fwd_t(jnp.asarray(s["wT"]), jnp.asarray(tables["obs_cam"]),
                                      jnp.asarray(ranks), jnp.asarray(vtab), P, interpret=True))
    got = tot.schur_fwd_t(torch.as_tensor(s["wT"]), torch.as_tensor(tables["obs_cam"]),
                          torch.as_tensor(ranks), torch.as_tensor(vtab), P)
    assert tuple(got.shape) == (P, 3)
    W = s["wT"].astype(np.float64).reshape(d, 3, -1)
    live = ranks < P
    dropped = np.einsum("dko,od->ok", W[6:], vtab[tables["obs_cam"]].astype(np.float64)[:, 6:])
    extra = np.zeros((P, 3))
    np.add.at(extra, ranks[live], dropped[live])
    if d > 6:
        assert np.abs(extra).max() > 1.0  # the dropped lanes are not negligible
    _close(got, want + extra, f"schur_fwd D={d}")


def test_segsum_table_twin_matches_reference_with_out_of_range_ids():
    r = np.random.default_rng(11)
    O, n, k = 700, 9, 42
    vals = r.normal(size=(k, O)).astype(np.float32)
    idx = r.integers(0, n, O).astype(np.int32)
    idx[r.random(O) < 0.05] = -1
    idx[r.random(O) < 0.05] = n + 3
    want = jot.segsum_table_t(jnp.asarray(vals), jnp.asarray(idx), n, interpret=True)
    got = tot.segsum_table_t(torch.as_tensor(vals), torch.as_tensor(idx), n)
    assert tuple(got.shape) == (n, k)
    _close(got, want, "segsum_table_t")


def test_segsum_sorted_twin_matches_reference_at_dense_ranks(tables):
    ranks = _dense_ranks(tables)
    P = int(ranks[ranks < 2 ** 30].max()) + 1
    vals = np.random.default_rng(12).normal(size=(12, len(ranks))).astype(np.float32)
    want = jot.segsum_sorted_t(jnp.asarray(vals), jnp.asarray(ranks), P, interpret=True)
    got = tot.segsum_sorted_t(torch.as_tensor(vals), torch.as_tensor(ranks), P)
    _close(got, want, "segsum_sorted_t")


def test_segsum_sorted_twin_sums_across_a_rank_gap(tables):
    """Ranks with the gap of 200 (and invalid rows at 2^30) against numpy in
    float64: rows past the gap are summed, rows at ranks >= p dropped."""
    ranks, P = tables["ranks"], tables["P"]
    vals = np.random.default_rng(13).normal(size=(12, len(ranks))).astype(np.float32)
    got = tot.segsum_sorted_t(torch.as_tensor(vals), torch.as_tensor(ranks), P)
    want = np.zeros((P, 12))
    live = ranks < P
    np.add.at(want, ranks[live], vals.T[live].astype(np.float64))
    assert np.abs(want[ranks[live][-1]]).max() > 0
    _close(got, want, "segsum_sorted_t across the gap")


def test_layout_chunks_cut_each_segment_in_order():
    """The two-level sums' chunk numbering: segment c owns
    ceil(rows_c / CHUNK_ROWS) consecutive chunks (none when empty), and the
    bound covers them all."""
    r = np.random.default_rng(14)
    n, big = 5, tot.CHUNK_ROWS * 2 + 17
    ids = np.concatenate([np.zeros(big, np.int32), r.integers(2, n, 300).astype(np.int32),
                          np.full(7, n + 1, np.int32)])
    r.shuffle(ids)
    lay = tot.obs_layout(torch.as_tensor(ids), n)
    counts = np.bincount(ids[ids < n], minlength=n)
    assert counts[1] == 0
    np.testing.assert_array_equal(
        lay.chunk_start.numpy(),
        np.concatenate([[0], np.cumsum(-(-counts // tot.CHUNK_ROWS))]))
    assert lay.chunk_start[-1] <= lay.chunk_bound


# K2's unreduced mode: full row-major blocks, one column per row.
_UNRED = {"held": (False, (0.0,) * 7), "all": (True, (1.0,) * 7),
          "focal": (True, (1.0, 1.0) + (0.0,) * 5)}


@pytest.mark.parametrize("w_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", list(_UNRED))
def test_linearize_unreduced_twin_matches_reference(tables, mode, w_dtype):
    """The unreduced twin against the reference's linearize_radial3_t
    (interpret=True runs its sublane kernels, whose 512-row windows cover
    the gap of 200): unpacked widths 43/85, 12, 18, 56, 21, W in w_dtype."""
    refine, rm = _UNRED[mode]
    kw = dict(refine=refine, refine_mask=rm, huber_delta=4.0, w_dtype=w_dtype)
    want = jot.linearize_radial3_t(*_k2_args(tables, jot), interpret=True, **kw)
    got = tot.linearize_radial3_t(*_k2_args(tables, tot), **kw)
    O = len(tables["ranks"])
    widths = (85, 12, 18, 56, 21) if refine else (43, 12, 18)
    assert len(got) == len(want) == len(widths)
    for g, w, k, name in zip(got, want, widths, ("camvals", "ptvals", "wc", "grpvals", "wg")):
        assert tuple(g.shape) == (k, O), name
        if name in ("wc", "wg") and w_dtype == "bf16":
            assert g.dtype == torch.bfloat16
            _bf16_close(g.float(), np.asarray(jnp.asarray(w, jnp.float32)), name)
        else:
            _close(g, w, name)
    if mode == "focal":  # masked lanes are exact zeros in Hcg, Hgg, gg and Wg
        assert torch.all(got[0][42:84].reshape(6, 7, -1)[:, 2:] == 0)
        assert torch.all(got[3][:49].reshape(7, 7, -1)[2:] == 0)
        assert torch.all(got[3][49 + 2:] == 0) and torch.all(got[4][6:] == 0)


def test_linearize_radial3_is_the_transpose(tables):
    """The sublane-layout entry point: obs_uv (O, 2) in, (O, k) tables
    out, the transposes of linearize_radial3_t's, and equal to the
    reference's linearize_radial3."""
    kw = dict(refine=True, refine_mask=(1.0,) * 7, huber_delta=4.0, w_dtype="f32")
    args = list(_k2_args(tables, tot))
    args[6] = args[6].T
    got = tot.linearize_radial3(*args, **kw)
    t_layout = tot.linearize_radial3_t(*_k2_args(tables, tot), **kw)
    jargs = list(_k2_args(tables, jot))
    jargs[6] = jargs[6].T
    want = jot.linearize_radial3(*jargs, interpret=True, **kw)
    for g, t, w in zip(got, t_layout, want):
        assert torch.equal(g, t.T)
        _close(g, w, "sublane layout")


def test_linearize_unreduced_float64_twin_is_the_oracle(tables):
    kw = dict(refine=True, refine_mask=(1.0,) * 7, huber_delta=4.0, w_dtype="f32")
    want = jot.linearize_radial3_t(*_k2_args(tables, jot), interpret=True, **kw)
    args = tuple(a.double() if a.is_floating_point() else a for a in _k2_args(tables, tot))
    got = tot.linearize_radial3_t(*args, **kw)
    assert got[0].dtype == got[1].dtype == got[3].dtype == torch.float64
    for i, name in ((0, "camvals"), (1, "ptvals"), (3, "grpvals")):
        _close(got[i], want[i], name)


@pytest.mark.parametrize("mode", ["held", "all"])
def test_unreduced_tables_reduced_by_k6_k7_equal_the_reduced_mode(tables, mode):
    """K6 (per camera, per group) and K7 (per rank) over the unreduced
    tables give the reduced mode's packed sums: the full blocks equal the
    packed ones through _FULL66/_FULL33/_FULL77 (the reference's
    tests/test_obs_table.py:147-196, with its tolerance)."""
    refine, rm = _UNRED[mode]
    kw = dict(refine=refine, refine_mask=rm, huber_delta=4.0, w_dtype="f32")
    args = _k2_args(tables, tot)
    cam, ranks, C, P = args[3], args[5], tables["C"], tables["P"]
    vals = tot.linearize_radial3_t(*args, **kw)
    red = tot.linearize_reduce_radial3_t(*args, **kw)
    camred = tot.segsum_table_t(vals[0], cam, C)
    ptred = tot.segsum_sorted_t(vals[1], ranks, P)
    full66, full33, full77 = (list(f) for f in (tot._FULL66, tot._FULL33, tot._FULL77))
    close = dict(rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(red[0][:, full66].numpy(), camred[:, :36].numpy(), **close)
    np.testing.assert_allclose(red[0][:, 21:27].numpy(), camred[:, 36:42].numpy(), **close)
    np.testing.assert_allclose(red[0][:, -1].numpy(), camred[:, -1].numpy(), **close)
    np.testing.assert_allclose(red[1][:, full33].numpy(), ptred[:, :9].numpy(), **close)
    np.testing.assert_allclose(red[1][:, 6:].numpy(), ptred[:, 9:].numpy(), **close)
    assert torch.equal(red[2], vals[2])
    if refine:
        np.testing.assert_allclose(red[0][:, 27:69].numpy(), camred[:, 42:84].numpy(), **close)
        grpred = tot.segsum_table_t(vals[3], cam, C)
        np.testing.assert_allclose(red[3][:, full77].numpy(), grpred[:, :49].numpy(), **close)
        np.testing.assert_allclose(red[3][:, 28:].numpy(), grpred[:, 49:].numpy(), **close)
        assert torch.equal(red[4], vals[4])


# The reference's sublane entry points (row-major (O, k) tables): the port's
# wrappers launch K6, K7, K5 and K4 on the (k, O) view; on the CPU they
# take the twins.  Same tolerance as above (float32 sums in other orders).

def _masked_ids(ids, n, seed):
    """ids with about 5% set to -1 and 5% set past n (both dropped)."""
    r = np.random.default_rng(seed)
    ids = ids.copy()
    ids[r.random(len(ids)) < 0.05] = -1
    ids[r.random(len(ids)) < 0.05] = n + 3
    assert (ids < 0).any() and (ids >= n).any()
    return ids


@pytest.mark.parametrize("d", [6, 7, 9])
def test_sublane_segsum_table_matches_reference(tables, d):
    n = tables["C"]
    idx = _masked_ids(tables["obs_cam"], n, 20 + d)
    vals = np.random.default_rng(d).normal(size=(len(idx), d)).astype(np.float32)
    want = jot.segsum_table(jnp.asarray(vals), jnp.asarray(idx), n, interpret=True)
    got = tot.segsum_table(torch.as_tensor(vals), torch.as_tensor(idx), n)
    assert tuple(got.shape) == (n, d)
    _close(got, want, f"segsum_table D={d}")


@pytest.mark.parametrize("d", [6, 7, 9])
def test_sublane_segsum_sorted_matches_reference(tables, d):
    """The table's ranks (a gap of 200 inside the reference's 512-row
    windows, invalid rows at 2^30) with p cut below the largest rank, so
    rows at ranks >= p are dropped."""
    ranks, p = tables["ranks"], tables["P"] - 3
    assert (ranks[ranks < 2 ** 30] >= p).any()
    vals = np.random.default_rng(30 + d).normal(size=(len(ranks), d)).astype(np.float32)
    want = jot.segsum_sorted(jnp.asarray(vals), jnp.asarray(ranks), p, interpret=True)
    got = tot.segsum_sorted(torch.as_tensor(vals), torch.as_tensor(ranks), p)
    assert tuple(got.shape) == (p, d)
    _close(got, want, f"segsum_sorted D={d}")


# f32 at every D, bf16 W (the BA's w_dtype) at D = 9.
_SUBLANE_W = [pytest.param(d, b, id=f"{d}-{'bf16' if b else 'f32'}")
              for d, b in ((6, False), (7, False), (9, False), (9, True))]


@pytest.mark.parametrize("d,w_bf16", _SUBLANE_W)
def test_sublane_schur_fwd_matches_reference_every_lane(tables, d, w_bf16):
    """The reference's sublane schur_fwd sums every lane of W (its kernels
    loop over all D rows), so the port's wrapper, whose K5 sums every lane,
    equals it at D = 7 and 9 as at 6; the reference's own schur_fwd_t drops
    the lanes past the sixth on the same inputs (ROADMAP queue 3)."""
    s = _schur_inputs(tables, d=d, seed=40 + d)
    ranks = _dense_ranks(tables)
    P = int(ranks[ranks < 2 ** 30].max()) + 1
    cam = _masked_ids(tables["obs_cam"], tables["C"], 50 + d)
    vtab = np.random.default_rng(60 + d).normal(size=(tables["C"], d)).astype(np.float32)
    w = torch.as_tensor(s["wT"].T.copy())
    if w_bf16:
        w = w.to(torch.bfloat16)
    jw = jnp.asarray(w.float().numpy())  # bf16 -> f32 -> bf16 is exact
    jw = jw.astype(jnp.bfloat16) if w_bf16 else jw
    jargs = (jnp.asarray(cam), jnp.asarray(ranks), jnp.asarray(vtab), P)
    want = np.asarray(jot.schur_fwd(jw, *jargs, interpret=True))
    got = tot.schur_fwd(w, torch.as_tensor(cam), torch.as_tensor(ranks), torch.as_tensor(vtab), P)
    assert tuple(got.shape) == (P, 3)
    _close(got, want, f"schur_fwd D={d}")
    lane_t = np.asarray(jot.schur_fwd_t(jw.T, *jargs, interpret=True))
    if d > 6:
        assert np.abs(lane_t - want).max() > 1.0  # the _t kernel's dropped lanes
    else:
        _close(lane_t, want, "schur_fwd_t D=6")


@pytest.mark.parametrize("d,w_bf16", _SUBLANE_W)
def test_schur_fwd_t_takes_the_view_of_a_row_major_table(tables, d, w_bf16):
    """schur_fwd_t on the (3D, O) view `w.T` of a row-major (O, 3D) table,
    the form the sublane schur_fwd passes (K5 reads it in place on the
    card), equals its result on the contiguous transpose; schur_fwd equals
    both."""
    s = _schur_inputs(tables, d=d, seed=100 + d)
    ranks = torch.as_tensor(tables["ranks"])
    cam = torch.as_tensor(_masked_ids(tables["obs_cam"], tables["C"], 110 + d))
    vtab = torch.as_tensor(np.random.default_rng(120 + d).normal(
        size=(tables["C"], d)).astype(np.float32))
    w = torch.as_tensor(s["wT"].T.copy())
    if w_bf16:
        w = w.to(torch.bfloat16)
    P = tables["P"]
    view = tot.schur_fwd_t(w.T, cam, ranks, vtab, P)
    assert not w.T.is_contiguous() and not tot.segsum_lane_major(w.T)
    lane = tot.schur_fwd_t(w.T.contiguous(), cam, ranks, vtab, P)
    assert torch.equal(view, lane)
    assert torch.equal(tot.schur_fwd(w, cam, ranks, vtab, P), lane)


@pytest.mark.parametrize("d,w_bf16", _SUBLANE_W)
def test_sublane_schur_bwd_matches_reference(tables, d, w_bf16):
    s = _schur_inputs(tables, d=d, seed=70 + d)
    ranks = _dense_ranks(tables)
    Pz = int(ranks[ranks < 2 ** 30].max()) + 1
    n = tables["C"]
    cam = _masked_ids(tables["obs_cam"], n, 80 + d)
    ztab = np.random.default_rng(90 + d).normal(size=(Pz, 3)).astype(np.float32)
    w = torch.as_tensor(s["wT"].T.copy())
    if w_bf16:
        w = w.to(torch.bfloat16)
    jw = jnp.asarray(w.float().numpy())
    jw = jw.astype(jnp.bfloat16) if w_bf16 else jw
    want = jot.schur_bwd(jw, jnp.asarray(cam), jnp.asarray(ranks), jnp.asarray(ztab), n,
                         interpret=True)
    got = tot.schur_bwd(w, torch.as_tensor(cam), torch.as_tensor(ranks), torch.as_tensor(ztab), n)
    assert tuple(got.shape) == (n, d)
    _close(got, want, f"schur_bwd D={d}")
