"""Matcher parity: the port's plain twin of kernel K1 and its full-matrix
matcher against the JAX reference (Pallas kernel in interpret mode, and
matching.match), on the planted pairs of tests/test_pallas_match.py.
On SIFT's u8 grid every distance is an exact integer, so d1, d2, i1 and
`ok` must agree bit for bit; on random float descriptors `ok` must agree and
i1 must agree where `ok` holds."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusfm.features import sift as jsift
from tpusfm.matching import match as jmatch
from tpusfm.ops import pallas_match
from tpusfm.pipeline import config as jconfig
from tpusfm.pipeline import sparse as jsparse
from tpusfm_torch import convert
from tpusfm_torch.matching import match as tmatch
from tpusfm_torch.ops import topk2_match
from tpusfm_torch.pipeline import config as tconfig
from tpusfm_torch.pipeline import sparse as tsparse

torch.set_num_threads(2)


def planted_pair(rng, na, nb, n_planted, noise=0.3, grid=False):
    da = rng.normal(size=(na, 128)).astype(np.float32) * 20
    perm = rng.permutation(na)[:n_planted]
    db = np.concatenate([
        da[perm] + rng.normal(size=(n_planted, 128)).astype(np.float32) * noise,
        rng.normal(size=(nb - n_planted, 128)).astype(np.float32) * 20,
    ])
    if grid:  # SIFT's u8 grid: integers in [0, 255]
        da = np.clip(np.floor(np.abs(da) * 4), 0, 255).astype(np.float32)
        db = np.clip(np.floor(np.abs(db) * 4), 0, 255).astype(np.float32)
    return da, db


CASES = {
    "300x460_masked": dict(na=300, nb=460, n_planted=300, masked=slice(100, 120)),
    "130x200": dict(na=130, nb=200, n_planted=130, masked=None),
    "130x200_all_masked": dict(na=130, nb=200, n_planted=130, masked=slice(0, 200)),
}


def _case(name, grid, seed=5):
    c = CASES[name]
    rng = np.random.default_rng(seed)
    da, db = planted_pair(rng, c["na"], c["nb"], c["n_planted"], grid=grid)
    ma = np.ones(c["na"], bool)
    mb = np.ones(c["nb"], bool)
    if c["masked"] is not None:
        mb[c["masked"]] = False
    return da, db, ma, mb


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", list(CASES))
def test_twin_bit_equal_on_u8_grid(name):
    da, db, ma, mb = _case(name, grid=True)
    jd1, jd2, ji1 = pallas_match.match_topk2(jnp.asarray(da), jnp.asarray(db),
                                             jnp.asarray(mb), interpret=True)
    d1, d2, i1 = topk2_match.match_topk2(_t(da)[None], _t(db)[None], _t(mb)[None])
    np.testing.assert_array_equal(d1[0].numpy(), np.asarray(jd1))
    np.testing.assert_array_equal(d2[0].numpy(), np.asarray(jd2))
    np.testing.assert_array_equal(i1[0].numpy(), np.asarray(ji1))
    if name.endswith("all_masked"):
        assert np.all(d1.numpy() >= 1e38)
    # Ratio test + cross-check against the reference's kernel wrapper.
    ji, jok = pallas_match.match_descriptors_pallas(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb), interpret=True)
    i, ok = topk2_match.match_descriptors_topk2(_t(da)[None], _t(db)[None], _t(ma)[None],
                                                _t(mb)[None])
    np.testing.assert_array_equal(ok[0].numpy(), np.asarray(jok))
    np.testing.assert_array_equal(i[0].numpy(), np.asarray(ji))


def _tf32(x):
    """float32 values rounded to TF32 as cvt.rna.tf32.f32 does (to nearest,
    ties away from zero): 0x1000 added to the bit pattern, the low 13 bits
    cleared."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """K1 f32's split of each value: hi = tf32(x), lo = tf32(x - hi) (x - hi
    is exact in float32)."""
    x = np.asarray(x, np.float32)
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _split_match(da, db, mb, dtype):
    """match_topk2_reference's function for one pair, with a.b taken as K1
    f32 takes it, hi.lo + lo.hi + hi.hi, the products and their sum in
    float64 (TF32 products are exact there), and the rest of the twin's
    arithmetic in `dtype`: d1, d2, i1 and the largest |lo|."""
    (ahi, alo), (bhi, blo) = _split(da), _split(db)
    f = lambda x: torch.from_numpy(x.astype(np.float64))  # noqa: E731
    ab = f(ahi) @ f(blo).T + f(alo) @ f(bhi).T + f(ahi) @ f(bhi).T
    a, b = _t(da).to(dtype), _t(db).to(dtype)
    a2 = torch.sum(a * a, dim=-1)
    b2m = torch.where(_t(mb), torch.sum(b * b, dim=-1), torch.tensor(topk2_match.INF, dtype=dtype))
    dts = b2m[None, :] - 2.0 * ab.to(dtype)
    m1, i1 = torch.amin(dts, dim=-1), torch.argmin(dts, dim=-1)
    m2 = torch.amin(dts.scatter(-1, i1[:, None], topk2_match.INF), dim=-1)
    return m1 + a2, m2 + a2, i1.to(torch.int32), max(np.abs(alo).max(), np.abs(blo).max())


@pytest.mark.parametrize("name", list(CASES))
def test_tf32_split_within_tolerance_of_float64_off_grid(name):
    """K1 f32's three-product split, emulated, on the reference's float
    descriptor sets: d1 and d2 within 4x the float32 twin's own largest
    error against the float64 twin (floored at 1e-6 of the output's
    scale), i1 equal to the float64 twin's wherever its d2 - d1 exceeds
    twice that tolerance.  The card tests hold the kernel to the same."""
    da, db, _, mb = _case(name, grid=False)
    got = _split_match(da, db, mb, torch.float64)
    f32 = topk2_match.match_topk2_reference(_t(da)[None], _t(db)[None], _t(mb)[None])
    f64 = topk2_match.match_topk2_reference(_t(da)[None].double(), _t(db)[None].double(),
                                            _t(mb)[None])
    assert got[3] > 0  # off the grid the lo parts carry bits
    tols = []
    for g, lo, hi in zip(got[:2], f32[:2], f64[:2]):
        hi = hi[0]
        tol = max(4 * float((lo[0].double() - hi).abs().max()), 1e-6 * float(hi.abs().max()))
        assert float((g - hi).abs().max()) <= tol, (name, float((g - hi).abs().max()), tol)
        tols.append(tol)
    sep = (f64[1][0] - f64[0][0]) > 2 * max(tols)
    assert torch.equal(got[2][sep], f64[2][0][sep])
    if not name.endswith("all_masked"):
        assert sep.float().mean() > 0.5


@pytest.mark.parametrize("name", list(CASES))
def test_tf32_split_bit_equal_to_f32_twin_on_u8_grid(name):
    """On SIFT's u8 grid every value is exact in TF32, so the split's lo
    parts are 0 and every partial sum is an integer below 2^24: the
    emulated split, its tail in float32, equals the float32 twin bit for
    bit."""
    da, db, _, mb = _case(name, grid=True)
    got = _split_match(da, db, mb, torch.float32)
    want = topk2_match.match_topk2_reference(_t(da)[None], _t(db)[None], _t(mb)[None])
    assert got[3] == 0
    for g, w in zip(got[:3], want):
        assert torch.equal(g, w[0])


@pytest.mark.parametrize("name", list(CASES))
def test_full_matrix_matcher_bit_equal_on_u8_grid(name):
    da, db, ma, mb = _case(name, grid=True)
    ji, jok = jmatch.match_descriptors(jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma),
                                       jnp.asarray(mb))
    i, ok = tmatch.match_descriptors(_t(da), _t(db), _t(ma), _t(mb))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_float_descriptors_ok_agrees():
    da, db, ma, mb = _case("300x460_masked", grid=False)
    ji, jok = jmatch.match_descriptors(jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma),
                                       jnp.asarray(mb))
    for i, ok in (tmatch.match_descriptors(_t(da), _t(db), _t(ma), _t(mb)),
                  (lambda r: (r[0][0], r[1][0]))(topk2_match.match_descriptors_topk2(
                      _t(da)[None], _t(db)[None], _t(ma)[None], _t(mb)[None]))):
        jok_np = np.asarray(jok)
        np.testing.assert_array_equal(ok.numpy(), jok_np)
        np.testing.assert_array_equal(i.numpy()[jok_np], np.asarray(ji)[jok_np])
        assert jok_np.sum() > 200


def test_batched_equals_single_calls():
    rng = np.random.default_rng(11)
    pairs = [planted_pair(rng, 130, 200, 100, grid=True) for _ in range(3)]
    da = np.stack([p[0] for p in pairs])
    db = np.stack([p[1] for p in pairs])
    mb = rng.random((3, 200)) > 0.1
    ma = rng.random((3, 130)) > 0.1
    batched = topk2_match.match_topk2(_t(da), _t(db), _t(mb))
    i_b, ok_b = topk2_match.match_descriptors_topk2(_t(da), _t(db), _t(ma), _t(mb))
    for p in range(3):
        single = topk2_match.match_topk2(_t(da[p:p + 1]), _t(db[p:p + 1]), _t(mb[p:p + 1]))
        for b, s in zip(batched, single):
            np.testing.assert_array_equal(b[p].numpy(), s[0].numpy())
        i_s, ok_s = topk2_match.match_descriptors_topk2(
            _t(da[p:p + 1]), _t(db[p:p + 1]), _t(ma[p:p + 1]), _t(mb[p:p + 1]))
        np.testing.assert_array_equal(ok_b[p].numpy(), ok_s[0].numpy())
        np.testing.assert_array_equal(i_b[p].numpy(), i_s[0].numpy())


def test_match_pairs_stage_equals_reference():
    """The pipeline's matching stage over every pair of five views, with the
    same u8-grid features handed to both packages (features_from_numpy):
    match indices and validity agree bit for bit, padded chunk rows
    included."""
    rng = np.random.default_rng(7)
    V, N = 5, 96
    base = np.clip(np.floor(np.abs(rng.normal(size=(N, 128))) * 80), 0, 255)
    desc = np.stack([np.clip(base[rng.permutation(N)] + rng.integers(-3, 4, size=(N, 128)), 0, 255)
                     for _ in range(V)]).astype(np.float32)
    kp = rng.uniform(0, 100, size=(V, N, 4)).astype(np.float32)
    score = rng.random((V, N)).astype(np.float32)
    mask = rng.random((V, N)) > 0.1
    jfeats = jsift.Features(kp=jnp.asarray(kp), desc=jnp.asarray(desc), score=jnp.asarray(score),
                            mask=jnp.asarray(mask))
    tfeats = convert.features_from_numpy(kp, desc, score, mask, "cpu")
    jcfg = jconfig.PipelineConfig()
    pl = jsparse.generate_pairs(V, jcfg)
    np.testing.assert_array_equal(tsparse.generate_pairs(V, tconfig.PipelineConfig()), pl)
    j_idx, j_ok = jsparse.match_pairs(jfeats, pl, jcfg)
    t_idx, t_ok = tsparse.match_pairs(tfeats, pl, convert.config_from_jax(jcfg))
    np.testing.assert_array_equal(t_ok, j_ok)
    np.testing.assert_array_equal(t_idx[t_ok], j_idx[j_ok])
    assert t_ok.sum() > 100


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Input checks run before any launch, so they are testable on the CPU
    through the private checker."""
    da = torch.zeros(2, 8, 128)
    db = torch.zeros(2, 9, 128)
    mb = torch.ones(2, 9, dtype=torch.bool)
    topk2_match._check_inputs(da, db, mb)
    with pytest.raises(ValueError):
        topk2_match._check_inputs(da[..., :64].contiguous(), db[..., :64].contiguous(), mb)
    with pytest.raises(TypeError):
        topk2_match._check_inputs(da.double(), db.double(), mb)
    with pytest.raises(ValueError, match="contiguous"):
        topk2_match._check_inputs(torch.zeros(8, 2, 128).transpose(0, 1), db, mb)
    with pytest.raises(ValueError):
        topk2_match._check_inputs(da, db, mb[:, :5])



# The reference's bf16 path (quantized=True, which its run_sparse passes):
# bf16 products, |a|^2 of the rounded A, |b|^2 of the unrounded B.

@pytest.mark.parametrize("name", list(CASES))
def test_quantized_twin_bit_equal_on_u8_grid(name):
    """On the u8 grid bf16 holds every value and every partial sum is an
    integer below 2^24: the port's quantized twin equals the reference's
    quantized kernel (interpret mode) and the f32 twin bit for bit."""
    da, db, ma, mb = _case(name, grid=True)
    want = pallas_match.match_topk2(jnp.asarray(da), jnp.asarray(db), jnp.asarray(mb),
                                    interpret=True, quantized=True)
    got = topk2_match.match_topk2(_t(da)[None], _t(db)[None], _t(mb)[None], quantized=True)
    f32 = topk2_match.match_topk2(_t(da)[None], _t(db)[None], _t(mb)[None])
    for g, w, f in zip(got, want, f32):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
        np.testing.assert_array_equal(g[0].numpy(), f[0].numpy())
    ji, jok = pallas_match.match_descriptors_pallas(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb), interpret=True,
        quantized=True)
    i, ok = topk2_match.match_descriptors_topk2(_t(da)[None], _t(db)[None], _t(ma)[None],
                                                _t(mb)[None], quantized=True)
    np.testing.assert_array_equal(ok[0].numpy(), np.asarray(jok))
    np.testing.assert_array_equal(i[0].numpy(), np.asarray(ji))


def _quantized_tol(da, db):
    """Per A row, the tolerance for the quantized path off the grid, where
    the two packages sum the same bf16 products in other orders:
    1e-5 x (|a|^2 of the rounded row + the largest |b|^2)."""
    a = torch.from_numpy(da).to(torch.bfloat16).double().numpy()
    return 1e-5 * (np.sum(a * a, -1) + np.max(np.sum(db.astype(np.float64) ** 2, -1)))


def _top2_q(a, b, mb, port):
    if port:
        return [x[0].numpy().astype(np.float64) for x in
                topk2_match.match_topk2(_t(a)[None], _t(b)[None], _t(mb)[None], quantized=True)]
    return [np.asarray(x).astype(np.float64) for x in
            pallas_match.match_topk2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mb),
                                     interpret=True, quantized=True)]


@pytest.mark.parametrize("name", list(CASES))
def test_quantized_twin_within_tolerance_off_grid(name):
    """Float (off-grid) descriptors: d1 and d2 within _quantized_tol of the
    reference's quantized kernel; i1 equal wherever d2 - d1 exceeds it; the
    ratio test + cross-check `ok` (and i1 where it holds) equal except for
    rows within it of the ratio boundary or whose forward or cross-check
    argmin it leaves open."""
    da, db, ma, mb = _case(name, grid=False)
    tol = _quantized_tol(da, db)
    d1, d2, i1 = _top2_q(da, db, mb, port=True)
    jd1, jd2, ji1 = _top2_q(da, db, mb, port=False)
    assert np.all(np.abs(d1 - jd1) <= tol) and np.all(np.abs(d2 - jd2) <= tol)
    sep = jd2 - jd1 > tol
    np.testing.assert_array_equal(i1[sep], ji1[sep])
    # The cross-check's B -> A call, whose tolerance is per B row.
    rd1, rd2, _ = _top2_q(db, da, ma, port=False)
    rsep = rd2 - rd1 > _quantized_tol(db, da)
    ratio2 = 0.8 * 0.8
    open_ = (~sep) | (~rsep[ji1.astype(int)]) | (np.abs(jd1 - ratio2 * jd2) <= (1 + ratio2) * tol)
    ji, jok = pallas_match.match_descriptors_pallas(
        jnp.asarray(da), jnp.asarray(db), jnp.asarray(ma), jnp.asarray(mb), interpret=True,
        quantized=True)
    i, ok = topk2_match.match_descriptors_topk2(_t(da)[None], _t(db)[None], _t(ma)[None],
                                                _t(mb)[None], quantized=True)
    ok, jok = ok[0].numpy(), np.asarray(jok)
    np.testing.assert_array_equal(ok[~open_], jok[~open_])
    both = ok & jok
    np.testing.assert_array_equal(i[0].numpy()[both], np.asarray(ji)[both])
    if name.endswith("all_masked"):
        assert not jok.any() and np.all(d1 >= 1e38)
    else:
        assert open_.mean() < 0.05 and jok.sum() > 100


def test_cuda_chunk_asks_for_the_quantized_kernel(monkeypatch):
    """The pipeline's CUDA matching chunk (``match_on_device``) calls K1
    with quantized=True, as the reference's run_sparse does
    (tpusfm/pipeline/sparse.py:97-105)."""
    seen = {}

    def fake(*a, **k):
        seen.update(k)
        return "i", "ok"

    monkeypatch.setattr(topk2_match, "match_descriptors_topk2", fake)
    chunk = types.SimpleNamespace(device=torch.device("cuda"), shape=(2, 8, 128))
    assert tmatch.match_on_device(chunk, chunk, None, None, 0.8, True) == ("i", "ok")
    assert seen == {"ratio": 0.8, "cross_check": True, "quantized": True}
