"""Matcher parity: the port's plain twin of kernel K1 and its full-matrix
matcher against the JAX reference (Pallas kernel in interpret mode, and
matching.match), on the planted pairs of tests/test_pallas_match.py.
On SIFT's u8 grid every distance is an exact integer, so d1, d2, i1 and
`ok` must agree bit for bit; on random float descriptors `ok` must agree and
i1 must agree where `ok` holds."""

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

