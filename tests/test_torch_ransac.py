"""RANSAC parity with the reference's own random draws passed in: F and E
8-point, homography DLT and P3P resection.  The reference's sample indices
(and scoring subset) come from its jax keys; the port takes them through
`idx`/`sub`.  Inlier masks must agree except for at most 0.5% of matches
lying within 1e-3 px of the threshold; models agree up to sign and scale."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusfm.core import epipolar as jepi
from tpusfm.core import homography as jhom
from tpusfm.core import lie as jlie
from tpusfm.sfm import pnp as jpnp
from tpusfm.sfm import ransac as jransac
from tpusfm_torch.core import epipolar as tepi
from tpusfm_torch.core import homography as thom
from tpusfm_torch.sfm import pnp as tpnp
from tpusfm_torch.sfm import ransac as transac

torch.set_num_threads(2)

F_PX = 500.0


def _scene(rng, n=300, outliers=0.3, noise_px=0.5, planar=False):
    X = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(4, 8, (n, 1))], -1)
    if planar:
        X[:, 2] = 5.0 - 0.3 * X[:, 0]
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.03, -0.15, 0.02], jnp.float32)), np.float64)
    t = np.array([0.8, 0.1, -0.05])
    Xc = X @ R.T + t
    x0 = X[:, :2] / X[:, 2:]
    x1 = Xc[:, :2] / Xc[:, 2:]
    x0 = x0 + rng.normal(scale=noise_px / F_PX, size=x0.shape)
    x1 = x1 + rng.normal(scale=noise_px / F_PX, size=x1.shape)
    bad = rng.random(n) < outliers
    x1[bad] = rng.uniform(-0.4, 0.4, (bad.sum(), 2))
    valid = rng.random(n) > 0.05
    return (X.astype(np.float32), x0.astype(np.float32), x1.astype(np.float32),
            valid, R.astype(np.float32), t.astype(np.float32))


def _reference_draws(key, valid, n_iters, sample_size, score_subset):
    k1, k_sub = jax.random.split(key)
    idx = np.asarray(jransac._sample_indices(k1, jnp.asarray(valid), n_iters, sample_size))
    sub = None
    if score_subset:
        r = jnp.where(jnp.asarray(valid), jax.random.uniform(k_sub, (len(valid),)), 2.0)
        sub = np.asarray(jnp.argsort(r)[:score_subset])
    return idx, sub


def _check_masks(j_inl, t_inl, err_ref, thresh, px_per_unit):
    mismatch = np.asarray(j_inl) != t_inl
    assert mismatch.sum() <= math.ceil(0.005 * len(mismatch)), mismatch.sum()
    near = np.abs(np.sqrt(np.asarray(err_ref)[mismatch]) - thresh) * px_per_unit <= 1e-3
    assert near.all()


def _up_to_sign_scale(a, b, atol):
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    np.testing.assert_allclose(b * np.sign(a @ b), a, atol=atol)


MODELS = {
    # name: (solver, scorer, sample size, pixel coords?, threshold, planar, score_subset)
    "f_8pt": ("fundamental_8pt", "sampson_error", 8, True, 4.0, False, 0),
    "f_8pt_subset": ("fundamental_8pt", "sampson_error", 8, True, 4.0, False, 128),
    "e_8pt": ("essential_8pt", "sampson_error", 8, False, 4.0 / F_PX, False, 0),
    "h_dlt": ("homography_dlt", "homography_transfer_error", 4, True, 4.0, True, 0),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_two_view_ransac_with_reference_draws(name):
    solver, scorer, s, pixels, thresh, planar, subset = MODELS[name]
    rng = np.random.default_rng(len(name))
    _, x0, x1, valid, _, _ = _scene(rng, planar=planar)
    if pixels:
        x0, x1 = x0 * F_PX + 320, x1 * F_PX + 240
    jmod = jhom if solver == "homography_dlt" else jepi
    tmod = thom if solver == "homography_dlt" else tepi
    key = jax.random.PRNGKey(3)
    n_iters = 128
    jm, jinl, jn = jransac.ransac(key, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(valid),
                                  solver=getattr(jmod, solver), scorer=getattr(jmod, scorer),
                                  sample_size=s, n_iters=n_iters, inlier_thresh=thresh,
                                  score_subset=subset)
    idx, sub = _reference_draws(key, valid, n_iters, s, subset)
    T = lambda a: torch.as_tensor(a)[None]  # noqa: E731
    tm, tinl, tn = transac.ransac(
        None, T(x0), T(x1), T(valid), solver=getattr(tmod, solver),
        scorer=getattr(tmod, scorer), sample_size=s, n_iters=n_iters, inlier_thresh=thresh,
        score_subset=subset, idx=T(idx), sub=None if sub is None else T(sub))
    err_ref = getattr(jmod, scorer)(jm, jnp.asarray(x0), jnp.asarray(x1))
    _check_masks(jinl, tinl[0].numpy(), err_ref, thresh, 1.0 if pixels else F_PX)
    assert int(jn) > 80  # a real model won, in the reference and so in the port
    _up_to_sign_scale(jm, tm[0].numpy(), atol=5e-3)


def _ac_ransac_both(refit):
    rng = np.random.default_rng(21)
    _, x0, x1, valid, _, _ = _scene(rng, n=250)
    x0, x1 = x0 * F_PX + 320, x1 * F_PX + 240
    key = jax.random.PRNGKey(9)
    n_iters, alpha0 = 128, 2.0 * 800.0 / (640.0 * 480.0)
    jout = jransac.ransac_ac(
        key, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(valid), solver=jepi.fundamental_8pt,
        scorer=jepi.sampson_error, sample_size=8, n_iters=n_iters, alpha0=alpha0,
        max_thresh=4.0, min_thresh=1.0, refit=refit)
    idx, _ = _reference_draws(key, valid, n_iters, 8, 0)
    T = lambda a: torch.as_tensor(a)[None]  # noqa: E731
    tout = transac.ransac_ac(
        None, T(x0), T(x1), T(valid), solver=tepi.fundamental_8pt, scorer=tepi.sampson_error,
        sample_size=8, n_iters=n_iters, alpha0=alpha0, max_thresh=4.0, min_thresh=1.0,
        idx=T(idx), refit=refit)
    return x0, x1, alpha0, jout, tout


@pytest.mark.parametrize("stage", ["hypotheses", "refit"])
def test_ac_ransac_with_reference_draws(stage):
    """A-contrario scoring, in two stages.

    hypotheses (refit=False on both sides): same winner, adaptive threshold
    eps* and support; NFA and eps* at rtol 1e-3.

    refit: the weighted 8-point refit is fed the reference's own pre-refit
    inlier mask, so its model is compared free of the inlier set; then the
    final NFA of the full ransac_ac.  The two pre-refit inlier sets may
    differ by a match lying exactly at eps* (140 vs 141 here), and the refit
    magnifies that one match, so the final log10-NFA is held to one inlier's
    a-contrario term at the largest threshold, |log10(alpha0 * max_thresh)|
    (1.68 decades), and the supports to two matches."""
    x0, x1, alpha0, (jm, jinl, jn, jnfa, jeps), (tm, tinl, tn, tnfa, teps) = \
        _ac_ransac_both(refit=stage == "refit")
    assert float(jnfa) < 0 and int(jn) > 80
    if stage == "hypotheses":
        collect = max(float(jeps), 1.0)
        err_ref = jepi.sampson_error(jm, jnp.asarray(x0), jnp.asarray(x1))
        _check_masks(jinl, tinl[0].numpy(), err_ref, collect, 1.0)
        np.testing.assert_allclose(float(tnfa[0]), float(jnfa), rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(float(teps[0]), float(jeps), rtol=1e-3)
        _up_to_sign_scale(jm, tm[0].numpy(), atol=5e-3)
        return
    jinl0 = _ac_ransac_both(refit=False)[3][1]  # the reference's pre-refit inliers
    w = np.asarray(jinl0).astype(np.float32)
    j_refit = jepi.fundamental_8pt(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(w))
    t_refit = tepi.fundamental_8pt(torch.as_tensor(x0), torch.as_tensor(x1), torch.as_tensor(w))
    _up_to_sign_scale(j_refit, t_refit.numpy(), atol=1e-5)
    one_inlier = abs(math.log10(alpha0 * 4.0))
    np.testing.assert_allclose(float(tnfa[0]), float(jnfa), rtol=0, atol=one_inlier)
    assert abs(int(tn[0]) - int(jn)) <= 2
    _up_to_sign_scale(jm, tm[0].numpy(), atol=5e-3)


def test_p3p_resection_with_reference_draws():
    rng = np.random.default_rng(11)
    X, _, x1, valid, R, t = _scene(rng, n=200, outliers=0.3)
    thresh = 8.0 / F_PX
    key = jax.random.PRNGKey(5)
    n_iters = 64
    jaa, jt, jinl, jn = jpnp.pnp_ransac(key, jnp.asarray(X), jnp.asarray(x1), jnp.asarray(valid),
                                       n_iters=n_iters, thresh_norm=thresh, minimal="p3p")
    idx, _ = _reference_draws(key, valid, n_iters, 3, 0)
    T = lambda a: torch.as_tensor(a)[None]  # noqa: E731
    taa, tt, tinl, tn = tpnp.pnp_ransac(None, T(X), T(x1), T(valid), n_iters=n_iters,
                                        thresh_norm=thresh, minimal="p3p", idx=T(idx))
    err_ref = jpnp.pnp_reproj_error((jlie.so3_exp(jaa), jt), jnp.asarray(X), jnp.asarray(x1))
    _check_masks(jinl, tinl[0].numpy(), err_ref, thresh, F_PX)
    np.testing.assert_allclose(taa[0].numpy(), np.asarray(jaa), atol=1e-4)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(tt[0].numpy(), t, atol=5e-3)
    assert int(tn[0]) > 120


def test_random_draws_are_valid_and_distinct():
    gen = torch.Generator().manual_seed(0)
    valid = torch.rand((3, 50), generator=gen) > 0.5
    idx = transac.sample_indices(gen, valid, n_iters=40, sample_size=5)
    assert idx.shape == (3, 40, 5)
    assert bool(torch.gather(valid[:, None].expand(3, 40, 50), 2, idx).all())
    srt = torch.sort(idx, dim=-1).values
    assert bool((srt[..., 1:] != srt[..., :-1]).all())  # without replacement
