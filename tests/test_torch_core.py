"""Geometry-core parity (Lie maps, camera models, polynomial roots,
triangulation, epipolar / homography / P3P solvers): the port against the
JAX reference on seeded inputs.  Maps agree to rtol 1e-5; solver models are
compared up to sign and scale; recover_pose R, t within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusfm.core import camera as jcam
from tpusfm.core import distortion as jdist
from tpusfm.core import epipolar as jepi
from tpusfm.core import homography as jhom
from tpusfm.core import lie as jlie
from tpusfm.core import p3p as jp3p
from tpusfm.core import polynomial as jpoly
from tpusfm.core import triangulate as jtri
from tpusfm_torch.core import camera as tcam
from tpusfm_torch.core import distortion as tdist
from tpusfm_torch.core import epipolar as tepi
from tpusfm_torch.core import homography as thom
from tpusfm_torch.core import lie as tlie
from tpusfm_torch.core import p3p as tp3p
from tpusfm_torch.core import polynomial as tpoly
from tpusfm_torch.core import triangulate as ttri

torch.set_num_threads(2)


def _both(jfn, tfn, *args):
    """Run the reference on jnp inputs and the port on torch inputs."""
    jout = jfn(*[jnp.asarray(a) for a in args])
    tout = tfn(*[torch.as_tensor(np.asarray(a)) for a in args])
    return jout, tout


def _close(j, t, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _up_to_sign_scale(j, t, atol=1e-4):
    j = np.asarray(j).reshape(len(j), -1)
    t = t.numpy().reshape(len(t), -1)
    j = j / np.linalg.norm(j, axis=-1, keepdims=True)
    t = t / np.linalg.norm(t, axis=-1, keepdims=True)
    sgn = np.sign(np.sum(j * t, axis=-1, keepdims=True))
    np.testing.assert_allclose(t * sgn, j, atol=atol)


def _aa_samples(rng):
    aa = rng.normal(size=(64, 3)).astype(np.float32)
    aa[:8] *= 1e-5                        # small-angle branch
    aa[8:16] *= (np.pi - 1e-4) / np.linalg.norm(aa[8:16], axis=-1, keepdims=True)  # near pi
    return aa


@pytest.mark.parametrize("fn", ["so3_exp", "so3_right_jacobian", "hat", "rotate_aa", "so3_log"])
def test_lie_maps(fn):
    rng = np.random.default_rng(0)
    aa = _aa_samples(rng)
    if fn == "rotate_aa":
        x = rng.normal(size=(64, 3)).astype(np.float32)
        _close(*_both(jlie.rotate_aa, tlie.rotate_aa, aa, x))
    elif fn == "so3_log":
        R = np.asarray(jlie.so3_exp(jnp.asarray(aa[16:])))  # away from pi: log is unique
        _close(*_both(jlie.so3_log, tlie.so3_log, R), atol=1e-5)
    else:
        _close(*_both(getattr(jlie, fn), getattr(tlie, fn), aa))


CAMS = {
    "radial3": np.array([500, 510, 320, 240, -0.2, 0.05, 0.01], np.float32),
    "brown": np.array([500, 510, 320, 240, -0.2, 0.05, 0.01, 1e-3, -2e-3], np.float32),
    "fisheye": np.array([300, 300, 320, 240, 0.05, -0.01, 0.002, 0.0, 0.0], np.float32),
    "spherical": np.array([100, 100, 320, 160, 0, 0, 0], np.float32),
}


@pytest.mark.parametrize("model", list(CAMS))
def test_camera_maps(model):
    rng = np.random.default_rng(1)
    intr = CAMS[model]
    m = model if model in ("fisheye", "spherical") else "auto"
    xc = np.concatenate([rng.uniform(-0.5, 0.5, (100, 2)), rng.uniform(1, 5, (100, 1))], -1)
    xc = xc.astype(np.float32)
    _close(*_both(lambda i, x: jcam.camera_to_pixel(i, x, model=m),
                  lambda i, x: tcam.camera_to_pixel(i, x, model=m), intr, xc), atol=1e-4)
    uv = rng.uniform([100, 80], [540, 400], (100, 2)).astype(np.float32)
    _close(*_both(lambda i, u: jcam.pixel_to_normal(i, u, model=m),
                  lambda i, u: tcam.pixel_to_normal(i, u, model=m), intr, uv), atol=1e-5)


def test_distortion_round_trips():
    rng = np.random.default_rng(2)
    xn = rng.uniform(-0.6, 0.6, (50, 2)).astype(np.float32)
    for jf, tf, p in ((jdist.distort_brown, tdist.distort_brown, CAMS["brown"][4:9]),
                      (jdist.undistort_brown, tdist.undistort_brown, CAMS["brown"][4:9]),
                      (jdist.distort_fisheye, tdist.distort_fisheye, CAMS["fisheye"][4:8]),
                      (jdist.undistort_fisheye, tdist.undistort_fisheye, CAMS["fisheye"][4:8])):
        _close(*_both(jf, tf, p, xn), atol=1e-6)


def test_real_roots():
    rng = np.random.default_rng(3)
    roots = rng.uniform(-3, 3, (200, 4))
    coeffs = np.stack([np.poly(r) for r in roots]).astype(np.float32)  # four real roots
    coeffs[100:] = rng.normal(size=(100, 5)).astype(np.float32)       # mixed real/complex
    (jr, jok), (tr, tok) = _both(lambda c: jpoly.real_roots(c, iters=60),
                                 lambda c: tpoly.real_roots(c, iters=60), coeffs)
    agree = np.asarray(jok) == tok.numpy()
    assert agree.mean() > 0.99
    both = np.asarray(jok) & tok.numpy()
    np.testing.assert_allclose(tr.numpy()[both], np.asarray(jr)[both], rtol=1e-3, atol=1e-3)
    # The planted real roots are found.
    found = np.sort(tr.numpy()[:100], axis=-1)
    np.testing.assert_allclose(found, np.sort(roots[:100], axis=-1), atol=2e-2)


def _two_view(rng, n=60, noise=0.0):
    X = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(4, 8, (n, 1))], -1)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.2, 0.03], jnp.float32)), np.float64)
    t = np.array([1.0, 0.1, -0.05])
    t /= np.linalg.norm(t)
    x0 = X[:, :2] / X[:, 2:]
    Xc = X @ R.T + t
    x1 = Xc[:, :2] / Xc[:, 2:]
    x0 = x0 + rng.normal(scale=noise, size=x0.shape)
    x1 = x1 + rng.normal(scale=noise, size=x1.shape)
    return x0.astype(np.float32), x1.astype(np.float32), R.astype(np.float32), t.astype(np.float32)


def test_triangulation_and_smallest_eigvec():
    rng = np.random.default_rng(4)
    x0, x1, R, t = _two_view(rng)
    P0 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    P1 = np.concatenate([R, t[:, None]], 1)
    _close(*_both(jtri.triangulate_two_view, ttri.triangulate_two_view, P0, P1, x0, x1),
           rtol=1e-4, atol=1e-4)
    Ps = np.stack([P0, P1, P1])[None].repeat(10, 0)
    xs = np.stack([x0[:10], x1[:10], x1[:10]], 1)
    mask = np.ones((10, 3), np.float32)
    mask[:, 2] = 0.0
    jX = np.stack([np.asarray(jtri.triangulate_n_view(jnp.asarray(Ps[i]), jnp.asarray(xs[i]),
                                                      jnp.asarray(mask[i]))) for i in range(10)])
    tX = ttri.triangulate_n_view(torch.as_tensor(Ps), torch.as_tensor(xs), torch.as_tensor(mask))
    _close(jX, tX, rtol=1e-4, atol=1e-4)
    A = rng.normal(size=(20, 9, 9)).astype(np.float32)
    A = A @ np.swapaxes(A, -1, -2)
    _up_to_sign_scale(*_both(jtri.smallest_eigvec_sym, ttri.smallest_eigvec_sym, A), atol=1e-3)


@pytest.mark.parametrize("solver", ["fundamental_8pt", "essential_8pt"])
def test_eight_point_solvers(solver):
    rng = np.random.default_rng(5)
    batch = [_two_view(rng, n=20, noise=1e-3) for _ in range(16)]
    x0 = np.stack([b[0] for b in batch])
    x1 = np.stack([b[1] for b in batch])
    if solver == "fundamental_8pt":  # pixel coordinates
        x0, x1 = x0 * 500 + 320, x1 * 500 + 240
    w = rng.uniform(0.5, 1.5, x0.shape[:2]).astype(np.float32)
    _up_to_sign_scale(*_both(getattr(jepi, solver), getattr(tepi, solver), x0, x1, w), atol=2e-3)
    F = np.asarray(getattr(jepi, solver)(jnp.asarray(x0), jnp.asarray(x1)))
    jerr, terr = _both(jepi.sampson_error, tepi.sampson_error, F, x0, x1)
    # num^2 / denom cancels near zero error: tolerance relative to the largest.
    _close(jerr, terr, rtol=1e-3, atol=1e-3 * float(np.abs(np.asarray(jerr)).max()))


@pytest.mark.parametrize("solver,k", [("essential_5pt", 5), ("fundamental_7pt", 7)])
def test_minimal_solvers_find_the_true_model(solver, k):
    """The minimal solvers' candidates depend on the nullspace basis the
    SVD returns, which differs between backends, so the comparison is on
    outcomes: how often the true model is among the valid candidates."""
    rng = np.random.default_rng(6)
    views = [_two_view(rng, n=k) for _ in range(64)]
    x0 = np.stack([v[0] for v in views])
    x1 = np.stack([v[1] for v in views])
    true = np.stack([np.asarray(jlie.hat(jnp.asarray(v[3]))) @ v[2] for v in views])
    true /= np.linalg.norm(true.reshape(64, -1), axis=-1)[:, None, None]

    def found(E, ok):
        E = np.asarray(E)
        E = E / np.linalg.norm(E.reshape(*E.shape[:2], -1), axis=-1)[..., None, None]
        d = np.minimum(np.abs(E - true[:, None]).max((-1, -2)),
                       np.abs(E + true[:, None]).max((-1, -2)))
        return (np.where(np.asarray(ok), d, np.inf).min(-1) < 1e-3).mean()

    (jE, jok), (tE, tok) = _both(getattr(jepi, solver), getattr(tepi, solver), x0, x1)
    assert found(tE.numpy(), tok.numpy()) >= found(jE, jok) - 0.05
    assert found(tE.numpy(), tok.numpy()) > 0.8


def test_recover_pose():
    rng = np.random.default_rng(7)
    x0, x1, R, t = _two_view(rng, n=80, noise=1e-4)
    E = np.asarray(jepi.essential_8pt(jnp.asarray(x0), jnp.asarray(x1)))
    jR, jt, jn, jfront, jX = jepi.recover_pose(jnp.asarray(E), jnp.asarray(x0), jnp.asarray(x1))
    tR, tt, tn, tfront, tX = tepi.recover_pose(torch.as_tensor(E), torch.as_tensor(x0),
                                               torch.as_tensor(x1))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_array_equal(tfront.numpy(), np.asarray(jfront))
    np.testing.assert_allclose(tR.numpy(), R, atol=1e-2)


def test_homography_dlt_and_decomposition():
    rng = np.random.default_rng(8)
    # A plane z = 5 - 0.2 x seen by two cameras.
    n = 40
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), np.zeros(n)], -1)
    X[:, 2] = 5 - 0.2 * X[:, 0]
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.1, 0.01], jnp.float32)), np.float64)
    t = np.array([0.5, 0.05, 0.02])
    x0 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    Xc = X @ R.T + t
    x1 = (Xc[:, :2] / Xc[:, 2:]).astype(np.float32)
    jH, tH = _both(jhom.homography_dlt, thom.homography_dlt, x0, x1)
    _close(jH, tH, rtol=1e-3, atol=1e-4)
    _close(*_both(jhom.homography_transfer_error, thom.homography_transfer_error,
                  np.asarray(jH), x0, x1), rtol=1e-2, atol=1e-9)
    (jRs, jts, _), (tRs, tts, _) = _both(jhom.decompose_homography, thom.decompose_homography,
                                         np.asarray(jH))
    # SVD signs may permute the four candidates: match them as a set.
    for Rj, tj in zip(np.asarray(jRs), np.asarray(jts)):
        d = [np.abs(Rt - Rj).max() + np.abs(tt_ - tj).max()
             for Rt, tt_ in zip(tRs.numpy(), tts.numpy())]
        assert min(d) < 1e-3


def test_p3p_grunert():
    rng = np.random.default_rng(9)
    X = np.concatenate([rng.uniform(-1, 1, (32, 3, 2)), rng.uniform(3, 6, (32, 3, 1))], -1)
    R = np.asarray(jlie.so3_exp(jnp.asarray([0.1, 0.2, -0.05], jnp.float32)), np.float64)
    t = np.array([0.2, -0.1, 0.5])
    Xc = X @ R.T + t
    xn = (Xc[..., :2] / Xc[..., 2:]).astype(np.float32)
    X = X.astype(np.float32)
    (jR, jt, jok), (tR, tt, tok) = _both(jp3p.p3p_grunert, tp3p.p3p_grunert, X, xn)
    agree = np.asarray(jok) == tok.numpy()
    assert agree.mean() > 0.98
    both = np.asarray(jok) & tok.numpy()
    np.testing.assert_allclose(tR.numpy()[both], np.asarray(jR)[both], atol=1e-3)
    np.testing.assert_allclose(tt.numpy()[both], np.asarray(jt)[both], atol=1e-3)
    # The true pose is among the candidates of every sample.
    err = np.abs(tR.numpy() - R[None, None]).max((-1, -2)) + np.where(tok.numpy(), 0, 1e9)
    assert (err.min(-1) < 1e-3).mean() > 0.95
