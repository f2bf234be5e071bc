"""The sparse layer's public helpers: each against its JAX reference on the
CPU, from numpy seeds.

Tolerances: host numpy helpers (pair sharding and padding, tracks, SIFT
presets, scene I/O, compact_points) exact; float32 geometry (intrinsics,
SE(3) helpers, epipolar distance, parallax angle, undistortion) atol 1e-5
relative to the values' scale; the RANSAC wrappers and the two-view chain,
given the reference's own sample indices and (for two-view) its features:
inlier masks equal but for at most 1% of matches within 0.05 px of the
threshold (the hypotheses of exactly determined minimal samples differ by
the two packages' float32 SVD rounding), models equal up to sign and scale
(5e-3); the plain BA chunked by obs_chunk equals it unchunked to float32
rounding (rtol 1e-5 on the cost, atol 1e-4 on poses and points), and
``bundle_adjust_scene`` equals the reference's within test_torch_ba.py's
1e-3.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ba import _FIELDS, _problem
from test_torch_ransac import F_PX, _reference_draws, _scene, _up_to_sign_scale
from tpusfm.ba import bundle_adjust as jba
from tpusfm.core import camera as jcam
from tpusfm.core import distortion as jdist
from tpusfm.core import epipolar as jepi
from tpusfm.core import homography as jhom
from tpusfm.core import lie as jlie
from tpusfm.core import triangulate as jtri
from tpusfm.features import sift as jsift
from tpusfm.matching import match as jmatch
from tpusfm.matching import pairs as jpairs
from tpusfm.pipeline import config as jconfig
from tpusfm.sfm import ransac as jransac
from tpusfm.sfm import scene as jscene
from tpusfm.sfm import tracks as jtracks
from tpusfm.sfm import two_view as jtwo
from tpusfm.utils import synth_render as jrender
from tpusfm_torch import convert
from tpusfm_torch.ba import bundle_adjust as tba
from tpusfm_torch.core import camera as tcam
from tpusfm_torch.core import distortion as tdist
from tpusfm_torch.core import epipolar as tepi
from tpusfm_torch.core import lie as tlie
from tpusfm_torch.core import triangulate as ttri
from tpusfm_torch.features import sift as tsift
from tpusfm_torch.matching import match as tmatch
from tpusfm_torch.matching import pairs as tpairs
from tpusfm_torch.pipeline import config as tconfig
from tpusfm_torch.sfm import ransac as transac
from tpusfm_torch.sfm import scene as tscene
from tpusfm_torch.sfm import tracks as ttracks
from tpusfm_torch.sfm import two_view as ttwo

torch.set_num_threads(2)


def _close(t, j, atol=1e-5):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype, (t.shape, j.shape, t.dtype, j.dtype)
    np.testing.assert_allclose(t, j, atol=atol * max(1.0, float(np.abs(j).max(initial=0.0))))


# -- matching/pairs, matching/match -------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 5, 16, 17])
def test_shard_and_pad_pairs(n):
    pairs = np.stack([np.arange(n), np.arange(n) + 3], 1).astype(np.int32)
    for a, b in zip(jpairs.shard_pairs(pairs, 3), tpairs.shard_pairs(pairs, 3)):
        np.testing.assert_array_equal(a, b)
    for (pa, va), (pb, vb) in ((jpairs.pad_pairs(pairs, m), tpairs.pad_pairs(pairs, m))
                               for m in (1, 8)):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(va, vb)
        assert pa.dtype == pb.dtype


def test_match_counts():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 50, size=(3, 4, 50)).astype(np.int32)
    valid = rng.random((3, 4, 50)) < 0.4
    want = jmatch.match_counts(jnp.asarray(idx), jnp.asarray(valid))
    got = tmatch.match_counts(torch.as_tensor(idx), torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


# -- core ----------------------------------------------------------------------

def test_make_intrinsics_k_matrix_in_front():
    for args in ((500.0,), (500.0, 480.0, 320.0, 240.0, -0.1, 0.01, 0.001)):
        _close(tcam.make_intrinsics(*args, device="cpu"), jcam.make_intrinsics(*args))
    rng = np.random.default_rng(1)
    intr = rng.uniform(100, 600, size=(5, 7)).astype(np.float32)
    _close(tcam.k_matrix(torch.as_tensor(intr)), jcam.k_matrix(jnp.asarray(intr)))
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(4, 3)), jnp.float32)))
    t = rng.normal(size=(4, 3)).astype(np.float32)
    X = rng.normal(size=(4, 3)).astype(np.float32) * 3
    np.testing.assert_array_equal(
        tcam.in_front(torch.as_tensor(R), torch.as_tensor(t), torch.as_tensor(X)).numpy(),
        np.asarray(jcam.in_front(jnp.asarray(R), jnp.asarray(t), jnp.asarray(X))))


def test_se3_helpers():
    rng = np.random.default_rng(2)
    aa = rng.normal(size=(2, 5, 3)).astype(np.float32)
    Ra = np.asarray(jlie.so3_exp(jnp.asarray(aa[0])))
    Rb = np.asarray(jlie.so3_exp(jnp.asarray(aa[1])))
    ta, tb, x = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3))
    J = lambda *a: [jnp.asarray(v) for v in a]  # noqa: E731
    T = lambda *a: [torch.as_tensor(v) for v in a]  # noqa: E731
    _close(tlie.se3_apply(*T(Ra, ta, x)), jlie.se3_apply(*J(Ra, ta, x)))
    for g, w in zip(tlie.se3_inv(*T(Ra, ta)), jlie.se3_inv(*J(Ra, ta))):
        _close(g, w)
    for g, w in zip(tlie.se3_compose(*T(Ra, ta, Rb, tb)), jlie.se3_compose(*J(Ra, ta, Rb, tb))):
        _close(g, w)
    _close(tlie.pose_to_matrix(*T(Ra, ta)), jlie.pose_to_matrix(*J(Ra, ta)))


def test_epipolar_distance_and_triangulation_angle():
    rng = np.random.default_rng(4)
    F = rng.normal(size=(3, 3, 3)).astype(np.float32)
    x0 = rng.uniform(-200, 200, size=(3, 40, 2)).astype(np.float32)
    x1 = rng.uniform(-200, 200, size=(3, 40, 2)).astype(np.float32)
    _close(tepi.epipolar_distance(*(torch.as_tensor(a) for a in (F, x0, x1))),
           jepi.epipolar_distance(*(jnp.asarray(a) for a in (F, x0, x1))), atol=1e-4)
    C0, C1, X = (rng.normal(size=(30, 3)).astype(np.float32) for _ in range(3))
    X[0] = C0[0]  # a degenerate ray
    _close(ttri.triangulation_angle(*(torch.as_tensor(a) for a in (C0, C1, X))),
           jtri.triangulation_angle(*(jnp.asarray(a) for a in (C0, C1, X))), atol=1e-4)


DIST_PARAMS = {"pinhole": None, "radial1": [-0.2], "radial3": [-0.2, 0.05, -0.01],
               "brown": [-0.1, 0.015, 0.0, 0.008, -0.006], "fisheye": [0.05, -0.01, 0.002, 0.0]}


@pytest.mark.parametrize("model", list(jdist.MODELS) + ["radial3 default"])
def test_undistort_to_pinhole(model):
    assert tdist.MODELS == jdist.MODELS
    name, params = (model, DIST_PARAMS[model]) if model in DIST_PARAMS else ("radial3", None)
    rng = np.random.default_rng(5)
    xd = rng.uniform(-0.6, 0.6, size=(7, 2)).astype(np.float32)
    jp = None if params is None else np.asarray(params, np.float32)
    want = jdist.undistort_to_pinhole(name, None if jp is None else jnp.asarray(jp),
                                      jnp.asarray(xd))
    got = tdist.undistort_to_pinhole(name, None if jp is None else torch.as_tensor(jp),
                                     torch.as_tensor(xd))
    _close(got, want)


def test_undistort_to_pinhole_unknown_model():
    with pytest.raises(ValueError, match="unknown camera model"):
        tdist.undistort_to_pinhole("orthographic", [0.0], torch.zeros(3, 2))


# -- features, tracks ----------------------------------------------------------

@pytest.mark.parametrize("name", ["NORMAL", "high", "Ultra"])
def test_sift_preset(name):
    want = jsift.preset(name, max_features=300)
    got = tsift.preset(name, max_features=300)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError):
        tsift.preset("EXTREME")


def test_union_find_and_track_observations():
    rng = np.random.default_rng(6)
    ju, tu = jtracks.UnionFind(40), ttracks.UnionFind(40)
    for a, b in rng.integers(0, 40, size=(30, 2)):
        ju.union(int(a), int(b))
        tu.union(int(a), int(b))
    assert [ju.find(i) for i in range(40)] == [tu.find(i) for i in range(40)]
    np.testing.assert_array_equal(ju.parent, tu.parent)
    track_ids = np.where(rng.random((5, 30)) < 0.5, rng.integers(0, 12, size=(5, 30)), -1)
    kp = rng.normal(size=(5, 30, 2)).astype(np.float32)
    want = jtracks.track_observations(track_ids.astype(np.int32), kp)
    got = ttracks.track_observations(track_ids.astype(np.int32), kp)
    assert list(got) == list(want)
    for t in want:
        for g, w in zip(got[t], want[t]):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


# -- scene ---------------------------------------------------------------------

def _scene_arrays(seed=7, C=4, P=16, O=32):
    rng = np.random.default_rng(seed)
    return {"intr": rng.uniform(50, 100, (C, 7)).astype(np.float32),
            "cam_rot": rng.normal(size=(C, 3)).astype(np.float32),
            "cam_t": rng.normal(size=(C, 3)).astype(np.float32),
            "cam_mask": rng.random(C) < 0.7,
            "points": rng.normal(size=(P, 3)).astype(np.float32),
            "colors": rng.integers(0, 256, (P, 3)).astype(np.uint8),
            "point_mask": rng.random(P) < 0.6,
            "obs_cam": rng.integers(0, C, O).astype(np.int32),
            "obs_pt": rng.integers(0, P, O).astype(np.int32),
            "obs_uv": rng.normal(size=(O, 2)).astype(np.float32),
            "obs_mask": rng.random(O) < 0.8}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_scene_npz_across_packages(tmp_path, writer):
    arrays = _scene_arrays()
    path = str(tmp_path / "scene.npz")
    extra = {"images": np.arange(6, dtype=np.int16)}
    if writer == "port":
        tscene.save_scene_npz(path, tscene.scene_from_numpy(arrays, "cpu"), extra=extra)
        back = jscene.scene_to_numpy(jscene.load_scene_npz(path))
    else:
        jscene.save_scene_npz(path, jscene.Scene(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                              extra=extra)
        back = tscene.scene_to_numpy(tscene.load_scene_npz(path, device="cpu"))
    assert set(back) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype, k
    np.testing.assert_array_equal(np.load(path)["images"], extra["images"])


def test_compact_points_equals_reference():
    arrays = _scene_arrays(seed=8)
    want = jscene.scene_to_numpy(jscene.compact_points(
        jscene.Scene(**{k: jnp.asarray(v) for k, v in arrays.items()})))
    got = tscene.scene_to_numpy(tscene.compact_points(tscene.scene_from_numpy(arrays, "cpu")))
    for k in arrays:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype, k


# -- sfm/ransac wrappers, sfm/two_view -----------------------------------------

def _masks_agree(j_inl, t_inl, err_ref, thresh, px_per_unit):
    """Inlier masks equal but for at most 1% of the matches, each within
    0.05 px of the threshold: minimal samples are exactly determined, so
    the two packages' SVDs give hypotheses apart by float32 rounding, which
    moves a match lying a few hundredths of a pixel from the threshold
    across it."""
    mismatch = np.asarray(j_inl) != t_inl
    assert mismatch.sum() <= math.ceil(0.01 * len(mismatch)), mismatch.sum()
    err = np.sqrt(np.asarray(err_ref)[mismatch])
    assert (np.abs(err - thresh) * px_per_unit <= 0.05).all(), err * px_per_unit


WRAPPERS = {  # name: (uses pixel coordinates, sample size, planar scene)
    "ransac_fundamental": (True, 8, False), "ransac_essential": (False, 8, False),
    "ransac_homography": (True, 4, True), "ransac_essential_5pt": (False, 5, False),
    "ransac_fundamental_7pt": (True, 7, False)}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_ransac_wrappers_with_reference_draws(name):
    pixels, s, planar = WRAPPERS[name]
    rng = np.random.default_rng(30 + len(name))
    _, x0, x1, valid, _, _ = _scene(rng, planar=planar)
    if pixels:
        x0, x1 = x0 * F_PX + 320, x1 * F_PX + 240
    key = jax.random.PRNGKey(4)
    n_iters = 64
    jm, jinl, jn = getattr(jransac, name)(key, jnp.asarray(x0), jnp.asarray(x1),
                                          jnp.asarray(valid), n_iters=n_iters)
    idx, _ = _reference_draws(key, valid, n_iters, s, 0)
    T = lambda a: torch.as_tensor(a)[None]  # noqa: E731
    tm, tinl, tn = getattr(transac, name)(None, T(x0), T(x1), T(valid), n_iters=n_iters,
                                          idx=T(idx))
    thresh = 4.0 if pixels else 4.0 / 800.0
    scorer = jhom.homography_transfer_error if planar else jepi.sampson_error
    err_ref = scorer(jm, jnp.asarray(x0), jnp.asarray(x1))
    _masks_agree(jinl, tinl[0].numpy(), err_ref, thresh, 1.0 if pixels else 800.0)
    assert int(jn) > 80
    _up_to_sign_scale(jm, tm[0].numpy(), atol=5e-3)


@pytest.fixture(scope="module")
def two_views():
    images, gt = jrender.render_orbit_images(n_views=2, img_h=240, img_w=320, focal=0.9 * 320,
                                             arc_deg=10.0, seed=3)
    return images, gt, jcam.make_intrinsics(0.9 * 320, cx=160.0, cy=120.0)


SIFT_2V = dict(n_octaves=3, max_per_octave=512, max_features=768)


def _rot_err_deg(R, gt):
    R_rel = gt["R"][1] @ gt["R"][0].T
    return np.degrees(np.arccos(np.clip((np.trace(np.asarray(R) @ R_rel.T) - 1) / 2, -1, 1)))


def test_two_view_with_reference_features_and_draws(two_views):
    """tests/test_two_view.py's setup: the reference's two_view_reconstruct,
    and the port's chain after SIFT on the reference's features with the
    reference's RANSAC sample indices."""
    images, gt, intr = two_views
    key = jax.random.PRNGKey(0)
    jout = jtwo.two_view_reconstruct(jnp.asarray(images), intr, key,
                                     sift_cfg=jsift.SiftConfig(**SIFT_2V), ransac_iters=256)
    jf = jout["features"]
    feats = convert.features_from_numpy(*(np.asarray(getattr(jf, k))
                                          for k in ("kp", "desc", "score", "mask")), "cpu")
    _, jvalid = jmatch.match_descriptors(jf.desc[0], jf.desc[1], jf.mask[0], jf.mask[1])
    idx, _ = _reference_draws(key, np.asarray(jvalid), 256, 8, 0)
    tout = ttwo.two_view_from_features(feats, torch.as_tensor(np.asarray(intr)), ransac_iters=256,
                                       idx=torch.as_tensor(idx)[None])
    np.testing.assert_array_equal(tout["match_idx"].numpy()[np.asarray(jvalid)],
                                  np.asarray(jout["match_idx"])[np.asarray(jvalid)])
    assert int(tout["n_matches"]) == int(jout["n_matches"])
    f = 0.5 * float(intr[0] + intr[1])
    x0n = jcam.pixel_to_normal(intr, jout["uv0"])
    x1n = jcam.pixel_to_normal(intr, jout["uv1"])
    err_ref = jepi.sampson_error(jout["E"], x0n, x1n)
    _masks_agree(jout["inliers"], tout["inliers"].numpy(), err_ref, 4.0 / f, f)
    _up_to_sign_scale(jout["E"], tout["E"].numpy(), atol=5e-3)
    _close(tout["R"], jout["R"], atol=1e-3)
    assert float(tout["t"] @ torch.as_tensor(np.asarray(jout["t"]))) > 0.999
    assert int(jout["n_inliers"]) > 40 and _rot_err_deg(tout["R"], gt) < 2.0


def test_two_view_reconstruct_on_cpu_meets_reference_bars(two_views):
    """The port's whole entry point (SIFT included) on the CPU holds
    tests/test_two_view.py's bars."""
    images, gt, intr = two_views
    out = ttwo.two_view_reconstruct(images, np.asarray(intr), sift_cfg=tsift.SiftConfig(**SIFT_2V),
                                    ransac_iters=256, device="cpu")
    assert set(out) == {"R", "t", "E", "points", "uv0", "uv1", "match_idx", "inliers",
                        "n_inliers", "n_matches", "features"}
    assert int(out["n_inliers"]) > 40
    assert _rot_err_deg(out["R"], gt) < 2.0
    X = out["points"].numpy()[out["inliers"].numpy()]
    assert (X[:, 2] > 0).mean() > 0.95


# -- ba: obs_chunk, bundle_adjust_scene, config conversion -------------------

@pytest.mark.parametrize("precond_path", ["dense_schur", "pcg"])
def test_obs_chunk_chunked_equals_unchunked(precond_path):
    prob = _problem(seed=5)
    O = len(prob["obs_cam"])
    scene = tscene.scene_from_numpy(prob, "cpu")
    args = {k: getattr(scene, k) for k in _FIELDS}
    base = tba.BAConfig(max_iters=6, dense_schur_max_dim=384 if precond_path == "dense_schur"
                        else 0)
    one = tba.bundle_adjust(cfg=base, **args)
    chunk = 256
    assert O > chunk and O % chunk  # several chunks, and a padded table
    many = tba.bundle_adjust(cfg=dataclasses.replace(base, obs_chunk=chunk), **args)
    a, b = float(one[4]["final_cost"]), float(many[4]["final_cost"])
    assert abs(a - b) <= 1e-5 * a and one[4]["iterations"] == many[4]["iterations"]
    for x, y in zip(one[1:4], many[1:4]):
        np.testing.assert_allclose(y.numpy(), x.numpy(), atol=1e-4)
    assert int(many[4]["n_obs"]) == int(prob["obs_mask"].sum())


@pytest.mark.parametrize("assume_sorted", [False, True])
def test_obs_chunk_padding(assume_sorted):
    cam = torch.tensor([3, 1, 2, 0, 1], dtype=torch.int32)
    pt = torch.tensor([0, 0, 1, 2, 2], dtype=torch.int32)
    uv = torch.ones((5, 2))
    mask = torch.ones(5, dtype=torch.bool)
    c, p, u, m = tba._pad_obs(cam, pt, uv, mask, 4, assume_sorted)
    assert len(c) == 8 and not m[5:].any() and (c[5:] == 0).all() and (u[5:] == 0).all()
    assert p[5:].tolist() == ([2, 2, 2] if assume_sorted else [0, 0, 0])
    assert tba._pad_obs(cam, pt, uv, mask, 8, assume_sorted)[0] is cam  # one chunk: no pad


def test_bundle_adjust_scene_equals_reference():
    prob = _problem(seed=9)
    jsc = jscene.Scene(**{k: jnp.asarray(prob[k]) for k in _FIELDS},
                       colors=jnp.asarray(prob["colors"]))
    jout, jinfo = jba.bundle_adjust_scene(jsc, jba.BAConfig(max_iters=8, impl="xla"))
    tout, tinfo = tba.bundle_adjust_scene(tscene.scene_from_numpy(prob, "cpu"),
                                          tba.BAConfig(max_iters=8))
    jc, tc = float(jinfo["final_cost"]), float(tinfo["final_cost"])
    assert abs(tc - jc) <= 1e-3 * jc
    for f in ("cam_rot", "cam_t", "points"):
        np.testing.assert_allclose(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                                   atol=1e-3)
    np.testing.assert_array_equal(tout.obs_uv.numpy(), prob["obs_uv"])


def test_config_conversion_carries_obs_chunk():
    assert tba.BAConfig().obs_chunk == jba.BAConfig().obs_chunk == 65536
    jcfg = jconfig.PipelineConfig()
    jcfg = dataclasses.replace(jcfg, engine=dataclasses.replace(
        jcfg.engine, ba=jba.BAConfig(max_iters=8, cg_iters=25, obs_chunk=32768)))
    got = convert.config_from_jax(jcfg)
    assert got.engine.ba.obs_chunk == 32768 and got.engine.ba.cg_iters == 25
    assert math.isclose(got.engine.ba.cg_tol, jba.BAConfig().cg_tol)
    assert got == dataclasses.replace(tconfig.PipelineConfig(), engine=dataclasses.replace(
        tconfig.PipelineConfig().engine, ba=tba.BAConfig(max_iters=8, cg_iters=25,
                                                         obs_chunk=32768)))
