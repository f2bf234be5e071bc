"""GPS geo-registration and the GPS-prior BA of the port against the JAX
reference on the CPU: lla_to_enu to 1e-9, georegister_scene to rtol 1e-5,
gps_prior_ba's final cost to rtol 1e-3, on a seeded synthetic orbit whose
reconstruction sits in an arbitrary similarity frame."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from synth import orbit_scene
from tpusfm.core import lie as jlie
from tpusfm.sfm import scene as jscene
from tpusfm.utils import geo as jgeo
from tpusfm_torch.sfm import scene as tscene
from tpusfm_torch.utils import geo as tgeo

torch.set_num_threads(2)


def test_lla_to_enu_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(3):
        ref = (rng.uniform(-80, 80), rng.uniform(-180, 180), rng.uniform(-50, 3000))
        lat = ref[0] + rng.normal(scale=1e-3, size=40)
        lon = ref[1] + rng.normal(scale=1e-3, size=40)
        alt = ref[2] + rng.normal(scale=30, size=40)
        np.testing.assert_allclose(tgeo.lla_to_ecef(lat, lon, alt), jgeo.lla_to_ecef(lat, lon, alt),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(tgeo.lla_to_enu(lat, lon, alt, ref),
                                   jgeo.lla_to_enu(lat, lon, alt, ref), rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def problem():
    """A 12-camera orbit with 0.5 px noise, expressed in a similarity frame
    (scale 0.05), two cameras unregistered and one without a fix; GPS fixes
    at the metric centres plus 0.3 m of noise."""
    rng = np.random.default_rng(7)
    s = orbit_scene(n_cams=12, n_points=200, noise_px=0.5, seed=7, vis_prob=0.9)
    s_true = 0.05
    R_g = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.3, 0.8])), np.float64)
    t_g = np.array([3.0, -1.0, 2.0])
    centers_rec = (s["centers"] - t_g) @ R_g / s_true
    R_rec = np.einsum("vij,jk->vik", s["R"].astype(np.float64), R_g)
    t_rec = -np.einsum("vij,vj->vi", R_rec, centers_rec)
    aa_rec = np.asarray(jlie.so3_log(jnp.asarray(R_rec.astype(np.float32))))
    pts_rec = (s["points"] - t_g) @ R_g / s_true
    C, O = len(s["t"]), len(s["obs_cam"])
    cam_mask = np.ones(C, bool)
    cam_mask[[4, 9]] = False
    arrays = dict(
        intr=np.tile(s["intr"], (C, 1)), cam_rot=aa_rec.astype(np.float32),
        cam_t=t_rec.astype(np.float32), cam_mask=cam_mask,
        points=pts_rec.astype(np.float32),
        colors=rng.integers(0, 256, (len(pts_rec), 3), dtype=np.uint8),
        point_mask=np.asarray(s["point_valid"]), obs_cam=s["obs_cam"].astype(np.int32),
        obs_pt=s["obs_pt"].astype(np.int32), obs_uv=s["obs_uv"].astype(np.float32),
        obs_mask=cam_mask[s["obs_cam"]])
    enu = s["centers"] + rng.normal(scale=0.3, size=s["centers"].shape)
    ref = (37.0, -122.0, 15.0)
    gps = [(ref[0] + n / 111_111.0, ref[1] + e / (111_111.0 * np.cos(np.radians(37.0))),
            ref[2] + u) for e, n, u in enu]
    gps[2] = None
    return arrays, gps


def _pair(arrays):
    return (jscene.Scene(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tscene.scene_from_numpy(arrays, "cpu"))


def _close(t_scene, j_scene, names, rtol, atol):
    for name in names:
        np.testing.assert_allclose(getattr(t_scene, name).numpy(),
                                   np.asarray(getattr(j_scene, name)), rtol=rtol, atol=atol,
                                   err_msg=name)


def test_georegister_scene_matches_reference(problem):
    arrays, gps = problem
    js, ts = _pair(arrays)
    jout, jinfo = jgeo.georegister_scene(js, gps)
    tout, tinfo = tgeo.georegister_scene(ts, gps)
    _close(tout, jout, ("points", "cam_t"), 1e-5, 1e-4)
    _close(tout, jout, ("cam_rot",), 1e-5, 1e-5)
    assert tinfo["n_gps"] == jinfo["n_gps"] == 9
    assert tinfo["ref_lla"] == jinfo["ref_lla"]
    np.testing.assert_allclose([tinfo["scale"], tinfo["rms_m"]],
                               [jinfo["scale"], jinfo["rms_m"]], rtol=1e-5)
    assert abs(tinfo["scale"] - 0.05) < 2.5e-3 and tinfo["rms_m"] < 1.0


def test_too_few_fixes(problem):
    arrays, gps = problem
    js, ts = _pair(arrays)
    few = [g if i in (0, 1) else None for i, g in enumerate(gps)]
    for geo, sc in ((jgeo, js), (tgeo, ts)):
        with pytest.raises(ValueError, match="needs >= 3 GPS views, got 2"):
            geo.georegister_scene(sc, few)
        out, info = geo.gps_prior_ba(sc, few)
        assert info is None and out is sc


def test_gps_prior_ba_matches_reference(problem):
    arrays, gps = problem
    js, ts = _pair(arrays)
    jreg, _ = jgeo.georegister_scene(js, gps)
    treg, _ = tgeo.georegister_scene(ts, gps)
    jout, jinfo = jgeo.gps_prior_ba(jreg, gps, max_iters=20)
    tout, tinfo = tgeo.gps_prior_ba(treg, gps, max_iters=20)
    assert tinfo["n_gps"] == jinfo["n_gps"] == 9 and tinfo["sigma_m"] == 3.0
    np.testing.assert_allclose(tinfo["ba_final_cost"], jinfo["ba_final_cost"], rtol=1e-3)
    np.testing.assert_allclose(tinfo["rms_m"], jinfo["rms_m"], rtol=1e-3, atol=1e-3)
    _close(tout, jout, ("points",), 0, 2e-3)
    assert tinfo["rms_m"] < 1.0
