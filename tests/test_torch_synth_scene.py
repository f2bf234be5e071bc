"""The port's jax-free orbit_scene (tpusfm_torch/utils/synth_scene.py)
against the reference test helper tests/synth.py, for two seeds and two
settings.  Every array is equal; the axis-angle column, computed by the
port's float32 so3_log instead of the reference's, agrees to 1e-6 (a few
float32 ulps of angles up to pi)."""

import numpy as np
import pytest
import torch

from synth import orbit_scene as jax_orbit_scene
from tpusfm_torch.utils.synth_scene import orbit_scene

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [
    dict(n_cams=12, n_points=300, noise_px=0.5, seed=3, arc_deg=350.0, vis_prob=0.3),
    dict(n_cams=8, n_points=200, noise_px=0.0, seed=0),
])
def test_orbit_scene_equals_reference(kw):
    want = jax_orbit_scene(**kw)
    got = orbit_scene(**kw)
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "aa":
            np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k


def test_brown_ba_problem_projects_through_the_reference_lens():
    """point_sorted_ba_problem(brown=...) keeps the pinhole problem's
    scene, visibility and start, and its observations are the reference
    camera model's Brown-T2 projections of the true scene plus the stated
    0.5 px noise (every residual under 5 sigma, the spread near 0.5)."""
    import jax.numpy as jnp

    from tpusfm.core import camera as jcam
    from tpusfm_torch.utils.synth_scene import point_sorted_ba_problem

    lens = (-0.10, 0.015, 0.0, 0.008, -0.006)
    pin = point_sorted_ba_problem(12, 400, vis_prob=0.5)
    got = point_sorted_ba_problem(12, 400, vis_prob=0.5, brown=lens)
    for k in ("obs_cam", "obs_pt", "cam_rot", "cam_t", "points"):
        np.testing.assert_array_equal(got[k], pin[k], err_msg=k)
    assert got["intr"].shape == (12, 9) and not got["intr"][:, 4:].any()
    s = orbit_scene(n_cams=12, n_points=400, seed=3, arc_deg=350.0, vis_prob=0.5)
    truth = s["points"][np.unique(s["obs_pt"])]  # point_sorted's ids: observed points in order
    Xc = np.einsum("oij,oj->oi", s["R"][got["obs_cam"]], truth[got["obs_pt"]]) \
        + s["t"][got["obs_cam"]]
    intr = np.concatenate([s["intr"][:4], lens]).astype(np.float32)
    want = np.asarray(jcam.camera_to_pixel(jnp.asarray(np.tile(intr, (len(Xc), 1))),
                                           jnp.asarray(Xc.astype(np.float32))))
    res = got["obs_uv"] - want
    assert np.abs(res).max() < 2.5 and 0.4 < res.std() < 0.6


def test_pod_ba_problem_equals_the_reference_scale_test():
    """pod_ba_problem builds tests/test_pod_scale.py:26-45's arguments (the
    reference's construction, replayed here at 40 cameras and 800 points
    from tests/synth.py).  The axis-angle column agrees to 2e-6: under ten
    float32 ulps of the angles near pi that this 355-degree orbit reaches."""
    from tpusfm_torch.utils.synth_scene import pod_ba_problem

    C, P = 40, 800
    s = jax_orbit_scene(n_cams=C, n_points=P, noise_px=0.5, seed=4, arc_deg=355.0,
                        vis_prob=0.04)
    r = np.random.default_rng(1)
    want = dict(intr=np.tile(s["intr"], (C, 1)),
                cam_rot=np.asarray(s["aa"] + r.normal(scale=0.008, size=(C, 3)), np.float32),
                cam_t=np.asarray(s["t"] + r.normal(scale=0.008, size=(C, 3)), np.float32),
                cam_mask=np.ones(C, bool),
                points=np.asarray(s["points"] + r.normal(scale=0.02, size=(P, 3)), np.float32),
                point_mask=np.asarray(s["point_valid"]), obs_cam=s["obs_cam"],
                obs_pt=s["obs_pt"], obs_uv=s["obs_uv"], obs_mask=np.ones(len(s["obs_cam"]), bool))
    got, centers = pod_ba_problem(C, P)
    assert set(got) == set(want)
    np.testing.assert_array_equal(centers, np.asarray(s["centers"]))
    for k, v in want.items():
        if k == "cam_rot":
            np.testing.assert_allclose(got[k], v, rtol=0, atol=2e-6)
        else:
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        assert got[k].dtype == np.asarray(v).dtype, k
