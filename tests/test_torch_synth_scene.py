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
