"""Bundle-adjustment parity: the port's LM solver against the JAX reference
on a perturbed 8-camera orbit scene, fed to both through
tpusfm_torch.convert.scene_from_numpy.  The dense-Schur Cholesky path (every
20-view solve), the plain PCG path (forced by dense_schur_max_dim=0,
against the reference's impl="xla") and the kernel path (impl="pallas":
K2-K4's twins on the CPU, against the reference's Pallas path in interpret
mode) must reach the same final cost within 1e-3 relative, and the same
poses and points within 1e-3.  More kernel-path cases are in
test_torch_ba_kernel_path.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import orbit_scene
from tpusfm.ba import bundle_adjust as jba
from tpusfm_torch import convert
from tpusfm_torch.ba import bundle_adjust as tba

torch.set_num_threads(2)

_FIELDS = ("intr", "cam_rot", "cam_t", "cam_mask", "points", "point_mask",
           "obs_cam", "obs_pt", "obs_uv", "obs_mask")


def _problem(seed=0, n_cams=8, n_points=200, noise_px=0.5, perturb=0.01):
    s = orbit_scene(n_cams=n_cams, n_points=n_points, noise_px=noise_px, seed=seed)
    r = np.random.default_rng(seed + 1)
    aa = s["aa"] + r.normal(scale=perturb, size=(n_cams, 3))
    t = s["t"] + r.normal(scale=perturb, size=(n_cams, 3))
    pts = s["points"] + r.normal(scale=2 * perturb, size=(n_points, 3))
    aa[0], t[0] = s["aa"][0], s["t"][0]
    O = len(s["obs_cam"])
    obs_mask = np.ones(O, bool)
    obs_mask[r.random(O) < 0.05] = False  # some observations washed out
    return dict(
        intr=np.tile(s["intr"], (n_cams, 1)).astype(np.float32),
        cam_rot=aa.astype(np.float32), cam_t=t.astype(np.float32),
        cam_mask=np.ones(n_cams, bool),
        points=pts.astype(np.float32), point_mask=s["point_valid"],
        obs_cam=s["obs_cam"].astype(np.int32), obs_pt=s["obs_pt"].astype(np.int32),
        obs_uv=s["obs_uv"].astype(np.float32), obs_mask=obs_mask,
        colors=np.zeros((n_points, 3), np.uint8),
    )


def _run_both(prob, jcfg, tcfg, **kw):
    jout = jba.bundle_adjust(cfg=jcfg, **{k: jnp.asarray(prob[k]) for k in _FIELDS},
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    scene = convert.scene_from_numpy(prob, "cpu")
    tout = tba.bundle_adjust(cfg=tcfg, **{k: getattr(scene, k) for k in _FIELDS},
                             **{k: torch.as_tensor(v) for k, v in kw.items()})
    return jout, tout


def _compare(jout, tout, rtol_cost=1e-3, atol=1e-3):
    jintr, jrot, jt, jpts, jinfo = jout
    tintr, trot, tt, tpts, tinfo = tout
    jc, tc = float(jinfo["final_cost"]), float(tinfo["final_cost"])
    assert tc < 0.1 * float(tinfo["initial_cost"])
    assert abs(tc - jc) <= rtol_cost * jc, (tc, jc)
    np.testing.assert_allclose(trot.numpy(), np.asarray(jrot), atol=atol)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=atol)
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), atol=atol)
    np.testing.assert_allclose(tintr.numpy(), np.asarray(jintr), rtol=1e-4)


@pytest.mark.parametrize("path", ["dense_schur", "pcg"])
def test_ba_matches_reference(path):
    prob = _problem()
    jcfg = jba.BAConfig(max_iters=10, impl="xla")
    tcfg = tba.BAConfig(max_iters=10)
    if path == "pcg":
        jcfg = dataclasses.replace(jcfg, dense_schur_max_dim=0)
        tcfg = dataclasses.replace(tcfg, dense_schur_max_dim=0)
    assert tba._dense_eligible(8, 8, 200, tcfg) == (path == "dense_schur")
    _compare(*_run_both(prob, jcfg, tcfg))


def test_ba_self_calibration_and_priors_match_reference():
    """Shared focal refined (one group) plus GPS camera-center priors.  (With
    every RADIAL3 lane free this noise-free scene leaves the principal point
    in a flat valley where the two solvers drift apart after the costs have
    converged, so the comparison refines the well-posed focal block.)"""
    prob = _problem(seed=3)
    s = orbit_scene(n_cams=8, n_points=200, seed=3)
    jcfg = jba.BAConfig(max_iters=8, impl="xla", refine_intrinsics=True, refine_params="focal")
    tcfg = tba.BAConfig(max_iters=8, refine_intrinsics=True, refine_params="focal")
    kw = dict(cam_group=np.zeros(8, np.int32), prior_pos=s["centers"].astype(np.float32),
              prior_weight=np.full(8, 0.5, np.float32))
    jout = jba.bundle_adjust(cfg=jcfg, n_groups=1, **{k: jnp.asarray(prob[k]) for k in _FIELDS},
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    scene = convert.scene_from_numpy(prob, "cpu")
    tout = tba.bundle_adjust(cfg=tcfg, n_groups=1, **{k: getattr(scene, k) for k in _FIELDS},
                             **{k: torch.as_tensor(v) for k, v in kw.items()})
    _compare(jout, tout)


@pytest.mark.parametrize("case", ["plain", "masked_points", "frozen_cams"])
def test_ba_kernel_path_matches_reference(case):
    """Port impl="pallas" vs reference impl="pallas", pallas_interpret=True
    (bf16 W on both sides, precond "hcc").  The cases share one reference
    compile: cam_free_mask is passed in all three."""
    prob = _problem()
    free = np.ones(8, bool)
    if case == "masked_points":  # held points sit at the truth, so the cost still falls
        held = np.arange(200) % 7 == 3
        prob["point_mask"] = prob["point_mask"] & ~held
        prob["points"][held] = orbit_scene(n_cams=8, n_points=200, seed=0)["points"][held]
    if case == "frozen_cams":
        free[[2, 5]] = False
    jcfg = jba.BAConfig(max_iters=10, impl="pallas", pallas_interpret=True)
    tcfg = tba.BAConfig(max_iters=10, impl="pallas")
    jout, tout = _run_both(prob, jcfg, tcfg, cam_free_mask=free)
    _compare(jout, tout)
    if case == "masked_points":
        held = ~prob["point_mask"]
        np.testing.assert_array_equal(tout[3].numpy()[held], prob["points"][held])
    if case == "frozen_cams":
        np.testing.assert_array_equal(tout[1].numpy()[~free], prob["cam_rot"][~free])
        np.testing.assert_array_equal(tout[2].numpy()[~free], prob["cam_t"][~free])

