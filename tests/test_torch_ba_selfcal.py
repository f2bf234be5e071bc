"""Self-calibrating and unfused solves of the BA kernel path (port
impl="pallas": the twins of K2's refine mode, K4, K5, K6 and K7 on the
CPU) against the JAX reference.

The reference's own kernel path is not the yardstick where intrinsics are
refined: its `_schur_fwd_t_kernel` drops the W rows past the sixth
(tpusfm/ops/obs_table.py:1811-1815), so its self-calibrating matvec is not
the operator its right-hand side assumes and its solve stalls.  Those
cases are held against the reference's plain path (impl="xla") instead.
Where intrinsics are held, its kernel path (interpret mode) is the
yardstick, as in test_torch_ba.py.

Tolerances: the final cost within 1e-3 relative (bf16 W and the damped-Hcc
preconditioner perturb the CG steps; LM's accept test absorbs that, as in
test_torch_ba.py).  Parameters in flat valleys of these small scenes
(principal point, fy of the planar orbit, points seen from two close
cameras) differ between two correct solvers after the costs have
converged, so only well-posed parameters are compared: fx to 2e-4
relative, and the Brown lanes to the bars of test_camera_models.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_camera_models import _brown_ba_problem
from test_torch_ba import _FIELDS, _problem
from tpusfm.ba import bundle_adjust as jba
from tpusfm_torch.ba import bundle_adjust as tba

torch.set_num_threads(2)

# Groups per case: camera -> group, the group count, and the cameras whose
# observations are all masked (their group has no weighted row, so it is
# frozen, as is an empty group).
CASES = {
    "one_group": (np.zeros(8, np.int32), 1, []),
    "two_groups": (np.repeat([0, 1], 4).astype(np.int32), 2, []),
    "frozen_group": (np.array([0] * 6 + [1, 1], np.int32), 3, [6, 7]),
}


def _solve_both(prob, jcfg, tcfg, cam_group, n_groups):
    jout = jba.bundle_adjust(cfg=jcfg, n_groups=n_groups, cam_group=jnp.asarray(cam_group),
                             **{k: jnp.asarray(prob[k]) for k in _FIELDS})
    tout = tba.bundle_adjust(cfg=tcfg, n_groups=n_groups, cam_group=torch.as_tensor(cam_group),
                             **{k: torch.as_tensor(prob[k]) for k in _FIELDS})
    jc, tc = float(jout[4]["final_cost"]), float(tout[4]["final_cost"])
    assert tc < 0.1 * float(tout[4]["initial_cost"])
    assert abs(tc - jc) <= 1e-3 * jc, (tc, jc)
    return jout, tout


@pytest.mark.parametrize("case", list(CASES))
def test_selfcal_kernel_path_matches_reference_plain_path(case):
    """RADIAL3, every lane refined ("all", as run_sparse's self-calibration
    sets it), the focal started 2% off: the fused K2 in refine mode, K5 on
    Wc and Wg, K4 on both, against the reference's plain PCG path."""
    cam_group, n_groups, masked = CASES[case]
    prob = _problem()
    prob["intr"][:, :2] *= 1.02
    prob["obs_mask"] = prob["obs_mask"] & ~np.isin(prob["obs_cam"], masked)
    jcfg = jba.BAConfig(max_iters=10, impl="xla", dense_schur_max_dim=0, refine_intrinsics=True)
    tcfg = tba.BAConfig(max_iters=10, impl="pallas", refine_intrinsics=True)
    jout, tout = _solve_both(prob, jcfg, tcfg, cam_group, n_groups)
    live = ~np.isin(np.arange(8), masked)
    np.testing.assert_allclose(tout[0].numpy()[live, 0], np.asarray(jout[0])[live, 0], rtol=2e-4)
    assert abs(float(tout[0][0, 0]) - 800.0) < 2.0  # from 816 back to the truth
    # A frozen group keeps its input intrinsics bit for bit.
    np.testing.assert_array_equal(tout[0].numpy()[~live], prob["intr"][~live])


def _brown_args(refine: bool):
    """tests/test_camera_models.py's 12-camera Brown-T2 problem (2,400
    observations), one group, started from zero distortion when refining
    and from the true intrinsics when they are held."""
    d = _brown_ba_problem()
    C, P, rng = d["C"], d["P"], d["rng"]
    intr0 = d["intr_gt"].copy()
    if refine:
        intr0[4:9] = 0.0
    return d["intr_gt"], dict(
        intr=np.tile(intr0, (C, 1)),
        cam_rot=(d["aa"] + rng.normal(scale=0.005, size=(C, 3))).astype(np.float32),
        cam_t=d["t"], cam_mask=np.ones(C, bool),
        points=(d["pts"] + rng.normal(scale=0.02, size=(P, 3))).astype(np.float32),
        point_mask=np.ones(P, bool), obs_cam=d["ocam"].astype(np.int32),
        obs_pt=d["opt"].astype(np.int32), obs_uv=d["uv"], obs_mask=np.ones(len(d["ocam"]), bool))


def test_brown_selfcal_unfused_kernel_path_matches_reference_plain_path():
    """Brown-T2 (9 lanes) takes the unfused path: jacfwd Jacobians reduced
    by K6/K7, K5 and K4 with D = 9 for the group.  Both reach the noise
    floor and recover the distortion within test_camera_models.py's bars."""
    gt, prob = _brown_args(refine=True)
    common = dict(max_iters=30, cg_iters=60, refine_intrinsics=True, camera_model="brown")
    jout, tout = _solve_both(prob, jba.BAConfig(impl="xla", dense_schur_max_dim=0, **common),
                             tba.BAConfig(impl="pallas", **common), np.zeros(12, np.int32), 1)
    g, jg = tout[0].numpy()[0], np.asarray(jout[0])[0]
    for lane, bar in ((4, 0.01), (7, 0.003), (8, 0.003)):
        assert abs(g[lane] - gt[lane]) < bar and abs(jg[lane] - gt[lane]) < bar, (lane, g, jg)
    np.testing.assert_allclose(g[0], jg[0], rtol=2e-4)


def test_brown_held_unfused_kernel_path_matches_reference_kernel_path():
    """Brown-T2 with intrinsics held: K6/K7 linearization and K3 matvecs
    against the reference's kernel path in interpret mode (with intrinsics
    held it runs no group table through its K5, so it is the yardstick
    here); poses within 1e-3."""
    _, prob = _brown_args(refine=False)
    common = dict(max_iters=15, cg_iters=60, camera_model="brown")
    jout, tout = _solve_both(prob, jba.BAConfig(impl="pallas", pallas_interpret=True, **common),
                             tba.BAConfig(impl="pallas", **common), np.zeros(12, np.int32), 1)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), atol=1e-3)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), atol=1e-3)
