"""More parity cases of the BA kernel path (port impl="pallas", K2-K4's
twins on the CPU) against the reference's Pallas path in interpret mode:
a 70-camera problem, where impl="auto" is not dense-eligible and so takes
the kernels on a CUDA device, and the exact Schur-diagonal preconditioner.
Final cost within 1e-3 relative, poses and points within 1e-3, as in
test_torch_ba.py."""

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_ba import _compare, _problem, _run_both
from tpusfm.ba import bundle_adjust as jba
from tpusfm_torch.ba import bundle_adjust as tba

torch.set_num_threads(2)


def test_ba_kernel_path_70_cameras_matches_reference():
    prob = _problem(n_cams=70, n_points=300)
    assert not tba._dense_eligible(70, 70, 300, tba.BAConfig())
    jcfg = jba.BAConfig(max_iters=10, impl="pallas", pallas_interpret=True)
    tcfg = tba.BAConfig(max_iters=10, impl="pallas")
    _compare(*_run_both(prob, jcfg, tcfg))


def test_ba_kernel_path_schur_diag_matches_reference():
    prob = _problem()
    jcfg = jba.BAConfig(max_iters=10, impl="pallas", pallas_interpret=True, precond="schur_diag")
    tcfg = tba.BAConfig(max_iters=10, impl="pallas", precond="schur_diag")
    jout, tout = _run_both(prob, jcfg, tcfg)
    _compare(jout, tout)
    assert np.isfinite(float(jnp.asarray(jout[4]["final_cost"])))
