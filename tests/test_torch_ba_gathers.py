"""The BA kernel path with the reference's `fused_linearize=False` and
`pallas_gathers=True` (port impl="pallas": the twins of K8, K9, K6, K7,
K3-K5 on the CPU) against the reference's Pallas path in interpret mode
with the same fields: the unfused linearization gathers poses, intrinsics
and rank-space points through K8/K9, and `precond="schur_diag"` gathers
the Hpp^-1 rows through K8.

Tolerances as in test_torch_ba.py: final cost within 1e-3 relative, poses
and points within 1e-3.  The refined case frees only the focal lanes
(refine_params="focal"): the reference's K5 drops the group table's W rows
past the sixth (ROADMAP section 3), which are zero under that mask, so its
kernel path is the yardstick there too; fx within 2e-4 relative, as in
test_torch_ba_selfcal.py."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_ba import _FIELDS, _compare, _problem, _run_both
from test_torch_ba_selfcal import _solve_both
from tpusfm.ba import bundle_adjust as jba
from tpusfm_torch.ba import bundle_adjust as tba
from tpusfm_torch.ops import obs_table as ot

torch.set_num_threads(2)

GATHER_PATH = dict(max_iters=10, impl="pallas", fused_linearize=False, pallas_gathers=True)


@pytest.mark.parametrize("precond", ["hcc", "schur_diag"])
def test_gather_path_matches_reference(precond):
    prob = _problem()
    jcfg = jba.BAConfig(pallas_interpret=True, precond=precond, **GATHER_PATH)
    tcfg = tba.BAConfig(precond=precond, **GATHER_PATH)
    _compare(*_run_both(prob, jcfg, tcfg))


def test_gather_path_self_calibrating_matches_reference():
    """One intrinsic group, focal lanes refined from 2% off."""
    prob = _problem()
    prob["intr"][:, :2] *= 1.02
    common = dict(refine_intrinsics=True, refine_params="focal", **GATHER_PATH)
    jout, tout = _solve_both(prob, jba.BAConfig(pallas_interpret=True, **common),
                             tba.BAConfig(**common), np.zeros(8, np.int32), 1)
    np.testing.assert_allclose(tout[0].numpy()[:, 0], np.asarray(jout[0])[:, 0], rtol=2e-4)
    assert abs(float(tout[0][0, 0]) - 800.0) < 2.0  # from 816 back to the truth


def _solve(prob, cfg, **kw):
    args = {k: torch.as_tensor(prob[k]) for k in _FIELDS}
    return tba.bundle_adjust(cfg=cfg, **args, **{k: torch.as_tensor(v) for k, v in kw.items()})


def _recording_gathers(monkeypatch):
    """Tables passed to K8 and K9 during a solve, as (name, rows, width)."""
    seen = []
    for name in ("gather_table", "gather_sorted"):
        fn = getattr(ot, name)

        def rec(table, idx, _name=name, _fn=fn):
            seen.append((_name, table.shape[0], table.shape[1]))
            return _fn(table, idx)

        monkeypatch.setattr(ot, name, rec)
    return seen


@pytest.mark.parametrize("refine", [False, True])
def test_gather_path_equals_plain_gathers_bit_for_bit(monkeypatch, refine):
    """K8 and K9 copy rows, so pallas_gathers changes no bit of the solve;
    the solve gathers poses (C, 6), intrinsics (G, 7), Hpp^-1 rows (P, 9)
    through K8 and the rank-space points (P, 3) through K9.  Both also put
    Wc's rows (O, 18) in camera order through K8, with or without
    pallas_gathers (K4 reads W in that order)."""
    prob = _problem()
    kw = dict(cam_group=np.zeros(8, np.int32), n_groups=1) if refine else {}
    cfg = tba.BAConfig(precond="schur_diag", refine_intrinsics=refine, **GATHER_PATH)
    plain = _solve(prob, dataclasses.replace(cfg, pallas_gathers=False), **kw)
    seen = _recording_gathers(monkeypatch)
    got = _solve(prob, cfg, **kw)
    for a, b in zip(got[:4], plain[:4]):
        assert torch.equal(a, b)
    assert float(got[4]["final_cost"]) == float(plain[4]["final_cost"])
    G = 1 if refine else 8
    P = prob["points"].shape[0]
    assert set(seen) == {("gather_table", 8, 6), ("gather_table", G, 7),
                         ("gather_table", P, 9), ("gather_sorted", P, 3),
                         ("gather_table", prob["obs_cam"].shape[0], 18)}


def test_schur_diag_gather_keeps_the_4096_row_gate(monkeypatch):
    """Above 4096 point ranks the Hpp^-1 gather takes the plain gather, as
    in the reference (:673); the pose, intrinsic and point gathers still go
    through K8 and K9.  (Wc's rows in camera order, (O, 18), go through K8
    at any size: that gather is the port's own, outside the gate.)"""
    prob = _problem(n_cams=6, n_points=4200)
    seen = _recording_gathers(monkeypatch)
    cfg = tba.BAConfig(precond="schur_diag", **dict(GATHER_PATH, max_iters=1))
    out = _solve(prob, cfg)
    assert np.isfinite(float(out[4]["final_cost"]))
    assert ("gather_sorted", 4200, 3) in seen and ("gather_table", 6, 6) in seen
    wc_seg = ("gather_table", prob["obs_cam"].shape[0], 18)
    assert wc_seg in seen
    assert not any(name == "gather_table" and rows > 4096 for name, rows, d in seen
                   if (name, rows, d) != wc_seg)
