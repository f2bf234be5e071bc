"""The kernel path's choice of linearization route (``_fused`` in
tpusfm_torch/ba/bundle_adjust.py) on the CPU twins: RADIAL3 takes the
fused K2 at any number of cameras and groups, past the reference's 2,048
too; other camera models, intrinsics of other than 7 lanes and
``fused_linearize=False`` take jacfwd reduced by K6/K7.  At 2,100 cameras
with short tracks (about 25k observations) the two routes give the same
first linearization in float64 and solves that end at the same cost.

The point blocks' 3x3 inverse (``_inv3``) stays finite for the blocks of
1e15 and more that a point just behind an image plane gives, which the K2
route met at BAL Final's size, and keeps every other block's bits."""

import pytest
import torch

from torch_ba_routes import FIELDS, ba_args, first_linearization
from tpusfm_torch.ba import bundle_adjust as tba
from tpusfm_torch.ops import obs_table as ot
from tpusfm_torch.utils.synth_scene import point_sorted_ba_problem

torch.set_num_threads(2)

N_CAMS = 2100


@pytest.fixture(scope="module")
def above_2048():
    prob = point_sorted_ba_problem(N_CAMS, 3000, vis_prob=0.004)
    assert len(prob["obs_cam"]) <= 30000
    return prob


def _counting(monkeypatch, name):
    calls = [0]
    fn = getattr(ot, name)

    def counted(*a, **kw):
        calls[0] += 1
        return fn(*a, **kw)

    monkeypatch.setattr(ot, name, counted)
    return calls


def test_ba_above_2048_cameras_takes_k2_on_the_twins(above_2048, monkeypatch):
    """A kernel-path solve at 2,100 cameras linearizes through K2 (its twin
    here) and sums no camera table through K6; the same solve with
    fused_linearize=False takes K6/K7 and never K2; the final costs agree
    within 1e-2."""
    args = ba_args(above_2048, "cpu")
    k2 = _counting(monkeypatch, "linearize_reduce_radial3_t")
    k6 = _counting(monkeypatch, "segsum_table_t")
    cfg = tba.BAConfig(max_iters=5, impl="pallas")
    fused = tba.bundle_adjust(cfg=cfg, **args)
    assert k2[0] == fused[4]["iterations"] + 1 and k6[0] == 0, (k2, k6)
    k2[0] = 0
    unfused = tba.bundle_adjust(cfg=tba.BAConfig(max_iters=5, impl="pallas",
                                                 fused_linearize=False), **args)
    assert k2[0] == 0 and k6[0] > 0, (k2, k6)
    fc, uc = float(fused[4]["final_cost"]), float(unfused[4]["final_cost"])
    assert fc < 0.1 * float(fused[4]["initial_cost"])
    assert abs(fc - uc) <= 1e-2 * uc, (fc, uc)
    assert torch.isfinite(fused[3]).all()


def test_first_linearization_routes_agree_above_2048_cameras(above_2048, monkeypatch):
    """Hcc, gc, Hpp, gp and the cost of the first linearization at 2,100
    cameras, K2's twin against jacfwd + K6/K7's, both in float64: within
    1e-9 of the scale (closed-form against automatic derivatives)."""
    args = ba_args(above_2048, "cpu", torch.float64)
    got = {fused: first_linearization(args, tba.BAConfig(impl="pallas", fused_linearize=fused),
                                      monkeypatch) for fused in (True, False)}
    for k in FIELDS:
        assert got[True][k].dtype == torch.float64
        scale = float(got[False][k].abs().max())
        assert scale > 0, k
        assert float((got[True][k] - got[False][k]).abs().max()) <= 1e-9 * scale, k


@pytest.mark.parametrize("kw,E,fused", [
    ({}, 7, True),
    ({"camera_model": "radial3"}, 7, True),
    ({"refine_intrinsics": True}, 7, True),
    ({}, 9, False),
    ({"camera_model": "brown"}, 9, False),
    ({"camera_model": "brown"}, 7, False),
    ({"camera_model": "fisheye"}, 8, False),
    ({"camera_model": "spherical"}, 7, False),
    ({"fused_linearize": False}, 7, False),
])
def test_fused_route_choice(kw, E, fused):
    """The route follows only the camera model, the intrinsics' lanes and
    fused_linearize: the number of cameras and groups is no input to it."""
    assert tba._fused(tba.BAConfig(impl="pallas", **kw), E) is fused


# A point block met on the card at BAL Final's size (a two-view point 5e-4
# behind one camera's image plane), damped as the LM step damps it.
FINAL_BLOCK = [[1903529102934016.0, -35582893883392.0, 125447891320832.0],
               [-35582893883392.0, 759747313664.0, -2515257524224.0],
               [125447891320832.0, -2515257524224.0, 8573771841536.0]]


def test_inv3_of_a_huge_point_block_is_finite():
    """The block's adjugate determinant overflows float32 unscaled; the
    inverse is finite and within 1e-4 of float64's, relative to its
    largest entry."""
    M = tba._damp_blocks(torch.tensor([FINAL_BLOCK]), torch.tensor(0.0032))
    got = tba._inv3(M)
    want = torch.linalg.inv(M.double() + 1e-12 * torch.eye(3, dtype=torch.float64))
    assert torch.isfinite(got).all()
    assert float((got.double() - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("j", [0, 30, 45, 60, 90])
def test_inv3_scales_exactly(j):
    """Blocks times 2^j give the inverse times 2^-j, bit for bit and finite,
    on both sides of the 2^40 scaling threshold and far past float32's
    unscaled overflow."""
    g = torch.Generator().manual_seed(0)
    A = torch.randn((1000, 3, 3), generator=g)
    S = A @ A.transpose(1, 2) * 1e3 + torch.eye(3)
    got = tba._inv3(S * 2.0 ** j) * 2.0 ** j
    assert torch.isfinite(got).all()
    assert torch.equal(got, tba._inv3(S))
