"""Tests of the port that need an NVIDIA card (marker `cuda`); they skip
where torch sees no CUDA device.  This file imports neither jax nor the
reference package, so it also runs on a machine that has only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpusfm_torch.ba import bundle_adjust as tba
from tpusfm_torch.ops import obs_table as ot
from tpusfm_torch.ops import topk2_match
from tpusfm_torch.pipeline.config import config_from_overrides
from tpusfm_torch.pipeline.sparse import run_sparse
from tpusfm_torch.utils import metrics
from tpusfm_torch.utils.synth_render import render_orbit_images
from tpusfm_torch.utils.synth_scene import point_sorted_ba_problem

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; none is visible to torch")
    return torch.device("cuda")


def _u8(shape, gen, dev):
    return torch.floor(torch.rand(shape, generator=gen, device=dev) * 256.0).clamp(max=255.0)


@pytest.mark.parametrize("P,na,nb,mask_frac", [(4, 1024, 1024, 0.1), (3, 130, 200, 0.1),
                                               (2, 65, 1, 0.0), (2, 130, 200, 1.1)])
def test_kernel_bit_equal_to_twin(dev, P, na, nb, mask_frac):
    gen = torch.Generator(device=dev).manual_seed(P * 1000 + na)
    da, db = _u8((P, na, 128), gen, dev), _u8((P, nb, 128), gen, dev)
    mb = torch.rand((P, nb), generator=gen, device=dev) >= mask_frac
    before = topk2_match.LAUNCHES
    got = topk2_match.match_topk2(da, db, mb)
    torch.cuda.synchronize()
    assert topk2_match.LAUNCHES == before + 1
    for g, w in zip(got, topk2_match.match_topk2_reference(da, db, mb)):
        assert torch.equal(g, w)


def test_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    da = torch.zeros((2, 8, 64), device=dev)
    with pytest.raises(ValueError):
        topk2_match.match_topk2(da, da, torch.ones((2, 8), dtype=torch.bool, device=dev))
    nc = torch.zeros((8, 2, 128), device=dev).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        topk2_match.match_topk2(nc, nc, torch.ones((2, 8), dtype=torch.bool, device=dev))


def test_run_sparse_on_card(dev):
    images, gt = render_orbit_images(n_views=6, img_h=240, img_w=320, focal=0.9 * 320,
                                     arc_deg=60.0, seed=1)
    cfg = config_from_overrides(**{"sift.n_octaves": 3, "sift.max_per_octave": 512,
                                   "sift.max_features": 768, "matching.pair_chunk": 16,
                                   "filter.max_iterations": 128, "feature_batch": 3})
    topk2_match.LAUNCHES = 0
    scene, report = run_sparse(images, gt["intr"], cfg, device=dev)
    assert topk2_match.LAUNCHES >= 2
    reg = scene.cam_mask.cpu().numpy()
    assert reg.sum() >= 5
    ate = metrics.ate_rmse(scene.camera_centers().cpu().numpy()[reg], gt["centers"][reg])
    assert ate < 0.08 and report["n_points"] > 50


def _ba_args(prob, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in prob.items()}


def test_ba_beyond_dense_runs_kernels_on_card(dev):
    """70 cameras (420 scalars > dense_schur_max_dim): impl="auto" on the
    card solves through K2-K4, sorting the table itself; the plain PCG path
    (impl="xla") reaches the same cost within 1e-2 (bf16 W and the Hcc
    preconditioner perturb the steps, LM's accept test absorbs that)."""
    prob = point_sorted_ba_problem(70, 2000, vis_prob=0.3)
    args = _ba_args(prob, dev)
    args["obs_mask"][::17] = False
    for name in ot.LAUNCHES:
        ot.LAUNCHES[name] = 0
    out = tba.bundle_adjust(cfg=tba.BAConfig(max_iters=10), **args)
    assert all(n > 0 for n in ot.LAUNCHES.values()), ot.LAUNCHES
    plain = tba.bundle_adjust(cfg=tba.BAConfig(max_iters=10, impl="xla"), **args)
    kc, pc = float(out[4]["final_cost"]), float(plain[4]["final_cost"])
    assert kc < 0.1 * float(out[4]["initial_cost"])
    assert abs(kc - pc) <= 1e-2 * pc, (kc, pc)
    assert torch.isfinite(out[3]).all()


def test_ba_kernel_path_raises_where_kernels_are_missing(dev):
    args = _ba_args(point_sorted_ba_problem(70, 500, vis_prob=0.3), dev)
    with pytest.raises(NotImplementedError, match="K5"):
        tba.bundle_adjust(cfg=tba.BAConfig(refine_intrinsics=True), **args)
    with pytest.raises(NotImplementedError, match="K6"):
        tba.bundle_adjust(cfg=tba.BAConfig(precond="schur_diag"), **args)


GAP = 200


@pytest.fixture
def k2_inputs(dev):
    return _k2_tables(dev)


def _k2_tables(dev):
    """K2 inputs on the card from a 70-camera problem: ranks shifted by 200
    from rank 300 on (a gap > 127), 64 invalid rows (rank 2^30, weight 0)
    appended, 5% of rows masked."""
    prob = point_sorted_ba_problem(70, 2000, vis_prob=0.3)
    r = np.random.default_rng(1)
    ranks = prob["obs_pt"].astype(np.int64)
    ranks = np.concatenate([ranks + np.where(ranks >= 300, GAP, 0), np.full(64, 2 ** 30)])
    P = int(ranks[:-64].max()) + 1
    pts = np.zeros((P, 3), np.float32)
    pts[ranks[:-64]] = prob["points"][prob["obs_pt"]]
    O = len(ranks)
    cam = np.concatenate([prob["obs_cam"], r.integers(0, 70, 64)]).astype(np.int32)
    uv = np.concatenate([prob["obs_uv"], r.uniform(0, 480, (64, 2))]).astype(np.float32)
    w = (np.arange(O) < O - 64).astype(np.float32)
    w[r.random(O) < 0.05] = 0.0
    ps = torch.as_tensor(np.concatenate([prob["cam_rot"], prob["cam_t"]], 1), device=dev)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (tba.camera_table(ps), T(prob["intr"]), T(pts), T(cam), T(cam),
            T(ranks.astype(np.int32)), T(uv.T.copy()), T(w))


def _oracle_close(got, f32, f64, what):
    """Kernel within 4x the float32 twin's own error against the float64
    twin (both sum in float32, in different orders), floored at 1e-6 of
    the output's scale."""
    scale = float(f64.abs().max())
    tol = max(4 * float((f32.double() - f64).abs().max()), 1e-6 * scale)
    err = float((got.double() - f64).abs().max())
    assert err <= tol, (what, err, tol)


def _f64(args):
    return tuple(a.double() if a.is_floating_point() else a for a in args)


@pytest.mark.parametrize("w_dtype", ["bf16", "f32"])
def test_k2_matches_float64_twin_and_repeats_bit_for_bit(dev, k2_inputs, w_dtype):
    kw = dict(refine=False, refine_mask=(0.0,) * 7, huber_delta=4.0, w_dtype=w_dtype)
    got = ot.linearize_reduce_radial3_t(*k2_inputs, **kw)
    again = ot.linearize_reduce_radial3_t(*k2_inputs, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    f32 = ot.linearize_reduce_radial3_t_reference(*k2_inputs, **kw)
    f64 = ot.linearize_reduce_radial3_t_reference(*_f64(k2_inputs), **dict(kw, w_dtype="f32"))
    for i, name in enumerate(("camred", "ptred")):
        _oracle_close(got[i], f32[i], f64[i].double(), name)
    assert float(got[1][-1].abs().max()) > 0  # the last rank, past the gap, was summed
    w64 = f64[2].double() if w_dtype == "f32" else f64[2].to(torch.bfloat16).double()
    ulp = torch.maximum(got[2].double().abs(), w64.abs()) * 2.0 ** -7  # >= 1 bf16 ulp
    assert bool(((got[2].double() - w64).abs() <= ulp + 1e-6 * float(w64.abs().max())).all())


@pytest.mark.parametrize("with_hcc", [False, True])
def test_k3_k4_match_float64_twin_and_repeat_bit_for_bit(dev, k2_inputs, with_hcc):
    camred, ptred, W = ot.linearize_reduce_radial3_t(*k2_inputs, w_dtype="bf16")
    cam, ranks = k2_inputs[3], k2_inputs[5]
    C, P = camred.shape[0], ptred.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn((C, 6), generator=gen, device=dev)
    hpp = ptred[:, list(ot._FULL33)].reshape(P, 3, 3) + torch.eye(3, device=dev)
    hinv = torch.linalg.inv(hpp)
    hcc = camred[:, list(ot._FULL66)].reshape(C, 6, 6) if with_hcc else None
    got = ot.schur_mv_t(W, cam, ranks, v, hinv, P, hcc_d=hcc)
    again = ot.schur_mv_t(W, cam, ranks, v, hinv, P, hcc_d=hcc)
    f32 = ot.schur_mv_t_reference(W, cam, ranks, v, hinv, P, hcc_d=hcc)
    f64 = ot.schur_mv_t_reference(W, cam, ranks, v.double(), hinv.double(), P,
                                  hcc_d=None if hcc is None else hcc.double())
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _oracle_close(got[0], f32[0], f64[0], "S v" if with_hcc else "bc")
    _oracle_close(got[1], f32[1], f64[1], "y")
    z = torch.randn((P, 3), generator=gen, device=dev)
    for d in (6, 7):
        Wd = torch.randn((3 * d, W.shape[1]), generator=gen, device=dev).to(torch.bfloat16)
        b = ot.schur_bwd_t(Wd, cam, ranks, z, C)
        assert torch.equal(b, ot.schur_bwd_t(Wd, cam, ranks, z, C))
        _oracle_close(b, ot.schur_bwd_t_reference(Wd, cam, ranks, z, C),
                      ot.schur_bwd_t_reference(Wd, cam, ranks, z.double(), C), f"bwd D={d}")
