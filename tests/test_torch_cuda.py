"""Tests of the port that need an NVIDIA card (marker `cuda`); they skip
where torch sees no CUDA device.  This file imports neither jax nor the
reference package, so it also runs on a machine that has only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

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
from torch_ba_routes import FIELDS, ba_args, first_linearization
from torch_layout_cases import layout_cases, numpy_layout

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
    before = dict(topk2_match.LAUNCHES)
    got = topk2_match.match_topk2(da, db, mb)
    torch.cuda.synchronize()
    assert topk2_match.LAUNCHES == {"quantized": before["quantized"], "f32": before["f32"] + 1}
    for g, w in zip(got, topk2_match.match_topk2_reference(da, db, mb)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("P,na,nb,mask_frac", [(4, 1024, 1024, 0.1), (3, 130, 200, 0.1),
                                               (2, 65, 1, 0.0), (2, 130, 200, 1.1)])
def test_quantized_kernel_bit_equal_to_twin_and_f32_variant(dev, P, na, nb, mask_frac):
    """The bf16 tensor-core variant on the u8 grid: bit-equal to its twin
    and to the f32 variant, the same bits on a repeat call, one launch of
    its own variant per call."""
    gen = torch.Generator(device=dev).manual_seed(P * 1000 + na + 7)
    da, db = _u8((P, na, 128), gen, dev), _u8((P, nb, 128), gen, dev)
    mb = torch.rand((P, nb), generator=gen, device=dev) >= mask_frac
    before = dict(topk2_match.LAUNCHES)
    got = topk2_match.match_topk2(da, db, mb, quantized=True)
    again = topk2_match.match_topk2(da, db, mb, quantized=True)
    f32 = topk2_match.match_topk2(da, db, mb)
    torch.cuda.synchronize()
    assert topk2_match.LAUNCHES == {"quantized": before["quantized"] + 2, "f32": before["f32"] + 1}
    want = topk2_match.match_topk2_reference(da, db, mb, quantized=True)
    for g, a, f, w in zip(got, again, f32, want):
        assert torch.equal(g, w) and torch.equal(g, f) and torch.equal(g, a)
    if mask_frac > 1:
        assert bool((got[0] >= 1e38).all())


def test_quantized_kernel_off_grid_within_tolerance(dev):
    """Float descriptors: d1 and d2 within 1e-5 x (|a|^2 of the rounded row
    + the largest |b|^2) of the quantized twin, which sums the same bf16
    products in another order; i1 equal wherever d2 - d1 exceeds that; the
    same bits on a repeat call."""
    gen = torch.Generator(device=dev).manual_seed(3)
    da = torch.randn((4, 300, 128), generator=gen, device=dev) * 20
    db = torch.cat([da[:, :250] + 0.3 * torch.randn((4, 250, 128), generator=gen, device=dev),
                    torch.randn((4, 210, 128), generator=gen, device=dev) * 20], dim=1)
    mb = torch.rand((4, 460), generator=gen, device=dev) > 0.05
    got = topk2_match.match_topk2(da, db, mb, quantized=True)
    again = topk2_match.match_topk2(da, db, mb, quantized=True)
    d1, d2, i1 = topk2_match.match_topk2_reference(da, db, mb, quantized=True)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    ar = da.to(torch.bfloat16).double()
    tol = 1e-5 * ((ar * ar).sum(-1) + (db.double() ** 2).sum(-1).amax(-1, keepdim=True))
    assert bool(((got[0].double() - d1.double()).abs() <= tol).all())
    assert bool(((got[1].double() - d2.double()).abs() <= tol).all())
    sep = (d2.double() - d1.double()) > tol
    assert torch.equal(got[2][sep], i1[sep]) and sep.float().mean() > 0.5


def _planted_off_grid(P, na, nb, gen, dev):
    """The reference's float descriptor sets (tests/test_pallas_match.py):
    A ~ 20 N(0, 1), B the first min(na, nb) rows of A plus 0.3 N(0, 1),
    then fresh 20 N(0, 1) rows."""
    da = torch.randn((P, na, 128), generator=gen, device=dev) * 20
    k = min(na, nb)
    return da, torch.cat([da[:, :k] + 0.3 * torch.randn((P, k, 128), generator=gen, device=dev),
                          torch.randn((P, nb - k, 128), generator=gen, device=dev) * 20], dim=1)


def _f32_kernel_close(got, da, db, mb, what):
    """K1 f32 against the float64 twin: d1 and d2 each within 4x the float32
    twin's own largest error against it, floored at 1e-6 of the output's
    scale (_oracle_close); i1 equal to the float64 twin's wherever its
    d2 - d1 exceeds twice the larger of the two tolerances.  Returns the
    mask of those rows."""
    f32 = topk2_match.match_topk2_reference(da, db, mb)
    f64 = topk2_match.match_topk2_reference(da.double(), db.double(), mb)
    tols = []
    for i in range(2):
        _oracle_close(got[i], f32[i], f64[i], f"{what} d{i + 1}")
        tols.append(max(4 * float((f32[i].double() - f64[i]).abs().max()),
                        1e-6 * float(f64[i].abs().max())))
    sep = (f64[1] - f64[0]) > 2 * max(tols)
    assert torch.equal(got[2][sep], f64[2][sep]), what
    return sep


@pytest.mark.parametrize("P,na,nb,mask_frac", [(4, 1024, 1024, 0.1), (3, 130, 200, 0.1),
                                               (2, 65, 1, 0.0), (2, 130, 200, 1.1)])
def test_f32_kernel_off_grid_within_tolerance_of_float64_twin(dev, P, na, nb, mask_frac):
    """K1 f32 (three TF32 products) on float descriptors: within the
    tolerance of _f32_kernel_close against the float64 twin, the same bits
    on a repeat call, one f32 launch per call; a fully masked B gives
    d1 >= 1e38."""
    gen = torch.Generator(device=dev).manual_seed(P * 1000 + na + 11)
    da, db = _planted_off_grid(P, na, nb, gen, dev)
    mb = torch.rand((P, nb), generator=gen, device=dev) >= mask_frac
    before = dict(topk2_match.LAUNCHES)
    got = topk2_match.match_topk2(da, db, mb)
    again = topk2_match.match_topk2(da, db, mb)
    torch.cuda.synchronize()
    assert topk2_match.LAUNCHES == {"quantized": before["quantized"], "f32": before["f32"] + 2}
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    sep = _f32_kernel_close(got, da, db, mb, f"K1 f32 {P}x{na}x{nb}")
    if mask_frac > 1:
        assert bool((got[0] >= 1e38).all())
    elif nb > 1:
        assert sep.float().mean() > 0.5


def test_f32_kernel_ties_keep_the_lowest_index_off_grid(dev):
    """Every B row twice (rows 2j and 2j + 1 equal), off the grid: a tie
    keeps the lower index and counts for d2, so d2 equals d1 bit for bit
    and i1 is 2x the float64 twin's i1 on the undoubled B wherever that is
    separated; within tolerance of the float64 twin on the doubled B."""
    gen = torch.Generator(device=dev).manual_seed(17)
    da, base = _planted_off_grid(3, 300, 230, gen, dev)
    db = torch.repeat_interleave(base, 2, dim=1)
    mb = torch.ones((3, 460), dtype=torch.bool, device=dev)
    got = topk2_match.match_topk2(da, db, mb)
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1]) and not bool((got[2] % 2).any())
    _f32_kernel_close(got, da, db, mb, "K1 f32 doubled B")
    f32 = topk2_match.match_topk2_reference(da, base, mb[:, :230])
    f64 = topk2_match.match_topk2_reference(da.double(), base.double(), mb[:, :230])
    tol = max(4 * float((f32[1].double() - f64[1]).abs().max()), 1e-6 * float(f64[1].abs().max()))
    sep = (f64[1] - f64[0]) > 2 * tol
    assert torch.equal(got[2][sep], 2 * f64[2][sep]) and sep.float().mean() > 0.5


def test_quantized_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    """Shapes, dtypes, strides and devices the kernel does not take raise
    before any launch."""
    mb = torch.ones((2, 8), dtype=torch.bool, device=dev)
    good = torch.zeros((2, 8, 128), device=dev)
    before = dict(topk2_match.LAUNCHES)
    bad = [(torch.zeros((2, 8, 64), device=dev),) * 2 + (mb,),
           (torch.zeros((8, 2, 128), device=dev).transpose(0, 1),) * 2 + (mb,),
           (good.double(), good.double(), mb),
           (good, good, mb[:, :5]),
           (good, good.cpu(), mb),
           (good[:, :0].contiguous(), good, mb)]
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            topk2_match.match_topk2(*args, quantized=True)
    assert topk2_match.LAUNCHES == before


def test_quantized_launch_error_raises_without_fallback(dev, monkeypatch):
    """A launch the card refuses raises; neither the f32 kernel nor the twin
    answers in its place, and nothing is counted."""
    class Refusing:
        def tpusfm_topk2_match(self, *args):
            self.quantized = args[10]
            return 98  # cudaErrorInvalidDeviceFunction

        def tpusfm_cuda_error_string(self, code):
            return b"invalid device function"

    lib = Refusing()
    monkeypatch.setattr(topk2_match.cuda_build, "kernels", lambda: lib)
    monkeypatch.setattr(topk2_match, "match_topk2_reference", None)
    da = torch.zeros((2, 8, 128), device=dev)
    before = dict(topk2_match.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        topk2_match.match_topk2(da, da, torch.ones((2, 8), dtype=torch.bool, device=dev),
                                quantized=True)
    assert lib.quantized == 1 and topk2_match.LAUNCHES == before


def test_run_sparse_at_20_views_launches_only_the_quantized_kernel(dev):
    """run_sparse matches its 190 pairs in one chunk through the bf16
    variant: two launches (the cross-check's second), none of the f32 one."""
    images, gt = render_orbit_images(n_views=20, img_h=240, img_w=320, focal=0.9 * 320,
                                     arc_deg=110.0, seed=0)
    cfg = config_from_overrides(**{"sift.n_octaves": 3, "sift.max_per_octave": 512,
                                   "sift.max_features": 768, "matching.pair_chunk": 16,
                                   "filter.max_iterations": 128, "feature_batch": 10})
    for k in topk2_match.LAUNCHES:
        topk2_match.LAUNCHES[k] = 0
    scene, report = run_sparse(images, gt["intr"], cfg, device=dev)
    assert topk2_match.LAUNCHES == {"quantized": 2, "f32": 0}
    assert int(scene.cam_mask.sum()) >= 15 and report["n_points"] > 50


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
    for k in topk2_match.LAUNCHES:
        topk2_match.LAUNCHES[k] = 0
    scene, report = run_sparse(images, gt["intr"], cfg, device=dev)
    assert topk2_match.LAUNCHES["quantized"] >= 2 and topk2_match.LAUNCHES["f32"] == 0
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
    assert all(ot.LAUNCHES[k] > 0 for k in ("linearize_reduce_radial3_t", "schur_mv_t",
                                            "schur_bwd_t")), ot.LAUNCHES
    plain = tba.bundle_adjust(cfg=tba.BAConfig(max_iters=10, impl="xla"), **args)
    kc, pc = float(out[4]["final_cost"]), float(plain[4]["final_cost"])
    assert kc < 0.1 * float(out[4]["initial_cost"])
    assert abs(kc - pc) <= 1e-2 * pc, (kc, pc)
    assert torch.isfinite(out[3]).all()


def test_ba_self_calibration_and_schur_diag_run_kernels_on_card(dev):
    """70 cameras, one intrinsic group refined from a focal 2% off (K2's
    refine mode, K5, K4 on the group), and the Schur-diagonal
    preconditioner (K6): each reaches the plain path's cost within 1e-2."""
    args = _ba_args(point_sorted_ba_problem(70, 2000, vis_prob=0.3), dev)
    args["intr"][:, :2] *= 1.02
    group = dict(cam_group=torch.zeros(70, dtype=torch.long, device=dev), n_groups=1)
    for cfg, kw, kernels in (
            (tba.BAConfig(max_iters=10, refine_intrinsics=True), group,
             ("linearize_reduce_radial3_t", "schur_fwd_t", "schur_bwd_t")),
            (tba.BAConfig(max_iters=10, precond="schur_diag"), {},
             ("linearize_reduce_radial3_t", "segsum_table_t", "schur_mv_t"))):
        for name in ot.LAUNCHES:
            ot.LAUNCHES[name] = 0
        out = tba.bundle_adjust(cfg=cfg, **args, **kw)
        assert all(ot.LAUNCHES[k] > 0 for k in kernels), ot.LAUNCHES
        plain = tba.bundle_adjust(cfg=dataclasses.replace(cfg, impl="xla"), **args, **kw)
        kc, pc = float(out[4]["final_cost"]), float(plain[4]["final_cost"])
        assert kc < 0.1 * float(out[4]["initial_cost"])
        assert abs(kc - pc) <= 1e-2 * pc, (cfg, kc, pc)


def _above_2048_problem():
    return point_sorted_ba_problem(2100, 3000, vis_prob=0.05)


def test_ba_above_2048_cameras_takes_k2(dev):
    """2,100 cameras: K2 reads its camera rows from device memory, so no
    camera count sends RADIAL3 to jacfwd; linearization is K2 and no K6 or
    K7 launches; the cost falls."""
    args = _ba_args(_above_2048_problem(), dev)
    for name in ot.LAUNCHES:
        ot.LAUNCHES[name] = 0
    out = tba.bundle_adjust(cfg=tba.BAConfig(max_iters=3), **args)
    assert ot.LAUNCHES["linearize_reduce_radial3_t"] > 0
    assert ot.LAUNCHES["segsum_table_t"] == 0 and ot.LAUNCHES["segsum_sorted_t"] == 0
    assert float(out[4]["final_cost"]) < 0.5 * float(out[4]["initial_cost"])
    assert torch.isfinite(out[3]).all()


def test_ba_above_2048_cameras_takes_the_unfused_kernels(dev):
    """The same 2,100 cameras with fused_linearize=False: linearization is
    jacfwd reduced by K6 (cameras) and K7 (ranks), K2 does not launch; the
    cost falls."""
    args = _ba_args(_above_2048_problem(), dev)
    for name in ot.LAUNCHES:
        ot.LAUNCHES[name] = 0
    out = tba.bundle_adjust(cfg=tba.BAConfig(max_iters=3, fused_linearize=False), **args)
    assert ot.LAUNCHES["linearize_reduce_radial3_t"] == 0
    assert ot.LAUNCHES["segsum_table_t"] > 0 and ot.LAUNCHES["segsum_sorted_t"] > 0
    assert float(out[4]["final_cost"]) < 0.5 * float(out[4]["initial_cost"])
    assert torch.isfinite(out[3]).all()


def test_k2_matches_jacfwd_above_2048_cameras(dev, monkeypatch):
    """The first linearization at 2,100 cameras, Hcc, gc, Hpp, gp and the
    cost, through K2 and through jacfwd + K6/K7 on the card: each within 4x
    its own route's float32 twin's error (the kernel path on CPU tensors)
    against the jacfwd route in float64 (_oracle_close).  That the two
    routes agree in float64 is held on the CPU (test_torch_ba_route.py)."""
    prob = _above_2048_problem()
    cfgs = {fused: tba.BAConfig(impl="pallas", fused_linearize=fused) for fused in (True, False)}
    f64 = first_linearization(ba_args(prob, "cpu", torch.float64), cfgs[False], monkeypatch)
    for fused, cfg in cfgs.items():
        for name in ot.LAUNCHES:
            ot.LAUNCHES[name] = 0
        card = first_linearization(ba_args(prob, dev), cfg, monkeypatch)
        torch.cuda.synchronize()
        assert (ot.LAUNCHES["linearize_reduce_radial3_t"] > 0) == fused, ot.LAUNCHES
        twin = first_linearization(ba_args(prob, "cpu"), cfg, monkeypatch)
        route = "K2" if fused else "jacfwd"
        for k in FIELDS:
            _oracle_close(card[k].cpu(), twin[k], f64[k], f"{route} {k}")


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
    return tuple(a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                 for a in args)


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


@pytest.mark.parametrize("w_dtype", ["bf16", "f32"])
def test_k2_refine_matches_float64_twin_and_repeats_bit_for_bit(dev, k2_inputs, w_dtype):
    """One group holds every row, so K2's group pass sums many chunks."""
    args = list(k2_inputs)
    args[1] = args[1][:1]
    args[4] = torch.zeros_like(args[4])
    kw = dict(refine=True, refine_mask=(1.0,) * 7, huber_delta=4.0, w_dtype=w_dtype)
    got = ot.linearize_reduce_radial3_t(*args, **kw)
    again = ot.linearize_reduce_radial3_t(*args, **kw)
    torch.cuda.synchronize()
    assert len(got) == 5 and all(torch.equal(a, b) for a, b in zip(got, again))
    assert args[3].shape[0] > 4 * ot.CHUNK_ROWS
    f32 = ot.linearize_reduce_radial3_t_reference(*args, **kw)
    f64 = ot.linearize_reduce_radial3_t_reference(*_f64(args), **dict(kw, w_dtype="f32"))
    for i, name in ((0, "camred"), (1, "ptred"), (3, "grpred")):
        _oracle_close(got[i], f32[i], f64[i].double(), name)
    for i in (2, 4):
        w64 = f64[i].double() if w_dtype == "f32" else f64[i].to(torch.bfloat16).double()
        ulp = torch.maximum(got[i].double().abs(), w64.abs()) * 2.0 ** -7
        assert bool(((got[i].double() - w64).abs() <= ulp + 1e-6 * float(w64.abs().max())).all())


def test_k4_k5_k6_k7_match_float64_twins_and_repeat_bit_for_bit(dev, k2_inputs):
    """K5 at D = 6, 7, 9 (every lane of W counts), K4 with D = 9 over one
    segment that holds every row (many chunks), K6 with k = 96 and ids
    outside [0, n), K7 with k = 12 across the rank gap."""
    cam, ranks = k2_inputs[3], k2_inputs[5]
    O, C, P = cam.shape[0], 70, k2_inputs[2].shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    grp = torch.zeros_like(cam)

    def check(fn, twin, args, what):
        got = fn(*args)
        assert torch.equal(got, fn(*args)), what
        torch.cuda.synchronize()
        _oracle_close(got, twin(*args), twin(*_f64(args)), what)

    for d in (6, 7, 9):
        W = torch.randn((3 * d, O), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((C, d), generator=gen, device=dev)
        check(ot.schur_fwd_t, ot.schur_fwd_t_reference, (W, cam, ranks, v, P), f"K5 D={d}")
    z = torch.randn((P, 3), generator=gen, device=dev)
    check(ot.schur_bwd_t, ot.schur_bwd_t_reference, (W, grp, ranks, z, 1), "K4 D=9, one group")
    vals = torch.randn((96, O), generator=gen, device=dev)
    ids = cam.clone()
    ids[::13] = -1
    ids[5::17] = C + 2
    check(ot.segsum_table_t, ot.segsum_table_t_reference, (vals, ids, C), "K6 k=96")
    check(ot.segsum_table_t, ot.segsum_table_t_reference, (vals[:36], grp, 1), "K6, one segment")
    check(ot.segsum_sorted_t, ot.segsum_sorted_t_reference, (vals[:12], ranks, P), "K7 k=12")


@pytest.mark.parametrize("k,n", [(1, 12), (33, 12), (96, 12), (33, 700), (96, 700)])
def test_k6_row_and_lane_major_give_the_same_bits(dev, k, n):
    """K6 on a row-major view x.T and on the lane-major copy of the same
    table: bit-equal to each other and on a repeat, within 4x the float32
    twin's error against the float64 twin; one segment holds more than two
    chunks of rows, one segment none, and ids fall outside [0, n).  With
    12 segments the row pass gets few chunks (1024-thread blocks), with 700
    more than four per SM of an H100 (256-thread blocks)."""
    gen = torch.Generator(device=dev).manual_seed(k + n)
    O = 4 * ot.CHUNK_ROWS + 517
    ids = torch.randint(0, n, (O,), generator=gen, device=dev, dtype=torch.int32)
    ids = torch.where(torch.rand(O, generator=gen, device=dev) < 0.7, 0, ids)
    ids[ids == 5] = 6
    ids[::13] = -1
    ids[5::17] = n + 3
    assert int((ids == 0).sum()) > 2 * ot.CHUNK_ROWS
    x = torch.randn((O, k), generator=gen, device=dev)
    row, lane = x.T, x.T.contiguous()
    assert not ot.segsum_lane_major(row) and ot.segsum_lane_major(lane) == (k > 1)
    before = ot.LAUNCHES["segsum_table_t"]
    got = ot.segsum_table_t(row, ids, n)
    assert torch.equal(got, ot.segsum_table_t(row, ids, n))
    assert torch.equal(got, ot.segsum_table_t(lane, ids, n))
    torch.cuda.synchronize()
    assert ot.LAUNCHES["segsum_table_t"] == before + 3
    assert not bool(got[5].any())
    _oracle_close(got, ot.segsum_table_t_reference(row, ids, n),
                  ot.segsum_table_t_reference(row.double(), ids, n), f"K6 k={k}")


def test_k6_refuses_other_strides(dev):
    x = torch.zeros((300, 96), device=dev)
    ids = torch.zeros(300, dtype=torch.int32, device=dev)
    for bad, idx in ((x.T[:36], ids), (x.T[:, ::2], ids[::2]), (x.T.contiguous()[::2], ids)):
        with pytest.raises(ValueError, match="strides"):
            ot.segsum_table_t(bad, idx, 1)


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
def test_k5_warp_per_rank_matches_float64_twin_and_repeats(dev, w_dtype):
    """K5 at D = 1 to 9 on ranks of 0, 1, 31, 32, 33 and 3,000 rows (around
    and far past a warp's 32 lanes), a run of ranks with no rows, empty
    ranks past the last row, rows at rank 2^30 and ids outside [0, n):
    within 4x the float32 twin's error against the float64 twin, zero at
    the empty ranks, repeats bit-identical."""
    lengths = [3, 0, 1, 31, 32, 33, 3000, 0, 0, 0, 17, 64, 65, 2]
    P = len(lengths) + 3
    ranks = np.concatenate([np.repeat(np.arange(len(lengths)), lengths), np.full(40, 2 ** 30)])
    O, n = len(ranks), 11
    gen = torch.Generator(device=dev).manual_seed(5)
    ranks = torch.as_tensor(ranks.astype(np.int32), device=dev)
    ids = torch.randint(0, n, (O,), generator=gen, device=dev, dtype=torch.int32)
    ids[::7] = -1
    ids[3::11] = n + 2
    empty = torch.as_tensor([i for i in range(P) if i >= len(lengths) or not lengths[i]],
                            device=dev)
    layout = ot.obs_layout(ids, n, ranks, P)
    for d in range(1, ot.MAX_W_ROWS + 1):
        W = torch.randn((3 * d, O), generator=gen, device=dev).to(w_dtype)
        v = torch.randn((n, d), generator=gen, device=dev)
        got = ot.schur_fwd_t(W, ids, ranks, v, P, layout=layout)
        assert torch.equal(got, ot.schur_fwd_t(W, ids, ranks, v, P, layout=layout)), d
        torch.cuda.synchronize()
        assert not bool(got[empty].any()), d
        _oracle_close(got, ot.schur_fwd_t_reference(W, ids, ranks, v, P),
                      ot.schur_fwd_t_reference(W, ids, ranks, v.double(), P), f"K5 D={d}")


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
def test_k5_row_major_read_bit_equal_to_lane_major_read(dev, w_dtype):
    """K5 on the (3D, O) view of a row-major (O, 3D) table, at D = 1 to 9,
    on test_k5_warp_per_rank_matches_float64_twin_and_repeats's ranks (0 to
    3,000 rows, empty ranks, rows at 2^30) with ids outside [0, n), the
    table one row into its storage so that the spans start at other
    alignments: the bits of the lane-major read of the same values, zero at
    the empty ranks, the same bits on a repeat."""
    lengths = [3, 0, 1, 31, 32, 33, 3000, 0, 0, 0, 17, 64, 65, 2]
    P = len(lengths) + 3
    ranks = np.concatenate([np.repeat(np.arange(len(lengths)), lengths), np.full(40, 2 ** 30)])
    O, n = len(ranks), 11
    gen = torch.Generator(device=dev).manual_seed(6)
    ranks = torch.as_tensor(ranks.astype(np.int32), device=dev)
    ids = torch.randint(0, n, (O,), generator=gen, device=dev, dtype=torch.int32)
    ids[::7] = -1
    ids[3::11] = n + 2
    empty = torch.as_tensor([i for i in range(P) if i >= len(lengths) or not lengths[i]],
                            device=dev)
    layout = ot.obs_layout(ids, n, ranks, P)
    for d in range(1, ot.MAX_W_ROWS + 1):
        w = torch.randn((O + 1, 3 * d), generator=gen, device=dev).to(w_dtype)[1:]
        v = torch.randn((n, d), generator=gen, device=dev)
        before = ot.LAUNCHES["schur_fwd_t"]
        row = ot.schur_fwd_t(w.T, ids, ranks, v, P, layout=layout)
        again = ot.schur_fwd_t(w.T, ids, ranks, v, P, layout=layout)
        lane = ot.schur_fwd_t(w.T.contiguous(), ids, ranks, v, P, layout=layout)
        torch.cuda.synchronize()
        assert ot.LAUNCHES["schur_fwd_t"] == before + 3, d
        assert torch.equal(row, lane) and torch.equal(row, again), d
        assert not bool(row[empty].any()), d


def test_sublane_schur_fwd_makes_no_copy(dev):
    """schur_fwd on a row-major (O, 27) float32 table of 200,000 rows: one
    K5 launch, the bits of K5's lane-major read, and a peak of allocated
    memory that rises by less than the table's bytes (no transposed
    copy)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    O, n, P = 200_000, 40, 9000
    ranks = torch.sort(torch.randint(0, P, (O,), generator=gen, device=dev)).values.int()
    ids = torch.randint(-1, n + 1, (O,), generator=gen, device=dev, dtype=torch.int32)
    w = torch.randn((O, 27), generator=gen, device=dev)
    v = torch.randn((n, 9), generator=gen, device=dev)
    lane = ot.schur_fwd_t(w.T.contiguous(), ids, ranks, v, P)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = dict(ot.LAUNCHES)
    got = ot.schur_fwd(w, ids, ranks, v, P)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(dev) - base
    assert ot.LAUNCHES == {**before, "schur_fwd_t": before["schur_fwd_t"] + 1}
    assert rise < w.numel() * w.element_size(), rise
    assert torch.equal(got, lane)


def test_k8_k9_bit_equal_to_twins_and_repeat(dev, k2_inputs):
    """K8 on tables of 6, 7 and 9 columns with ids in any order, negative
    and past the table; K9 on the rank-space points by sorted ranks across
    the gap of 200, with invalid rows at 2^30: bit-equal to the twins, zero
    rows outside the table, repeats identical."""
    _, intr, pts, cam, _, ranks = k2_inputs[:6]
    gen = torch.Generator(device=dev).manual_seed(2)
    ids = cam.clone()
    ids[::11] = -1
    ids[3::13] = 70 + 5
    P = pts.shape[0]
    hinv_rows = torch.randn((P, 9), generator=gen, device=dev)
    cases = [(ot.gather_table, ot.gather_table_reference, torch.randn((70, 6), generator=gen,
                                                                       device=dev), ids),
             (ot.gather_table, ot.gather_table_reference, intr, ids),
             (ot.gather_table, ot.gather_table_reference, hinv_rows, ranks),
             (ot.gather_sorted, ot.gather_sorted_reference, pts, ranks)]
    for fn, twin, table, idx in cases:
        before = dict(ot.LAUNCHES)
        got = fn(table, idx)
        assert torch.equal(got, fn(table, idx))
        torch.cuda.synchronize()
        assert ot.LAUNCHES[fn.__name__] == before[fn.__name__] + 2
        assert torch.equal(got, twin(table, idx))
        out = (idx < 0) | (idx >= table.shape[0])
        assert bool(out.any()) and not bool(got[out].any())


@pytest.mark.parametrize("d", list(range(1, 10)) + [13])
def test_k8_k9_warp_tiles_bit_equal_at_every_width(dev, d):
    """K8's and K9's warp tiles at D = 1 to 9 (compile-time 3, 6, 7, 9, the
    rest and 13 through the run-time path) and row counts around a 32-row
    tile, O = 1 among them: K8 on a 4096-row table with ids below 0 and
    past N in the same call, K9 on a 50,000-rank table by sorted ranks with
    a gap of 5,000 and a tail at 2^30; bit-equal to the twin, zero rows
    outside the table, repeats identical, one launch a call."""
    gen = torch.Generator(device=dev).manual_seed(100 + d)
    table = torch.randn((4096, d), generator=gen, device=dev)
    for o in (1, 5, 31, 32, 33, 1000, 32 * 257 + 5):
        idx = torch.randint(-3, 4096 + 3, (o,), generator=gen, device=dev, dtype=torch.int32)
        idx[:2] = torch.tensor([-1, 4096], dtype=torch.int32, device=dev)[: min(o, 2)]
        before = ot.LAUNCHES["gather_table"]
        got = ot.gather_table(table, idx)
        assert torch.equal(got, ot.gather_table(table, idx)), (d, o)
        torch.cuda.synchronize()
        assert ot.LAUNCHES["gather_table"] == before + 2
        assert torch.equal(got, ot.gather_table_reference(table, idx)), (d, o)
        assert not bool(got[(idx < 0) | (idx >= 4096)].any())
    P = 50000
    pts = torch.randn((P, d), generator=gen, device=dev)
    rng = np.random.default_rng(d)
    live = np.sort(rng.integers(0, P - 5000, 200003))
    ranks = np.concatenate([live + np.where(live >= 20000, 5000, 0), np.full(77, 2 ** 30)])
    ranks = torch.as_tensor(ranks.astype(np.int32), device=dev)
    got = ot.gather_sorted(pts, ranks)
    assert torch.equal(got, ot.gather_sorted(pts, ranks))
    torch.cuda.synchronize()
    assert torch.equal(got, ot.gather_sorted_reference(pts, ranks))
    assert not bool(got[-77:].any()) and bool(got[-78].any())


def test_k8_takes_64_bit_offsets_past_2_31_elements(dev):
    """An output of 3 x 716,000,005 floats (past 2^31 elements, a ragged
    last tile) takes the 64-bit offset path: its first and last 100,000
    rows equal the twin on the same ids (about 11.5 GB on the card)."""
    O, d = 716_000_005, 3
    gen = torch.Generator(device=dev).manual_seed(7)
    table = torch.randn((4096, d), generator=gen, device=dev)
    idx = torch.randint(-2, 4096 + 2, (O,), generator=gen, device=dev, dtype=torch.int32)
    got = ot.gather_table(table, idx)
    torch.cuda.synchronize()
    for sl in (slice(0, 100_000), slice(O - 100_000, O)):
        assert torch.equal(got[sl], ot.gather_table_reference(table, idx[sl]))
    del got, idx
    torch.cuda.empty_cache()


def _k3_padded_table(C, seed):
    """A rank-sorted table of C cameras shaped like the engine's: 3,000
    ranks with gaps, 1 to 40 rows each, 30% of the rows on camera 0 and a
    few on camera ids outside [0, C); 40 rows at rank -1 at its head and
    2,500 padding rows on camera 0 at rank 2^30 at its tail, so camera 0
    holds more than 3 x CHUNK_ROWS rows, some of them outside every rank."""
    rng = np.random.default_rng(seed)
    live = np.sort(rng.choice(6000, 3000, replace=False))
    ranks = np.repeat(live, rng.integers(1, 41, 3000))
    cam = rng.integers(0, C, ranks.shape[0])
    cam[rng.random(ranks.shape[0]) < 0.3] = 0
    cam[rng.random(ranks.shape[0]) < 0.01] = -1
    cam[rng.random(ranks.shape[0]) < 0.01] = C + 2
    ranks = np.concatenate([np.full(40, -1), ranks, np.full(2500, 2 ** 30)])
    cam = np.concatenate([rng.integers(0, C, 40), cam, np.zeros(2500, np.int64)])
    assert (cam == 0).sum() > 3 * ot.CHUNK_ROWS
    return cam.astype(np.int32), ranks.astype(np.int32), int(live[-1]) + 1


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_hcc", [False, True])
@pytest.mark.parametrize("C", [300, 700])
def test_k3_padded_table_matches_float64_twin_and_repeats(dev, C, with_hcc, w_dtype):
    """K3 on an engine-shaped table (_k3_padded_table) of more than 256
    cameras: out and y within 4x the float32 twin's error against the
    float64 twin, repeats bit-identical, one launch a call.  With 300
    cameras the camera pass gets fewer chunks than an H100 has SMs, with
    700 more."""
    cam, ranks, P = _k3_padded_table(C, seed=C)
    cam, ranks = torch.as_tensor(cam, device=dev), torch.as_tensor(ranks, device=dev)
    O = cam.shape[0]
    gen = torch.Generator(device=dev).manual_seed(C + with_hcc)
    W = torch.randn((18, O), generator=gen, device=dev).to(w_dtype)
    v = torch.randn((C, 6), generator=gen, device=dev)
    hinv = 0.1 * torch.randn((P, 3, 3), generator=gen, device=dev)
    hcc = torch.randn((C, 6, 6), generator=gen, device=dev) if with_hcc else None
    layout = ot.obs_layout(cam, C, ranks, P)
    # Leave NaN in the block the wrapper's scratch will most likely reuse, so
    # a scratch row that the kernel fails to write shows in the sums.
    poison = torch.full(((O + layout.chunk_bound) * 6,), float("nan"), device=dev)
    del poison
    before = ot.LAUNCHES["schur_mv_t"]
    got = ot.schur_mv_t(W, cam, ranks, v, hinv, P, hcc_d=hcc, layout=layout)
    again = ot.schur_mv_t(W, cam, ranks, v, hinv, P, hcc_d=hcc, layout=layout)
    torch.cuda.synchronize()
    assert ot.LAUNCHES["schur_mv_t"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    f32 = ot.schur_mv_t_reference(W, cam, ranks, v, hinv, P, hcc_d=hcc)
    f64 = ot.schur_mv_t_reference(W, cam, ranks, v.double(), hinv.double(), P,
                                  hcc_d=None if hcc is None else hcc.double())
    _oracle_close(got[0], f32[0], f64[0], "S v" if with_hcc else "bc")
    _oracle_close(got[1], f32[1], f64[1], "y")


def _unreduced_args(k2_inputs, refine):
    args = list(k2_inputs)
    if refine:  # one group holds every row
        args[1] = args[1][:1]
        args[4] = torch.zeros_like(args[4])
    return args


@pytest.mark.parametrize("w_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("refine", [False, True])
def test_k2_unreduced_matches_float64_twin_and_reduces_to_k2(dev, k2_inputs, refine, w_dtype):
    """K2's unreduced mode: every value table within 4x the float32 twin's
    error against the float64 twin, W within one bf16 ulp, repeats
    bit-identical; K6 and K7 over its tables give K2's reduced sums
    (rtol 2e-5, atol 1e-4 of each output's largest entry)."""
    args = _unreduced_args(k2_inputs, refine)
    kw = dict(refine=refine, refine_mask=(1.0,) * 7 if refine else (0.0,) * 7, huber_delta=4.0,
              w_dtype=w_dtype)
    got = ot.linearize_radial3_t(*args, **kw)
    again = ot.linearize_radial3_t(*args, **kw)
    torch.cuda.synchronize()
    assert len(got) == (5 if refine else 3) and all(torch.equal(a, b) for a, b in zip(got, again))
    f32 = ot.linearize_radial3_t_reference(*args, **kw)
    f64 = ot.linearize_radial3_t_reference(*_f64(args), **dict(kw, w_dtype="f32"))
    for i in range(len(got)):
        if i in (2, 4):
            w64 = f64[i].double() if w_dtype == "f32" else f64[i].to(torch.bfloat16).double()
            ulp = torch.maximum(got[i].double().abs(), w64.abs()) * 2.0 ** -7
            assert bool(((got[i].double() - w64).abs() <= ulp + 1e-6 * float(w64.abs().max()))
                        .all())
        else:
            _oracle_close(got[i], f32[i], f64[i].double(), f"unreduced output {i}")
    cam, ranks, C, P = args[3], args[5], args[0].shape[0], args[2].shape[0]
    red = ot.linearize_reduce_radial3_t(*args, **kw)

    def close(a, b):
        tol = 2e-5 * b.abs() + 1e-4 * float(b.abs().max())
        assert bool(((a - b).abs() <= tol).all())

    camred = ot.segsum_table_t(got[0], cam, C)
    close(camred[:, :36], red[0][:, list(ot._FULL66)])
    close(camred[:, 36:42], red[0][:, 21:27])
    close(camred[:, -1], red[0][:, -1])
    ptred = ot.segsum_sorted_t(got[1], ranks, P)
    close(ptred[:, :9], red[1][:, list(ot._FULL33)])
    close(ptred[:, 9:], red[1][:, 6:])
    if refine:
        close(camred[:, 42:84], red[0][:, 27:69])
        grpred = ot.segsum_table_t(got[3], args[4], 1)
        close(grpred[:, :49], red[3][:, list(ot._FULL77)])
        close(grpred[:, 49:], red[3][:, 28:])


def test_ba_gather_path_on_card_equals_plain_gathers(dev):
    """70 cameras through the unfused kernel path with schur_diag, held and
    self-calibrating one group: pallas_gathers=True (K8, K9 launched)
    gives the same bits as the plain gathers, and the cost falls."""
    args = _ba_args(point_sorted_ba_problem(70, 2000, vis_prob=0.3), dev)
    group = dict(cam_group=torch.zeros(70, dtype=torch.long, device=dev), n_groups=1)
    for refine, kw in ((False, {}), (True, group)):
        cfg = tba.BAConfig(max_iters=6, fused_linearize=False, precond="schur_diag",
                           refine_intrinsics=refine)
        plain = tba.bundle_adjust(cfg=cfg, **args, **kw)
        for name in ot.LAUNCHES:
            ot.LAUNCHES[name] = 0
        out = tba.bundle_adjust(cfg=dataclasses.replace(cfg, pallas_gathers=True), **args, **kw)
        assert ot.LAUNCHES["gather_table"] > 0 and ot.LAUNCHES["gather_sorted"] > 0
        assert ot.LAUNCHES["linearize_reduce_radial3_t"] == 0
        for a, b in zip(out[:4], plain[:4]):
            assert torch.equal(a, b)
        assert float(out[4]["final_cost"]) == float(plain[4]["final_cost"])
        assert float(out[4]["final_cost"]) < 0.1 * float(out[4]["initial_cost"])


# K2 and K4 at the BA path's shapes: the 200-view final BA's (200, 2048)
# table padded to 32,768 rows as the engine pads it (rows of camera 0 at
# rank 2^30, weight 0), and the 500-camera bench problem's 1,484,375 rows.
_ENGINE_SHAPES = {"200-view": (dict(n_cams=200, n_points=2048, seed=2, arc_deg=120.0,
                                    vis_prob=0.06), 32768),
                  "500-camera": (dict(n_cams=500, n_points=50000, seed=3, arc_deg=350.0,
                                      vis_prob=0.06), None)}


@pytest.fixture(scope="module")
def engine_tables():
    """K2's arguments and the camera and one-group layouts at each shape of
    _ENGINE_SHAPES, built once per module on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; none is visible to torch")
    dev = torch.device("cuda")
    out = {}
    for name, (kw, rows) in _ENGINE_SHAPES.items():
        prob = point_sorted_ba_problem(**kw)
        n = len(prob["obs_cam"])
        pad = (rows or n) - n
        cam = np.concatenate([prob["obs_cam"], np.zeros(pad, np.int64)]).astype(np.int32)
        ranks = np.concatenate([prob["obs_pt"], np.full(pad, 2 ** 30)]).astype(np.int32)
        uv = np.concatenate([prob["obs_uv"], np.zeros((pad, 2), np.float32)])
        w = (np.arange(n + pad) < n).astype(np.float32)
        T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        ps = T(np.concatenate([prob["cam_rot"], prob["cam_t"]], 1))
        cam, ranks = T(cam), T(ranks)
        C, P = prob["intr"].shape[0], prob["points"].shape[0]
        grp = torch.zeros_like(cam)
        out[name] = dict(args=(tba.camera_table(ps), T(prob["intr"]), T(prob["points"]), cam,
                               cam, ranks, T(uv.T.copy()), T(w)),
                         grp=grp, C=C, P=P, layout=ot.obs_layout(cam, C, ranks, P),
                         grp_layout=ot.obs_layout(grp, 1, ranks, P))
    return out


def _w_close(got, f64, w_dtype, what):
    """A W table within one bf16 ulp of the float64 twin (module note)."""
    w64 = f64.double() if w_dtype == "f32" else f64.to(torch.bfloat16).double()
    ulp = torch.maximum(got.double().abs(), w64.abs()) * 2.0 ** -7
    assert bool(((got.double() - w64).abs() <= ulp + 1e-6 * float(w64.abs().max())).all()), what


@pytest.mark.parametrize("w_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("shape", list(_ENGINE_SHAPES))
def test_k2_engine_shapes_match_float64_twin_and_repeat(engine_tables, shape, refine, w_dtype):
    """K2 (held on the cameras, refine on one group) at the BA path's shapes
    with the camera-ordered W copy requested: the sums within 4x the
    float32 twin's error against the float64 twin, each W within one bf16
    ulp, the copy equal to wcT[:, seg_perm] bit for bit, repeats
    bit-identical, and the layouts' arrival counters left at zero."""
    t = engine_tables[shape]
    args = list(t["args"])
    kw = dict(refine=refine, refine_mask=(1.0,) * 7 if refine else (0.0,) * 7, huber_delta=4.0,
              w_dtype=w_dtype, seg_ordered_w=True)
    if refine:
        args[1], args[4] = args[1][:1], t["grp"]
    lay = dict(layout=t["layout"], grp_layout=t["grp_layout"] if refine else None)
    got = ot.linearize_reduce_radial3_t(*args, **kw, **lay)
    again = ot.linearize_reduce_radial3_t(*args, **kw, **lay)
    torch.cuda.synchronize()
    assert len(got) == (6 if refine else 4) and all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[-1], got[2][:, t["layout"].seg_perm.long()])
    assert not t["layout"].arrivals.any() and not t["grp_layout"].arrivals.any()
    f32 = ot.linearize_reduce_radial3_t_reference(*args, **kw)
    f64 = ot.linearize_reduce_radial3_t_reference(*_f64(args), **dict(kw, w_dtype="f32"))
    for i in range(len(got)):
        if i in (2, 4, len(got) - 1):
            _w_close(got[i], f64[i], w_dtype, f"K2 {shape} output {i}")
        else:
            _oracle_close(got[i], f32[i], f64[i].double(), f"K2 {shape} output {i}")


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [6, 7, 9])
@pytest.mark.parametrize("shape", list(_ENGINE_SHAPES))
def test_k4_read_paths_give_the_same_bits(engine_tables, shape, d, w_dtype):
    """K4 on the cameras through the permutation and on the same W in
    camera order, lane-major and row-major; on one group in order (its
    permutation is the identity) and through the identity permutation: the
    reads of one table give the same bits, repeats too (the arrival
    counters are left at zero), within 4x the float32 twin's error against
    the float64 twin."""
    t = engine_tables[shape]
    cam, ranks = t["args"][3], t["args"][5]
    lay, glay = t["layout"], t["grp_layout"]
    assert not bool(lay.in_seg_order) and bool(glay.in_seg_order)
    gen = torch.Generator(device="cuda").manual_seed(d)
    W = torch.randn((3 * d, cam.shape[0]), generator=gen, device="cuda").to(w_dtype)
    z = torch.randn((t["P"], 3), generator=gen, device="cuda")
    perm = lay.seg_perm.long()
    cams = [ot.schur_bwd_t(W, cam, ranks, z, t["C"], layout=lay),
            ot.schur_bwd_t(W, cam, ranks, z, t["C"], layout=lay, w_seg=W[:, perm].contiguous()),
            ot.schur_bwd_t(W, cam, ranks, z, t["C"], layout=lay,
                           w_seg=W.T[perm].contiguous().T),
            ot.schur_bwd_t(W, cam, ranks, z, t["C"], layout=lay)]
    grp = [ot.schur_bwd_t(W, t["grp"], ranks, z, 1, layout=glay),
           ot.schur_bwd_t(W, t["grp"], ranks, z, 1, layout=dataclasses.replace(
               glay, in_seg_order=torch.zeros(1, dtype=torch.int32, device="cuda"))),
           ot.schur_bwd_t(W, t["grp"], ranks, z, 1, layout=glay)]
    torch.cuda.synchronize()
    assert all(torch.equal(cams[0], c) for c in cams[1:])
    assert all(torch.equal(grp[0], g) for g in grp[1:])
    assert not lay.arrivals.any() and not glay.arrivals.any()
    for got, ids, n in ((cams[0], cam, t["C"]), (grp[0], t["grp"], 1)):
        _oracle_close(got, ot.schur_bwd_t_reference(W, ids, ranks, z, n),
                      ot.schur_bwd_t_reference(W, ids, ranks, z.double(), n), f"K4 D={d} n={n}")


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [6, 7, 9])
def test_sublane_entry_points_launch_their_kernels(engine_tables, d, w_dtype):
    """segsum_table, segsum_sorted, schur_fwd and schur_bwd on row-major
    (O, k) tables at the 200-view shape: one launch of K6, K7, K5 and K4
    each (segsum_table and schur_bwd also one of the layout kernel, for the
    layout they build), within 4x the float32 twin's error against the
    float64 twin; K4's row-major permuted read, K7's and K5's row-major
    reads give the bits of their lane-major reads."""
    t = engine_tables["200-view"]
    cam, ranks, C, P = t["args"][3], t["args"][5], t["C"], t["P"]
    gen = torch.Generator(device="cuda").manual_seed(20 + d)
    w = torch.randn((cam.shape[0], 3 * d), generator=gen, device="cuda").to(w_dtype)
    vals = torch.randn((cam.shape[0], d), generator=gen, device="cuda")
    v = torch.randn((C, d), generator=gen, device="cuda")
    z = torch.randn((P, 3), generator=gen, device="cuda")
    calls = {"segsum_table": ((vals, cam, C), "segsum_table_t"),
             "segsum_sorted": ((vals, ranks, P), "segsum_sorted_t"),
             "schur_fwd": ((w, cam, ranks, v, P), "schur_fwd_t"),
             "schur_bwd": ((w, cam, ranks, z, C), "schur_bwd_t")}
    for name, (a, kernel) in calls.items():
        before = dict(ot.LAUNCHES)
        got = getattr(ot, name)(*a)
        torch.cuda.synchronize()
        layout = int(name in ("segsum_table", "schur_bwd"))
        assert ot.LAUNCHES == {**before, kernel: before[kernel] + 1,
                               "seg_layout": before["seg_layout"] + layout}, name
        twin = getattr(ot, name + "_reference")
        _oracle_close(got, twin(*a), twin(*_f64(a)), f"{name} D={d}")
    lane = ot.schur_bwd_t(w.T.contiguous(), cam, ranks, z, C)
    assert torch.equal(ot.schur_bwd(w, cam, ranks, z, C), lane)
    lane = ot.segsum_sorted_t(vals.T.contiguous(), ranks, P)
    assert torch.equal(ot.segsum_sorted(vals, ranks, P), lane)
    lane = ot.schur_fwd_t(w.T.contiguous(), cam, ranks, v, P)
    assert torch.equal(ot.schur_fwd(w, cam, ranks, v, P), lane)


def _sorted_layout(ids, n, ranks=None):
    """An ObsLayout whose segments come from the twin's torch.sort on the
    card (seg_layout_reference), not from the layout kernel."""
    seg_perm, seg_start, chunk_start, arrivals, in_order = ot.seg_layout_reference(ids, n)
    return ot.ObsLayout(rank_start=None, seg_perm=seg_perm, seg_start=seg_start,
                        chunk_start=chunk_start,
                        seg_ranks=None if ranks is None else ranks[seg_perm.long()],
                        in_seg_order=in_order, arrivals=arrivals)


def _layout_equal(got, want, what):
    for g, w, part in zip(got, want, ("seg_perm", "seg_start", "chunk_start", "arrivals",
                                      "in_order")):
        assert g.dtype == torch.int32 and g.device.type == "cuda", (what, part)
        assert torch.equal(g, w), (what, part)


@pytest.mark.parametrize("case", range(len(layout_cases())), ids=[c[0] for c in layout_cases()])
def test_seg_layout_kernel_bit_equal_to_twin_and_numpy(dev, case):
    """The layout kernel (csrc/ba_layout.cu) on tests/torch_layout_cases.py's
    edge cases: one launch, bit-equal to its torch.sort twin on the card and
    to numpy's stable argsort; the same bits on a repeat."""
    name, ids_np, n = layout_cases()[case]
    ids = torch.as_tensor(ids_np, device=dev)
    before = ot.LAUNCHES["seg_layout"]
    got = ot.seg_layout(ids, n)
    again = ot.seg_layout(ids, n)
    torch.cuda.synchronize()
    assert ot.LAUNCHES["seg_layout"] == before + 2
    _layout_equal(got, ot.seg_layout_reference(ids, n), name)
    _layout_equal(again, got, f"{name} (repeat)")
    for g, w in zip(got, numpy_layout(ids_np, n)):
        np.testing.assert_array_equal(g.cpu().numpy(), w, err_msg=name)


@pytest.mark.parametrize("n", [32767, 32768, 40000])
def test_seg_layout_at_the_largest_segment_counts(dev, n):
    """n up to LAYOUT_MAX_N = 32,768 takes the kernel (one warp a block,
    128 KB of shared offsets), bit-equal to the twin on 200,003 ids with
    every segment hit and ids outside [0, n); above it obs_layout takes the
    twin's sort on the card (no kernel launch, no host read) and seg_layout
    refuses."""
    gen = torch.Generator(device=dev).manual_seed(n)
    ids = torch.randint(-5, n + 5, (200_003,), generator=gen, device=dev, dtype=torch.int32)
    ids[:n] = torch.arange(n, device=dev, dtype=torch.int32)
    want = ot.seg_layout_reference(ids, n)
    before = ot.LAUNCHES["seg_layout"]
    if n <= ot.LAYOUT_MAX_N:
        _layout_equal(ot.seg_layout(ids, n), want, f"n={n}")
    else:
        with pytest.raises(ValueError):
            ot.seg_layout(ids, n)
    torch.cuda.set_sync_debug_mode("error")
    try:
        lay = ot.obs_layout(ids, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ot.LAUNCHES["seg_layout"] == before + 2 * (n <= ot.LAYOUT_MAX_N)
    _layout_equal((lay.seg_perm, lay.seg_start, lay.chunk_start, lay.arrivals, lay.in_seg_order),
                  want, f"obs_layout n={n}")


@pytest.mark.parametrize("shape", list(_ENGINE_SHAPES))
def test_seg_layout_kernel_on_the_ba_tables(engine_tables, shape):
    """The layouts of the BA path's tables (the 200-view padded and the
    500-camera tables), cameras and one group: the fixture's layouts, built
    by the kernel, bit-equal to the twin's; the rank parts as before."""
    t = engine_tables[shape]
    cam, ranks = t["args"][3], t["args"][5]
    for ids, n, lay in ((cam, t["C"], t["layout"]), (t["grp"], 1, t["grp_layout"])):
        want = ot.seg_layout_reference(ids, n)
        _layout_equal((lay.seg_perm, lay.seg_start, lay.chunk_start, lay.arrivals,
                       lay.in_seg_order), want, f"{shape} n={n}")
        assert torch.equal(lay.seg_ranks, ranks[want[0].long()])
        assert torch.equal(lay.rank_start, torch.searchsorted(
            ranks, torch.arange(t["P"] + 1, device="cuda", dtype=torch.int32), out_int32=True))
    assert not bool(t["layout"].in_seg_order) and bool(t["grp_layout"].in_seg_order)


@pytest.fixture(scope="module")
def final13682():
    """BAL Final-13682 at full size (13,682 cameras, 4,456,117 points,
    28,987,644 observations), made on the card by the benchmark's generator
    from its configuration: (configuration, scene)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; none is visible to torch")
    import json
    from pathlib import Path

    from sfmbench.gen import scene as gen

    path = Path(__file__).resolve().parents[1] / "sfmbench/configs/bal-final-13682.json"
    cfg = json.loads(path.read_text())
    return cfg, gen.generate(cfg, "cuda")


def test_seg_layout_at_final_13682_camera_column(final13682):
    """The layout kernel on Final-13682's camera column, all 28,987,644 ids
    over 13,682 segments, camera-major as generated and point-sorted as a
    solve lays it out: the one-warp plan with no staged tile, one launch
    each, bit-equal to the twin's stable sort on the card."""
    _, scene = final13682
    n, O = scene.shape[0], scene.shape[2]
    assert ot._layout_plan(n, O) == (1, 13824, 2097, False)
    point_sorted = scene.obs_cam[torch.sort(scene.obs_pt, stable=True).indices]
    assert "route=kernel warps=1 warp_rows=13824 tiles=2097 staged=0" in \
        ot.layout_plan_args(point_sorted, n)
    for what, ids in (("camera-major", scene.obs_cam), ("point-sorted", point_sorted)):
        before = ot.LAUNCHES["seg_layout"]
        got = ot.seg_layout(ids, n)
        torch.cuda.synchronize()
        assert ot.LAUNCHES["seg_layout"] == before + 1
        _layout_equal(got, ot.seg_layout_reference(ids, n), f"Final-13682 {what}")
        assert bool(got[4]) == (what == "camera-major")


def test_final_13682_solve_takes_k2_and_ends_finite(final13682):
    """One full-size Final-13682 solve as the benchmark calls it
    (the configuration's solver settings, a group a camera, a start
    perturbed by 0.01 in pose and 0.02 in points): every linearization is
    K2's, CG products are K3's, the camera layout is the kernel's, no K6 or
    K7 launches, and the answer is finite below its start's cost."""
    cfg, scene = final13682
    C, P, O = scene.shape
    g = torch.Generator(device="cuda").manual_seed(13682)
    rot = scene.aa + 0.01 * torch.randn(C, 3, generator=g, device="cuda")
    t = scene.t + 0.01 * torch.randn(C, 3, generator=g, device="cuda")
    pts = scene.points + 0.02 * torch.randn(P, 3, generator=g, device="cuda")
    ones = dict(dtype=torch.bool, device="cuda")
    for name in ot.LAUNCHES:
        ot.LAUNCHES[name] = 0
    out = tba.bundle_adjust(scene.intr, rot, t, torch.ones(C, **ones), pts, torch.ones(P, **ones),
                            scene.obs_cam, scene.obs_pt, scene.obs_uv, torch.ones(O, **ones),
                            tba.BAConfig(**cfg["ba"]))
    torch.cuda.synchronize()
    info = out[4]
    assert ot.LAUNCHES["linearize_reduce_radial3_t"] == info["iterations"] + 1, ot.LAUNCHES
    assert ot.LAUNCHES["schur_mv_t"] > 0 and ot.LAUNCHES["seg_layout"] == 1, ot.LAUNCHES
    assert ot.LAUNCHES["segsum_table_t"] == ot.LAUNCHES["segsum_sorted_t"] == 0, ot.LAUNCHES
    assert all(bool(torch.isfinite(x).all()) for x in out[:4])
    assert 0 < float(info["final_cost"]) < float(info["initial_cost"])


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [6, 7, 9])
@pytest.mark.parametrize("ids", ["cameras", "one group"])
@pytest.mark.parametrize("shape", list(_ENGINE_SHAPES))
def test_sublane_entries_make_no_host_read(engine_tables, shape, ids, d, w_dtype):
    """segsum_table (k = 12 d) and schur_bwd run under
    torch.cuda.set_sync_debug_mode("error") (a host read raises), each
    bit-equal to its _t call through a layout from the twin's torch.sort,
    and within 4x the float32 twin's error against the float64 twin; the
    given layout's arrival counters are left at zero."""
    t = engine_tables[shape]
    ranks = t["args"][5]
    idx, n = (t["args"][3], t["C"]) if ids == "cameras" else (t["grp"], 1)
    gen = torch.Generator(device="cuda").manual_seed(30 + d)
    O = idx.shape[0]
    vals = torch.randn((O, 12 * d), generator=gen, device="cuda")
    w = torch.randn((O, 3 * d), generator=gen, device="cuda").to(w_dtype)
    z = torch.randn((t["P"], 3), generator=gen, device="cuda")
    ot.segsum_table(vals, idx, n)
    ot.schur_bwd(w, idx, ranks, z, n)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ot.segsum_table(vals, idx, n), ot.schur_bwd(w, idx, ranks, z, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    lay = _sorted_layout(idx, n)
    want = (ot.segsum_table_t(vals.T, idx, n, layout=lay),
            ot.schur_bwd_t(w.T, idx, ranks, z, n, layout=lay))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not lay.arrivals.any()
    if shape == "500-camera" and d != 6:
        return  # the float64 twins of the widest tables add little
    _oracle_close(got[0], ot.segsum_table_reference(vals, idx, n),
                  ot.segsum_table_reference(vals.double(), idx, n), f"segsum_table {ids}")
    _oracle_close(got[1], ot.schur_bwd_reference(w, idx, ranks, z, n),
                  ot.schur_bwd_reference(w, idx, ranks, z.double(), n), f"schur_bwd {ids}")


def test_k2_and_k4_launch_counts_at_path_a(engine_tables):
    """At path A's shape K4 is one kernel launch per call (the chunk sums
    and the finish in one), K2 held two and K2 refine three."""
    from torch.profiler import ProfilerActivity, profile

    from tpusfm_torch.tools.profile_rung import _device_kernels

    t = engine_tables["200-view"]
    a, cam, ranks = t["args"], t["args"][3], t["args"][5]
    gen = torch.Generator(device="cuda").manual_seed(0)
    Wc = torch.randn((18, cam.shape[0]), generator=gen, device="cuda").to(torch.bfloat16)
    Wg = torch.randn((21, cam.shape[0]), generator=gen, device="cuda").to(torch.bfloat16)
    z = torch.randn((t["P"], 3), generator=gen, device="cuda")
    wseg = Wc[:, t["layout"].seg_perm.long()].contiguous()
    refine = a[:1] + (a[1][:1],) + a[2:4] + (t["grp"],) + a[5:]
    calls = {"K4 cameras": (1, lambda: ot.schur_bwd_t(Wc, cam, ranks, z, t["C"],
                                                      layout=t["layout"], w_seg=wseg)),
             "K4 group": (1, lambda: ot.schur_bwd_t(Wg, t["grp"], ranks, z, 1,
                                                    layout=t["grp_layout"])),
             "K2 held": (2, lambda: ot.linearize_reduce_radial3_t(*a, w_dtype="bf16",
                                                                   layout=t["layout"])),
             "K2 refine": (3, lambda: ot.linearize_reduce_radial3_t(
                 *refine, refine=True, refine_mask=(1.0,) * 7, w_dtype="bf16",
                 layout=t["layout"], grp_layout=t["grp_layout"], seg_ordered_w=True))}
    for name, (kernels, fn) in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        rows = _device_kernels(prof)
        assert len(rows) == kernels and all(n == 5 for _, n, _ in rows), (name, rows)


PRE_BASE = {"sift.n_octaves": 3, "sift.max_features": 512, "sift.max_per_octave": 256,
            "matching.pair_chunk": 8}


def test_preemptive_k1_keep_mask_equals_plain_matcher_on_card(dev):
    """tests/test_preemptive.py's 8-view scene on the card: the prefilter
    runs K1's bf16 variant only, and its keep mask equals the one the plain
    full-matrix matcher gives on the same card tensors; kept rows equal
    full matching's, dropped rows are all invalid, some pairs drop."""
    from tpusfm_torch.matching import match as tmatch
    from tpusfm_torch.pipeline import sparse

    images, _ = render_orbit_images(n_views=8, img_h=240, img_w=320, arc_deg=200.0)
    full = config_from_overrides(**PRE_BASE)
    pre = config_from_overrides(**PRE_BASE, **{"matching.preemptive": True})
    feats = sparse.detect_features(images, full, device=dev)
    pl = sparse.generate_pairs(8, full)
    for k in topk2_match.LAUNCHES:
        topk2_match.LAUNCHES[k] = 0
    keep = sparse.preemptive_filter_pairs(feats, pl, pre)
    assert topk2_match.LAUNCHES["quantized"] > 0 and topk2_match.LAUNCHES["f32"] == 0
    K = pre.matching.preemptive_features
    ia, ib = (torch.as_tensor(pl[:, i], device=dev).long() for i in (0, 1))
    desc, mask = feats.desc[:, :K], feats.mask[:, :K]
    _, ok = tmatch.match_descriptors(desc[ia], desc[ib], mask[ia], mask[ib])
    plain = (ok.sum(-1) >= pre.matching.preemptive_min_matches).cpu().numpy()
    np.testing.assert_array_equal(keep, plain)
    assert (~keep).any() and keep.any()
    mi0, mv0 = sparse.match_pairs(feats, pl, full)
    mi1, mv1 = sparse.match_pairs(feats, pl, pre)
    np.testing.assert_array_equal(mv1[keep], mv0[keep])
    np.testing.assert_array_equal(mi1[keep], mi0[keep])
    assert not mv1[~keep].any()


def test_two_view_on_card_meets_reference_bars(dev):
    """tests/test_two_view.py's setup through the port's entry point on the
    card (K1 launched): more than 40 inliers, relative rotation within 2
    degrees, more than 95% of the inlier points in front."""
    from tpusfm_torch.core import camera as tcam
    from tpusfm_torch.features.sift import SiftConfig
    from tpusfm_torch.sfm.two_view import two_view_reconstruct

    images, gt = render_orbit_images(n_views=2, img_h=240, img_w=320, focal=0.9 * 320,
                                     arc_deg=10.0, seed=3)
    for k in topk2_match.LAUNCHES:
        topk2_match.LAUNCHES[k] = 0
    out = two_view_reconstruct(images, tcam.make_intrinsics(0.9 * 320, cx=160.0, cy=120.0,
                                                            device=dev),
                               sift_cfg=SiftConfig(n_octaves=3, max_per_octave=512,
                                                   max_features=768),
                               ransac_iters=256, device=dev)
    assert topk2_match.LAUNCHES["quantized"] == 2 and topk2_match.LAUNCHES["f32"] == 0
    assert int(out["n_inliers"]) > 40
    R_rel = gt["R"][1] @ gt["R"][0].T
    cos = (np.trace(out["R"].cpu().numpy() @ R_rel.T) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 2.0
    X = out["points"][out["inliers"]].cpu().numpy()
    assert (X[:, 2] > 0).mean() > 0.95


def test_1000_camera_ba_through_the_kernels_on_card(dev):
    """tests/test_pod_scale.py's problem (1000 cameras, 40,000 points, more
    than 200k observations) single-device through _lm_kernels (K2-K4) with
    its BAConfig: rmse under 0.8 px, ATE under 0.01."""
    from tpusfm_torch.core import lie
    from tpusfm_torch.utils.synth_scene import pod_ba_problem

    prob, centers = pod_ba_problem()
    O = len(prob["obs_cam"])
    assert O > 200_000
    for name in ot.LAUNCHES:
        ot.LAUNCHES[name] = 0
    cfg = tba.BAConfig(max_iters=8, cg_iters=25, obs_chunk=32768)
    _, rot, t, _, info = tba.bundle_adjust(cfg=cfg, **_ba_args(prob, dev))
    assert all(ot.LAUNCHES[k] > 0 for k in ("linearize_reduce_radial3_t", "schur_mv_t",
                                            "schur_bwd_t")), ot.LAUNCHES
    rmse = float(np.sqrt(2 * float(info["final_cost"]) / O))
    assert rmse < 0.8, rmse
    ate = metrics.ate_rmse(lie.camera_center(lie.so3_exp(rot), t).cpu().numpy(), centers)
    assert ate < 0.01, ate


def test_200_camera_ba_through_the_kernels_on_card(dev):
    """tests/test_medium_scale.py's problem (200 cameras, 20,000 points,
    seed 3, vis_prob 0.25, more than 100k observations, poses perturbed by
    0.01 and points by 0.02 with numpy seed 0) single-device through
    _lm_kernels (K2-K4, the camera layout built by the layout kernel) with
    its BAConfig: rmse under 0.8 px, ATE under 0.01."""
    from tpusfm_torch.core import lie
    from tpusfm_torch.utils.synth_scene import orbit_scene

    C, P = 200, 20000
    s = orbit_scene(n_cams=C, n_points=P, noise_px=0.5, seed=3, arc_deg=350.0, vis_prob=0.25)
    O = len(s["obs_cam"])
    assert O > 100_000
    r = np.random.default_rng(0)
    prob = dict(intr=np.tile(s["intr"], (C, 1)),
                cam_rot=(s["aa"] + r.normal(scale=0.01, size=(C, 3))).astype(np.float32),
                cam_t=(s["t"] + r.normal(scale=0.01, size=(C, 3))).astype(np.float32),
                cam_mask=np.ones(C, bool),
                points=(s["points"] + r.normal(scale=0.02, size=(P, 3))).astype(np.float32),
                point_mask=s["point_valid"], obs_cam=s["obs_cam"], obs_pt=s["obs_pt"],
                obs_uv=s["obs_uv"], obs_mask=np.ones(O, bool))
    for name in ot.LAUNCHES:
        ot.LAUNCHES[name] = 0
    cfg = tba.BAConfig(max_iters=10, cg_iters=30, obs_chunk=32768)
    _, rot, t, _, info = tba.bundle_adjust(cfg=cfg, **_ba_args(prob, dev))
    assert all(ot.LAUNCHES[k] > 0 for k in ("linearize_reduce_radial3_t", "schur_mv_t",
                                            "schur_bwd_t", "seg_layout")), ot.LAUNCHES
    rmse = float(np.sqrt(2 * float(info["final_cost"]) / O))
    assert rmse < 0.8, rmse
    ate = metrics.ate_rmse(lie.camera_center(lie.so3_exp(rot), t).cpu().numpy(), s["centers"])
    assert ate < 0.01, ate


# ---------------------------------------------------------------------------
# The dense and mesh stages: plain PyTorch on the card against the same code
# on the CPU, with the same draws (CPU generators) and the CPU parity tests'
# tolerances.
# ---------------------------------------------------------------------------

def _dense_room(h=96, w=128):
    """tests/test_patchmatch.py's corner room at h x w: images, ground
    truth, and the port's scene with true poses and 150 projected points."""
    import torch as _torch

    from tpusfm_torch.core import lie
    from tpusfm_torch.sfm.scene import empty_scene

    images, gt = render_orbit_images(n_views=5, img_h=h, img_w=w, focal=0.8 * w, arc_deg=40.0,
                                     seed=4)
    V = len(images)
    rng = np.random.default_rng(0)
    X = rng.uniform([-2.2] * 3, [2.2] * 3, (150, 3)).astype(np.float32)
    oc, op = [], []
    for v in range(V):
        Xc = X @ gt["R"][v].T + gt["t"][v]
        uv = Xc[:, :2] / Xc[:, 2:] * gt["intr"][0] + np.array([w / 2, h / 2])
        vis = (Xc[:, 2] > 1) & (uv[:, 0] > 0) & (uv[:, 0] < w) & (uv[:, 1] > 0) & (uv[:, 1] < h)
        oc += [v] * int(vis.sum())
        op += np.nonzero(vis)[0].tolist()
    f32 = dict(dtype=_torch.float32)
    sc = empty_scene(V, 150, len(oc), "cpu").replace(
        intr=_torch.as_tensor(np.tile(gt["intr"], (V, 1)), **f32),
        cam_rot=lie.so3_log(_torch.as_tensor(gt["R"], **f32)),
        cam_t=_torch.as_tensor(gt["t"], **f32), cam_mask=_torch.ones(V, dtype=_torch.bool),
        points=_torch.as_tensor(X), point_mask=_torch.ones(150, dtype=_torch.bool),
        obs_cam=_torch.as_tensor(oc, dtype=_torch.int32),
        obs_pt=_torch.as_tensor(op, dtype=_torch.int32),
        obs_mask=_torch.ones(len(oc), dtype=_torch.bool))
    return images, gt, sc


def _share_within(got, want, tol):
    return float(np.mean(np.abs(got - want) <= tol))


@pytest.mark.parametrize("fine", [False, True])
def test_patchmatch_refine_on_card_matches_cpu(dev, fine):
    from tpusfm_torch.dense import depth as tdepth
    from tpusfm_torch.dense import patchmatch as tpm

    images, gt, _ = _dense_room()
    v, srcs = 2, [1, 3, 0]
    H, W = images.shape[1:]
    K = np.array([[gt["intr"][0], 0, gt["intr"][2]], [0, gt["intr"][1], gt["intr"][3]],
                  [0, 0, 1]], np.float32)
    R_rel = np.einsum("sij,kj->sik", gt["R"][srcs], gt["R"][v]).astype(np.float32)
    t_rel = (gt["t"][srcs] - np.einsum("sij,j->si", R_rel, gt["t"][v])).astype(np.float32)
    norm = tdepth.local_normalize(torch.as_tensor(images), 5)
    Ks = torch.as_tensor(np.tile(K, (3, 1, 1)))
    d0, _ = tdepth.plane_sweep_depth(norm[v], norm[srcs], torch.as_tensor(K), Ks,
                                     torch.as_tensor(R_rel), torch.as_tensor(t_rel),
                                     torch.linspace(1 / 9.0, 1 / 2.5, 24),
                                     tdepth.DenseConfig(n_sources=3))
    gen = torch.Generator().manual_seed(11)
    draws = [tpm.draw_half_sweep(gen, H, W // 2, fine, "cpu") for _ in range(4)]
    n_init = None
    if fine:
        n_init = torch.zeros(H, W, 3)
        n_init[..., 2] = -1.0
    cfg = tpm.PatchMatchConfig(n_iters=2, fine=fine)
    args = [torch.as_tensor(images[v]), torch.as_tensor(images[srcs]), torch.as_tensor(K), Ks,
            torch.as_tensor(R_rel), torch.as_tensor(t_rel), 1.0 / d0]
    want = tpm.patchmatch_refine(*args, 1 / 9.0, 1 / 2.5, None, cfg, n_init, draws=draws)
    got = tpm.patchmatch_refine(*[a.to(dev) for a in args], 1 / 9.0, 1 / 2.5, None, cfg,
                                None if n_init is None else n_init.to(dev),
                                draws=[{k: x.to(dev) for k, x in d.items()} for d in draws])
    assert all(x.device.type == "cuda" for x in got)
    (dg, cg, ng), (dw, cw, nw) = ([x.cpu().numpy() for x in o] for o in (got, want))
    assert _share_within(dg / dw, 1.0, 1e-3) >= 0.99
    assert _share_within(cg, cw, 1e-3) >= 0.99
    assert _share_within(np.abs(ng - nw).max(-1), 0.0, 1e-3) >= 0.99


@pytest.mark.parametrize("coarse_px", [120_000, 5_000])
def test_dense_reconstruct_on_card_matches_cpu(dev, coarse_px):
    """One seed gives the same draws on both devices (CPU generators per
    view and level); at 5,000 px the coarse-to-fine path runs.  A
    PatchMatch near-tie can flip on either device and the coarse level's
    flips pass on to the fine one, so the float16 maps agree within 1e-3
    on 98% of the pixels both keep, the masks on 99%, the fused counts
    within 2%; both meet tests/test_patchmatch.py's bars."""
    from tpusfm_torch.dense import depth as tdepth
    from tpusfm_torch.dense import patchmatch as tpm

    images, gt, sc = _dense_room()
    cfg = tdepth.DenseConfig(n_planes=32, n_sources=3, pm=tpm.PatchMatchConfig(n_iters=2),
                             pm_coarse_px=coarse_px)
    outs = []
    for device in ("cpu", dev):
        timings = {}
        outs.append(tdepth.dense_reconstruct(sc, images, None, cfg, views=[1, 2, 3],
                                             return_maps=True, device=device, timings=timings))
        assert (timings["pm_coarse"] > 0) == (coarse_px < 96 * 128)
    (pw, _, mw), (pg, _, mg) = outs
    both = mw["valid"] & mg["valid"]
    assert _share_within(mg["depths"][both] / mw["depths"][both], 1.0, 1e-3) >= 0.98
    assert np.mean(mg["valid"] == mw["valid"]) >= 0.99
    assert abs(len(pg) - len(pw)) <= 0.02 * len(pw) and len(pw) > 1000
    for pts in (pw, pg):
        Xc = pts @ gt["R"][2].T + gt["t"][2]
        u = np.round(Xc[:, 0] / Xc[:, 2] * gt["intr"][0] + 64).astype(int)
        w_ = np.round(Xc[:, 1] / Xc[:, 2] * gt["intr"][0] + 48).astype(int)
        inb = (u >= 0) & (u < 128) & (w_ >= 0) & (w_ < 96) & (Xc[:, 2] > 0)
        zgt = gt["depth"][2][w_[inb], u[inb]]
        fin = np.isfinite(zgt)
        assert np.median(np.abs(Xc[inb, 2][fin] - zgt[fin]) / zgt[fin]) < 0.015


def test_tsdf_fuse_and_photo_sweep_on_card_match_cpu(dev):
    from tpusfm_torch.dense import meshing as tmesh

    images, gt = render_orbit_images(n_views=6, img_h=64, img_w=88, focal=0.8 * 88,
                                     arc_deg=70.0, seed=4)
    depths = gt["depth"].copy()
    depths[~(np.isfinite(depths) & (depths < 50))] = 0.0
    K = np.array([[gt["intr"][0], 0, 44], [0, gt["intr"][1], 32], [0, 0, 1]], np.float32)
    cpu = [torch.as_tensor(np.array(a, np.float32)) for a in (depths, K, gt["R"], gt["t"],
                                                              [-3.0, -3.0, -3.0])]
    grid = (np.float32(6.0 / 47), np.float32(18.0 / 47), 48)
    want = tmesh.tsdf_fuse(*cpu, *grid)
    got = tmesh.tsdf_fuse(*[a.to(dev) for a in cpu], *grid)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert _share_within(g.cpu().numpy(), w.numpy(), 1e-5) >= 0.9999
    tsdf, wsum = (x.numpy() for x in want)
    verts, _ = tmesh.marching_tetrahedra(tsdf, wsum >= 1.0, np.full(3, -3.0), 6.0 / 47)
    rng = np.random.default_rng(1)
    N = min(len(verts), 400)
    vn = rng.normal(size=(N, 3))
    vn /= np.linalg.norm(vn, axis=1, keepdims=True)
    t1 = np.cross(vn, [0.0, 0.0, 1.0])
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(vn, t1)
    cpu = [torch.as_tensor(np.array(a, np.float32)) for a in (verts[:N], vn, t1, t2)]
    cpu += [torch.as_tensor(np.stack([rng.permutation(6)[:4] for _ in range(N)])),
            torch.as_tensor((rng.random((N, 4)) > 0.2).astype(np.float32)),
            torch.as_tensor(images), torch.as_tensor(np.tile(K, (6, 1, 1))),
            torch.as_tensor(gt["R"].astype(np.float32)),
            torch.as_tensor(gt["t"].astype(np.float32))]
    want = tmesh._photo_sweep(*cpu, np.float32(0.1), np.float32(0.05), 9)
    got = tmesh._photo_sweep(*[a.to(dev) for a in cpu], np.float32(0.1), np.float32(0.05), 9)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-4)


def test_service_on_card_runs_the_sparse_stage(dev, tmp_path):
    """The port's HTTP service on the card over tests/test_service.py's
    6-view 240x320 orbit: upload, /preprocessing, /sparse; the stage ends
    without error, K1 launched as bf16 only, and 5 of the 6 views register
    at ATE < 0.05: the staged pipeline self-calibrates one group, and on
    this scene both packages' staged runs register 5/6 on the CPU
    (tests/test_torch_staged.py holds the counts equal)."""
    from tpusfm_torch.service.http_server import start_background
    from tpusfm_torch.tools.service_rung import Client, png_bytes, run_stages, scene_quality

    images, gt = render_orbit_images(n_views=6, img_h=240, img_w=320, focal=0.9 * 320,
                                     arc_deg=60.0, seed=1)
    cfg = config_from_overrides(**{
        "sift.n_octaves": 3, "sift.max_per_octave": 512, "sift.max_features": 768,
        "matching.pair_chunk": 16, "filter.max_iterations": 128, "feature_batch": 3,
        "focal_prior_px": 0.9 * 320})
    httpd, state, port = start_background(str(tmp_path), cfg, host="127.0.0.1")
    try:
        assert state.pipeline.device.type == "cuda"  # the default
        client = Client(port)
        files = [(f"view_{i:03d}.png", png_bytes(img)) for i, img in enumerate(images)]
        assert client.post_multipart("/upload", files)[0] == 200
        before = dict(topk2_match.LAUNCHES)
        run_stages(client, ("preprocessing", "sparse"), 300)
        st = client.get_json("/status")[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert st["error"] is None and st["device"].startswith("cuda")
    q = scene_quality(tmp_path, gt)
    assert q["registered"] == 5 and q["ate"] < 0.05, q
    assert topk2_match.LAUNCHES["quantized"] > before["quantized"]
    assert topk2_match.LAUNCHES["f32"] == before["f32"]


def _feature_tracks(s):
    """(kp, track_ids) of a synthetic observation table, each view's
    features its observations (tests/test_incremental.py's helper)."""
    V = len(s["R"])
    per_view = [np.nonzero(s["obs_cam"] == v)[0] for v in range(V)]
    N = max(len(p) for p in per_view)
    kp = np.zeros((V, N, 2), np.float32)
    track_ids = np.full((V, N), -1, np.int32)
    for v, rows in enumerate(per_view):
        kp[v, : len(rows)] = s["obs_uv"][rows]
        track_ids[v, : len(rows)] = s["obs_pt"][rows]
    return kp, track_ids


@pytest.mark.parametrize("engine", ["global", "stellar"])
def test_engines_on_card_meet_the_reference_test_bars(dev, engine):
    """The global and stellar engines on the card over the reference
    tests' 12-view scene (tests/test_global_sfm.py:60-72,
    test_stellar.py:61-73): 12/12, ATE < 0.02, > 150 points."""
    from tpusfm_torch.sfm import global_sfm, stellar
    from tpusfm_torch.utils.synth_scene import orbit_scene

    s = orbit_scene(n_cams=12, n_points=300, noise_px=0.4, seed=9, arc_deg=140.0)
    kp, track_ids = _feature_tracks(s)
    intr = np.tile(s["intr"], (12, 1))
    cls = global_sfm.GlobalEngine if engine == "global" else stellar.StellarEngine
    eng = cls(kp, intr, track_ids, int(track_ids.max()) + 1, device=dev)
    scene = eng.run(torch.Generator(device=dev).manual_seed(0))
    assert scene.cam_mask.device.type == dev.type
    reg = scene.cam_mask.cpu().numpy()
    assert reg.sum() == 12
    ate = metrics.ate_rmse(scene.camera_centers().cpu().numpy()[reg], s["centers"][reg])
    assert ate < 0.02, f"{engine} ATE {ate:.4f}"
    assert int(scene.point_mask.sum()) > 150


def test_averaging_on_card_repeats_bit_for_bit_and_matches_cpu(dev):
    """The four averaging solves on the card: the same bits on two calls,
    and within 1e-4 (of the largest output) of the same solve on the CPU."""
    from tpusfm_torch.core import lie
    from tpusfm_torch.sfm import global_sfm, stellar

    rng = np.random.default_rng(0)
    V = 40
    R_gt = lie.so3_exp(torch.as_tensor(rng.normal(scale=0.6, size=(V, 3)), dtype=torch.float32))
    C_gt = torch.as_tensor(rng.normal(size=(V, 3)) * 3, dtype=torch.float32)
    edges = np.array([(i, j) for i in range(V) for j in range(i + 1, min(V, i + 7))], np.int64)
    ei, ej = torch.as_tensor(edges[:, 0]), torch.as_tensor(edges[:, 1])
    R_rel = R_gt[ej] @ R_gt[ei].transpose(1, 2)
    d = C_gt[ej] - C_gt[ei]
    w = torch.as_tensor(rng.uniform(0.2, 1, len(edges)), dtype=torch.float32)
    la = torch.as_tensor(rng.integers(0, len(edges), 600))
    lb = torch.as_tensor(rng.integers(0, len(edges), 600))
    rhs = torch.as_tensor(rng.normal(size=600) * 0.1, dtype=torch.float32)
    R_init = torch.eye(3).expand(V, 3, 3).contiguous()
    calls = {
        "rotation": lambda t: global_sfm.rotation_averaging(
            t(ei), t(ej), t(R_rel), t(w), t(R_init), V, 40),
        "translation": lambda t: global_sfm.translation_averaging(
            t(ei), t(ej), t(d / d.norm(dim=1, keepdim=True)), t(w), 1, V, 100),
        "edge_scale": lambda t: stellar.edge_scale_solve(t(la), t(lb), t(rhs), t(w[:1].expand(600)),
                                                         len(edges), cg_iters=len(edges)),
        "scaled_translation": lambda t: stellar.scaled_translation_solve(
            t(ei), t(ej), t(d), t(w), V, cg_iters=3 * V),
    }
    for name, call in calls.items():
        a, b = call(lambda x: x.to(dev)), call(lambda x: x.to(dev))
        assert torch.equal(a, b), name
        cpu = call(lambda x: x)
        tol = 1e-4 * float(cpu.abs().max())
        assert float((a.cpu() - cpu).abs().max()) <= tol, name


def test_calibration_on_card_meets_the_reference_test_bars(dev):
    """calibrate_camera on the card over tests/test_calibration.py's boards
    (rendered by the port's copy of its renderer): that test's bars, and
    within 1e-3 relative (1e-3 px rms) of the same solve on the CPU."""
    from tpusfm_torch.tools.calib_boards import render_board_views
    from tpusfm_torch.utils import calibration

    images, K = render_board_views()
    corners = calibration.find_chessboard_corners(images, (9, 6))
    intr, rms, V = calibration.calibrate_camera(corners, (9, 6), device=dev)
    cpu, cpu_rms, _ = calibration.calibrate_camera(corners, (9, 6), device="cpu")
    assert V >= 4 and rms < 0.5
    assert abs(intr[0] - K[0, 0]) / K[0, 0] < 0.02 and abs(intr[1] - K[1, 1]) / K[1, 1] < 0.02
    assert abs(intr[2] - K[0, 2]) < 15 and abs(intr[3] - K[1, 2]) < 15
    np.testing.assert_allclose(intr[:4], cpu[:4], rtol=1e-3)
    np.testing.assert_allclose(intr[4:], cpu[4:], atol=1e-3)
    assert abs(rms - cpu_rms) < 1e-3


def _sharded_ba_rank(rank, prob):
    """One rank of test_sharded_ba_two_gloo_ranks_on_one_card."""
    from tpusfm_torch.parallel import dist_ba
    from tpusfm_torch.parallel import mesh as tmesh

    dev = torch.device("cuda", 0)
    m = tmesh.make_mesh(device=dev)
    t = {k: torch.as_tensor(v, device=dev) for k, v in prob.items()}
    obs = dist_ba.shard_obs_table(prob["obs_cam"], prob["obs_pt"], prob["obs_uv"],
                                  prob["obs_mask"], m.size, device=dev)
    rest = {k: v for k, v in t.items() if not k.startswith("obs_")}
    cfg = tba.BAConfig(max_iters=8, converge_rtol=0.0)  # 70 cameras: the kernel path
    before = dict(ot.LAUNCHES)
    out = dist_ba.bundle_adjust_sharded(m, **rest, obs_cam=obs[0], obs_pt=obs[1], obs_uv=obs[2],
                                        obs_mask=obs[3], cfg=cfg)
    launches = {k: ot.LAUNCHES[k] - before[k] for k in before}
    single = tba.bundle_adjust(**t, cfg=cfg)
    return {"cost": float(out[4]["final_cost"]), "single_cost": float(single[4]["final_cost"]),
            "rot": out[1].cpu().numpy(), "t": out[2].cpu().numpy(),
            "single_rot": single[1].cpu().numpy(), "single_t": single[2].cpu().numpy(),
            "launches": launches}


def test_sharded_ba_two_gloo_ranks_on_one_card(dev, tmp_path):
    """Two gloo ranks on cuda:0 solve a 70-camera BA with the observation
    table split between them (K2, then K5 and K4 in point space; K3 is one
    device's) and match the single-device kernel solve: final cost within
    1% relative, poses within 5e-3; both ranks get the same bits."""
    from tpusfm_torch.parallel import mesh as tmesh

    prob = point_sorted_ba_problem(70, 3000, seed=3, vis_prob=0.2)
    res = tmesh.run_ranks(_sharded_ba_rank, 2, backend="gloo",
                          init_method=f"file://{tmp_path}/init", args=(prob,))
    for r in res:
        assert abs(r["cost"] - r["single_cost"]) <= 0.01 * r["single_cost"]
        np.testing.assert_allclose(r["rot"], r["single_rot"], atol=5e-3)
        np.testing.assert_allclose(r["t"], r["single_t"], atol=5e-3)
        n = r["launches"]
        assert n["linearize_reduce_radial3_t"] and n["schur_fwd_t"] and n["schur_bwd_t"], n
        assert n["schur_mv_t"] == 0, n
    np.testing.assert_array_equal(res[0]["t"], res[1]["t"])
