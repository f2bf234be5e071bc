"""The port's dense stage (tpusfm_torch.dense.depth, parallel.dist_dense and
the dense stage's ops.image functions) against the JAX reference on the CPU,
and end to end against the renderer's ground truth on
tests/test_patchmatch.py's scene."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusfm.core import lie as jlie
from tpusfm.dense import depth as jdepth
from tpusfm.dense import patchmatch as jpm
from tpusfm.ops import image as jimage
from tpusfm.parallel import dist_dense as jdist
from tpusfm.sfm import scene as jscene
from tpusfm_torch import convert
from tpusfm_torch.dense import depth as tdepth
from tpusfm_torch.dense import patchmatch as tpm
from tpusfm_torch.ops import image as timage
from tpusfm_torch.parallel import dist_dense as tdist
from tpusfm_torch.utils.synth_render import render_orbit_images

torch.set_num_threads(2)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _sparse_scene(images, gt, n_points=150):
    """tests/test_patchmatch.py's scene: ground-truth poses and a few
    projected world points to set the depth ranges (reference Scene)."""
    V, H, W = images.shape
    aa = np.asarray(jlie.so3_log(jnp.asarray(gt["R"])))
    rng = np.random.default_rng(0)
    X = rng.uniform([-2.2, -2.2, -2.2], [2.2, 2.2, 2.2], (n_points, 3)).astype(np.float32)
    obs_cam, obs_pt, obs_uv = [], [], []
    f = gt["intr"][0]
    for v in range(V):
        Xc = X @ gt["R"][v].T + gt["t"][v]
        z = Xc[:, 2]
        uv = Xc[:, :2] / z[:, None] * f + np.array([W / 2, H / 2])
        vis = (z > 1) & (uv[:, 0] > 0) & (uv[:, 0] < W) & (uv[:, 1] > 0) & (uv[:, 1] < H)
        idx = np.nonzero(vis)[0]
        obs_cam += [v] * len(idx)
        obs_pt += idx.tolist()
        obs_uv += uv[idx].tolist()
    O = len(obs_cam)
    return jscene.empty_scene(V, n_points, O).replace(
        intr=jnp.asarray(np.tile(gt["intr"], (V, 1))),
        cam_rot=jnp.asarray(aa, dtype=jnp.float32),
        cam_t=jnp.asarray(gt["t"]),
        cam_mask=jnp.ones(V, bool),
        points=jnp.asarray(X),
        point_mask=jnp.ones(n_points, bool),
        obs_cam=jnp.asarray(obs_cam, dtype=jnp.int32),
        obs_pt=jnp.asarray(obs_pt, dtype=jnp.int32),
        obs_uv=jnp.asarray(np.asarray(obs_uv, np.float32)),
        obs_mask=jnp.ones(O, bool),
    )


@pytest.fixture(scope="module")
def room():
    images, gt = render_orbit_images(n_views=5, img_h=144, img_w=192, focal=0.8 * 192,
                                     arc_deg=40.0, seed=4)
    jsc = _sparse_scene(images, gt)
    tsc = convert.scene_from_numpy(jscene.scene_to_numpy(jsc), device="cpu")
    rgb = np.repeat((images * 255).astype(np.uint8)[..., None], 3, -1)
    return dict(images=images, gt=gt, jsc=jsc, tsc=tsc, rgb=rgb)


def _median_rel_err(pts, gt, shape, v=2):
    """tests/test_patchmatch.py's check: fused points reprojected into view
    v against the renderer's depth."""
    H, W = shape
    f = gt["intr"][0]
    Xc = pts @ gt["R"][v].T + gt["t"][v]
    z = Xc[:, 2]
    u = (Xc[:, 0] / z * f + W / 2).round().astype(int)
    w_ = (Xc[:, 1] / z * f + H / 2).round().astype(int)
    inb = (u >= 0) & (u < W) & (w_ >= 0) & (w_ < H) & (z > 0)
    zgt = gt["depth"][v][w_[inb], u[inb]]
    fin = np.isfinite(zgt)
    return float(np.median(np.abs(z[inb][fin] - zgt[fin]) / zgt[fin]))


@pytest.mark.parametrize("w", [3, 4, 5])
def test_box_mean_and_local_normalize_match_reference(room, w):
    imgs = room["images"][:2]
    np.testing.assert_allclose(tdepth._box_mean(_t(imgs), w).numpy(),
                               np.asarray(jdepth._box_mean(jnp.asarray(imgs), w)), atol=1e-5)
    np.testing.assert_allclose(tdepth.local_normalize(_t(imgs[0]), w).numpy(),
                               np.asarray(jdepth.local_normalize(jnp.asarray(imgs[0]), w)),
                               atol=1e-5)


def test_bilinear_sample_level_matches_reference():
    rng = np.random.default_rng(0)
    vol = rng.random((3, 20, 30)).astype(np.float32)
    lvl = rng.integers(0, 3, 500)
    y = rng.uniform(-2, 22, 500).astype(np.float32)
    x = rng.uniform(-2, 32, 500).astype(np.float32)
    for h_lim, w_lim in ((None, None), (12, 17)):
        want = jimage.bilinear_sample_level(jnp.asarray(vol), jnp.asarray(lvl), jnp.asarray(y),
                                            jnp.asarray(x), h_lim, w_lim)
        got = timage.bilinear_sample_level(_t(vol), torch.as_tensor(lvl), _t(y), _t(x),
                                           h_lim, w_lim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    got = timage.bilinear_sample_level(_t(vol), 1, _t(y), _t(x), torch.tensor(12),
                                       torch.tensor(17))
    want = jimage.bilinear_sample_level(jnp.asarray(vol), 1, jnp.asarray(y), jnp.asarray(x),
                                        jnp.int32(12), jnp.int32(17))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("model,lens,rgb", [
    ("auto", (-0.25, 0.05, 0.0), False), ("auto", (0.5, 0.0, 0.0), True),
    ("auto", (-0.1, 0.015, 0.0, 0.008, -0.006), False),
    ("fisheye", (0.05, -0.01, 0.002, 0.0, 0.0), True)])
def test_undistort_image_matches_reference(model, lens, rgb):
    h, w = 50, 70
    rng = np.random.default_rng(1)
    img = rng.random((h, w, 3) if rgb else (h, w)).astype(np.float32)
    intr = np.array([60.0, 58.0, w / 2 + 0.3, h / 2 - 0.2, *lens], np.float32)
    want = jimage.undistort_image(jnp.asarray(img), jnp.asarray(intr), fill=-1.0, model=model)
    got = timage.undistort_image(_t(img), _t(intr), fill=-1.0, model=model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("sampling", ["up4", "nearest", "bilinear"])
def test_plane_sweep_depth_matches_reference(room, sampling):
    images, gt = room["images"], room["gt"]
    v, srcs = 2, [1, 3, 0]
    cfg_j = jdepth.DenseConfig(n_planes=24, n_sources=3, sweep_sampling=sampling)
    cfg_t = tdepth.DenseConfig(n_planes=24, n_sources=3, sweep_sampling=sampling)
    norm = np.asarray(jax.vmap(lambda im: jdepth.local_normalize(im, 5))(jnp.asarray(images)))
    K = np.array([[gt["intr"][0], 0, gt["intr"][2]], [0, gt["intr"][1], gt["intr"][3]],
                  [0, 0, 1]], np.float32)
    Ks = np.broadcast_to(K, (3, 3, 3)).copy()
    R_rel = np.einsum("sij,kj->sik", gt["R"][srcs], gt["R"][v]).astype(np.float32)
    t_rel = (gt["t"][srcs] - np.einsum("sij,j->si", R_rel, gt["t"][v])).astype(np.float32)
    inv = np.linspace(1 / 9.0, 1 / 2.5, 24).astype(np.float32)
    args = (norm[v], norm[srcs], K, Ks, R_rel, t_rel, inv)
    d_w, c_w = (np.asarray(x) for x in jdepth.plane_sweep_depth(*map(jnp.asarray, args), cfg_j))
    d_g, c_g = (x.numpy() for x in tdepth.plane_sweep_depth(*map(_t, args), cfg_t))
    assert np.mean(np.abs(d_g / d_w - 1.0) <= 1e-4) >= 0.99
    assert np.mean(np.abs(c_g - c_w) <= 1e-4) >= 0.99


def test_sources_ranges_and_packing_match_reference(room):
    jsc, tsc = room["jsc"], room["tsc"]
    for v in range(5):
        assert tdepth.select_source_views(tsc, v, 3) == jdepth.select_source_views(jsc, v, 3)
        want = jdepth.depth_range_from_sparse(jsc, v, 0.25)
        np.testing.assert_allclose(tdepth.depth_range_from_sparse(tsc, v, 0.25), want, rtol=1e-5)
    for got, want in zip(tdepth.depth_ranges_all(tsc, 0.25), jdepth.depth_ranges_all(jsc, 0.25)):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    ranges = tdepth.depth_ranges_all(tsc, 0.25)
    for rng_arg in (None, ranges):
        got = tdist.pack_sweep_inputs(tsc, [1, 2, 3], tdepth.DenseConfig(n_sources=3), 16,
                                      ranges=rng_arg)
        want = jdist.pack_sweep_inputs(jsc, [1, 2, 3], jdepth.DenseConfig(n_sources=3), 16,
                                       ranges=rng_arg)
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_packed_paths_equal_per_view_calls(room):
    """The packed functions run view by view: each view's maps equal a
    direct call with the same inputs and the same seed."""
    images, tsc = room["images"], room["tsc"]
    cfg = tdepth.DenseConfig(n_planes=12, n_sources=3, pm=tpm.PatchMatchConfig(n_iters=1))
    idx, R_rel, t_rel, inv, lo, hi = (torch.as_tensor(a) for a in tdist.pack_sweep_inputs(
        tsc, [1, 3], cfg, 12))
    Ks = _t(np.tile(np.array([[room["gt"]["intr"][0], 0, 96], [0, room["gt"]["intr"][1], 72],
                              [0, 0, 1]], np.float32), (5, 1, 1)))
    norm = tdepth.local_normalize(_t(images), 5)
    d, c = tdist.plane_sweep_all_views(norm, Ks, idx, R_rel, t_rel, inv, cfg)
    gens = [torch.Generator().manual_seed(s) for s in (4, 5)]
    pm = tdist.patchmatch_all_views(_t(images), Ks, idx, R_rel, t_rel, 1.0 / d, lo, hi, gens,
                                    cfg.pm)
    for b in range(2):
        s = idx[b].long()
        d1, c1 = tdepth.plane_sweep_depth(norm[s[-1]], norm[s[:-1]], Ks[s[-1]], Ks[s[:-1]],
                                          R_rel[b], t_rel[b], inv[b], cfg)
        assert torch.equal(d1, d[b]) and torch.equal(c1, c[b])
        one = tpm.patchmatch_refine(_t(images)[s[-1]], _t(images)[s[:-1]], Ks[s[-1]], Ks[s[:-1]],
                                    R_rel[b], t_rel[b], 1.0 / d1, lo[b], hi[b],
                                    torch.Generator().manual_seed(4 + b), cfg.pm)
        for x, y in zip(one, pm):
            assert torch.equal(x, y[b])


def test_consistency_filter_matches_reference(room):
    gt = room["gt"]
    depths = gt["depth"].copy().astype(np.float32)
    depths[~np.isfinite(depths)] = 0.0
    rng = np.random.default_rng(2)
    depths = (depths * (1 + rng.normal(scale=0.01, size=depths.shape))).astype(np.float32)
    depths[:, :, :20] = 0.0  # an invalid band
    costs = rng.uniform(0, 1, depths.shape).astype(np.float32)
    V = depths.shape[0]
    K = np.array([[gt["intr"][0], 0, gt["intr"][2]], [0, gt["intr"][1], gt["intr"][3]],
                  [0, 0, 1]], np.float32)
    nbrs = np.array([[(v + 1) % V, (v + 2) % V, (v - 1) % V] for v in range(V)], np.int32)
    R, t = gt["R"].astype(np.float32), gt["t"].astype(np.float32)
    for Karg in (K, np.tile(K, (V, 1, 1))):
        want = np.asarray(jdepth.consistency_filter(
            jnp.asarray(depths), jnp.asarray(costs), jnp.asarray(Karg), jnp.asarray(R),
            jnp.asarray(t), jnp.asarray(nbrs), jdepth.DenseConfig()))
        got = tdepth.consistency_filter(_t(depths), _t(costs), _t(Karg), _t(R), _t(t),
                                        torch.as_tensor(nbrs), tdepth.DenseConfig()).numpy()
        assert np.mean(got == want) >= 0.999
        assert 0.05 < want.mean() < 0.95


def test_sharded_paths_raise(room):
    """The sharded paths run in a process group (test_torch_parallel.py,
    test_torch_mesh_pipeline.py); a batch that does not split over the mesh,
    or a mesh outside any group, raises instead of running on one device."""
    from tpusfm_torch.parallel import mesh as tmesh

    three = tmesh.Mesh(group=None, axis="shard", size=3, rank=0, device=torch.device("cpu"),
                       backend="gloo")
    sidx = torch.zeros((4, 4), dtype=torch.int32)
    for fn, n_rest in ((tdist.plane_sweep_sharded, 3), (tdist.patchmatch_sharded, 7)):
        with pytest.raises(ValueError, match="must divide mesh axis 3"):
            fn(three, None, None, sidx, *([None] * n_rest))
    one = dataclasses.replace(three, size=1)
    with pytest.raises(ValueError, match="process group"):
        tdepth.dense_reconstruct(room["tsc"], room["images"], None, mesh=one, device="cpu")


def test_dense_config_carries_from_reference():
    jcfg = jdepth.DenseConfig(n_planes=64, n_sources=3, view_batch=2,
                              pm=jpm.PatchMatchConfig(n_iters=3))
    got = convert._convert_dataclass(jcfg, tdepth.DenseConfig)
    assert got == tdepth.DenseConfig(n_planes=64, n_sources=3, view_batch=2,
                                     pm=tpm.PatchMatchConfig(n_iters=3))
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)


@pytest.fixture(scope="module")
def pm_runs(room):
    """tests/test_patchmatch.py's dense_reconstruct config on both packages."""
    jcfg = jdepth.DenseConfig(n_planes=32, n_sources=3, pm=jpm.PatchMatchConfig(n_iters=2))
    tcfg = tdepth.DenseConfig(n_planes=32, n_sources=3, pm=tpm.PatchMatchConfig(n_iters=2))
    want = jdepth.dense_reconstruct(room["jsc"], room["images"], room["rgb"], jcfg,
                                    views=[1, 2, 3])
    timings = {}
    got = tdepth.dense_reconstruct(room["tsc"], room["images"], room["rgb"], tcfg,
                                   views=[1, 2, 3], device="cpu", timings=timings,
                                   return_maps=True)
    return want, got, timings


def test_dense_reconstruct_meets_the_reference_test_bars(room, pm_runs):
    """The bars of tests/test_patchmatch.py::test_dense_reconstruct_with_
    patchmatch, and the fused count within 15% of the reference's."""
    (pts_w, _), (pts, cols, maps), _ = pm_runs
    H, W = room["images"].shape[1:]
    assert len(pts) > 2000, len(pts)
    assert _median_rel_err(pts, room["gt"], (H, W)) < 0.015
    assert abs(len(pts) - len(pts_w)) <= 0.15 * len(pts_w), (len(pts), len(pts_w))
    assert cols.shape == pts.shape and cols.dtype == np.uint8
    assert sorted(maps) == ["K", "R", "computed", "costs", "depths", "t", "valid"]
    np.testing.assert_array_equal(maps["computed"], [1, 2, 3])
    assert int(maps["valid"].sum()) == len(pts)


def test_dense_reconstruct_is_seeded_and_timed(room, pm_runs):
    _, (pts, _, _), timings = pm_runs
    assert sorted(timings) == sorted(["setup", "sweep", "pm_coarse", "pm_fine",
                                      "consistency_fetch", "fusion"])
    assert timings["pm_fine"] > 0 and timings["pm_coarse"] == 0.0  # 27,648 px: one level
    cfg = tdepth.DenseConfig(n_planes=32, n_sources=3, pm=tpm.PatchMatchConfig(n_iters=2))
    again, _ = tdepth.dense_reconstruct(room["tsc"], room["images"], None, cfg, views=[1, 2, 3],
                                        device="cpu")
    np.testing.assert_array_equal(again, pts)
    gen = torch.Generator().manual_seed(9)
    other, _ = tdepth.dense_reconstruct(room["tsc"], room["images"], None, cfg, views=[1, 2, 3],
                                        device="cpu", generator=gen)
    assert len(other) > 2000


def test_dense_reconstruct_sweep_only_matches_reference(room):
    """patchmatch=False has no random draws: the fused clouds agree to a few
    points and the maps on >= 99% of pixels."""
    jcfg = jdepth.DenseConfig(n_planes=32, n_sources=3, patchmatch=False)
    tcfg = tdepth.DenseConfig(n_planes=32, n_sources=3, patchmatch=False)
    pts_w, _, maps_w = jdepth.dense_reconstruct(room["jsc"], room["images"], None, jcfg,
                                                views=[1, 2, 3], return_maps=True)
    pts, _, maps = tdepth.dense_reconstruct(room["tsc"], room["images"], None, tcfg,
                                            views=[1, 2, 3], device="cpu", return_maps=True)
    assert abs(len(pts) - len(pts_w)) <= 0.01 * len(pts_w)
    assert np.mean(maps["valid"] == maps_w["valid"]) >= 0.999
    d, dw = maps["depths"][1:4], maps_w["depths"][1:4]
    assert np.mean(np.abs(d - dw) <= 1e-3 * np.maximum(dw, 1e-6)) >= 0.99
    H, W = room["images"].shape[1:]
    assert _median_rel_err(pts, room["gt"], (H, W)) < 0.015


def test_dense_reconstruct_multiscale_meets_the_bars(room):
    """The coarse-to-fine path (half-resolution sweep and PatchMatch, then
    one fine iteration) engaged by lowering pm_coarse_px below the scene's
    27,648 px."""
    cfg = tdepth.DenseConfig(n_planes=32, n_sources=3, pm=tpm.PatchMatchConfig(n_iters=2),
                             pm_coarse_px=10_000)
    timings = {}
    pts, _ = tdepth.dense_reconstruct(room["tsc"], room["images"], None, cfg, views=[1, 2, 3],
                                      device="cpu", timings=timings)
    assert timings["pm_coarse"] > 0
    H, W = room["images"].shape[1:]
    assert len(pts) > 2000, len(pts)
    assert _median_rel_err(pts, room["gt"], (H, W)) < 0.015
