"""The port's PatchMatch (tpusfm_torch.dense.patchmatch) against the JAX
reference on the CPU: samplers, window offsets, checkerboard parity,
plane/state conversion, the candidate cost and the whole refinement with
the reference's own random draws fed in.

The scene is tests/test_patchmatch.py's corner room cut to 48x64 (three
sources, one iteration), so that JAX compiles each refinement in seconds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusfm.dense import depth as jdepth
from tpusfm.dense import patchmatch as jpm
from tpusfm_torch.dense import patchmatch as tpm
from tpusfm_torch.utils.synth_render import render_orbit_images

torch.set_num_threads(2)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def room():
    images, gt = render_orbit_images(n_views=5, img_h=48, img_w=64, focal=0.8 * 64,
                                     arc_deg=40.0, seed=4)
    v, srcs = 2, [1, 3, 0]
    K = np.array([[gt["intr"][0], 0, gt["intr"][2]], [0, gt["intr"][1], gt["intr"][3]],
                  [0, 0, 1]], np.float32)
    R_rel = np.einsum("sij,kj->sik", gt["R"][srcs], gt["R"][v]).astype(np.float32)
    t_rel = (gt["t"][srcs] - np.einsum("sij,j->si", R_rel, gt["t"][v])).astype(np.float32)
    zgt = gt["depth"][v]
    lo, hi = np.percentile(zgt[np.isfinite(zgt)], [1, 99])
    lo, hi = 0.8 * lo, 1.2 * hi
    cfg = jdepth.DenseConfig(n_planes=16, n_sources=3)
    norm = np.asarray(jax.vmap(lambda im: jdepth.local_normalize(im, cfg.window))(
        jnp.asarray(images)))
    inv_planes = np.linspace(1.0 / hi, 1.0 / lo, 16).astype(np.float32)
    Ks = np.broadcast_to(K, (3, 3, 3)).copy()
    d_sweep, _ = jdepth.plane_sweep_depth(
        jnp.asarray(norm[v]), jnp.asarray(norm[srcs]), jnp.asarray(K), jnp.asarray(Ks),
        jnp.asarray(R_rel), jnp.asarray(t_rel), jnp.asarray(inv_planes), cfg)
    inv0 = (1.0 / np.maximum(np.asarray(d_sweep), 1e-9)).astype(np.float32)
    return dict(ref=images[v], src=images[srcs], K=K, Ks=Ks, R_rel=R_rel, t_rel=t_rel,
                inv0=inv0, inv_lo=np.float32(1.0 / hi), inv_hi=np.float32(1.0 / lo))


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significand bits)."""
    a = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "up2", "up4", "up8"])
def test_sampler_matches_reference(room, mode):
    rng = np.random.default_rng(1)
    src = room["src"]
    S, H, W = src.shape
    vv = rng.uniform(-3, H + 3, (S, 7, 400)).astype(np.float32)
    uu = rng.uniform(-3, W + 3, (S, 7, 400)).astype(np.float32)
    want = np.asarray(jpm.make_sampler(jnp.asarray(src), mode)(jnp.asarray(vv), jnp.asarray(uu)))
    got = tpm.make_sampler(_t(src), mode)(_t(vv), _t(uu)).numpy()
    if mode.startswith("up"):
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))
    else:
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_upsample_pyramid_equals_jax_resize(room, k):
    """F.interpolate(bilinear, align_corners=False) enlarges as
    jax.image.resize does, edges included; the bf16 copies then agree
    within one bf16 ulp."""
    src = room["src"]
    S, H, W = src.shape
    want = jax.image.resize(jnp.asarray(src), (S, H * k, W * k), "bilinear")
    got = torch.nn.functional.interpolate(_t(src)[:, None], size=(H * k, W * k), mode="bilinear",
                                          align_corners=False)[:, 0].numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    want16 = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
    got16 = tpm.upsample_pyramid(_t(src), k).float().numpy()
    assert np.all(np.abs(got16 - want16) <= _bf16_ulp(want16))


@pytest.mark.parametrize("cfg", [tpm.PatchMatchConfig(),
                                 tpm.PatchMatchConfig(window_pattern="square"),
                                 tpm.PatchMatchConfig(window_radius=4, dilation=1)])
def test_window_offsets_match_reference(cfg):
    jcfg = jpm.PatchMatchConfig(**dataclasses.asdict(cfg))
    assert tpm._window_offsets(cfg) == jpm._window_offsets(jcfg)
    assert tpm._presel_offsets(cfg) == jpm._presel_offsets(jcfg)


def test_parity_gather_scatter_and_shift_match_reference():
    rng = np.random.default_rng(2)
    x2 = rng.normal(size=(7, 10)).astype(np.float32)
    x3 = rng.normal(size=(7, 10, 3)).astype(np.float32)
    for phase in (0, 1):
        for x in (x2, x3):
            g = tpm._gather_parity(_t(x), phase).numpy()
            np.testing.assert_array_equal(g, np.asarray(jpm._gather_parity(jnp.asarray(x), phase)))
            val = rng.normal(size=g.shape).astype(np.float32)
            np.testing.assert_array_equal(
                tpm._scatter_parity(_t(x), _t(val), phase).numpy(),
                np.asarray(jpm._scatter_parity(jnp.asarray(x), jnp.asarray(val), phase)))
    for dy, dx in ((0, 0), (2, -3), (-6, 6), (1, 0)):
        np.testing.assert_array_equal(tpm._shift_edge(_t(x2), dy, dx).numpy(),
                                      np.asarray(jpm._shift_edge(jnp.asarray(x2), dy, dx)))
    np.testing.assert_array_equal(tpm._shift_edge(_t(x3), 2, -3).numpy(),
                                  np.stack([np.asarray(jpm._shift_edge(jnp.asarray(x3[..., i]), 2,
                                                                       -3)) for i in range(3)], -1))


def test_plane_state_and_random_normals_match_reference():
    rng = np.random.default_rng(3)
    n = rng.normal(size=(6, 8, 3)).astype(np.float32)
    n[..., 2] = -np.abs(n[..., 2]) - 0.3
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    inv = rng.uniform(0.05, 0.5, (6, 8)).astype(np.float32)
    rpx, rpy = (rng.uniform(-0.5, 0.5, (6, 8)).astype(np.float32) for _ in range(2))
    c_w = np.asarray(jpm._plane_from_state(*(jnp.asarray(a) for a in (inv, n, rpx, rpy))))
    c_g = tpm._plane_from_state(*(_t(a) for a in (inv, n, rpx, rpy))).numpy()
    np.testing.assert_allclose(c_g, c_w, rtol=1e-6)
    i_w, ok_w = jpm._state_from_plane(jnp.asarray(n), jnp.asarray(c_w), jnp.asarray(rpx),
                                      jnp.asarray(rpy), 0.05)
    i_g, ok_g = tpm._state_from_plane(_t(n), _t(c_w), _t(rpx), _t(rpy), 0.05)
    np.testing.assert_allclose(i_g.numpy(), np.asarray(i_w), rtol=1e-6)
    np.testing.assert_array_equal(ok_g.numpy(), np.asarray(ok_w))
    # The normal perturbation and the restart normal, from the same draws.
    key = jax.random.PRNGKey(5)
    z = np.asarray(jax.random.normal(key, n.shape))
    np.testing.assert_allclose(tpm._perturb_normal(_t(z), _t(n), 12.5).numpy(),
                               np.asarray(jpm._perturb_normal(key, jnp.asarray(n), 12.5)),
                               atol=1e-6)
    k1, k2 = jax.random.split(key)
    ux, uy = (np.asarray(jax.random.uniform(k, (6, 8))) for k in (k1, k2))
    np.testing.assert_allclose(tpm._random_unit_normal(_t(ux), _t(uy)).numpy(),
                               np.asarray(jpm._random_unit_normal(key, (6, 8))), atol=1e-6)


@pytest.mark.parametrize("S,k", [(3, 1), (3, 2), (3, 3), (4, 2)])
def test_best_k_mean_matches_reference(S, k):
    c = np.random.default_rng(S * 10 + k).uniform(0, 2, (S, 5, 6)).astype(np.float32)
    np.testing.assert_allclose(tpm._best_k_mean(_t(c), k).numpy(),
                               np.asarray(jpm._best_k_mean(jnp.asarray(c), k)), atol=1e-6)


def _cost_inputs(room, phase):
    ref, src, K = room["ref"], room["src"], room["K"]
    H, W = ref.shape
    Wh = W // 2
    cfg = jpm.PatchMatchConfig()
    offs = jpm._window_offsets(cfg)
    xs_a = (2.0 * np.arange(Wh)[None, :] + ((np.arange(H) + phase) % 2)[:, None]).astype(np.float32)
    ys_a = np.repeat(np.arange(H, dtype=np.float32)[:, None], Wh, 1)
    rv = np.stack([np.asarray(jpm._gather_parity(jpm._shift_edge(jnp.asarray(ref), dy, dx), phase))
                   for dy, dx in offs])
    mr, var = rv.mean(0), rv.var(0)
    rng = np.random.default_rng(4 + phase)
    n = rng.normal(size=(3, H, Wh, 3)).astype(np.float32) * 0.3
    n[..., 2] = -1.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    inv = rng.uniform(room["inv_lo"], room["inv_hi"], (3, H, Wh)).astype(np.float32)
    rpx = (xs_a - K[0, 2]) / K[0, 0]
    rpy = (ys_a - K[1, 2]) / K[1, 1]
    c = np.asarray(jpm._plane_from_state(jnp.asarray(inv), jnp.asarray(n), rpx, rpy))
    return cfg, offs, xs_a, ys_a, rv, mr, var, n, c


@pytest.mark.parametrize("phase,sampling", [(0, "bilinear"), (1, "bilinear"), (0, "up8"),
                                            (1, "up8")])
def test_cost_active_matches_reference(room, phase, sampling):
    """The candidate cost for three planes per pixel: the port evaluates
    them as one batch, the reference one at a time.  Within 1e-4 on >= 99%
    of pixels: a window of low variance (sigma ~ 0.02) turns float32
    rounding of the samples into 1e-4 of NCC, a sample at the frame's edge
    can fall in or out of bounds, and up8's one-texel lookup can take the
    next texel."""
    cfg, offs, xs_a, ys_a, rv, mr, var, n, c = _cost_inputs(room, phase)
    K, Ks, src = room["K"], room["Ks"], room["src"]
    H, W = room["ref"].shape

    def kw(mod, arr, sample):
        return dict(sample=sample, S=3, fx=arr(K[0, 0]), fy=arr(K[1, 1]), cx=arr(K[0, 2]),
                    cy=arr(K[1, 2]), fxs=arr(Ks[:, 0, 0]), fys=arr(Ks[:, 1, 1]),
                    cxs=arr(Ks[:, 0, 2]), cys=arr(Ks[:, 1, 2]), R_rel=arr(room["R_rel"]),
                    t_rel=arr(room["t_rel"]), offsets=offs, cfg=mod.PatchMatchConfig(), HW=(H, W))

    jkw = kw(jpm, jnp.asarray, jpm.make_sampler(jnp.asarray(src), sampling))
    want = np.stack([np.asarray(jpm._cost_active(
        jnp.asarray(n[i]), jnp.asarray(c[i]), jnp.asarray(xs_a), jnp.asarray(ys_a),
        jnp.asarray(rv), jnp.asarray(mr), jnp.asarray(var), **jkw)) for i in range(3)])
    tkw = kw(tpm, _t, tpm.make_sampler(_t(src), sampling))
    got = tpm._cost_active(_t(n), _t(c), _t(xs_a), _t(ys_a), _t(rv), _t(mr), _t(var), **tkw)
    close = np.abs(got.numpy() - want) <= 1e-4
    assert close.mean() >= 0.99, close.mean()
    assert (want < 2.0).mean() > 0.5  # most windows are valid


def reference_draws(key, n_iters: int, H: int, Wh: int, fine: bool):
    """The reference's per-half-sweep draws, rebuilt with its own key
    splits (tpusfm/dense/patchmatch.py: split(key, 2 n_iters), then split
    each into k1..k5; k4 splits again for the restart normal)."""
    out = []
    for k in jax.random.split(key, 2 * n_iters):
        k1, k2, k3, k4, k5 = jax.random.split(k, 5)
        d = {"depth": jax.random.normal(k1, (H, Wh)), "normal": jax.random.normal(k2, (H, Wh, 3))}
        if not fine:
            a, b = jax.random.split(k4)
            d.update(restart=jax.random.uniform(k3, (H, Wh)),
                     restart_nx=jax.random.uniform(a, (H, Wh)),
                     restart_ny=jax.random.uniform(b, (H, Wh)),
                     normal_only=jax.random.normal(k5, (H, Wh, 3)))
        out.append({name: _t(np.asarray(v)) for name, v in d.items()})
    return out


def _share_close(got, want, tol):
    return float(np.mean(np.abs(got - want) <= tol))


@pytest.mark.parametrize("fine,width", [(False, 64), (True, 64), (False, 63)])
def test_patchmatch_refine_matches_reference_with_its_draws(room, fine, width):
    """With the reference's draws injected, depth, cost and normal agree on
    >= 99% of pixels within 1e-3; the rest are near-ties that flip a
    candidate choice.  The odd width goes through the reference's one-
    column edge pad (draws at the padded width)."""
    ref, src, inv0 = room["ref"][:, :width], room["src"][:, :, :width], room["inv0"][:, :width]
    H = ref.shape[0]
    cfg = dataclasses.replace(jpm.PatchMatchConfig(), n_iters=1, fine=fine)
    key = jax.random.PRNGKey(7)
    n_init = None
    if fine:  # the fine level starts from an upsampled coarse normal field
        rng = np.random.default_rng(8)
        n_init = np.concatenate([rng.normal(size=(H, width, 2)) * 0.2,
                                 -np.ones((H, width, 1))], -1).astype(np.float32)
    d_w, c_w, n_w = (np.asarray(x) for x in jpm.patchmatch_refine(
        jnp.asarray(ref), jnp.asarray(src), jnp.asarray(room["K"]), jnp.asarray(room["Ks"]),
        jnp.asarray(room["R_rel"]), jnp.asarray(room["t_rel"]), jnp.asarray(inv0),
        jnp.float32(room["inv_lo"]), jnp.float32(room["inv_hi"]), key, cfg,
        None if n_init is None else jnp.asarray(n_init)))
    draws = reference_draws(key, 1, H, (width + 1) // 2, fine)
    d_g, c_g, n_g = (x.numpy() for x in tpm.patchmatch_refine(
        _t(ref), _t(src), _t(room["K"]), _t(room["Ks"]), _t(room["R_rel"]), _t(room["t_rel"]),
        _t(inv0), room["inv_lo"], room["inv_hi"], None, tpm.PatchMatchConfig(n_iters=1, fine=fine),
        None if n_init is None else _t(n_init), draws=draws))
    assert d_g.shape == d_w.shape == (H, width)
    assert _share_close(d_g / d_w, 1.0, 1e-3) >= 0.99
    assert _share_close(c_g, c_w, 1e-3) >= 0.99
    assert _share_close(np.abs(n_g - n_w).max(-1), 0.0, 1e-3) >= 0.99


def test_patchmatch_refine_generator_is_reproducible(room):
    args = [_t(room[k]) for k in ("ref", "src", "K", "Ks", "R_rel", "t_rel", "inv0")]
    cfg = tpm.PatchMatchConfig(n_iters=1)
    a = tpm.patchmatch_refine(*args, room["inv_lo"], room["inv_hi"],
                              torch.Generator().manual_seed(3), cfg)
    b = tpm.patchmatch_refine(*args, room["inv_lo"], room["inv_hi"],
                              torch.Generator().manual_seed(3), cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    depth, cost, normal = a
    assert depth.shape == cost.shape == room["ref"].shape and normal.shape == depth.shape + (3,)
    assert torch.isfinite(depth).all() and (cost <= 2.0).all()
    np.testing.assert_allclose(torch.linalg.vector_norm(normal, dim=-1).numpy(), 1.0, atol=1e-5)
