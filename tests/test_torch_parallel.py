"""The port's parallel/ layer (torch.distributed) against the reference's
on its 8-device virtual mesh, on the reference tests' inputs.

The port's side runs in one spawned gloo world of 2 CPU ranks (one torch
thread each) that imports no JAX: `_world` runs every sharded call there
and returns what each rank got.  The reference's side runs here, in the
pytest process.  Bars:

- matching (tests/test_parallel.py inputs): `ok` equal, `idx` equal where ok;
- BA (tests/test_parallel.py's problem): sharded against the reference's
  sharded solve and the port's single-device solve, final cost within 5%
  relative, rotations and translations within 5e-3 (the reference tests'
  bars), on the dense-Schur path, the plain PCG path and the kernel path
  (twins of K2-K5 here; `dense_schur_max_dim=0` for the last two);
- self-calibrating shared-group BA (tests/test_ba_distortion.py:136):
  k1 within 2e-3, t within 5e-3;
- ring matching (tests/test_ring_match.py): every ordered pair equal to the
  port's local matcher;
- dense (tests/test_dist_dense.py): the sharded sweep and PatchMatch equal
  the port's packed single-device paths exactly, and the sharded sweep
  meets the reference test's bars against the reference's sharded sweep.
"""

import sys

import numpy as np
import pytest
import torch

from tpusfm_torch.parallel import mesh as tmesh

WORLD = 2
BA_CFGS = {
    "dense": dict(max_iters=6),
    "xla": dict(max_iters=5, impl="xla", dense_schur_max_dim=0),
    "kernels": dict(max_iters=5, impl="pallas", dense_schur_max_dim=0),
}
SELFCAL_CFGS = {
    "dense": dict(max_iters=10, refine_intrinsics=True),
    "kernels": dict(max_iters=10, refine_intrinsics=True, impl="pallas"),
}


def _ba_run(m, prob, kw, **extra):
    """(sharded, single-device) solves of a numpy BA problem on this rank."""
    from tpusfm_torch.ba import bundle_adjust as tba
    from tpusfm_torch.parallel import dist_ba

    t = {k: torch.as_tensor(v) for k, v in prob.items()}
    extra = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in extra.items()}
    cfg = tba.BAConfig(**kw)
    obs = dist_ba.shard_obs_table(prob["obs_cam"], prob["obs_pt"], prob["obs_uv"],
                                  prob["obs_mask"], m.size, device="cpu")
    rest = {k: v for k, v in t.items() if not k.startswith("obs_")}
    sharded = dist_ba.bundle_adjust_sharded(m, **rest, obs_cam=obs[0], obs_pt=obs[1],
                                            obs_uv=obs[2], obs_mask=obs[3], cfg=cfg, **extra)
    single = tba.bundle_adjust(**t, cfg=cfg, **extra)

    def host(out):
        intr, rot, tt, pts, info = out
        return dict(intr=intr.numpy(), rot=rot.numpy(), t=tt.numpy(), pts=pts.numpy(),
                    cost=float(info["final_cost"]), init=float(info["initial_cost"]),
                    iters=int(info["iterations"]), n_obs=int(info["n_obs"]))

    return host(sharded), host(single)


def _world(rank, inp):
    """Every sharded call of the port on this rank of a 2-rank gloo world."""
    import torch.distributed as dist

    from tpusfm_torch.dense import depth as tdepth
    from tpusfm_torch.dense.patchmatch import PatchMatchConfig
    from tpusfm_torch.matching import match as tmatch
    from tpusfm_torch.parallel import dist_dense, dist_matching, ring_match
    from tpusfm_torch.pipeline import config as tconfig
    from tpusfm_torch.pipeline.sparse import get_mesh

    out = {"jax_imported": "jax" in sys.modules}
    m = tmesh.make_mesh(device="cpu")
    out["mesh"] = (m.shape, m.rank, m.backend, str(m.device), tmesh.mesh_for("shard") is m)
    out["initialize_again"] = tmesh.initialize_distributed("file:///unused", WORLD, rank,
                                                           device="cpu")
    out["get_mesh"] = get_mesh(tconfig.config_from_overrides(devices=WORLD), "cpu").shape
    try:
        get_mesh(tconfig.config_from_overrides(devices=3), "cpu")
    except ValueError as e:
        out["get_mesh_3"] = str(e)
    try:
        tmesh.check_same(m, "test", value=rank)
    except RuntimeError as e:
        out["check_same"] = str(e)
    out["psum"] = tmesh.psum(torch.full((3,), float(rank + 1)), "shard").tolist()
    out["ring_shift"] = tmesh.ring_shift(m, [torch.tensor([rank])])[0].item()

    mt = inp["match"]
    t = {k: torch.as_tensor(v) for k, v in mt.items()}
    idx, ok = dist_matching.match_pairs_sharded(m, t["da"], t["db"], t["ma"], t["ma"])
    out["match"] = (idx.numpy(), ok.numpy())

    out["ba"] = {name: _ba_run(m, inp["ba"], kw) for name, kw in BA_CFGS.items()}
    out["selfcal"] = {name: _ba_run(m, inp["selfcal"], kw, cam_group=np.zeros(8, np.int64),
                                    n_groups=1)
                      for name, kw in SELFCAL_CFGS.items()}

    rg = inp["ring"]
    desc, mask = torch.as_tensor(rg["desc"]), torch.as_tensor(rg["mask"])
    idx_r, ok_r = ring_match.ring_match_all_pairs(m, desc, mask)
    out["ring_local_shape"] = tuple(idx_r.shape)
    idx_f, ok_f = tmesh.all_gather(m, idx_r), tmesh.all_gather(m, ok_r)
    V = desc.shape[0]
    ia, ib = np.repeat(np.arange(V), V), np.tile(np.arange(V), V)
    i_loc, ok_loc = tmatch.match_descriptors(desc[ia], desc[ib], mask[ia], mask[ib],
                                             cross_check=False)
    out["ring"] = (idx_f.numpy(), ok_f.numpy(), i_loc.reshape(V, V, -1).numpy(),
                   ok_loc.reshape(V, V, -1).numpy())

    dn = inp["dense"]
    cfg = tdepth.DenseConfig(n_planes=24, n_sources=3)
    norm = tdepth.local_normalize(torch.as_tensor(dn["images"]), cfg.window)
    Ks = torch.as_tensor(dn["Ks"])
    packed = [torch.as_tensor(dn[k]) for k in ("sidx", "Rr", "tr", "invd")]
    d_s, c_s = dist_dense.plane_sweep_sharded(m, norm, Ks, *packed, cfg)
    d_l, c_l = dist_dense.plane_sweep_all_views(norm, Ks, *packed, cfg)
    out["sweep"] = (d_s.numpy(), c_s.numpy(), d_l.numpy(), c_l.numpy())
    B = 4  # PatchMatch over the first 4 packed views, one draw stream per view
    imgs = torch.as_tensor(dn["images"])
    inv0 = 1.0 / torch.clamp(d_l[:B], min=1e-9)
    lo, hi = torch.as_tensor(dn["lo"][:B]), torch.as_tensor(dn["hi"][:B])
    pm_cfg = PatchMatchConfig(n_iters=1)

    def gens():
        return [torch.Generator().manual_seed(100 + v) for v in range(B)]

    pm_args = (imgs, Ks, *(x[:B] for x in packed[:3]), inv0, lo, hi)
    pm_s = dist_dense.patchmatch_sharded(m, *pm_args, gens(), pm_cfg)
    pm_l = dist_dense.patchmatch_all_views(*pm_args, gens(), pm_cfg)
    out["pm"] = ([x.numpy() for x in pm_s], [x.numpy() for x in pm_l])
    out["world"] = dist.get_world_size()
    return out


@pytest.fixture(scope="module")
def ref_inputs():
    """The reference tests' inputs, as numpy."""
    from test_ba_distortion import K1_TRUE, _problem
    from test_parallel import _ba_problem

    from tpusfm.utils.synth_render import render_orbit_images

    rng = np.random.default_rng(11)  # test_parallel.py's matching inputs
    P_, N, D = 16, 64, 128
    da = rng.normal(size=(P_, N, D)).astype(np.float32) * 20
    db = rng.normal(size=(P_, N, D)).astype(np.float32) * 20
    db[:, : N // 2] = da[:, : N // 2] + rng.normal(size=(P_, N // 2, D)).astype(np.float32) * 0.1
    match = dict(da=da, db=db, ma=np.ones((P_, N), bool))

    s, args = _ba_problem()
    O = len(s["obs_cam"])
    ba = {k: np.asarray(v) for k, v in args.items()}
    ba.update(obs_cam=np.asarray(s["obs_cam"], np.int64), obs_pt=np.asarray(s["obs_pt"], np.int64),
              obs_uv=np.asarray(s["obs_uv"], np.float32), obs_mask=np.ones(O, bool))

    _s, sargs = _problem(k1=K1_TRUE, n_cams=8, n_points=200, seed=6)
    selfcal = {k: np.asarray(v) for k, v in sargs.items()}
    selfcal["obs_mask"] = np.ones(len(selfcal["obs_cam"]), bool)

    rng = np.random.default_rng(7)  # test_ring_match.py's inputs
    V, N, D = 16, 64, 128
    base = rng.normal(size=(V, N, D)).astype(np.float32) * 20
    base[:, : N // 2] = base[0, : N // 2] + rng.normal(size=(V, N // 2, D)).astype(np.float32) * 0.2
    rmask = np.ones((V, N), bool)
    rmask[3, 50:] = False

    images, gt = render_orbit_images(n_views=8, img_h=120, img_w=160, focal=0.8 * 160,
                                     arc_deg=70.0, seed=3)
    return dict(match=match, ba=ba, selfcal=selfcal, ring=dict(desc=base, mask=rmask),
                dense=dict(images=images, gt=gt))


@pytest.fixture(scope="module")
def dense_inputs(ref_inputs):
    """tests/test_dist_dense.py's scene, packed by the port and by the
    reference."""
    from test_dense import gt_scene

    from tpusfm.sfm import scene as jscene
    from tpusfm_torch import convert
    from tpusfm_torch.dense import depth as tdepth
    from tpusfm_torch.parallel import dist_dense

    images, gt = ref_inputs["dense"]["images"], ref_inputs["dense"]["gt"]
    V, H, W = images.shape
    jsc = gt_scene(gt, V, (H, W))
    tsc = convert.scene_from_numpy(jscene.scene_to_numpy(jsc), device="cpu")
    cfg = tdepth.DenseConfig(n_planes=24, n_sources=3)
    sidx, Rr, tr, invd, lo, hi = dist_dense.pack_sweep_inputs(tsc, list(range(V)), cfg, 24)
    K = np.array([[gt["intr"][0], 0, W / 2], [0, gt["intr"][1], H / 2], [0, 0, 1]], np.float32)
    Ks = np.broadcast_to(K, (V, 3, 3)).copy()
    return dict(images=images, Ks=Ks, sidx=sidx, Rr=Rr, tr=tr, invd=invd, lo=lo, hi=hi, jsc=jsc)


@pytest.fixture(scope="module")
def port(ref_inputs, dense_inputs, tmp_path_factory):
    inp = {k: v for k, v in ref_inputs.items() if k != "dense"}
    inp["dense"] = {k: v for k, v in dense_inputs.items() if k != "jsc"}
    init = f"file://{tmp_path_factory.mktemp('pg') / 'init'}"
    return tmesh.run_ranks(_world, WORLD, backend="gloo", init_method=init, args=(inp,),
                           threads=1)


def test_world_imports_no_jax_and_meshes(port):
    for rank, r in enumerate(port):
        assert not r["jax_imported"]
        assert r["world"] == WORLD
        assert r["mesh"] == ({"shard": WORLD}, rank, "gloo", "cpu", True)
        assert r["initialize_again"] is False  # a group exists: nothing to do
        assert r["get_mesh"] == {"shard": WORLD}
        assert "3 of 2" in r["get_mesh_3"]
        assert "disagree" in r["check_same"] and "'value': (0, 1)" in r["check_same"]
        assert r["psum"] == [3.0, 3.0, 3.0]
        assert r["ring_shift"] == (rank - 1) % WORLD


def test_get_mesh_outside_a_group_raises():
    import torch.distributed as dist

    from tpusfm_torch.pipeline import config as tconfig
    from tpusfm_torch.pipeline.sparse import get_mesh

    assert not dist.is_initialized()
    assert get_mesh(tconfig.config_from_overrides()) is None
    assert get_mesh(tconfig.config_from_overrides(devices=1)) is None
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node N"):
        get_mesh(tconfig.config_from_overrides(devices=2))
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tmesh.make_mesh()
    assert tmesh.initialize_distributed(None, 1, 0) is False  # one process: nothing to do


def test_make_mesh_without_a_device_takes_the_card(tmp_path):
    """With no device= a mesh is made on the rank's card: where no CUDA
    device is present that raises (as resolve_device does), and the CPU
    serves only when asked for."""
    import torch
    import torch.distributed as dist

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init", world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.make_mesh()
        assert tmesh.make_mesh(device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()
        tmesh._MESHES.clear()


def test_pad_to_multiple_matches_reference():
    from tpusfm.parallel import mesh as jmesh

    a = np.arange(10, dtype=np.float32).reshape(5, 2)
    for mult, axis in ((4, 0), (3, 1), (5, 0)):
        got, want = tmesh.pad_to_multiple(a, mult, axis, fill=-1), \
            jmesh.pad_to_multiple(a, mult, axis, fill=-1)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_sharded_matching_matches_reference(port, ref_inputs):
    import jax.numpy as jnp

    from tpusfm.parallel import dist_matching, mesh as jmesh

    mt = ref_inputs["match"]
    idx_j, ok_j = dist_matching.match_pairs_sharded(
        jmesh.make_mesh(8), jnp.asarray(mt["da"]), jnp.asarray(mt["db"]), jnp.asarray(mt["ma"]),
        jnp.asarray(mt["ma"]))
    idx_j, ok_j = np.asarray(idx_j), np.asarray(ok_j)
    for r in port:
        idx, ok = r["match"]
        np.testing.assert_array_equal(ok, ok_j)
        np.testing.assert_array_equal(idx[ok], idx_j[ok_j])
        assert ok[:, :32].mean() > 0.9


def _close(got, want, cost_rtol=0.05, atol=5e-3):
    rel = abs(got["cost"] - want["cost"]) / max(want["cost"], 1e-9)
    assert rel < cost_rtol, (got["cost"], want["cost"])
    np.testing.assert_allclose(got["rot"], want["rot"], atol=atol)
    np.testing.assert_allclose(got["t"], want["t"], atol=atol)


def _reference_ba(prob, **kw):
    import jax.numpy as jnp

    from tpusfm.ba import bundle_adjust as jba
    from tpusfm.parallel import dist_ba, mesh as jmesh

    cfg_kw = dict(kw)
    extra = {k: cfg_kw.pop(k) for k in ("cam_group", "n_groups") if k in cfg_kw}
    if "cam_group" in extra:
        extra["cam_group"] = jnp.asarray(extra["cam_group"], jnp.int32)
    ocam, opt, ouv, omask = dist_ba.shard_obs_table(prob["obs_cam"], prob["obs_pt"],
                                                    prob["obs_uv"], prob["obs_mask"], 8)
    rest = {k: jnp.asarray(v) for k, v in prob.items() if not k.startswith("obs_")}
    _, rot, t, _, info = dist_ba.bundle_adjust_sharded(
        jmesh.make_mesh(8), obs_cam=ocam, obs_pt=opt, obs_uv=ouv, obs_mask=omask,
        cfg=jba.BAConfig(**cfg_kw), **rest, **extra)
    return dict(rot=np.asarray(rot), t=np.asarray(t), cost=float(info["final_cost"]),
                init=float(info["initial_cost"]))


@pytest.mark.parametrize("path", sorted(BA_CFGS))
def test_sharded_ba_matches_reference_and_single_device(port, ref_inputs, path):
    # The reference's kernel path runs in interpret mode; its own test holds
    # it to its XLA path with these bars, so the port's kernel path is held
    # to the reference's sharded XLA solve of the same algorithm.
    ref_kw = dict(BA_CFGS["xla"] if path == "kernels" else BA_CFGS[path])
    want = _reference_ba(ref_inputs["ba"], **ref_kw)
    O = len(ref_inputs["ba"]["obs_cam"])
    for r in port:
        sharded, single = r["ba"][path]
        assert sharded["cost"] < sharded["init"] * 0.01
        assert sharded["n_obs"] == O
        _close(sharded, want)
        _close(sharded, single)
        gaps = (abs(sharded["cost"] - want["cost"]) / want["cost"],
                abs(sharded["cost"] - single["cost"]) / single["cost"])
        print(f"{path}: cost gap to the reference {gaps[0]:.2e}, to one device {gaps[1]:.2e}")
    # Every rank returns the same solution.
    np.testing.assert_array_equal(port[0]["ba"][path][0]["pts"], port[1]["ba"][path][0]["pts"])


@pytest.mark.parametrize("path", sorted(SELFCAL_CFGS))
def test_sharded_shared_intrinsics_matches_reference(port, ref_inputs, path):
    want = _reference_ba(ref_inputs["selfcal"], **SELFCAL_CFGS["dense"],
                         cam_group=np.zeros(8, np.int32), n_groups=1)
    for r in port:
        sharded, single = r["selfcal"][path]
        np.testing.assert_allclose(sharded["intr"][:, 4], single["intr"][:, 4], atol=2e-3)
        np.testing.assert_allclose(sharded["t"], single["t"], atol=5e-3)
        np.testing.assert_allclose(sharded["t"], want["t"], atol=5e-3)
        assert np.ptp(sharded["intr"], axis=0).max() == 0.0  # one shared block


def test_ring_matches_equal_local(port, ref_inputs):
    from tpusfm.parallel import ring_match as jring

    from tpusfm_torch.parallel import ring_match as tring

    V, N = ref_inputs["ring"]["mask"].shape
    for r in port:
        assert r["ring_local_shape"] == (V // WORLD, V, N)
        idx, ok, i_loc, ok_loc = r["ring"]
        np.testing.assert_array_equal(ok, ok_loc)
        np.testing.assert_array_equal(np.where(ok, idx, -1), np.where(ok_loc, i_loc, -1))
    got = tring.pairs_from_ring_table(idx, ok, min_matches=5)
    want = jring.pairs_from_ring_table(idx, ok, min_matches=5)
    assert len(got[0]) > 0 and (got[0][:, 0] < got[0][:, 1]).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sharded_dense_equals_single_device_and_reference(port, dense_inputs):
    import jax
    import jax.numpy as jnp
    from functools import partial

    from tpusfm.dense import depth as jdepth
    from tpusfm.parallel import dist_dense as jdist, mesh as jmesh

    for r in port:
        d_s, c_s, d_l, c_l = r["sweep"]
        np.testing.assert_array_equal(d_s, d_l)
        np.testing.assert_array_equal(c_s, c_l)
        for s, l in zip(*r["pm"]):
            np.testing.assert_array_equal(s, l)
    di = dense_inputs
    cfg = jdepth.DenseConfig(n_planes=24, n_sources=3)
    norm = jnp.asarray(np.asarray(jax.jit(jax.vmap(partial(jdepth.local_normalize,
                                                          w=cfg.window)))(di["images"])))
    sidx, Rr, tr, invd, _lo, _hi = jdist.pack_sweep_inputs(di["jsc"], list(range(8)), cfg, 24)
    np.testing.assert_array_equal(sidx, di["sidx"])
    d_j, c_j = jdist.plane_sweep_sharded(jmesh.make_mesh(8), norm, jnp.asarray(di["Ks"]),
                                         jnp.asarray(sidx), jnp.asarray(Rr), jnp.asarray(tr),
                                         jnp.asarray(invd), cfg)
    d_j, c_j = np.asarray(d_j), np.asarray(c_j)
    d_s, c_s = port[0]["sweep"][:2]
    assert (np.abs(d_s - d_j) / np.maximum(d_j, 1e-6) < 2e-3).mean() > 0.995
    assert np.mean(np.abs(c_s - c_j) <= 1e-4) >= 0.99
