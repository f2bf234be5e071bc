"""The port's mesh stage (tpusfm_torch.dense.meshing, dense.texturing) and
PLY I/O (io.ply) against the JAX reference on the CPU, on the exact depth
maps of tests/test_meshing.py's rendered corner room cut to 64x88."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusfm.dense import meshing as jmesh
from tpusfm.dense import texturing as jtex
from tpusfm.io import ply as jply
from tpusfm_torch.dense import meshing as tmesh
from tpusfm_torch.dense import texturing as ttex
from tpusfm_torch.io import ply as tply
from tpusfm_torch.utils.synth_render import render_orbit_images

torch.set_num_threads(2)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


@pytest.fixture(scope="module")
def room():
    images, gt = render_orbit_images(n_views=6, img_h=64, img_w=88, focal=0.8 * 88,
                                     arc_deg=70.0, seed=4)
    V, H, W = images.shape
    depths = gt["depth"].copy()
    valid = np.isfinite(depths) & (depths < 50)
    depths[~valid] = 0.0
    K = np.array([[gt["intr"][0], 0, W / 2], [0, gt["intr"][1], H / 2], [0, 0, 1]], np.float32)
    rgb = np.repeat((images * 255).astype(np.uint8)[..., None], 3, -1)
    return dict(images=images, depths=depths.astype(np.float32), valid=valid, K=K,
                R=gt["R"].astype(np.float32), t=gt["t"].astype(np.float32), rgb=rgb)


@pytest.fixture(scope="module")
def reference_mesh(room):
    return jmesh.mesh_from_depths(room["depths"], room["valid"], room["K"], room["R"],
                                  room["t"], rgb_images=room["rgb"], cfg=jmesh.MeshConfig(grid=48))


GRID_ARGS = (np.array([-3.0, -3.0, -3.0], np.float32), np.float32(6.0 / 47),
             np.float32(3 * 6.0 / 47), 48)


@pytest.mark.parametrize("shared_k", [True, False])
def test_tsdf_fuse_matches_reference(room, shared_k):
    """Within 1e-5 on >= 99.99% of voxels: a voxel that projects within
    float32 rounding of a pixel boundary may read the neighbouring pixel's
    depth in one package (one voxel of 110,592 here)."""
    K = room["K"] if shared_k else np.tile(room["K"], (6, 1, 1))
    origin, voxel, trunc, grid = GRID_ARGS
    want = jmesh.tsdf_fuse(jnp.asarray(room["depths"]), jnp.asarray(K), jnp.asarray(room["R"]),
                           jnp.asarray(room["t"]), jnp.asarray(origin), voxel, trunc, grid)
    got = tmesh.tsdf_fuse(_t(room["depths"]), _t(K), _t(room["R"]), _t(room["t"]), _t(origin),
                          voxel, trunc, grid)
    for g, w in zip(got, want):
        assert np.mean(np.abs(g.numpy() - np.asarray(w)) <= 1e-5) >= 0.9999
    assert (np.asarray(want[1]) >= 1).mean() > 0.05


def test_marching_tetrahedra_and_case_table_equal_reference(room):
    origin, voxel, trunc, grid = GRID_ARGS
    tsdf, w = (np.asarray(x) for x in jmesh.tsdf_fuse(
        jnp.asarray(room["depths"]), jnp.asarray(room["K"]), jnp.asarray(room["R"]),
        jnp.asarray(room["t"]), jnp.asarray(origin), voxel, trunc, grid))
    assert tmesh._tet_case_table() == jmesh._tet_case_table()
    got = tmesh.marching_tetrahedra(tsdf, w >= 1.0, origin, voxel)
    want = jmesh.marching_tetrahedra(tsdf, w >= 1.0, origin, voxel)
    assert len(want[1]) > 500
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


def test_mesh_from_depths_matches_reference(room, reference_mesh):
    """Same faces; vertices within a hundredth of a voxel (a vertex sits
    where the TSDF crosses zero along an edge, so float32 differences in
    the TSDF move it most where both corners are near zero)."""
    timings = {}
    verts, faces, colors = tmesh.mesh_from_depths(
        room["depths"], room["valid"], room["K"], room["R"], room["t"], rgb_images=room["rgb"],
        cfg=tmesh.MeshConfig(grid=48), device="cpu", timings=timings)
    wv, wf, wc = reference_mesh
    np.testing.assert_array_equal(faces, wf)
    span = wv.max(0) - wv.min(0)
    assert np.abs(verts - wv).max() <= 0.01 * span.max() / 47
    assert np.mean(np.all(colors == wc, axis=1)) >= 0.999
    assert sorted(timings) == ["bounds", "color", "marching_tetrahedra", "tsdf"]


def test_host_refiners_and_colors_equal_reference(room, reference_mesh):
    verts, faces, _ = reference_mesh
    args = (room["depths"], room["valid"], room["K"], room["R"], room["t"])
    np.testing.assert_array_equal(
        tmesh.color_vertices(verts, room["rgb"], room["depths"], np.tile(room["K"], (6, 1, 1)),
                             room["R"], room["t"]),
        jmesh.color_vertices(verts, room["rgb"], room["depths"], np.tile(room["K"], (6, 1, 1)),
                             room["R"], room["t"]))
    noisy = verts + np.random.default_rng(0).normal(scale=0.05, size=verts.shape).astype(np.float32)
    np.testing.assert_array_equal(tmesh.refine_mesh(noisy, faces, *args, iters=3),
                                  jmesh.refine_mesh(noisy, faces, *args, iters=3))


def _photo_inputs(room, verts):
    rng = np.random.default_rng(1)
    N = len(verts)
    vn = rng.normal(size=(N, 3))
    vn /= np.linalg.norm(vn, axis=1, keepdims=True)
    t1 = np.cross(vn, [0.0, 0.0, 1.0])
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(vn, t1)
    vidx = np.stack([rng.permutation(6)[:4] for _ in range(N)]).astype(np.int32)
    vweight = (rng.random((N, 4)) > 0.2).astype(np.float32)
    return [np.asarray(a, np.float32) for a in (verts, vn, t1, t2)] + [vidx, vweight]


@pytest.mark.parametrize("n_steps", [1, 9])
def test_photo_sweep_matches_reference(room, reference_mesh, n_steps):
    X, vn, t1, t2, vidx, vweight = _photo_inputs(room, reference_mesh[0][:400])
    Ks = np.tile(room["K"], (6, 1, 1))
    want = jmesh._photo_sweep(*map(jnp.asarray, (X, vn, t1, t2, vidx, vweight, room["images"],
                                                  Ks, room["R"], room["t"])),
                              jnp.float32(0.1), jnp.float32(0.05), n_steps)
    got = tmesh._photo_sweep(*map(_t, (X, vn, t1, t2)), torch.as_tensor(vidx), _t(vweight),
                             _t(room["images"]), _t(Ks), _t(room["R"]), _t(room["t"]),
                             np.float32(0.1), np.float32(0.05), n_steps)
    s_w, c_w, m_w = (np.asarray(x) for x in want)
    s_g, c_g, m_g = (x.numpy() for x in got)
    np.testing.assert_allclose(c_g, c_w, atol=1e-4)
    np.testing.assert_array_equal(m_g, m_w)
    np.testing.assert_allclose(s_g, s_w, atol=1e-4)
    assert (c_w < 2.0).mean() > 0.3


def test_refine_mesh_photometric_matches_reference(room, reference_mesh):
    """Two iterations of the photometric refiner; a vertex whose line
    search is a near-tie may take the neighbouring step in one package, so
    99% of vertices agree within 1e-4."""
    verts, faces, _ = reference_mesh
    gray = room["rgb"].astype(np.float32).mean(-1) / 255.0
    args = (room["K"], room["R"], room["t"], room["depths"], room["valid"])
    want = jmesh.refine_mesh_photometric(verts, faces, gray, *args, iters=2)
    got = tmesh.refine_mesh_photometric(verts, faces, gray, *args, iters=2, device="cpu")
    assert np.mean(np.abs(got - want).max(1) <= 1e-4) >= 0.99
    assert np.abs(got - verts).max() > 1e-3  # the refiner moved vertices


def test_reconstruct_mesh_equals_reference():
    rng = np.random.default_rng(0)
    p = rng.normal(size=(5000, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    rgb = rng.integers(0, 255, (len(p), 3)).astype(np.uint8)
    got = tmesh.reconstruct_mesh(p, rgb, tmesh.MeshConfig(grid=32))
    want = jmesh.reconstruct_mesh(p, rgb, jmesh.MeshConfig(grid=32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(want[1]) > 300


def test_texturing_equals_reference(room, reference_mesh, tmp_path):
    verts, faces, _ = reference_mesh
    args = (room["depths"], room["valid"], room["K"], room["R"], room["t"])
    fv = ttex.face_view_assignment(verts, faces, *args)
    np.testing.assert_array_equal(fv, jtex.face_view_assignment(verts, faces, *args))
    # texture_mesh runs build_atlas: equal OBJ, MTL and PNG bytes hold the
    # atlas and the texture coordinates to the reference's.
    path_g, ok_g = ttex.texture_mesh(tmp_path / "port", verts, faces, *args, room["rgb"])
    path_w, ok_w = jtex.texture_mesh(tmp_path / "ref", verts, faces, *args, room["rgb"])
    np.testing.assert_array_equal(ok_g, ok_w)
    assert ok_g.mean() > 0.5
    for suffix in (".obj", ".mtl", ".png"):
        assert (path_g.with_suffix(suffix).read_bytes()
                == path_w.with_suffix(suffix).read_bytes())


@pytest.mark.parametrize("binary", [True, False])
def test_ply_round_trip_across_packages(tmp_path, binary):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    pts[5] = np.nan
    cols = rng.integers(0, 255, (200, 3)).astype(np.uint8)
    cams = rng.normal(size=(4, 3)).astype(np.float32)
    n_g = tply.write_ply_points(tmp_path / "g.ply", pts, cols, cams, binary=binary)
    n_w = jply.write_ply_points(tmp_path / "w.ply", pts, cols, cams, binary=binary)
    assert n_g == n_w == 203
    assert (tmp_path / "g.ply").read_bytes() == (tmp_path / "w.ply").read_bytes()
    for reader in (tply.read_ply_points, jply.read_ply_points):
        xyz, rgb = reader(tmp_path / "g.ply")
        want_xyz, want_rgb = jply.read_ply_points(tmp_path / "w.ply")
        np.testing.assert_array_equal(xyz, want_xyz)
        np.testing.assert_array_equal(rgb, want_rgb)
    np.testing.assert_array_equal(xyz[:5], pts[:5])
    faces = rng.integers(0, 200, (50, 3)).astype(np.int32)
    tply.write_ply_mesh(tmp_path / "gm.ply", pts[:200], faces, cols)
    jply.write_ply_mesh(tmp_path / "wm.ply", pts[:200], faces, cols)
    assert (tmp_path / "gm.ply").read_bytes() == (tmp_path / "wm.ply").read_bytes()
    tply.write_pcd_points(tmp_path / "g.pcd", pts, cols)
    jply.write_pcd_points(tmp_path / "w.pcd", pts, cols)
    assert (tmp_path / "g.pcd").read_text() == (tmp_path / "w.pcd").read_text()
