"""The port's global engine (tpusfm_torch.sfm.global_sfm) against the JAX
reference on the CPU: rotation and translation averaging on the inputs of
tests/test_global_sfm.py, the deterministic segment sums and the CG
stopping rule, relative_poses and the engine on the reference test's
12-view scene, and run_sparse(engine_type="global") on the 6-view
rendered scene of test_torch_pipeline.py."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import orbit_scene
from test_incremental import scene_to_feature_tracks
from tpusfm.core import lie as jlie
from tpusfm.pipeline import config as jconfig
from tpusfm.pipeline import sparse as jsparse
from tpusfm.sfm import global_sfm as jg
from tpusfm_torch import convert
from tpusfm_torch.pipeline import config as tconfig
from tpusfm_torch.pipeline import sparse as tsparse
from tpusfm_torch.sfm import global_sfm as tg
from tpusfm_torch.utils import metrics
from tpusfm_torch.utils import synth_render as trender

torch.set_num_threads(2)

# The 6-view scene's config (test_torch_pipeline.py's OVERRIDES).
OVERRIDES = {"sift.n_octaves": 3, "sift.max_per_octave": 512, "sift.max_features": 768,
             "matching.pair_chunk": 16, "filter.max_iterations": 128, "feature_batch": 3}


def _rotation_inputs():
    """tests/test_global_sfm.py:14-38's graph: 15 views, chain plus every
    (i, j) with i + j even, relative rotations with 0.01 rad noise."""
    rng = np.random.default_rng(0)
    V = 15
    aa = rng.normal(scale=0.6, size=(V, 3)).astype(np.float32)
    R_gt = np.asarray(jlie.so3_exp(jnp.asarray(aa)))
    R_gt = np.einsum("vij,kj->vik", R_gt, R_gt[0])
    edges = [(i, j) for i in range(V) for j in range(i + 1, V) if (i + j) % 2 == 0 or j == i + 1]
    R_rel = np.einsum("eij,ekj->eik", R_gt[[e[1] for e in edges]], R_gt[[e[0] for e in edges]])
    noise = rng.normal(scale=0.01, size=(len(edges), 3)).astype(np.float32)
    R_rel = np.einsum("eij,ejk->eik", np.asarray(jlie.so3_exp(jnp.asarray(noise))), R_rel)
    R_init = np.tile(np.eye(3, dtype=np.float32), (V, 1, 1))
    for v in range(1, V):
        R_init[v] = R_rel[edges.index((v - 1, v))] @ R_init[v - 1]
    ei = np.asarray([e[0] for e in edges], np.int32)
    ej = np.asarray([e[1] for e in edges], np.int32)
    return V, ei, ej, R_rel.astype(np.float32), R_init, R_gt


def _angle_deg(Ra, Rb):
    c = (np.einsum("vij,vij->v", Ra.astype(np.float64), Rb.astype(np.float64)) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def test_rotation_averaging_matches_reference():
    """Outputs within 1e-3 degrees of the reference's; both within the
    reference test's 1.5 degrees of the truth."""
    V, ei, ej, R_rel, R_init, R_gt = _rotation_inputs()
    w = np.ones(len(ei), np.float32)
    want = np.asarray(jg.rotation_averaging(jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(R_rel),
                                            jnp.asarray(w), jnp.asarray(R_init), V, 40))
    got = tg.rotation_averaging(torch.as_tensor(ei), torch.as_tensor(ej),
                                torch.as_tensor(R_rel), torch.as_tensor(w),
                                torch.as_tensor(R_init), V, 40).numpy()
    assert _angle_deg(got, want).max() < 1e-3
    assert metrics.rotation_error_deg(got, R_gt).max() < 1.5
    np.testing.assert_allclose(got[0], np.eye(3), atol=1e-5)


def _translation_inputs(flip: int):
    """tests/test_global_sfm.py:41-57's complete graph on 12 views, with
    the first `flip` directions reversed (a wrong-sign decomposition)."""
    rng = np.random.default_rng(1)
    V = 12
    C_gt = rng.normal(size=(V, 3)).astype(np.float32) * 3
    C_gt[0] = 0
    edges = [(i, j) for i in range(V) for j in range(i + 1, V)]
    d = C_gt[[e[1] for e in edges]] - C_gt[[e[0] for e in edges]]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[2: 2 + flip] *= -1
    ei = np.asarray([e[0] for e in edges], np.int32)
    ej = np.asarray([e[1] for e in edges], np.int32)
    return V, ei, ej, d, C_gt


@pytest.mark.parametrize("flip", [0, 3])
def test_translation_averaging_matches_reference(flip):
    """Centers within 1e-4 of the largest center's norm of the reference's,
    with and without flipped edges for the cheirality round; without
    flips, the reference test's bar against the truth."""
    V, ei, ej, d, C_gt = _translation_inputs(flip)
    w = np.ones(len(ei), np.float32)
    anchor = 1
    want = np.asarray(jg.translation_averaging(jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(d),
                                               jnp.asarray(w), jnp.asarray(anchor), V, 200))
    got = tg.translation_averaging(torch.as_tensor(ei), torch.as_tensor(ej), torch.as_tensor(d),
                                   torch.as_tensor(w), anchor, V, 200).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    if not flip:
        s = np.linalg.norm(C_gt[anchor]) / max(np.linalg.norm(got[anchor]), 1e-9)
        np.testing.assert_allclose(got * s, C_gt, atol=0.05)


@pytest.mark.parametrize("n,E,width", [(7, 40, 3), (200, 1200, 1), (5, 0, 2)])
def test_segments_sum_like_index_add_and_repeat(n, E, width):
    """Segment sums equal numpy's add.at within float32 rounding, give the
    same bits on a repeat, and leave empty segments zero."""
    rng = np.random.default_rng(n + E)
    ids = rng.integers(0, max(n - 2, 1), E)
    u = rng.normal(size=(E, width)).astype(np.float32)
    want = np.zeros((n, width), np.float64)
    np.add.at(want, ids, u.astype(np.float64))
    seg = tg.Segments(torch.as_tensor(ids), n)
    got = seg(torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, seg(torch.as_tensor(u)))
    assert not got[n - 2:].any()


@pytest.mark.parametrize("iters", [3, 64, 65, 500])
def test_cg_keeps_the_while_loop_result(iters):
    """_cg's masked freeze with host checks every _CG_CHECK iterations
    gives the bits of a loop that tests the rule before every iteration."""
    rng = np.random.default_rng(iters)
    A = rng.normal(size=(30, 30)).astype(np.float32)
    A = torch.as_tensor(A @ A.T + 30 * np.eye(30, dtype=np.float32))
    b = torch.as_tensor(rng.normal(size=30).astype(np.float32))
    x0 = torch.zeros(30)
    tol = 1e-10

    def mv(v):
        return A @ v

    x, r = x0, b - mv(x0)
    p, rs, it = r, torch.sum(r * r), 0
    while it < iters and bool(rs > tol):
        Ap = mv(p)
        alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r)
        p = r + (rs_new / torch.clamp(rs, min=1e-20)) * p
        rs, it = rs_new, it + 1
    assert torch.equal(tg._cg(mv, b, x0, tol, iters), x)


@pytest.fixture(scope="module")
def scene12():
    s = orbit_scene(n_cams=12, n_points=300, noise_px=0.4, seed=9, arc_deg=140.0)
    kp, track_ids = scene_to_feature_tracks(s)
    intr = np.tile(s["intr"], (len(s["R"]), 1))
    return s, kp, track_ids, int(track_ids.max()) + 1, intr


def test_relative_poses_edge_set_matches_reference(scene12):
    """The kept edges are the reference's, each relative rotation within 1
    degree of the reference's and of the truth."""
    s, kp, track_ids, n_tracks, intr = scene12
    ref = jg.GlobalEngine(kp, intr, track_ids, n_tracks)
    want, _ = ref.relative_poses(jax.random.PRNGKey(0))
    eng = tg.GlobalEngine(kp, intr, track_ids, n_tracks, device="cpu")
    got = eng.relative_poses(torch.Generator().manual_seed(0))
    assert [(e[0], e[1]) for e in got] == [(e[0], e[1]) for e in want]
    assert len(got) >= 11
    R_gt = np.asarray(s["R"], np.float64)
    for g, w in zip(got, want):
        assert _angle_deg(g[2][None], np.asarray(w[2])[None])[0] < 1.0
        truth = R_gt[g[1]] @ R_gt[g[0]].T
        assert _angle_deg(g[2][None], truth[None])[0] < 1.0


def test_global_engine_12_views(scene12):
    """The reference test's bars (tests/test_global_sfm.py:60-72): 12/12,
    ATE < 0.02, > 150 points; every BA of the tail is a final one."""
    s, kp, track_ids, n_tracks, intr = scene12
    eng = tg.GlobalEngine(kp, intr, track_ids, n_tracks, device="cpu")
    scene = eng.run(torch.Generator().manual_seed(0))
    reg = scene.cam_mask.numpy()
    assert reg.sum() == 12
    ate = metrics.ate_rmse(scene.camera_centers().numpy()[reg], s["centers"][reg])
    assert ate < 0.02, f"global SfM ATE {ate:.4f}"
    assert int(scene.point_mask.sum()) > 150
    assert [k for k, *_ in eng.ba_solves] == ["final"] * 4
    for phase in ("relative_poses", "view_graph", "rotation_averaging", "translation_averaging",
                  "triangulate", "wash", "final_ba"):
        assert eng.timings[phase] >= 0.0
    assert eng.log is eng._inc.log


def test_global_config_converts():
    assert convert.global_config_from_jax(jg.GlobalConfig()) == tg.GlobalConfig()
    off = dataclasses.replace(jg.GlobalConfig(), rot_iters=12, pair_chunk=8)
    assert convert.global_config_from_jax(off) == tg.GlobalConfig(rot_iters=12, pair_chunk=8)


@pytest.fixture(scope="module")
def scene6():
    return trender.render_orbit_images(n_views=6, img_h=240, img_w=320, focal=0.9 * 320,
                                       arc_deg=60.0, seed=1)


def test_run_sparse_global_matches_reference(scene6):
    """run_sparse(engine_type="global") on the 6-view scene: the
    reference's registered views, points within 20%, the engine log's
    shape (both empty: the global tail logs nothing), the report's keys."""
    images, gt = scene6
    ov = dict(OVERRIDES, engine_type="global")
    jscene, jrep = jsparse.run_sparse(images, gt["intr"], jconfig.config_from_overrides(**ov),
                                      key=jax.random.PRNGKey(0))
    scene, rep = tsparse.run_sparse(images, gt["intr"], tconfig.config_from_overrides(**ov),
                                    device="cpu")
    assert rep["n_registered"] == jrep["n_registered"] >= 5
    assert abs(rep["n_points"] - jrep["n_points"]) <= 0.2 * jrep["n_points"]
    assert [line.split(":")[0] for line in rep["engine_log"]] == \
        [line.split(":")[0] for line in jrep["engine_log"]]
    assert set(jrep) <= set(rep)
    assert {"relative_poses", "rotation_averaging", "final_ba"} <= set(rep["recon_phase_s"])
    assert set(rep["ba_solves"]) == {"final 6x1024x8192"}
    reg = scene.cam_mask.numpy()
    ate = metrics.ate_rmse(scene.camera_centers().numpy()[reg], gt["centers"][reg])
    jreg = np.asarray(jscene.cam_mask)
    jate = metrics.ate_rmse(np.asarray(jscene.camera_centers())[jreg], gt["centers"][jreg])
    assert ate <= max(1.5 * jate, jate + 0.02), (ate, jate)


def test_cli_reconstructs_with_the_stellar_engine(scene6, tmp_path):
    """`cli reconstruct --engine stellar` runs the staged pipeline with the
    stellar engine (self-calibrating, the CLI's default) on the CPU."""
    from PIL import Image

    from tpusfm_torch import cli

    images, gt = scene6
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, img in enumerate(images):
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(frames / f"v{i}.png")
    ws = tmp_path / "ws"
    cli.main(["reconstruct", str(frames), "--workspace", str(ws), "--focal",
              str(float(gt["intr"][0])), "--max-features", "768", "--engine", "stellar",
              "--device", "cpu"])
    cfg = json.loads((ws / "config.json").read_text())
    report = json.loads((ws / "report.json").read_text())
    assert cfg["engine_type"] == "stellar"
    assert report["n_registered"] >= 5 and report["n_points"] > 50
    assert {"stellar_pods", "edge_scale"} <= set(report["recon_phase_s"])
