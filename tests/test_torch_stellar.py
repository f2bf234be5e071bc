"""The port's stellar engine (tpusfm_torch.sfm.stellar) against the JAX
reference on the CPU: the edge-scale and scaled-translation solves on the
inputs of tests/test_stellar.py, the engine on the reference test's
12-view scene, the no-link fallback, and run_sparse(engine_type=
"stellar") self-calibrating on the 6-view rendered scene."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import orbit_scene
from test_incremental import scene_to_feature_tracks
from tpusfm.pipeline import config as jconfig
from tpusfm.pipeline import sparse as jsparse
from tpusfm.sfm import stellar as js
from tpusfm_torch.pipeline import config as tconfig
from tpusfm_torch.pipeline import sparse as tsparse
from tpusfm_torch.sfm import stellar as ts
from tpusfm_torch.utils import metrics
from tpusfm_torch.utils import synth_render as trender

torch.set_num_threads(2)

OVERRIDES = {"sift.n_octaves": 3, "sift.max_per_octave": 512, "sift.max_features": 768,
             "matching.pair_chunk": 16, "filter.max_iterations": 128, "feature_batch": 3}


def _links():
    """tests/test_stellar.py:15-31's random link graph over 30 edges."""
    rng = np.random.default_rng(0)
    E = 30
    s_true = rng.uniform(-1, 1, E)
    s_true -= s_true.mean()
    links = [(a, b) for a in range(E) for b in range(a + 1, E) if rng.random() < 0.3]
    la = np.asarray([l[0] for l in links], np.int32)
    lb = np.asarray([l[1] for l in links], np.int32)
    rhs = (s_true[la] - s_true[lb] + rng.normal(size=len(links)) * 0.01).astype(np.float32)
    w = rng.uniform(1, 50, len(links)).astype(np.float32)
    return E, la, lb, rhs, w, s_true


def _both_edge_scales(la, lb, rhs, w, E, iters):
    want = np.asarray(js.edge_scale_solve(jnp.asarray(la), jnp.asarray(lb), jnp.asarray(rhs),
                                          jnp.asarray(w), n_edges=E, cg_iters=iters))
    got = ts.edge_scale_solve(torch.as_tensor(la), torch.as_tensor(lb), torch.as_tensor(rhs),
                              torch.as_tensor(w), n_edges=E, cg_iters=iters).numpy()
    return got, want


def test_edge_scale_solve_matches_reference():
    """Log-scales within 1e-4 of the largest one of the reference's, and
    the reference test's 0.05 of the truth."""
    E, la, lb, rhs, w, s_true = _links()
    got, want = _both_edge_scales(la, lb, rhs, w, E, 200)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.abs(got - s_true).max() < 0.05


def test_edge_scale_solve_pins_unlinked_edges_to_zero():
    """Edges outside every link come back exactly 0 in both packages."""
    la, lb = np.array([0, 1], np.int32), np.array([1, 2], np.int32)
    rhs, w = np.array([0.5, -0.2], np.float32), np.ones(2, np.float32)
    got, want = _both_edge_scales(la, lb, rhs, w, 6, 50)
    assert np.isfinite(got).all()
    assert (got[3:] == 0).all() and (want[3:] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("weights", ["ones", "random"])
def test_scaled_translation_solve_matches_reference(weights):
    """tests/test_stellar.py:44-58's graph: centers within 1e-4 of the
    largest center's norm of the reference's, the reference test's 0.05 of
    the truth, C_0 exactly 0."""
    rng = np.random.default_rng(1)
    V = 10
    C_gt = rng.normal(size=(V, 3)).astype(np.float32) * 3
    C_gt[0] = 0
    edges = [(i, j) for i in range(V) for j in range(i + 1, V) if rng.random() < 0.6]
    ei = np.asarray([e[0] for e in edges], np.int32)
    ej = np.asarray([e[1] for e in edges], np.int32)
    tvec = C_gt[ej] - C_gt[ei] + rng.normal(size=(len(edges), 3)).astype(np.float32) * 0.01
    w = (np.ones(len(edges)) if weights == "ones" else rng.uniform(0.2, 1, len(edges)))
    w = w.astype(np.float32)
    want = np.asarray(js.scaled_translation_solve(jnp.asarray(ei), jnp.asarray(ej),
                                                  jnp.asarray(tvec), jnp.asarray(w),
                                                  n_views=V, cg_iters=300))
    got = ts.scaled_translation_solve(torch.as_tensor(ei), torch.as_tensor(ej),
                                      torch.as_tensor(tvec), torch.as_tensor(w), n_views=V,
                                      cg_iters=300).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.abs(got - C_gt).max() < 0.05
    assert (got[0] == 0).all()


def test_stellar_engine_12_views():
    """The reference test's bars (tests/test_stellar.py:61-73): 12/12,
    ATE < 0.02, > 150 points; the pod and edge-scale phases ran."""
    s = orbit_scene(n_cams=12, n_points=300, noise_px=0.4, seed=9, arc_deg=140.0)
    kp, track_ids = scene_to_feature_tracks(s)
    intr = np.tile(s["intr"], (len(s["R"]), 1))
    eng = ts.StellarEngine(kp, intr, track_ids, int(track_ids.max()) + 1, device="cpu")
    scene = eng.run(torch.Generator().manual_seed(0))
    reg = scene.cam_mask.numpy()
    assert reg.sum() == 12
    ate = metrics.ate_rmse(scene.camera_centers().numpy()[reg], s["centers"][reg])
    assert ate < 0.02, f"stellar SfM ATE {ate:.4f}"
    assert int(scene.point_mask.sum()) > 150
    assert {"stellar_pods", "edge_scale", "rotation_averaging"} <= set(eng.timings)
    assert eng.log == []


def test_pod_links_star_and_cap():
    """pod_links: all pairs among the strongest MAX_POD_DEGREE edges of a
    pod plus a star link from each further edge to the strongest, links
    only where 5 tracks are shared, rhs the median log depth ratio."""
    tr = np.arange(10)
    z = np.linspace(1.0, 2.0, 10)
    # View 0's pod: edges 0..3 to views 1..4, weights 40, 30, 20, 10; edge 3
    # shares only 4 tracks with the others.
    n = [10, 10, 10, 4]
    E = [(0, k + 1, None, None, 40 - 10 * k, (tr[:n[k]], z[:n[k]] * (k + 1), z[:n[k]]))
         for k in range(4)]
    la, lb, rhs, w = ts.pod_links(E, 5, max_degree=2)
    # Cap 2: (0, 1) among the top two, stars (0, 2); (0, 3) shares 4 tracks.
    assert list(zip(la, lb)) == [(0, 1), (0, 2)]
    np.testing.assert_allclose(rhs, [np.log(2), np.log(3)], rtol=1e-12)
    assert w == [10.0, 10.0]


def _two_view_tracks():
    """A 6-view orbit whose tracks keep only their first two observations:
    no two edges of a pod share a track, so there is no scale link."""
    s = orbit_scene(n_cams=6, n_points=1200, noise_px=0.3, seed=4, arc_deg=60.0)
    kp, track_ids = scene_to_feature_tracks(s)
    count = np.zeros(track_ids.max() + 1, np.int64)
    for v in range(track_ids.shape[0]):
        for f in np.nonzero(track_ids[v] >= 0)[0]:
            count[track_ids[v, f]] += 1
            if count[track_ids[v, f]] > 2:
                track_ids[v, f] = -1
    return kp, track_ids, np.tile(s["intr"], (6, 1))


def test_no_link_fallback_logs_and_reference_drops_the_line():
    """Without pod links both packages fall back to the global path and
    reach the same registered views and points.  The port's log keeps the
    fallback line; the reference's rebinds its log to the inner engine's at
    the end of the global tail and loses it (tpusfm/sfm/stellar.py:199,
    global_sfm.py:379), which this test pins."""
    kp, track_ids, intr = _two_view_tracks()
    n_tracks = int(track_ids.max()) + 1
    eng = ts.StellarEngine(kp, intr, track_ids, n_tracks, device="cpu")
    scene = eng.run(torch.Generator().manual_seed(0))
    ref = js.StellarEngine(kp, intr, track_ids, n_tracks)
    jscene = ref.run(jax.random.PRNGKey(0))
    line = "stellar: no pod scale links; falling back to global"
    assert eng.log == [line]
    assert ref.log == []
    assert int(scene.cam_mask.sum()) == int(np.asarray(jscene.cam_mask).sum()) >= 3
    jpts = int(np.asarray(jscene.point_mask).sum())
    assert abs(int(scene.point_mask.sum()) - jpts) <= 0.2 * jpts


@pytest.fixture(scope="module")
def scene6():
    return trender.render_orbit_images(n_views=6, img_h=240, img_w=320, focal=0.9 * 320,
                                       arc_deg=60.0, seed=1)


def test_run_sparse_stellar_self_calibrating_matches_reference(scene6):
    """run_sparse(engine_type="stellar") self-calibrating one group from the
    true focal on the 6-view scene: the reference's registered views,
    points within 20%, the engine log's shape, the report's keys; the
    refined focal within 1% of the reference's."""
    images, gt = scene6
    ov = dict(OVERRIDES, engine_type="stellar")
    group = np.zeros(6, np.int32)
    jscene, jrep = jsparse.run_sparse(images, gt["intr"], jconfig.config_from_overrides(**ov),
                                      key=jax.random.PRNGKey(0), cam_group=group)
    scene, rep = tsparse.run_sparse(images, gt["intr"], tconfig.config_from_overrides(**ov),
                                    device="cpu", cam_group=group)
    assert rep["n_registered"] == jrep["n_registered"] >= 5
    assert abs(rep["n_points"] - jrep["n_points"]) <= 0.2 * jrep["n_points"]
    assert [line.split(":")[0] for line in rep["engine_log"]] == \
        [line.split(":")[0] for line in jrep["engine_log"]]
    assert set(jrep) <= set(rep)
    assert {"stellar_pods", "edge_scale", "final_ba"} <= set(rep["recon_phase_s"])
    reg = scene.cam_mask.numpy()
    jreg = np.asarray(jscene.cam_mask)
    f, jf = scene.intr.numpy()[reg][0, 0], np.asarray(jscene.intr)[jreg][0, 0]
    assert abs(f / jf - 1) < 0.01, (f, jf)
