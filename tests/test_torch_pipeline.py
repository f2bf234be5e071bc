"""End to end: the port's run_sparse on the CPU against ground truth and
against the JAX reference on the same rendered 6-view scene (the small_cfg of
tests/test_pipeline_e2e.py), plus config conversion and the host modules
the port carries (tracks, metrics, the renderer)."""

import dataclasses

import numpy as np
import pytest
import torch

from tpusfm.pipeline import config as jconfig
from tpusfm.pipeline import sparse as jsparse
from tpusfm.sfm import tracks as jtracks
from tpusfm.utils import metrics as jmetrics
from tpusfm.utils import synth_render as jrender
from tpusfm_torch import convert
from tpusfm_torch.pipeline import config as tconfig
from tpusfm_torch.pipeline import sparse as tsparse
from tpusfm_torch.sfm import tracks as ttracks
from tpusfm_torch.utils import metrics as tmetrics
from tpusfm_torch.utils import synth_render as trender

torch.set_num_threads(2)

OVERRIDES = {
    "sift.n_octaves": 3,
    "sift.max_per_octave": 512,
    "sift.max_features": 768,
    "matching.pair_chunk": 16,
    "filter.max_iterations": 128,
    "feature_batch": 3,
}


@pytest.fixture(scope="module")
def scene6():
    return trender.render_orbit_images(n_views=6, img_h=240, img_w=320, focal=0.9 * 320,
                                       arc_deg=60.0, seed=1)


@pytest.fixture(scope="module")
def port_run(scene6):
    images, gt = scene6
    cfg = tconfig.config_from_overrides(**OVERRIDES)
    events = []
    scene, report = tsparse.run_sparse(images, gt["intr"], cfg, device="cpu",
                                       progress=lambda t, p, **kw: events.append((t, p)))
    return scene, report, events


def test_run_sparse_end_to_end(scene6, port_run):
    _, gt = scene6
    scene, report, events = port_run
    reg = scene.cam_mask.numpy()
    assert reg.sum() >= 5, f"registered {reg.sum()}/6; log: {report['engine_log']}"
    centers = scene.camera_centers().numpy()[reg]
    ate = tmetrics.ate_rmse(centers, gt["centers"][reg])
    assert ate < 0.08, f"ATE {ate}; log: {report['engine_log']}"
    assert report["n_points"] > 50
    stages = [t for t, _ in events]
    for st in ("preprocessing", "matching", "filtering", "reconstruction", "done"):
        assert st in stages, f"missing progress events for {st}"
    cols = scene.colors.numpy()[scene.point_mask.numpy()]
    assert cols.std() > 1.0


def test_pair_ok_agrees_with_reference(scene6, port_run):
    """The reference's detect/match/filter stages on the same images keep
    the same pairs (random draws differ, so agreement is statistical)."""
    images, gt = scene6
    _, report, _ = port_run
    cfg = jconfig.config_from_overrides(**OVERRIDES)
    feats = jsparse.detect_features(images, cfg)
    pl = jsparse.generate_pairs(6, cfg)
    mi, mv = jsparse.match_pairs(feats, pl, cfg)
    _, _, pair_ok = jsparse.filter_pairs(feats, pl, mi, mv, cfg, intr=np.tile(gt["intr"], (6, 1)),
                                         img_hw=images.shape[1:3])
    agree = np.mean(pair_ok == report["pair_ok"])
    assert agree >= 0.9, (pair_ok, report["pair_ok"])


def test_config_defaults_match_reference():
    ported = convert.config_from_jax(jconfig.PipelineConfig())
    assert ported == tconfig.PipelineConfig()
    small = convert.config_from_jax(jconfig.config_from_overrides(**OVERRIDES))
    assert small == tconfig.config_from_overrides(**OVERRIDES)
    # A reference field the port lacks raises only when it left its default.
    dense_off = dataclasses.replace(jconfig.PipelineConfig(), dense=dataclasses.replace(
        jconfig.PipelineConfig().dense, n_planes=32))
    with pytest.raises(NotImplementedError, match="dense"):
        convert.config_from_jax(dense_off)


@pytest.mark.parametrize("what", ["preemptive", "loop_closure", "devices", "engine_type"])
def test_unported_options_raise(what):
    cfg = {
        "preemptive": tconfig.config_from_overrides(**{"matching.preemptive": True}),
        "loop_closure": tconfig.config_from_overrides(**{"matching.pair_mode": "contiguous",
                                                        "matching.loop_closure": True}),
        "devices": tconfig.config_from_overrides(devices=2),
        "engine_type": tconfig.config_from_overrides(engine_type="global"),
    }[what]
    images = np.zeros((2, 32, 32), np.float32)
    with pytest.raises(NotImplementedError):
        tsparse.run_sparse(images, np.array([30, 30, 16, 16, 0, 0, 0], np.float32), cfg,
                           device="cpu")


def test_host_modules_equal_reference():
    """Tracks, ATE and the renderer are host numpy carried into the port so
    that it stands alone: they must give the reference's results exactly."""
    rng = np.random.default_rng(0)
    pl = np.array([[0, 1], [0, 2], [1, 2], [2, 3]], np.int32)
    mi = rng.integers(0, 40, size=(4, 40)).astype(np.int32)
    mv = rng.random((4, 40)) < 0.6
    for a, b in zip(jtracks.build_tracks(4, 40, pl, mi, mv), ttracks.build_tracks(4, 40, pl, mi, mv)):
        np.testing.assert_array_equal(a, b)
    est = rng.normal(size=(7, 3))
    gt = 2.0 * est @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 1.0 + 0.01 * rng.normal(size=(7, 3))
    assert tmetrics.ate_rmse(est, gt) == jmetrics.ate_rmse(est, gt)
    ji, jgt = jrender.render_orbit_images(n_views=2, img_h=48, img_w=64, seed=3, tex_size=64)
    ti, tgt = trender.render_orbit_images(n_views=2, img_h=48, img_w=64, seed=3, tex_size=64)
    np.testing.assert_array_equal(ji, ti)
    for k in jgt:
        np.testing.assert_array_equal(jgt[k], tgt[k])
