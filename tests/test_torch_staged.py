"""The port's staged pipeline against the JAX reference's on the CPU, at
tests/test_service.py's 6-view 240x320 setup with GPS fixes in views.json
(tests/test_geo_resume.py:43-56): the same workspace files, config and
views, the same registered count, both ATEs under 0.05 and geo rms under
1 m; a re-run seeded from an existing scene.npz (the port's own, and the
reference's) registers the missing views without a new bootstrap."""

import json
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from tpusfm.pipeline import config as jconfig
from tpusfm.pipeline import staged as jstaged
from tpusfm.utils import metrics as jmetrics
from tpusfm_torch.pipeline import config as tconfig
from tpusfm_torch.pipeline import staged as tstaged
from tpusfm_torch.sfm import scene as tscene
from tpusfm_torch.utils import metrics as tmetrics
from tpusfm_torch.utils import synth_render as trender

torch.set_num_threads(2)

OVERRIDES = {"sift.n_octaves": 3, "sift.max_per_octave": 512, "sift.max_features": 768,
             "matching.pair_chunk": 8, "filter.max_iterations": 128, "feature_batch": 3}
FOCAL = 0.9 * 320
GPS_REF = (47.0, 8.0, 500.0)


@pytest.fixture(scope="module")
def scene6():
    return trender.render_orbit_images(n_views=6, img_h=240, img_w=320, focal=FOCAL,
                                       arc_deg=60.0, seed=1)


def _run(pipe, images, gt):
    for i, img in enumerate(images):
        Image.fromarray((img * 255).astype(np.uint8)).save(pipe.image_dir() / f"v{i:03d}.png")
    pipe.preprocess(focal_prior_px=FOCAL)
    views = json.loads((pipe.ws / "views.json").read_text())
    for i, v in enumerate(views):
        e, n, u = (float(x) for x in gt["centers"][i])
        v["gps"] = [GPS_REF[0] + n / 111_194.9,
                    GPS_REF[1] + e / (111_194.9 * float(np.cos(np.radians(47.0)))),
                    GPS_REF[2] + u]
    (pipe.ws / "views.json").write_text(json.dumps(views))
    return pipe.sparse()


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory, scene6):
    images, gt = scene6
    pipe = jstaged.StagedPipeline(tmp_path_factory.mktemp("ref") / "ws",
                                  jconfig.config_from_overrides(**OVERRIDES))
    scene, report = _run(pipe, images, gt)
    return pipe.ws, scene, report


@pytest.fixture(scope="module")
def port_run(tmp_path_factory, scene6):
    images, gt = scene6
    pipe = tstaged.StagedPipeline(tmp_path_factory.mktemp("port") / "ws",
                                  tconfig.config_from_overrides(**OVERRIDES), device="cpu")
    scene, report = _run(pipe, images, gt)
    return pipe.ws, scene, report


def _files(ws):
    return sorted(str(p.relative_to(ws)) for p in ws.rglob("*") if p.is_file())


def test_same_workspace_files_config_and_views(ref_run, port_run):
    (jws, _, _), (tws, _, _) = ref_run, port_run
    assert _files(tws) == _files(jws)
    assert "colmap/points3D.txt" in _files(tws) and "viewer.html" in _files(tws)
    assert (tws / "config.json").read_bytes() == (jws / "config.json").read_bytes()
    jv = json.loads((jws / "views.json").read_text())
    tv = json.loads((tws / "views.json").read_text())
    for a, b in zip(jv, tv):
        assert a.pop("path").replace(str(jws), "") == b.pop("path").replace(str(tws), "")
        assert a == b
    with np.load(jws / "features.npz") as a, np.load(tws / "features.npz") as b:
        assert {k: (a[k].shape, a[k].dtype) for k in a} == {k: (b[k].shape, b[k].dtype) for k in b}


def test_same_registered_count_and_quality(ref_run, port_run, scene6):
    _, gt = scene6
    (_, jsc, jrep), (tws, tsc, trep) = ref_run, port_run
    assert trep["n_registered"] == jrep["n_registered"] >= 5
    jreg = np.asarray(jsc.cam_mask)
    treg = tsc.cam_mask.numpy()
    jate = jmetrics.ate_rmse(np.asarray(jsc.camera_centers())[jreg], gt["centers"][jreg])
    tate = tmetrics.ate_rmse(tsc.camera_centers().numpy()[treg], gt["centers"][treg])
    assert jate < 0.05 and tate < 0.05, (jate, tate)
    for rep in (jrep, trep):
        assert rep["geo"] is not None and rep["geo"]["n_gps"] >= 5
        assert rep["geo"]["rms_m"] < 1.0, rep["geo"]
    assert set(jrep) <= set(trep) and trep["device"] == "cpu"
    assert json.loads((tws / "report.json").read_text())["n_registered"] == trep["n_registered"]
    # The metric frame: centres relative to the first registered view match
    # the GPS layout.
    c = tsc.camera_centers().numpy()[treg]
    enu = gt["centers"][treg] - gt["centers"][np.nonzero(treg)[0][0]]
    assert float(np.sqrt(((c - c[0]) - enu) ** 2).mean()) < 1.0


def _drop_last_two(src_ws, ws):
    """A copy of the workspace whose scene.npz lost its last two registered
    views, as if a run had stopped there."""
    shutil.copytree(src_ws, ws)
    with np.load(ws / "scene.npz") as d:
        arrays = dict(d)
    reg = np.nonzero(arrays["cam_mask"])[0]
    arrays["cam_mask"][reg[-2:]] = False
    np.savez_compressed(ws / "scene.npz", **arrays)
    return ws


@pytest.mark.parametrize("source", ["port", "reference"])
def test_resume_registers_without_bootstrap(tmp_path, ref_run, port_run, source):
    """The port's engine, seeded from the stopped scene (of the port's
    workspace, or of the reference's), registers the dropped views again
    and never bootstraps."""
    src_ws, _, src_rep = port_run if source == "port" else ref_run
    ws = _drop_last_two(src_ws, tmp_path / "ws")
    pipe = tstaged.StagedPipeline(ws, tconfig.config_from_overrides(**OVERRIDES), device="cpu")
    scene, report = pipe.sparse()
    log = report["engine_log"]
    assert any("seeded from existing scene: 3 views" in line for line in log), log
    assert not any("bootstrap" in line for line in log), log
    assert report["n_registered"] == src_rep["n_registered"], log
    assert report["n_points"] >= 0.9 * src_rep["n_points"], log
    assert int(tscene.load_scene_npz(str(ws / "scene.npz"), device="cpu").n_cams) == \
        report["n_registered"]


def test_reference_resume_drops_the_seeded_map(tmp_path, ref_run):
    """Pins the deviation: the reference seeds the intrinsics of registered
    cameras only, so its self-calibrating group keeps the prior of an
    unregistered member, BA projects the seeded views through it, and the
    wash empties the map (the port seeds every member of a seeded group)."""
    ws = _drop_last_two(ref_run[0], tmp_path / "ws")
    _, report = jstaged.StagedPipeline(ws, jconfig.config_from_overrides(**OVERRIDES)).sparse()
    assert not any("bootstrap" in line for line in report["engine_log"])
    assert report["n_points"] == 0 and report["n_registered"] == 3, report["engine_log"]


def test_no_cuda_is_an_error_not_a_cpu_run(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstaged.StagedPipeline(tmp_path / "ws")
    assert not (tmp_path / "ws").exists()
