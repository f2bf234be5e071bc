"""The port's host modules of the staged pipeline against the JAX reference
on the CPU, on inputs made from a seed: events and results, image records
and decoding (native and PIL), match-graph reports, the viewer, COLMAP
export and import, checkpoints, config.json and the CLI's configs."""

import base64
import dataclasses
import json
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from synth import orbit_scene
from test_colmap import GOLDEN, _scene_from_synth
from tpusfm import cli as jcli
from tpusfm.io import colmap as jcolmap
from tpusfm.io import images as jimages
from tpusfm.io import native_ingest as jnative
from tpusfm.io import reports as jreports
from tpusfm.io import viewer as jviewer
from tpusfm.pipeline import checkpoint as jckpt
from tpusfm.pipeline import config as jconfig
from tpusfm.sfm import scene as jscene
from tpusfm.utils import events as jevents
from tpusfm.utils import result as jresult
from tpusfm_torch import cli as tcli
from tpusfm_torch import convert
from tpusfm_torch.io import colmap as tcolmap
from tpusfm_torch.io import images as timages
from tpusfm_torch.io import native_ingest as tnative
from tpusfm_torch.io import reports as treports
from tpusfm_torch.io import viewer as tviewer
from tpusfm_torch.pipeline import checkpoint as tckpt
from tpusfm_torch.pipeline import config as tconfig
from tpusfm_torch.sfm import scene as tscene
from tpusfm_torch.tools import service_rung
from tpusfm_torch.utils import events as tevents
from tpusfm_torch.utils import result as tresult

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# events, result
# ---------------------------------------------------------------------------

def test_event_bus_matches_reference():
    out = []
    for mod in (jevents, tevents):
        bus = mod.EventBus()
        q = bus.subscribe()
        q2 = bus.subscribe()
        bus.publish("matching", 0.123456789, pairs=3)
        bus.progress_fn()("done", 1.0, n_points=42, warning="w")
        bus.unsubscribe(q2)
        bus.publish("mesh", 0.5)
        got = [q.get_nowait().to_json() for _ in range(3)]
        out.append((got, q2.qsize(), [e.to_json() for e in bus.history]))
    assert out[0] == out[1]
    assert json.loads(out[1][0][0]) == {"type": "matching", "progress": 0.1235, "pairs": 3}


def test_result_matches_reference():
    for mod in (jresult, tresult):
        ok, err = mod.Result.ok(5), mod.Result.err("bad")
        assert (ok.is_ok, ok.is_err, ok.unwrap(), ok.error) == (True, False, 5, None)
        assert (err.is_ok, err.is_err, err.unwrap_or(7), err.error) == (False, True, 7, "bad")
        assert mod.Result.ok().unwrap() == mod.UNIT == ()
        with pytest.raises(RuntimeError, match="unwrap of Err: bad"):
            err.unwrap()
        mod.ensure(True)
        with pytest.raises(AssertionError, match="boom"):
            mod.ensure(False, "boom")


# ---------------------------------------------------------------------------
# image ingest
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def photo_dir(tmp_path_factory):
    """PNG, BMP, PPM and JPEG files; two JPEGs carry EXIF make/model,
    focal and GPS (the service rung's photographs)."""
    d = tmp_path_factory.mktemp("photos")
    rng = np.random.default_rng(0)
    for i, fmt in enumerate(["PNG", "BMP", "PPM", "JPEG"]):
        arr = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
        Image.fromarray(arr).save(d / f"img_{i}.{fmt.lower()}", format=fmt)
    gps = service_rung.centers_to_gps(rng.uniform(-8, 8, (2, 3)))
    for i in range(2):
        img = rng.random((120, 160)).astype(np.float32)
        (d / f"photo_{i}.jpg").write_bytes(service_rung.exif_jpeg_bytes(img, 110.0, gps[i]))
    return d, gps


def _same_fix(got, want):
    """A fix as written: seconds of arc to 1e-6, altitude to 1e-4 m."""
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-9)
    assert abs(got[2] - want[2]) <= 1e-4


def _records(mod, paths, **kw):
    return [dataclasses.asdict(mod.read_image_record(p, **kw)) for p in paths]


def _without_native(monkeypatch):
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "available", lambda: False)


def test_image_records_match_reference(photo_dir, monkeypatch):
    d, gps = photo_dir
    paths = timages.list_images(d)
    assert [p.name for p in paths] == [p.name for p in jimages.list_images(d)]
    for kw in ({}, {"focal_prior_px": 321.5}):
        assert _records(timages, paths, **kw) == _records(jimages, paths, **kw)
    rec = timages.read_image_record(d / "photo_1.jpg")
    assert rec.camera_model == "Canon EOS 5D Mark III"
    assert rec.focal_px == pytest.approx(110.0, rel=1e-6)
    if tnative.available():
        assert timages.DECODER["exif"] == "native"
        _same_fix(rec.gps, gps[1])
    # PIL alone: the same focal and camera; the port's PIL path also reads
    # the GPS fix, which the reference's misses (its EXIF merge keeps only
    # the GPS IFD's offset).
    _without_native(monkeypatch)
    port_pil = _records(timages, paths)
    ref_pil = _records(jimages, paths)
    assert timages.DECODER["exif"] == "PIL"
    for p, r in zip(port_pil, ref_pil):
        if p["gps"] is not None:
            assert r["gps"] is None
            p = {**p, "gps": None}
        assert p == r
    _same_fix(port_pil[-1]["gps"], gps[1])


@pytest.mark.parametrize("decoder", ["native", "PIL"])
def test_decoded_arrays_match_reference(photo_dir, monkeypatch, decoder):
    d, _ = photo_dir
    same = [p for p in timages.list_images(d) if p.suffix != ".jpg" or "photo" not in p.name]
    if decoder == "native" and not tnative.available():
        pytest.skip("native ingest library not built (no compiler or libjpeg/libpng)")
    if decoder == "PIL":
        _without_native(monkeypatch)
    np.testing.assert_array_equal(timages.load_images_gray(same), jimages.load_images_gray(same))
    np.testing.assert_array_equal(timages.load_images_rgb(same), jimages.load_images_rgb(same))
    assert timages.DECODER["gray"] == timages.DECODER["rgb"] == decoder
    # Mixed sizes go through PIL and are resized to the most common shape.
    mixed = same + [p for p in timages.list_images(d) if "photo" in p.name]
    np.testing.assert_array_equal(timages.load_images_gray(mixed),
                                  jimages.load_images_gray(mixed))
    assert timages.DECODER["gray"] == "PIL"


def test_sensor_db_matches_reference(tmp_path):
    f = tmp_path / "db.txt"
    f.write_text("Foo Cam;7.5\nbroken line\nBar X;notanumber\nCanon EOS R5;35.9\n")
    assert timages.load_sensor_db(str(f)) == jimages.load_sensor_db(str(f))
    assert timages.load_sensor_db(None) == jimages.BUILTIN_SENSOR_DB


# ---------------------------------------------------------------------------
# reports, viewer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_reports_byte_equal(tmp_path, seed):
    rng = np.random.default_rng(seed)
    V = 9
    pairs = np.stack(np.triu_indices(V, 1), 1).astype(np.int32)
    counts = rng.integers(0, 300, len(pairs)) * (rng.random(len(pairs)) > 0.4)
    for mod, tag in ((jreports, "j"), (treports, "t")):
        mod.write_adjacency_svg(tmp_path / f"{tag}.svg", V, pairs, counts)
        mod.write_graphviz(tmp_path / f"{tag}.dot", pairs, counts)
        report = {"n_views": V, "geo": None, "engine_log": ["a", "b"], "t": {"x": 1.5}}
        mod.write_html_report(tmp_path / f"{tag}.html", report, [str(tmp_path / f"{tag}.svg")])
    for ext in ("svg", "dot"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    html_t = (tmp_path / "t.html").read_text().replace("t.svg", "j.svg")
    assert html_t == (tmp_path / "j.html").read_text()
    assert treports.graph_stats(V, pairs, counts) == jreports.graph_stats(V, pairs, counts)


def _embedded(html: str, key: str, dtype) -> np.ndarray:
    return np.frombuffer(base64.b64decode(html.split(f'{key}="')[1].split('"')[0]), dtype)


@pytest.mark.parametrize("cams", ["frusta", "axes", "none"])
def test_viewer_html_byte_equal(tmp_path, cams):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    pts[5] = np.nan
    cols = rng.integers(0, 255, (700, 3)).astype(np.uint8)
    kw = {}
    if cams != "none":
        kw["cam_centers"] = rng.normal(size=(4, 3)).astype(np.float32)
    if cams == "frusta":
        kw["cam_rotations"] = np.linalg.qr(rng.normal(size=(4, 3, 3)))[0].astype(np.float32)
    for mod, tag in ((jviewer, "j"), (tviewer, "t")):
        mod.write_viewer_html(tmp_path / f"{tag}.html", pts, cols, title="t", max_points=500,
                              **kw)
    assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()


def _scene_pair(seed=2, C=6, P=80, noise_px=0.4):
    """The same synthetic scene in both packages (the port's on the CPU)."""
    s = orbit_scene(n_cams=C, n_points=P, seed=seed, vis_prob=0.9, noise_px=noise_px)
    js = _scene_from_synth(s)
    return js, tscene.scene_from_numpy(jscene.scene_to_numpy(js), "cpu")


def test_scene_viewer_matches_reference(tmp_path):
    """Points and colours embed bit for bit; the frusta within float32
    rounding (each package's so3_exp may differ in the last bit)."""
    js, ts = _scene_pair()
    jviewer.write_scene_viewer(tmp_path / "j.html", js)
    tviewer.write_scene_viewer(tmp_path / "t.html", ts)
    a, b = (tmp_path / "j.html").read_text(), (tmp_path / "t.html").read_text()
    for key, dt in (("PTS_B64", np.float32), ("COL_B64", np.uint8)):
        np.testing.assert_array_equal(_embedded(b, key, dt), _embedded(a, key, dt))
    np.testing.assert_allclose(_embedded(b, "CAM_B64", np.float32),
                               _embedded(a, "CAM_B64", np.float32), rtol=0, atol=1e-5)
    assert a.split('const PTS_B64')[0] == b.split('const PTS_B64')[0]


# ---------------------------------------------------------------------------
# COLMAP
# ---------------------------------------------------------------------------

def _model(d):
    return {f: (d / f).read_text() for f in ("cameras.txt", "images.txt", "points3D.txt")}


def test_colmap_golden_import_and_export_equal_reference(tmp_path):
    js, jn = jcolmap.import_colmap(GOLDEN)
    ts, tn = tcolmap.import_colmap(GOLDEN, device="cpu")
    assert tn == jn
    for f in dataclasses.fields(ts):
        np.testing.assert_array_equal(getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name)),
                                      err_msg=f.name)
    assert (int(ts.n_cams), int(ts.n_points), int(ts.n_obs)) == (2, 2, 4)
    sizes = np.tile([[640, 480]], (2, 1))
    jcolmap.export_colmap(tmp_path / "j", js, jn, image_sizes=sizes)
    tcolmap.export_colmap(tmp_path / "t", ts, tn, image_sizes=sizes)
    assert _model(tmp_path / "t") == _model(tmp_path / "j")
    # The port's writer is a fixed point under its reader, as the reference's.
    ts2, tn2 = tcolmap.import_colmap(tmp_path / "t", device="cpu")
    tcolmap.export_colmap(tmp_path / "t2", ts2, tn2, image_sizes=sizes)
    assert _model(tmp_path / "t2") == _model(tmp_path / "t")


def _tokens_close(a: str, b: str, atol: float):
    """Two COLMAP texts with the same lines and integer/name tokens, their
    float tokens within atol."""
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        tx, ty = x.split(), y.split()
        assert len(tx) == len(ty), (x, y)
        for u, v in zip(tx, ty):
            if u == v:
                continue
            assert "." in u + v or "e" in u + v, (x, y)  # only floats may differ
            assert abs(float(u) - float(v)) <= atol, (x, y)


@pytest.mark.parametrize("distorted", [False, True])
def test_colmap_export_of_converted_scene(tmp_path, distorted):
    """cameras.txt is byte-equal; images.txt's quaternions and points3D.txt's
    mean reprojection errors come from float32 math (so3_exp, projection)
    that may differ in the last bit between the packages, so those tokens
    are held to 1e-6 and 1e-4 px; every other token is equal."""
    js, ts = _scene_pair(seed=4)
    if distorted:
        intr = np.asarray(js.intr).copy()
        intr[:, 4:7] = [0.01, -0.002, 0.0001]
        js = js.replace(intr=jnp.asarray(intr))
        ts = ts.replace(intr=torch.as_tensor(intr))
    names = [f"img_{i:02d}.jpg" for i in range(6)]
    jcolmap.export_colmap(tmp_path / "j", js, names)
    tcolmap.export_colmap(tmp_path / "t", ts, names)
    a, b = _model(tmp_path / "j"), _model(tmp_path / "t")
    assert b["cameras.txt"] == a["cameras.txt"]
    assert ("FULL_OPENCV" in b["cameras.txt"]) == distorted
    _tokens_close(a["images.txt"], b["images.txt"], 1e-6)
    _tokens_close(a["points3D.txt"], b["points3D.txt"], 1e-4)


def test_colmap_roundtrip_through_port(tmp_path):
    js, ts = _scene_pair(seed=2)
    names = [f"img_{i:02d}.jpg" for i in range(6)]
    out = tcolmap.export_colmap(tmp_path / "c", ts, names, image_sizes=np.tile([[640, 480]],
                                                                                (6, 1)))
    t2, n2 = tcolmap.import_colmap(out, device="cpu")
    j2, _ = jcolmap.import_colmap(out)
    assert n2 == names and int(t2.n_cams) == 6
    for f in ("intr", "cam_t", "points", "colors", "obs_uv", "obs_cam", "obs_pt", "point_mask"):
        np.testing.assert_array_equal(getattr(t2, f).numpy(), np.asarray(getattr(j2, f)),
                                      err_msg=f)
    np.testing.assert_allclose(t2.cam_rot.numpy(), np.asarray(j2.cam_rot), atol=1e-6)
    np.testing.assert_allclose(t2.camera_centers().numpy(), ts.camera_centers().numpy(),
                               atol=1e-4)


# ---------------------------------------------------------------------------
# checkpoint, config.json, CLI
# ---------------------------------------------------------------------------

def _same_scene(a, b):
    for f in dataclasses.fields(tscene.Scene):
        x, y = getattr(a, f.name), getattr(b, f.name)
        np.testing.assert_array_equal(x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x),
                                      y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y))


def test_checkpoint_crosses_packages(tmp_path, monkeypatch):
    """The port writes and reads the reference's npz form; the reference
    takes that form when orbax is not importable."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    js, ts = _scene_pair(seed=3)
    path = tckpt.save_checkpoint(tmp_path / "p", ts, step=7, extra={"lambda": 1e-4})
    assert path.name == "p.npz"
    sc, step, extra = jckpt.load_checkpoint(tmp_path / "p")
    assert step == 7 and abs(float(extra["lambda"]) - 1e-4) < 1e-12
    _same_scene(ts, sc)
    jckpt.save_checkpoint(tmp_path / "r", js, step=3, extra={"k": [1, 2]})
    sc2, step2, extra2 = tckpt.load_checkpoint(tmp_path / "r", device="cpu")
    assert step2 == 3 and extra2["k"].tolist() == [1, 2]
    _same_scene(sc2, js)


@pytest.mark.parametrize("overrides", [{}, {"matching.ratio": 0.7, "filter.model": "e",
                                            "focal_prior_px": 288.0, "feature_batch": 3,
                                            "dense.n_planes": 32}])
def test_config_json_equal(overrides):
    jcfg = jconfig.config_from_overrides(**overrides)
    tcfg = tconfig.config_from_overrides(**overrides)
    assert tcfg.to_json() == jcfg.to_json()
    assert convert.config_from_jax(jcfg) == tcfg


@pytest.mark.parametrize("field", [{"axis_name": "obs"}, {"pallas_interpret": True}])
def test_config_json_only_fields_raise_when_set(field):
    """BAConfig keeps the reference's axis_name and pallas_interpret so that
    both packages write the same config.json.  The port has no interpret
    mode, so pallas_interpret=True raises; axis_name names a mesh that
    parallel.mesh.make_mesh registered (test_torch_parallel.py), and an
    axis no mesh was made for raises."""
    from tpusfm_torch.ba.bundle_adjust import BAConfig, bundle_adjust

    z = torch.zeros
    args = (z(2, 7), z(2, 3), z(2, 3), torch.ones(2, dtype=torch.bool), z(4, 3),
            torch.ones(4, dtype=torch.bool), torch.zeros(8, dtype=torch.long),
            torch.zeros(8, dtype=torch.long), z(8, 2), torch.ones(8, dtype=torch.bool))
    error = RuntimeError if "axis_name" in field else NotImplementedError
    with pytest.raises(error, match="axis 'obs'" if "axis_name" in field else "pallas_interpret"):
        bundle_adjust(*args, cfg=BAConfig(**field))


CLI_ARGS = [
    ["reconstruct", "imgs"],
    ["reconstruct", "imgs", "--preset", "HIGH", "--max-features", "1024", "--pair-mode",
     "contiguous", "--focal", "288.5", "--no-self-calibrate"],
    ["serve", "--preset", "ULTRA", "--devices", "1"],
    ["reconstruct", "imgs", "--engine", "stellar"],
    ["serve", "--engine", "global", "--no-self-calibrate"],
]


@pytest.mark.parametrize("argv", CLI_ARGS)
def test_cli_make_cfg_matches_reference(argv, monkeypatch):
    seen = {}
    for mod in (jcli, tcli):
        monkeypatch.setattr(mod, "cmd_reconstruct", lambda a, _m=mod: seen.__setitem__(_m, a))
        monkeypatch.setattr(mod, "cmd_serve", lambda a, _m=mod: seen.__setitem__(_m, a))
    jcli.main(argv)
    tcli.main(argv)
    assert seen[tcli].device == "cuda"  # the card unless asked
    got = tcli._make_cfg(seen[tcli])
    assert got == convert.config_from_jax(jcli._make_cfg(seen[jcli]))
    assert got.to_json() == jcli._make_cfg(seen[jcli]).to_json()


def test_cli_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 1"):
        tcli.main(["bench"])
    # --devices 2 outside torchrun's group of 2 ranks (test_torch_mesh_pipeline.py
    # runs it inside one).
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        tcli.main(["reconstruct", str(tmp_path), "--workspace", str(tmp_path / "ws"),
                    "--device", "cpu", "--devices", "2"])
    if not torch.cuda.is_available():  # the card default never falls back to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["reconstruct", str(tmp_path), "--workspace", str(tmp_path / "ws")])
