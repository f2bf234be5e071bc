"""The port's HTTP service on the CPU, end to end, with the reference's
endpoints (tests/test_service.py): multipart upload byte for byte, 409
while a stage runs, /preprocessing, /sparse, /dense and /mesh on the 6-view
240x320 orbit, the SSE stream, artifact download, path traversal refused,
a stage's error surfaced through /status and /event, and no CPU fallback
when the card is asked for and absent."""

import json
import threading

import pytest
import torch

from tpusfm.service import http_server as jserver
from tpusfm_torch.dense.depth import DenseConfig
from tpusfm_torch.dense.patchmatch import PatchMatchConfig
from tpusfm_torch.pipeline.config import config_from_overrides
from tpusfm_torch.service.http_server import start_background
from tpusfm_torch.tools.service_rung import Client, png_bytes, run_stages, scene_quality
from tpusfm_torch.utils.synth_render import render_orbit_images

torch.set_num_threads(2)

FOCAL = 0.9 * 320


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    ws = tmp_path_factory.mktemp("svc_ws")
    cfg = config_from_overrides(**{
        "sift.n_octaves": 3, "sift.max_per_octave": 512, "sift.max_features": 768,
        "matching.pair_chunk": 16, "filter.max_iterations": 128, "feature_batch": 3,
        "focal_prior_px": FOCAL,
        "dense": DenseConfig(n_planes=32, n_sources=2, pm=PatchMatchConfig(n_iters=2)),
    })
    httpd, state, port = start_background(str(ws), cfg, host="127.0.0.1", device="cpu")
    yield ws, state, Client(port)
    httpd.shutdown()
    httpd.server_close()


def test_root_and_status(service):
    ws, _, client = service
    code, body = client.get_json("/")
    assert code == 200 and body["service"] == "tpusfm"
    assert body["endpoints"] == ["/upload", "/preprocessing", "/sparse", "/dense", "/mesh",
                                 "/event", "/status", "/files/<artifact>"]
    code, st = client.get_json("/status")
    assert code == 200 and st["busy"] is None and st["error"] is None
    assert st["device"] == "cpu" and st["workspace"] == str(ws)
    assert client.get("/nope")[0] == 404
    assert client.get("/files/config.json")[1] == (ws / "config.json").read_bytes()


def test_upload_binary_payload_exact(service):
    """Payload bytes survive byte for byte, trailing CR/LF/'-' included
    (RFC 2046: the delimiter's leading CRLF belongs to the framing)."""
    ws, _, client = service
    payload = bytes(range(256)) * 3 + b"\r\n-" + b"\x2d\x0d\x0a"
    code, body = client.post_multipart("/upload", [("tricky.bin", payload),
                                                   ("../escape.bin", b"x\r\n")])
    assert code == 200 and body["saved"] == ["tricky.bin", "escape.bin"]
    assert (ws / "images" / "tricky.bin").read_bytes() == payload
    assert (ws / "images" / "escape.bin").read_bytes() == b"x\r\n"
    assert not (ws / "escape.bin").exists()
    for name in ("tricky.bin", "escape.bin"):
        (ws / "images" / name).unlink()


def test_busy_stage_refuses_another(service):
    _, state, client = service
    release = threading.Event()
    assert state.run_stage("hold", release.wait)
    try:
        assert client.get("/sparse")[0] == 409
        code, body = client.get_json("/dense")
        assert code == 409 and body["status"] == "busy"
        assert client.get("/preprocessing") == (409, b"busy")
        assert client.get_json("/status")[1]["busy"] == "hold"
    finally:
        release.set()
    assert client.wait_idle(30)["error"] is None


def test_upload_then_every_stage(service):
    ws, state, client = service
    images, gt = render_orbit_images(n_views=6, img_h=240, img_w=320, focal=FOCAL, arc_deg=60.0,
                                     seed=1)
    files = [(f"view_{i:03d}.png", png_bytes(img)) for i, img in enumerate(images)]
    code, body = client.post_multipart("/upload", files)
    assert code == 200 and body["saved"] == [n for n, _ in files]
    run_stages(client, ("preprocessing",), 300)
    code, body = client.get_json("/sparse")
    assert code == 200 and body == {"status": "sparse begin", "result": "/files/colorized.ply"}
    assert client.wait_idle(300)["error"] is None
    run_stages(client, ("dense", "mesh"), 600)
    st = client.get_json("/status")[1]
    assert st["error"] is None and set(st["stage_s"]) >= {"preprocessing", "sparse", "dense",
                                                          "mesh"}
    q = scene_quality(ws, gt)
    assert q["registered"] >= 5 and q["ate"] < 0.05 and q["finite"], q
    for name in ("colorized.ply", "colorized.pcd", "cloud_and_poses.ply", "report.json",
                 "report.html", "viewer.html", "dense.ply", "depth_maps.npz", "mesh.ply",
                 "textured_mesh.obj", "textured_mesh.mtl", "textured_mesh.png"):
        assert name in st["artifacts"] and (ws / name).stat().st_size > 0, name
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (ws / "colmap" / name).stat().st_size > 0
    report = json.loads((ws / "report.json").read_text())
    assert report["device"] == "cpu" and report["n_registered"] == q["registered"]
    code, data = client.get("/files/colorized.ply")
    assert code == 200 and data.startswith(b"ply")
    assert client.get("/files/../../etc/passwd")[0] == 404
    # A sibling directory whose name starts with the workspace's name.
    sibling = ws.parent / (ws.name + "2")
    sibling.mkdir(exist_ok=True)
    (sibling / "secret.txt").write_text("secret")
    assert client.get(f"/files/../{sibling.name}/secret.txt")[0] == 404
    assert client.get("/files/images")[0] == 404  # directories are not served
    types = {e.type for e in state.bus.history}
    assert {"preprocessing", "matching", "reconstruction", "done", "dense", "mesh"} <= types
    # A late subscriber first gets the replay of the last 20 events.
    frames = client.sse_frames(3)
    assert frames == [json.loads(e.to_json()) for e in state.bus.history[-20:][:3]]


def test_stage_error_surfaces(tmp_path):
    """A stage that fails ends with busy None and its error in /status and
    on the event stream (the service behaviour of the reference)."""
    errs = []
    for start in (jserver.start_background, start_background):
        kw = {} if start is jserver.start_background else {"device": "cpu"}
        httpd, state, port = start(str(tmp_path / start.__module__), host="127.0.0.1", **kw)
        try:
            client = Client(port)
            assert client.get("/preprocessing") == (200, b"preprocessing begin")
            st = client.wait_idle(60)
            errs.append(st["error"])
            ev = [e for e in state.bus.history if e.type == "error"]
            assert ev and ev[-1].payload["stage"] == "preprocessing"
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert errs[0].startswith("FileNotFoundError: no images in")
    assert errs[1].split(" in ")[0] == errs[0].split(" in ")[0]


def test_card_requested_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        start_background(str(tmp_path / "ws"))
