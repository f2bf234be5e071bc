"""The port's HTTP service driven as a user drives it: upload photographs,
then trigger the stages and wait on /status.

    python -m tpusfm_torch.tools.service_rung [--rung a|b] [--device cuda]

Rung A is the 20-view 480x640 orbit (bench.py:693-706, seed 0) uploaded as
PNG, with the reference bench's sparse config, its focal as the focal
prior and the dense rung's DenseConfig (bench.py:243-349), through
/preprocessing, /sparse, /dense and /mesh.  Rung B is the medium rung's
200 views (240x320, seed 2, contiguous pairs; bench.py:383-389) uploaded
as JPEG photographs (quality 95) that carry EXIF Make/Model from the sensor
database, a FocalLength giving the rung's focal, and a GPS fix at each
camera's true centre (1 scene unit = 1 m), through /preprocessing and
/sparse: the EXIF focal seeds self-calibration and the fixes drive
geo-registration and the GPS-prior BA.  Prints one JSON line per rung:
the workspace's scene quality against the truth, the report's geo block,
stage wall seconds, the engine's phase seconds and the decoders that ran.
``chip_smoke.py`` runs both rungs and holds them to their bars, then runs
rung B and rung A's first 6 frames through a service of two ranks
(``ranks_main``, one gloo rank each, both on the one card).
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import tempfile
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

# A camera of io.images' sensor database and the reference point the GPS
# fixes are laid around (tests/test_geo_resume.py:43-52).
CAMERA = ("Canon", "EOS 5D Mark III", 36.0)
GPS_REF = (47.0, 8.0, 500.0)
METERS_PER_DEG_LAT = 111_194.9


def png_bytes(img: np.ndarray) -> bytes:
    """A float [0, 1] grey image as 8-bit PNG bytes."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _dms(deg: float):
    from PIL.TiffImagePlugin import IFDRational

    deg = abs(deg)
    d = int(deg)
    m = int((deg - d) * 60)
    s = (deg - d - m / 60.0) * 3600.0
    return (IFDRational(d, 1), IFDRational(m, 1), IFDRational(int(round(s * 1e6)), 1_000_000))


def exif_jpeg_bytes(img: np.ndarray, focal_px: float, gps=None, quality: int = 95) -> bytes:
    """A float [0, 1] grey image as JPEG bytes with EXIF Make/Model of
    CAMERA, the FocalLength that gives `focal_px` at this image size
    (max(w, h) * focal_mm / sensor width) and, when given, a GPS fix
    (lat, lon, alt)."""
    from PIL import Image
    from PIL.TiffImagePlugin import IFDRational

    make, model, ccd_mm = CAMERA
    h, w = img.shape[:2]
    exif = Image.Exif()
    exif[271] = make
    exif[272] = model
    exif.get_ifd(0x8769)[0x920A] = IFDRational(int(round(focal_px * ccd_mm / max(w, h) * 1e4)),
                                               10_000)
    if gps is not None:
        lat, lon, alt = gps
        exif.get_ifd(0x8825).update({
            1: "N" if lat >= 0 else "S", 2: _dms(lat),
            3: "E" if lon >= 0 else "W", 4: _dms(lon),
            5: 0, 6: IFDRational(int(round(alt * 1e4)), 10_000),
        })
    buf = io.BytesIO()
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=quality, exif=exif)
    return buf.getvalue()


def centers_to_gps(centers: np.ndarray, ref=GPS_REF) -> list[tuple[float, float, float]]:
    """Scene centres (x, y, z) as GPS fixes with (east, north, up) = (x, y,
    z) metres around `ref` (tests/test_geo_resume.py:45-52)."""
    out = []
    for e, n, u in np.asarray(centers, np.float64):
        out.append((ref[0] + n / METERS_PER_DEG_LAT,
                    ref[1] + e / (METERS_PER_DEG_LAT * float(np.cos(np.radians(ref[0])))),
                    ref[2] + u))
    return out


class Client:
    """Minimal HTTP client of the service on localhost:`port`."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self.base = f"http://{host}:{port}"

    def get(self, path: str, timeout: float = 30.0):
        """(status, body bytes); HTTP errors return their status."""
        try:
            with urllib.request.urlopen(self.base + path, timeout=timeout) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def get_json(self, path: str):
        code, body = self.get(path)
        return code, json.loads(body)

    def post_multipart(self, path: str, files, timeout: float = 120.0,
                       boundary: str = "tpusfmboundary7MA4YWxk"):
        """POST files [(name, bytes), ...] as multipart/form-data."""
        body = io.BytesIO()
        for name, data in files:
            body.write(f"--{boundary}\r\n".encode())
            body.write(f'Content-Disposition: form-data; name="file"; filename="{name}"\r\n'
                       "Content-Type: application/octet-stream\r\n\r\n".encode())
            body.write(data)
            body.write(b"\r\n")
        body.write(f"--{boundary}--\r\n".encode())
        req = urllib.request.Request(
            self.base + path, data=body.getvalue(),
            headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())

    def wait_idle(self, deadline_s: float, poll_s: float = 0.25) -> dict:
        """Poll /status until no stage runs; raises TimeoutError past the
        deadline.  Returns the last status."""
        end = time.time() + deadline_s
        while True:
            _, st = self.get_json("/status")
            if st["busy"] is None:
                return st
            if time.time() > end:
                raise TimeoutError(f"stage {st['busy']} still running after {deadline_s} s")
            time.sleep(poll_s)

    def sse_frames(self, n: int, timeout: float = 30.0) -> list[dict]:
        """The first `n` JSON data frames of /event (the history replays)."""
        frames = []
        with urllib.request.urlopen(self.base + "/event", timeout=timeout) as r:
            while len(frames) < n:
                line = r.readline()
                if not line:
                    break
                line = line.strip()
                if line.startswith(b"data: "):
                    frames.append(json.loads(line[len(b"data: "):]))
        return frames


def run_stages(client: Client, stages, deadline_s: float) -> dict:
    """Trigger each stage in turn and wait for it; raises when a trigger is
    refused or a stage ends with an error.  Returns each stage's wall
    seconds seen by the client."""
    seen = {}
    for stage in stages:
        t0 = time.time()
        code, body = client.get(f"/{stage}")
        if code != 200:
            raise RuntimeError(f"/{stage} answered {code}: {body[:200]!r}")
        st = client.wait_idle(deadline_s)
        seen[stage] = round(time.time() - t0, 3)
        if st["error"] is not None:
            raise RuntimeError(f"stage {stage} failed: {st['error']}")
    return seen


def scene_quality(ws: Path, gt: dict) -> dict:
    """Registered views, ATE (similarity-aligned) and points of the
    workspace's scene.npz, and its first registered camera's intrinsics."""
    from ..sfm.scene import scene_from_numpy
    from ..utils import metrics

    with np.load(ws / "scene.npz") as d:
        scene = scene_from_numpy(d, "cpu")
    reg, pm = scene.cam_mask.numpy(), scene.point_mask.numpy()
    centers = scene.camera_centers().numpy()[reg]
    ate = metrics.ate_rmse(centers, gt["centers"][reg]) if reg.sum() >= 3 else float("nan")
    pts = scene.points.numpy()[pm]
    return {"registered": int(reg.sum()), "views": int(len(reg)), "ate": float(ate),
            "points": int(pm.sum()), "finite": bool(np.isfinite(pts).all()
                                                   and np.isfinite(centers).all()),
            "intr": scene.intr.numpy()[reg][0].tolist() if reg.any() else None}


def rung_a_inputs():
    """Rung A: the 20-view 480x640 orbit, its sparse config with the focal
    as the focal prior, and the reference bench's dense rung config."""
    import dataclasses

    from ..dense.depth import DenseConfig
    from ..dense.patchmatch import PatchMatchConfig
    from .dense_rung import headline_inputs

    images, gt, cfg = headline_inputs(480, 640, 20)
    cfg = dataclasses.replace(
        cfg, focal_prior_px=float(gt["intr"][0]),
        dense=DenseConfig(n_planes=64, n_sources=3, view_batch=2,
                          pm=PatchMatchConfig(n_iters=3)))
    files = [(f"view_{i:03d}.png", png_bytes(img)) for i, img in enumerate(images)]
    return files, gt, cfg


def rung_b_inputs(n_views: int = 200):
    """Rung B: the medium rung's views as EXIF JPEG photographs with GPS."""
    from .front_end_counts import rung_inputs

    images, gt, cfg = rung_inputs(n_views)
    gps = centers_to_gps(gt["centers"])
    files = [(f"photo_{i:04d}.jpg", exif_jpeg_bytes(img, float(gt["intr"][0]), gps[i]))
             for i, img in enumerate(images)]
    return files, gt, cfg


def drive(files, cfg, stages, workspace, *, device, deadline_s: float = 900.0) -> dict:
    """Start the service on a free port of 127.0.0.1, upload `files`, run
    `stages` and read the first /event frames; stops the server.  Returns
    the upload count, the stage seconds (the client's and the service's;
    with ranks, each rank's too), the final status, the SSE frames and the
    decoders that ran.  With cfg.devices = N > 1 this is rank 0's part;
    ranks 1..N-1 call ``service.http_server.follow`` meanwhile."""
    from ..io import images as im_io
    from ..service.http_server import start_background

    httpd, state, port = start_background(str(workspace), cfg, host="127.0.0.1", device=device)
    try:
        client = Client(port)
        t0 = time.time()
        code, body = client.post_multipart("/upload", files)
        upload_s = time.time() - t0
        if code != 200 or len(body["saved"]) != len(files):
            raise RuntimeError(f"/upload answered {code}: {body}")
        seen = run_stages(client, stages, deadline_s)
        _, status = client.get_json("/status")
        frames = client.sse_frames(3)
        code, ply = client.get("/files/colorized.ply")
        return {"uploaded": len(body["saved"]), "upload_s": round(upload_s, 3),
                "client_stage_s": seen, "stage_s": status["stage_s"],
                "rank_stage_s": state.rank_stage_s, "status": status,
                "sse": frames, "colorized_download": code == 200 and ply.startswith(b"ply"),
                "decoders": dict(im_io.DECODER)}
    finally:
        httpd.shutdown()
        httpd.server_close()


def ranks_main(rank: int, spec: dict) -> dict:
    """One rank of a service of the group's ranks on spec["device"]: for
    each (name, files, cfg, stages) of spec["rungs"] in turn, rank 0 serves
    a fresh workspace spec["root"]/<name> and drives it (``drive``) while
    the others follow; each rank resets the kernel counts just before and
    reads them just after.  Returns, by rung, rank 0's drive result, every
    rank's launches and kernel calls by variant, and rank 0's last call
    (args, kwargs, on the CPU) of each (wrapper, variant) of spec["hold"]
    that ran, for the caller to hold against its twin."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from ..service.http_server import follow
    from . import kernel_calls as kc
    from .parallel_rung import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "jax_imported": "jax" in sys.modules}
    for name, files, cfg, stages in spec["rungs"]:
        cfg = dataclasses.replace(cfg, devices=dist.get_world_size())
        ws = Path(spec["root"]) / name
        kc.reset_counts()
        captured = {}
        with kc.recording(captured) as (_, calls):
            t0 = time.time()
            if rank == 0:
                res = drive(files, cfg, stages, ws, device=spec["device"])
            else:
                follow(str(ws), cfg, device=spec["device"])
                res = {}
            res["wall_s"] = time.time() - t0
        held = {k: captured[k] for k in spec.get("hold", ()) if rank == 0 and k in captured}
        out[name] = {**res, "launches": kc.counts(), "calls": kc.named(calls),
                     "held": to_device(held, "cpu")}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rung", default="a", choices=["a", "b"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.rung == "a":
        files, gt, cfg = rung_a_inputs()
        stages = ("preprocessing", "sparse", "dense", "mesh")
    else:
        files, gt, cfg = rung_b_inputs()
        stages = ("preprocessing", "sparse")
    with tempfile.TemporaryDirectory() as tmp:
        out = drive(files, cfg, stages, Path(tmp), device=args.device)
        report = json.loads((Path(tmp) / "report.json").read_text())
        print(json.dumps({"rung": args.rung, **scene_quality(Path(tmp), gt),
                          "geo": report["geo"], "stage_s": out["stage_s"],
                          "recon_phase_s": report["recon_phase_s"],
                          "decoders": out["decoders"]}))


if __name__ == "__main__":
    main()
