"""Image ingest: loading, EXIF focal priors, sensor-width database (port of
``tpusfm/io/images.py``; host numpy, the arrays go to the device in
``pipeline.staged``).

Capability parity with ``readImagesCluster``
(src/sparseBuilder/sparseBuilder.cpp:314-573): enumerate an image
directory, read sizes, extract EXIF focal length and camera model, map the
model to a sensor width through a database, and derive the focal prior in
pixels as ``max(w, h) * focal_mm / sensor_width_mm`` (.cpp:455) — falling
back to a caller-supplied prior (the reference hard-codes 2905.88 at
main.cpp:124) or a default FOV guess.  GPS EXIF priors (.cpp getGPS
.cpp:112) are parsed when present.  Decoding goes through the native C++
worker pool (``io.native_ingest``) where it is available and through PIL
otherwise; ``DECODER`` records which one decoded the last batch.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".ppm", ".pgm"}

# Compact sensor-width database (mm) — the reference loads the OpenMVG
# sensor_width_camera_database.txt (sparseBuilder.h:20); a full file can be
# supplied via ``sensor_db_path``.
BUILTIN_SENSOR_DB = {
    "canon eos 5d mark iii": 36.0,
    "canon eos 5d mark ii": 35.8,
    "canon eos r5": 36.0,
    "nikon d850": 35.9,
    "nikon d750": 35.9,
    "sony ilce-7m3": 35.6,
    "sony ilce-7rm4": 35.7,
    "fujifilm x-t4": 23.5,
    "apple iphone 12": 5.76,
    "apple iphone 13": 7.01,
    "apple iphone 14 pro": 9.8,
    "google pixel 7": 6.81,
    "samsung sm-g998b": 6.4,
    "dji fc330": 6.24,
    "gopro hero9 black": 6.17,
}


# What read the last batch of load_images_gray / load_images_rgb and the
# last record's EXIF: "native" or "PIL".
DECODER = {"gray": None, "rgb": None, "exif": None}


@dataclasses.dataclass
class ImageRecord:
    path: str
    width: int
    height: int
    focal_px: float | None
    camera_model: str | None = None
    gps: tuple[float, float, float] | None = None


def load_sensor_db(path: str | None) -> dict[str, float]:
    db = dict(BUILTIN_SENSOR_DB)
    if path and Path(path).exists():
        for line in Path(path).read_text(errors="replace").splitlines():
            parts = line.strip().split(";")
            if len(parts) >= 2:
                try:
                    db[parts[0].strip().lower()] = float(parts[-1])
                except ValueError:
                    continue
    return db


def _exif_of(img) -> dict:
    try:
        exif = img.getexif()
        out = {k: v for k, v in exif.items()}
        # Merge the EXIF IFD (FocalLength etc. live there).
        try:
            out.update(dict(exif.get_ifd(0x8769)))
        except Exception:
            pass
        # The GPS IFD as a dict: items() gives only its offset there, so the
        # reference's PIL path reads no GPS fix from a JPEG (its native
        # reader does).
        gps = exif.get_ifd(0x8825)
        if gps:
            out[0x8825] = dict(gps)
        return out
    except Exception:
        return {}


def _gps_of(exif) -> tuple[float, float, float] | None:
    gps = exif.get(0x8825)
    try:
        if not gps:
            return None

        def to_deg(v):
            d, m, s = (float(x) for x in v)
            return d + m / 60.0 + s / 3600.0

        lat = to_deg(gps[2]) * (-1 if gps[1] == "S" else 1)
        lon = to_deg(gps[4]) * (-1 if gps[3] == "W" else 1)
        alt = float(gps.get(6, 0.0))
        return (lat, lon, alt)
    except Exception:
        return None


def list_images(directory: str | Path) -> list[Path]:
    """Sorted image listing (parity: list_files + computeIndexFromImageNames,
    sparseBuilder.cpp:258-312 — stable name order defines view indices)."""
    d = Path(directory)
    return sorted(p for p in d.iterdir() if p.suffix.lower() in IMAGE_EXTS)


def read_image_record(
    path: str | Path,
    sensor_db: dict[str, float] | None = None,
    focal_prior_px: float | None = None,
    default_fov_deg: float = 55.0,
) -> ImageRecord:
    from PIL import Image

    sensor_db = sensor_db or BUILTIN_SENSOR_DB
    with Image.open(path) as img:
        w, h = img.size
        exif = _exif_of(img)
    # Prefer the native C++ EXIF parser for JPEGs (tsfm_exif — the
    # counterpart of the reference's Exif_IO_EasyExif); PIL covers the rest.
    nat = None
    if Path(path).suffix.lower() in (".jpg", ".jpeg"):
        from . import native_ingest

        nat = native_ingest.exif_info(path) if native_ingest.available() else None
    DECODER["exif"] = "native" if nat else "PIL"
    if nat:
        make = nat.get("make", "").strip()
        model = nat.get("model", "").strip()
        cam = f"{make} {model}".strip() or None
        focal_mm = nat.get("focal_mm")
        gps = nat.get("gps")
    else:
        make = str(exif.get(271, "")).strip()
        model = str(exif.get(272, "")).strip()
        cam = f"{make} {model}".strip() or None
        focal_mm = exif.get(0x920A)  # FocalLength
        gps = _gps_of(exif)
    focal_px = None
    if focal_mm:
        try:
            focal_mm = float(focal_mm)
            key = (cam or "").lower()
            ccd = sensor_db.get(key) or sensor_db.get(model.lower())
            if ccd and focal_mm > 0:
                # .cpp:455: focal = max(w, h) * focal_mm / ccd_width_mm
                focal_px = max(w, h) * focal_mm / ccd
        except (TypeError, ValueError):
            focal_px = None
    if focal_px is None:
        focal_px = focal_prior_px
    if focal_px is None:
        focal_px = max(w, h) / (2.0 * np.tan(np.radians(default_fov_deg) / 2.0))
    return ImageRecord(
        path=str(path), width=w, height=h, focal_px=float(focal_px),
        camera_model=cam, gps=gps,
    )


def _native_batch(paths, want_gray: bool, want_rgb: bool):
    """Try the native C++ worker-pool decoder (native/src/ingest.cpp) for a
    uniform-size batch; None -> caller falls back to PIL."""
    from . import native_ingest

    if not paths or not native_ingest.available():
        return None
    info = native_ingest.image_info(paths[0])
    if info is None:
        return None
    w, h, _ = info
    res = native_ingest.load_batch(paths, w, h, gray=want_gray, rgb=want_rgb)
    if res is None:
        return None
    gray, rgb, status = res
    if not status.all():  # mixed sizes/undecodable -> PIL path handles it
        return None
    return gray, rgb


def load_images_gray(paths, target_size: tuple[int, int] | None = None) -> np.ndarray:
    """Load images as (V, H, W) float32 grayscale in [0, 1].  All images must
    share one size (or are resized to target_size).  Uses the native C++
    threaded decoder when available, PIL otherwise."""
    from PIL import Image

    if target_size is None:
        res = _native_batch(list(paths), True, False)
        if res is not None:
            DECODER["gray"] = "native"
            return res[0]
    DECODER["gray"] = "PIL"
    out = []
    for p in paths:
        img = Image.open(p).convert("L")
        if target_size is not None:
            img = img.resize((target_size[1], target_size[0]))
        out.append(np.asarray(img, np.float32) / 255.0)
    shapes = {a.shape for a in out}
    if len(shapes) > 1:
        # Resize everything to the most common shape.
        from collections import Counter

        target = Counter(a.shape for a in out).most_common(1)[0][0]
        out = [
            np.asarray(Image.fromarray((a * 255).astype(np.uint8)).resize((target[1], target[0])), np.float32) / 255.0
            if a.shape != target else a
            for a in out
        ]
    return np.stack(out)


def load_images_rgb(paths, target_size: tuple[int, int] | None = None) -> np.ndarray:
    from PIL import Image

    if target_size is None:
        res = _native_batch(list(paths), False, True)
        if res is not None:
            DECODER["rgb"] = "native"
            return res[1]
    DECODER["rgb"] = "PIL"
    out = []
    for p in paths:
        img = Image.open(p).convert("RGB")
        if target_size is not None:
            img = img.resize((target_size[1], target_size[0]))
        out.append(np.asarray(img, np.uint8))
    return np.stack(out)
