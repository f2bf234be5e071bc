"""The reference's dense rung through the port: PatchMatch MVS, consistency
fusion, TSDF meshing, both refiners and texturing after ``run_sparse``.

    python -m tpusfm_torch.tools.dense_rung [--device cuda] [--height 480 --width 640]

Renders the 20-view headline scene (bench.py:693-706: focal 0.9 x width,
arc 110 degrees, seed 0), runs ``run_sparse`` with the headline config,
then the dense rung of bench.py:243-349 on the first 6 registered views:
``DenseConfig(n_planes=64, n_sources=3, view_batch=2,
pm=PatchMatchConfig(n_iters=3))`` (a half-resolution sweep and coarse
PatchMatch, one fine full-resolution iteration), and the same config with
``patchmatch=False`` (a full-resolution sweep).  Then the mesh stage as the
reference's staged pipeline runs it (tpusfm/pipeline/staged.py:367-409):
``mesh_from_depths`` (grid 128), ``refine_mesh``,
``refine_mesh_photometric`` and ``texture_mesh``.  Prints one JSON line
with each stage's seconds (host clock, device sync at each stage end),
views/s, fused points, the median relative depth error against the
renderer's depth (bench.py:221-240, scale from camera-centre alignment,
bench.py:293-302), faces and the textured share.  ``chip_smoke.py`` runs
the same functions and holds them to its bars; ``--device cpu --height 240
--width 320`` is a CPU rehearsal of about a minute and a half (one
PatchMatch level: 76,800 px is below ``pm_coarse_px``).  ``--profile``
(card only) adds a torch.profiler table of one more dense run.
"""

from __future__ import annotations

import argparse
import json
import re
import tempfile
import time
from pathlib import Path

import numpy as np


def dense_rung_config():
    """bench.py:276-278's dense config at full size."""
    from ..dense.depth import DenseConfig
    from ..dense.patchmatch import PatchMatchConfig

    return DenseConfig(n_planes=64, n_sources=3, view_batch=2, pm=PatchMatchConfig(n_iters=3))


def gt_scale(scene, gt) -> float | None:
    """Scene units -> ground-truth units from the registered camera
    centres' spread about their means (bench.py:293-302)."""
    reg = scene.cam_mask.cpu().numpy()
    sc = scene.camera_centers().cpu().numpy()[reg]
    gc = np.asarray(gt["centers"])[reg]
    scd = sc - sc.mean(0)
    gcd = gc - gc.mean(0)
    denom = float(np.sum(scd * scd))
    return float(np.sqrt(np.sum(gcd * gcd) / denom)) if denom > 1e-12 else None


def depth_quality(depths, views, gt, scale: float) -> float | None:
    """Median over views of each view's median relative depth error
    against the renderer's depth (bench.py:221-240, unrounded)."""
    errs = []
    for v in views:
        d = np.asarray(depths[v], np.float64)
        g = np.asarray(gt["depth"][v], np.float64)
        m = np.isfinite(g) & (g > 1e-3) & np.isfinite(d) & (d > 1e-6)
        if m.sum() < 100:
            continue
        errs.append(float(np.median(np.abs(d[m] * scale - g[m]) / g[m])))
    return float(np.median(errs)) if errs else None


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_dense(scene, images, gt, *, device, seed: int = 0) -> dict:
    """The dense rung and its sweep-only variant, one timed run each after
    a warm-up of the PatchMatch config.  Returns the numbers, the PM run's
    maps and the views."""
    import dataclasses

    from ..dense.depth import dense_reconstruct

    cfg = dense_rung_config()
    reg = [int(v) for v in np.nonzero(scene.cam_mask.cpu().numpy())[0]]
    views = reg[:6]
    scale = gt_scale(scene, gt)

    def timed(c):
        timings = {}
        _sync(device)
        t0 = time.time()
        pts, cols, maps = dense_reconstruct(scene, images, None, c, views=views, seed=seed,
                                            return_maps=True, device=device, timings=timings)
        _sync(device)
        return time.time() - t0, timings, pts, maps

    dense_reconstruct(scene, images, None, cfg, views=views, seed=seed, device=device)
    wall, timings, pts, maps = timed(cfg)
    wall_sw, timings_sw, pts_sw, maps_sw = timed(dataclasses.replace(cfg, patchmatch=False))
    return {"views": views, "scale": scale, "maps": maps,
            "pm": {"seconds": wall, "views_per_s": len(views) / wall, "points": int(len(pts)),
                   "depth_med_rel_err": depth_quality(maps["depths"], views, gt, scale),
                   "stage_s": timings},
            "sweep_only": {"seconds": wall_sw, "views_per_s": len(views) / wall_sw,
                           "points": int(len(pts_sw)),
                           "depth_med_rel_err": depth_quality(maps_sw["depths"], views, gt,
                                                              scale),
                           "stage_s": timings_sw},
            "points": pts}


def run_mesh(maps, rgb, out_dir, *, device) -> dict:
    """The staged pipeline's mesh stage on the dense maps: TSDF + marching
    tetrahedra (+ vertex colours), the depth-fit and photometric refiners,
    the texture atlas, and mesh.ply; seconds per stage."""
    from ..dense import meshing, texturing
    from ..io import ply

    stage = {}
    t0 = time.time()
    verts, faces, vcols = meshing.mesh_from_depths(
        maps["depths"], maps["valid"], maps["K"], maps["R"], maps["t"], rgb_images=rgb,
        device=device, timings=stage)
    stage["mesh_from_depths"] = time.time() - t0
    args = (maps["depths"], maps["valid"], maps["K"], maps["R"], maps["t"])
    t0 = time.time()
    verts = meshing.refine_mesh(verts, faces, *args)
    stage["refine"] = time.time() - t0
    t0 = time.time()
    gray = np.asarray(rgb, np.float32).mean(axis=-1) / 255.0
    verts = meshing.refine_mesh_photometric(verts, faces, gray, maps["K"], maps["R"], maps["t"],
                                            maps["depths"], maps["valid"], device=device)
    _sync(device)
    stage["photometric"] = time.time() - t0
    t0 = time.time()
    path, ok = texturing.texture_mesh(out_dir, verts, faces, *args, rgb)
    stage["texture"] = time.time() - t0
    ply.write_ply_mesh(Path(out_dir) / "mesh.ply", verts, faces, vcols)
    return {"verts": int(len(verts)), "faces": int(len(faces)),
            "textured_share": float(ok.mean()) if len(ok) else 0.0,
            "finite": bool(np.isfinite(verts).all()), "obj": str(path), "stage_s": stage}


def op_name(name: str) -> str:
    """A profiler kernel name cut to the kernel template and the functor
    or operation it runs (PyTorch's elementwise kernels differ only
    there)."""
    base = name.removeprefix("void ").split("<")[0].split("(")[0].split("::")[-1].strip()
    ops = re.findall(r"\w*(?:Functor|_impl|_kernel|_cuda)\w*(?:<\w+>)?|OpaqueType<\d+>", name)
    ops = [o for o in dict.fromkeys(ops) if o != base and not o.startswith(("gpu_", "Binary"))]
    return base + (f" [{', '.join(ops[:2])}]" if ops else "")


def profile_dense(scene, images, views, *, device, seed: int = 0, top: int = 10) -> dict:
    """torch.profiler over one dense_reconstruct of the rung: the device
    kernels with the most time, the launch count and the busy share (device
    time over the wall time of an unprofiled run just before)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..dense.depth import dense_reconstruct
    from .profile_rung import _device_kernels

    cfg = dense_rung_config()
    _sync(device)
    t0 = time.time()
    dense_reconstruct(scene, images, None, cfg, views=views, seed=seed, device=device)
    _sync(device)
    wall = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dense_reconstruct(scene, images, None, cfg, views=views, seed=seed, device=device)
        torch.cuda.synchronize(device)
    rows = _device_kernels(prof)
    dev_ms = sum(r[2] for r in rows) / 1e3
    return {"wall_s": wall, "device_ms": dev_ms, "launches": sum(r[1] for r in rows),
            "busy_share": dev_ms / 1e3 / wall,
            "top": [(name, n, us / 1e3) for name, n, us in rows[:top]]}


def headline_inputs(height: int = 480, width: int = 640, n_views: int = 20):
    """The 20-view headline scene and run_sparse config (bench.py:693-706)."""
    from ..pipeline.config import config_from_overrides
    from ..utils.synth_render import render_orbit_images

    images, gt = render_orbit_images(n_views=n_views, img_h=height, img_w=width,
                                     focal=0.9 * width, arc_deg=110.0, seed=0)
    cfg = config_from_overrides(**{
        "sift.n_octaves": 4, "sift.max_per_octave": 1024, "sift.max_features": 1024,
        "matching.pair_chunk": 32, "filter.max_iterations": 256, "feature_batch": 10,
    })
    return images, gt, cfg


def main() -> None:
    import torch

    from ..pipeline.sparse import run_sparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--profile", action="store_true", help="also profile one dense run")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("dense_rung: no CUDA device visible to torch")
    images, gt, cfg = headline_inputs(args.height, args.width)
    scene, report = run_sparse(images, gt["intr"], cfg, device=args.device, seed=0)
    out = run_dense(scene, images, gt, device=args.device)
    rgb = np.repeat((np.clip(images, 0, 1) * 255).astype(np.uint8)[..., None], 3, -1)
    with tempfile.TemporaryDirectory(dir=Path.cwd()) as tmp:
        mesh = run_mesh(out["maps"], rgb, tmp, device=args.device)
    res = {"registered": report["n_registered"], "sparse_points": report["n_points"],
           "pm": out["pm"], "sweep_only": out["sweep_only"], "mesh": mesh}
    if args.profile:
        prof = profile_dense(scene, images, out["views"], device=args.device)
        prof["top"] = [(op_name(name), n, ms) for name, n, ms in prof["top"]]
        res["profile"] = prof
    print(json.dumps(res, default=float))


if __name__ == "__main__":
    main()
