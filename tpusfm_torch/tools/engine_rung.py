"""The global or stellar engine over the medium rung, alone in a fresh process.

    python -m tpusfm_torch.tools.engine_rung --engine global [--repeats 3]
    python -m tpusfm_torch.tools.engine_rung --engine stellar --self-calibrate

Renders the medium rung (bench.py:379-389, cut to ``--views``; see
``front_end_counts.rung_inputs``), then runs ``run_sparse`` with
``engine_type`` = ``--engine`` ``--repeats`` times in this process: the
intrinsics held, or with ``--self-calibrate`` one intrinsic group refined
from ``--focal-start`` times the true focal.  Prints one JSON line per run:
registered views, ATE (similarity-aligned), points, the refined focal's
relative errors, stage and engine-phase seconds, BA solves by kind and
shape, the wall time and, on the card, the kernel launches of the run.
``chip_smoke.py`` runs the same rungs and holds them to the bars set from
the reference's run (``scripts/selfcal_rung.py --engine ...``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def engine_args(gt, cfg, engine: str, self_calibrate: bool, focal_start: float = 1.0):
    """The medium rung's config with engine_type = `engine`, and
    run_sparse's intrinsics and intrinsic groups (None when held), for the
    ground truth and config of ``rung_inputs``."""
    n_views = len(gt["centers"])
    cfg = dataclasses.replace(cfg, engine_type=engine)
    intr = np.tile(np.asarray(gt["intr"], np.float32), (n_views, 1))
    group = None
    if self_calibrate:
        intr[:, :2] *= focal_start
        group = np.zeros(n_views, np.int32)
    return cfg, intr, group


def engine_summary(scene, report, gt) -> dict:
    """Registered views, ATE, points, the refined focal's relative errors,
    finite geometry, and the report's stage and engine-phase seconds and
    BA solves."""
    from ..utils import metrics

    reg = scene.cam_mask.cpu().numpy()
    centers = scene.camera_centers().cpu().numpy()[reg]
    pts = scene.points[scene.point_mask].cpu().numpy()
    f = scene.intr.cpu().numpy()[reg][0] if reg.any() else np.full(7, np.nan)
    return {"registered": int(reg.sum()), "views": int(len(reg)),
            "ate": float(metrics.ate_rmse(centers, gt["centers"][reg])) if reg.sum() >= 3
            else float("nan"),
            "points": int(report["n_points"]), "n_obs": int(report["n_obs"]),
            "fx_err": float(f[0] / gt["intr"][0] - 1), "fy_err": float(f[1] / gt["intr"][1] - 1),
            "finite": bool(np.isfinite(pts).all() and np.isfinite(centers).all()),
            "times_s": report["times_s"], "recon_phase_s": report["recon_phase_s"],
            "ba_solves": report["ba_solves"], "engine_log": report["engine_log"]}


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=("global", "stellar"), required=True)
    ap.add_argument("--self-calibrate", action="store_true")
    ap.add_argument("--focal-start", type=float, default=1.0)
    ap.add_argument("--views", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from ..ops import obs_table as ot
    from ..ops import topk2_match as k1
    from ..pipeline.sparse import run_sparse
    from .front_end_counts import rung_inputs

    dev = torch.device(args.device)
    images, gt, cfg = rung_inputs(args.views)
    cfg, intr, group = engine_args(gt, cfg, args.engine, args.self_calibrate, args.focal_start)
    for rep in range(args.repeats):
        for launches in (k1.LAUNCHES, ot.LAUNCHES):
            for name in launches:
                launches[name] = 0
        t0 = time.time()
        scene, report = run_sparse(images, intr, cfg, device=dev, seed=0, cam_group=group)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out = {"engine": args.engine, "self_calibrate": args.self_calibrate, "repeat": rep,
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
               **engine_summary(scene, report, gt), "wall_s": time.time() - t0}
        if dev.type == "cuda":
            out["launches"] = {"topk2_match bf16": k1.LAUNCHES["quantized"],
                               "topk2_match f32": k1.LAUNCHES["f32"], **ot.LAUNCHES}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
