"""The reference's 1000-view pod rung through the port's ``run_sparse``.

    python -m tpusfm_torch.tools.pod_rung [--views 1000] [--device cuda]

Renders the pod rung's multi-loop orbit (bench.py:481-491: 240x320, focal
0.9 x 320, an arc of 0.6 degrees a view, seed 5), runs ``run_sparse`` once
with the reference's overrides (bench.py:492-502: contiguous window 8 plus
loop-closure retrieval, top 5) and prints one JSON line: registered views,
ATE (similarity-aligned over the registered centres), points, observations,
the pair counts (contiguous, loop pairs proposed and kept by the geometric
filter), stage and engine-phase seconds, BA solves by kind and, on the
card, the kernel launches of the run.  ``chip_smoke.py`` runs the same
rung and holds it to its bars.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import Counter

import numpy as np


def pod_inputs(n_views: int = 1000):
    """The pod rung's images, ground truth and pipeline config, uncut at
    1000 views."""
    from ..pipeline.config import config_from_overrides
    from ..utils.synth_render import render_orbit_images

    images, gt = render_orbit_images(n_views=n_views, img_h=240, img_w=320, focal=0.9 * 320,
                                     arc_deg=0.6 * n_views, seed=5)
    cfg = config_from_overrides(**{
        "sift.n_octaves": 3, "sift.max_per_octave": 512, "sift.max_features": 512,
        "matching.pair_mode": "contiguous", "matching.contiguous_window": 8,
        "matching.loop_closure": True, "matching.loop_top_k": 5,
        "matching.pair_chunk": 32, "filter.max_iterations": 128,
        "feature_batch": 10, "engine_type": "incremental",
    })
    return images, gt, cfg


def pod_summary(scene, report, gt, window: int) -> dict:
    """Quality and pair counts of one run: loop pairs are those more than
    2 * window views apart (retrieval excludes the rest); local step-BAs
    counted by their camera bucket."""
    from ..utils import metrics

    reg = scene.cam_mask.cpu().numpy()
    centers = scene.camera_centers().cpu().numpy()[reg]
    ate = metrics.ate_rmse(centers, gt["centers"][reg]) if reg.sum() >= 3 else float("nan")
    pts = scene.points[scene.point_mask].cpu().numpy()
    pl, ok = report["pair_list"], report["pair_ok"]
    loop = (pl[:, 1] - pl[:, 0]) > 2 * window
    kinds, local_cams = Counter(), Counter()
    for key, n in report["ba_solves"].items():  # "kind CxPxO"
        kind, shape = key.split()
        kinds[kind] += n
        if kind == "local":
            local_cams[int(shape.split("x")[0])] += n
    n_step = kinds["step"] + kinds["local"]
    return {"registered": int(reg.sum()), "n_views": int(report["n_views"]),
            "ate": float(ate), "points": int(report["n_points"]), "n_obs": int(report["n_obs"]),
            "finite": bool(np.isfinite(pts).all() and np.isfinite(centers).all()),
            "pairs": {"contiguous": int((~loop).sum()), "loop_proposed": int(loop.sum()),
                      "loop_kept": int((loop & ok).sum()), "kept": int(ok.sum())},
            "ba_solves": report["ba_solves"],
            "local_step_ba_share": kinds["local"] / max(n_step, 1),
            "local_ba_cams": dict(sorted(local_cams.items())),
            "times_s": report["times_s"], "recon_phase_s": report["recon_phase_s"]}


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from ..ops import obs_table as ot
    from ..ops import topk2_match as k1
    from ..pipeline.sparse import run_sparse

    images, gt, cfg = pod_inputs(args.views)
    for launches in (k1.LAUNCHES, ot.LAUNCHES):
        for name in launches:
            launches[name] = 0
    t0 = time.time()
    scene, report = run_sparse(images, gt["intr"], cfg, device=args.device, seed=0)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    out = pod_summary(scene, report, gt, cfg.matching.contiguous_window)
    out["wall_s"] = time.time() - t0
    out["launches"] = {"topk2_match bf16": k1.LAUNCHES["quantized"],
                       "topk2_match f32": k1.LAUNCHES["f32"], **ot.LAUNCHES}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
