"""Self-calibration on the medium rung (bench.py:379-389, cut to --views):
one intrinsic group, every RADIAL3 lane refined, the focal started at
--focal-start times the truth.  Runs the JAX reference's run_sparse on the
CPU (--impl reference) or the PyTorch port's (--impl port, on --device)
and prints one JSON line: registered views, points, ATE, the refined
intrinsics and the focal's relative error.  --engine picks the engine
(incremental, global or stellar); --held holds the true intrinsics (no
intrinsic group, nothing refined).

Usage: JAX_PLATFORMS=cpu python scripts/selfcal_rung.py --views 60 --focal-start 1.02
       python scripts/selfcal_rung.py --impl port --views 200 --focal-start 1.0
       JAX_PLATFORMS=cpu python scripts/selfcal_rung.py --views 200 --engine global --held
"""
import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("reference", "port"), default="reference")
    ap.add_argument("--views", type=int, default=60)
    ap.add_argument("--focal-start", type=float, default=1.02)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--engine", choices=("incremental", "global", "stellar"),
                    default="incremental")
    ap.add_argument("--held", action="store_true",
                    help="hold the true intrinsics (no group, --focal-start ignored)")
    args = ap.parse_args()
    import numpy as np

    from tpusfm_torch.tools.front_end_counts import rung_inputs
    from tpusfm_torch.utils import metrics

    images, gt, cfg = rung_inputs(args.views)
    intr = np.tile(np.asarray(gt["intr"], np.float32), (args.views, 1))
    group = None
    if not args.held:
        intr[:, :2] *= args.focal_start
        group = np.zeros(args.views, np.int32)
    cfg = dataclasses.replace(cfg, engine_type=args.engine)
    t0 = time.time()
    if args.impl == "reference":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from tpusfm.pipeline.config import config_from_overrides
        from tpusfm.pipeline.sparse import run_sparse

        jcfg = config_from_overrides(**{
            "sift.n_octaves": 3, "sift.max_per_octave": 512, "sift.max_features": 512,
            "matching.pair_mode": "contiguous", "matching.contiguous_window": 6,
            "matching.pair_chunk": 32, "filter.max_iterations": 128,
            "feature_batch": 10, "engine_type": args.engine})
        scene, report = run_sparse(images, intr, jcfg, key=jax.random.PRNGKey(0),
                                   cam_group=group)
        reg = np.asarray(scene.cam_mask)
        centers, f = np.asarray(scene.camera_centers()), np.asarray(scene.intr)
    else:
        from tpusfm_torch.pipeline.sparse import run_sparse

        scene, report = run_sparse(images, intr, cfg, device=args.device, seed=0,
                                   cam_group=group)
        reg = scene.cam_mask.cpu().numpy()
        centers, f = scene.camera_centers().cpu().numpy(), scene.intr.cpu().numpy()
    f = f[reg][0]
    print(json.dumps({
        "impl": args.impl, "engine": args.engine, "views": args.views,
        "focal_start": None if args.held else args.focal_start,
        "registered": int(reg.sum()), "points": int(report["n_points"]),
        "ate": float(metrics.ate_rmse(centers[reg], gt["centers"][reg])),
        "rel_err_fx": float(f[0] / gt["intr"][0] - 1),
        "rel_err_fy": float(f[1] / gt["intr"][1] - 1),
        "intr": [float(v) for v in f], "seconds": round(time.time() - t0, 1),
        "times_s": report["times_s"], "recon_phase_s": report["recon_phase_s"],
        "log_tail": report["engine_log"][-3:]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
