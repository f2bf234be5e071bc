"""Stage counts of the port's front end on the reference's medium rung.

    python -m tpusfm_torch.tools.front_end_counts --views 200 --devices cuda cpu

Renders the medium rung's orbit sequence (bench.py:352-421, cut to
``--views``), runs features, matching, filtering and track building on each
device named (the card alone unless ``--devices`` names others, e.g.
``--devices cpu``), and prints one JSON line per device with the counts of
every stage (features, putative and geometric matches, pairs kept, tracks
and the track-length histogram).  Counts that differ between devices on
the same inputs locate where their numerics part.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def rung_inputs(n_views: int = 200):
    """The medium rung's images, ground truth and pipeline config
    (bench.py:379-389): 240x320, arc 120 deg, seed 2, contiguous pairs."""
    from ..pipeline.config import config_from_overrides
    from ..utils.synth_render import render_orbit_images

    images, gt = render_orbit_images(n_views=n_views, img_h=240, img_w=320, focal=0.9 * 320,
                                     arc_deg=120.0, seed=2)
    cfg = config_from_overrides(**{
        "sift.n_octaves": 3, "sift.max_per_octave": 512, "sift.max_features": 512,
        "matching.pair_mode": "contiguous", "matching.contiguous_window": 6,
        "matching.pair_chunk": 32, "filter.max_iterations": 128,
        "feature_batch": 10, "engine_type": "incremental",
    })
    return images, gt, cfg


def track_counts(n_views: int, n_feats: int, pair_list, match_idx, match_valid) -> dict:
    """Tracks built from the kept matches and their length histogram."""
    from ..sfm import tracks as tracks_mod

    track_ids, n_tracks = tracks_mod.build_tracks(n_views, n_feats, pair_list, match_idx,
                                                  match_valid)
    lengths = np.bincount(track_ids[track_ids >= 0], minlength=n_tracks)
    return {"tracks": int(n_tracks),
            "track_len": {"2": int((lengths == 2).sum()), "3": int((lengths == 3).sum()),
                          "4-6": int(((lengths >= 4) & (lengths <= 6)).sum()),
                          "7+": int((lengths >= 7).sum())}}


def front_end_counts(images, intr, cfg, *, device, seed: int = 0) -> dict:
    """Features, matches, filter and tracks of run_sparse on `device`."""
    import torch

    from ..pipeline import sparse

    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(seed)
    intr = np.asarray(intr, np.float32)
    if intr.ndim == 1:
        intr = np.tile(intr, (images.shape[0], 1))
    t0 = time.time()
    feats = sparse.detect_features(images, cfg, device=device)
    pair_list = sparse.generate_pairs(images.shape[0], cfg, feats=feats)
    match_idx, match_valid = sparse.match_pairs(feats, pair_list, cfg)
    putative = int(match_valid.sum())
    match_idx, match_valid, pair_ok = sparse.filter_pairs(
        feats, pair_list, match_idx, match_valid, cfg, gen, intr=intr,
        img_hw=images.shape[1:3])
    per_view = feats.mask.sum(1).cpu().numpy()
    out = {"device": str(device), "views": int(images.shape[0]),
           "features": int(per_view.sum()),
           "features_per_view": [int(per_view.min()), float(np.median(per_view)),
                                 int(per_view.max())],
           "pairs": int(len(pair_list)), "putative": putative,
           "geometric": int(match_valid.sum()), "pairs_kept": int(pair_ok.sum())}
    out.update(track_counts(images.shape[0], feats.mask.shape[1], pair_list[pair_ok],
                            match_idx[pair_ok], match_valid[pair_ok]))
    out["seconds"] = round(time.time() - t0, 3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=200)
    ap.add_argument("--devices", nargs="+", default=["cuda"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    images, gt, cfg = rung_inputs(args.views)
    for dev in args.devices:
        print(json.dumps(front_end_counts(images, gt["intr"], cfg, device=dev, seed=args.seed)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
