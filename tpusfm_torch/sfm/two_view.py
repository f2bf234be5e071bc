"""End-to-end two-view reconstruction.

Port of ``tpusfm/sfm/two_view.py``: SIFT on an image pair, ratio-test
matching with cross-check (``match_on_device``: kernel K1 on the card),
an 8-point essential RANSAC on normalized coordinates, pose recovery by
cheirality and DLT triangulation.  Camera 0 is the identity.
"""

from __future__ import annotations

import torch

from ..core import camera as cam
from ..core import epipolar
from ..features import sift
from ..matching import match
from . import ransac as ransac_mod


def two_view_from_features(feats: sift.Features, intr: torch.Tensor,
                           generator: torch.Generator | None = None, ransac_iters: int = 512,
                           ratio: float = 0.8, thresh_px: float = 4.0,
                           idx: torch.Tensor | None = None) -> dict:
    """The two-view chain after SIFT, on the features' device: feats of two
    views (2, N, ...), intr (7,) on that device.  idx (1, ransac_iters, 8)
    passes the RANSAC sample indices in instead of drawing them from
    `generator`.  Returns the dict of ``two_view_reconstruct`` without the
    features."""
    idx_b, valid = match.match_on_device(feats.desc[:1], feats.desc[1:2], feats.mask[:1],
                                         feats.mask[1:2], ratio=ratio)
    uv0, uv1, valid = match.gather_matched_points(feats.kp[0], feats.kp[1], idx_b[0], valid[0])
    x0n = cam.pixel_to_normal(intr, uv0)
    x1n = cam.pixel_to_normal(intr, uv1)
    f = 0.5 * (intr[0] + intr[1])
    E, inl, _ = ransac_mod.ransac(
        generator, x0n[None], x1n[None], valid[None], solver=epipolar.essential_8pt,
        scorer=epipolar.sampson_error, sample_size=8, n_iters=ransac_iters,
        inlier_thresh=(thresh_px / f).reshape(1), idx=idx)
    E, inl = E[0], inl[0]
    R, t, _, front, X = epipolar.recover_pose(E, x0n, x1n, w=inl.to(x0n.dtype))
    good = inl & front & valid
    return {"R": R, "t": t, "E": E, "points": X, "uv0": uv0, "uv1": uv1, "match_idx": idx_b[0],
            "inliers": good, "n_inliers": torch.sum(good), "n_matches": torch.sum(valid)}


def two_view_reconstruct(images, intr, generator: torch.Generator | None = None,
                         sift_cfg: sift.SiftConfig = sift.SiftConfig(), ransac_iters: int = 512,
                         ratio: float = 0.8, thresh_px: float = 4.0, *, device,
                         seed: int = 0) -> dict:
    """images (2, H, W) float32 in [0, 1] or uint8, intr (7,) shared
    intrinsics (arrays or tensors).  Random draws come from `generator` (a torch.Generator on
    `device`, made from `seed` when none is given).  Returns a dict with
    the relative pose R, t, the essential matrix E, the triangulated
    points, the matched pixel coordinates uv0/uv1, match_idx, the inlier
    mask (RANSAC inliers in front of both cameras), n_inliers, n_matches
    and the features, all on `device`.  Turns TF32 off, as run_sparse
    does."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    feats = sift.detect_and_describe(torch.as_tensor(images, device=device), sift_cfg)
    intr = torch.as_tensor(intr, dtype=torch.float32, device=device)
    out = two_view_from_features(feats, intr, generator, ransac_iters, ratio, thresh_px)
    out["features"] = feats
    return out
