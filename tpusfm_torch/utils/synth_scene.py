"""Synthetic orbit scene with known ground truth, without jax.

A copy of the reference test helper ``tests/synth.py:orbit_scene`` (same
arguments, same random stream, same arrays), so that programs of the port
that must run where jax is absent, such as ``chip_smoke.py``, can build the
reference's bundle-adjustment problems.  The axis-angle column comes from
the port's ``so3_log`` in float32.  ``point_sorted_ba_problem`` builds the
reference bench's BA problem from it (``bench.py:171-202``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import lie


def orbit_scene(
    n_cams: int = 20,
    n_points: int = 500,
    radius: float = 6.0,
    arc_deg: float = 120.0,
    noise_px: float = 0.0,
    seed: int = 0,
    img_w: int = 640,
    img_h: int = 480,
    focal: float = 800.0,
    min_track_len: int = 2,
    vis_prob: float = 0.85,
    k1: float = 0.0,
    k2: float = 0.0,
    k3: float = 0.0,
):
    """Cameras orbit a point cloud at the origin.

    Returns a dict of numpy arrays: intr (7,), R (C,3,3), t (C,3), aa (C,3),
    centers, points (P,3), point_valid (P,), and the observation table
    (obs_cam, obs_pt, obs_uv) of the points visible in each camera (in
    front, in frame, and kept with probability vis_prob), camera-major."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1.5, -1.5, -1.5], [1.5, 1.5, 1.5], size=(n_points, 3))
    intr = np.array([focal, focal, img_w / 2, img_h / 2, k1, k2, k3], np.float32)

    angles = np.radians(np.linspace(0, arc_deg, n_cams))
    centers = np.stack(
        [radius * np.sin(angles), 0.3 * np.sin(2 * angles), -radius * np.cos(angles)],
        axis=1,
    )
    Rs, ts = [], []
    for c in centers:
        z = -c / np.linalg.norm(c)  # look at the origin, y roughly down
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=0)  # world -> camera rows
        Rs.append(R)
        ts.append(-R @ c)
    R = np.asarray(Rs, np.float32)
    t = np.asarray(ts, np.float32)

    obs_cam, obs_pt, obs_uv = [], [], []
    for ci in range(n_cams):
        Xc = X @ R[ci].T + t[ci]
        z = Xc[:, 2]
        xn = Xc[:, :2] / z[:, None]
        r2 = np.sum(xn * xn, axis=-1, keepdims=True)
        xn = xn * (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        uv = xn * focal + np.array([img_w / 2, img_h / 2])
        vis = (
            (z > 0.5)
            & (uv[:, 0] >= 0) & (uv[:, 0] < img_w)
            & (uv[:, 1] >= 0) & (uv[:, 1] < img_h)
            & (rng.random(n_points) < vis_prob)
        )
        idx = np.nonzero(vis)[0]
        obs_cam.append(np.full(len(idx), ci, np.int32))
        obs_pt.append(idx.astype(np.int32))
        obs_uv.append(uv[idx] + rng.normal(scale=noise_px, size=(len(idx), 2)))
    obs_cam = np.concatenate(obs_cam)
    obs_pt = np.concatenate(obs_pt)
    obs_uv = np.concatenate(obs_uv).astype(np.float32)

    # Drop points with too-short tracks.
    counts = np.bincount(obs_pt, minlength=n_points)
    keep_pt = counts >= min_track_len
    keep_obs = keep_pt[obs_pt]
    return dict(
        intr=intr,
        R=R,
        t=t,
        aa=lie.so3_log(torch.from_numpy(R)).numpy(),
        centers=centers.astype(np.float32),
        points=X.astype(np.float32),
        point_valid=keep_pt,
        obs_cam=obs_cam[keep_obs],
        obs_pt=obs_pt[keep_obs],
        obs_uv=obs_uv[keep_obs],
        img_w=img_w,
        img_h=img_h,
    )


def point_sorted(prob: dict) -> dict:
    """A bundle_adjust argument dict (numpy) with the table sorted by point
    and the observed points relabelled 0..k-1 in order (unobserved points
    trail), as ``BAConfig.assume_sorted`` requires."""
    n_points = len(prob["points"])
    obs_pt = prob["obs_pt"]
    observed = np.zeros(n_points, bool)
    observed[obs_pt] = True
    new_of = np.empty(n_points, np.int64)
    new_of[observed] = np.arange(observed.sum())
    new_of[~observed] = observed.sum() + np.arange((~observed).sum())
    perm = np.argsort(new_of)
    order = np.argsort(new_of[obs_pt], kind="stable")
    out = dict(prob, points=prob["points"][perm], point_mask=prob["point_mask"][perm],
               obs_pt=new_of[obs_pt][order].astype(np.int32))
    for k in ("obs_cam", "obs_uv", "obs_mask"):
        out[k] = prob[k][order]
    return out


def point_sorted_ba_problem(n_cams: int, n_points: int, seed: int = 3, arc_deg: float = 350.0,
                            vis_prob: float = 0.06, noise_px: float = 0.5,
                            perturb: float = 0.01) -> dict:
    """The reference bench's BA problem (``bench.py:171-202``): an orbit
    scene with poses perturbed by `perturb` and points by 2 * perturb
    (numpy seed 0), point-sorted (``point_sorted``).  Returns the numpy
    arguments of ``bundle_adjust``."""
    s = orbit_scene(n_cams=n_cams, n_points=n_points, noise_px=noise_px, seed=seed,
                    arc_deg=arc_deg, vis_prob=vis_prob)
    r = np.random.default_rng(0)
    return point_sorted(dict(
        intr=np.tile(s["intr"], (n_cams, 1)),
        cam_rot=(s["aa"] + r.normal(scale=perturb, size=(n_cams, 3))).astype(np.float32),
        cam_t=(s["t"] + r.normal(scale=perturb, size=(n_cams, 3))).astype(np.float32),
        cam_mask=np.ones(n_cams, bool),
        points=(s["points"] + r.normal(scale=2 * perturb, size=(n_points, 3)))
        .astype(np.float32),
        point_mask=s["point_valid"],
        obs_cam=s["obs_cam"],
        obs_pt=s["obs_pt"],
        obs_uv=s["obs_uv"],
        obs_mask=np.ones(len(s["obs_cam"]), bool),
    ))
