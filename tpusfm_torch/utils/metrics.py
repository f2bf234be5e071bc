"""Evaluation metrics: similarity alignment and trajectory error.

Port of ``tpusfm/utils/metrics.py`` (host numpy).  Reconstruction is defined up to a similarity transform, so
trajectories are Umeyama-aligned before the error is taken.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform mapping src -> dst (N, 3 each).
    Returns (s, R, t) with dst ~ s * R @ src + t."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(S) @ D) / max(var_s, 1e-18))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE of camera centers) after similarity
    alignment — the headline quality metric (BASELINE.md)."""
    s, R, t = umeyama_alignment(est_centers, gt_centers, with_scale)
    aligned = (s * (R @ np.asarray(est_centers, np.float64).T)).T + t
    err = aligned - gt_centers
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rotation_error_deg(R_est: np.ndarray, R_gt: np.ndarray) -> np.ndarray:
    """Per-camera geodesic rotation error in degrees, gauge-free: each
    rotation is taken relative to camera 0's in both sets."""
    R_est = np.asarray(R_est, np.float64)
    R_gt = np.asarray(R_gt, np.float64)
    rel_est = np.einsum("nij,kj->nik", R_est, R_est[0])
    rel_gt = np.einsum("nij,kj->nik", R_gt, R_gt[0])
    dR = np.einsum("nij,nkj->nik", rel_est, rel_gt)
    tr = np.clip((np.trace(dR, axis1=1, axis2=2) - 1.0) * 0.5, -1.0, 1.0)
    return np.degrees(np.arccos(tr))
