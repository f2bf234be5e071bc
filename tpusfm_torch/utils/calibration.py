"""Chessboard camera calibration.

Port of ``tpusfm/utils/calibration.py`` (``calibrateCameraFromImages``
parity: findChessboardCorners -> cornerSubPix -> cv::calibrateCamera).
Corner detection stays a host OpenCV call, as in the reference; the solve
is Zhang's closed-form initialization from per-view homographies
(``core.homography.homography_dlt``) followed by a joint Gauss-Newton
refinement of shared intrinsics [fx, fy, cx, cy, k1, k2] and per-view
poses on the device given, with no host read between its steps.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import homography, lie


def board_points(cols: int, rows: int, square_size: float = 1.0) -> np.ndarray:
    """Inner-corner grid on the z=0 plane, row-major (OpenCV ordering)."""
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    return np.stack([xs.ravel(), ys.ravel(), np.zeros(cols * rows)], 1).astype(np.float64) * square_size


def find_chessboard_corners(images, pattern=(9, 6)):
    """Detect inner corners in each image (host OpenCV, subpixel refined).
    Returns a list with an (N, 2) float32 array or None per image."""
    import cv2

    out = []
    for img in np.asarray(images):
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        ok, corners = cv2.findChessboardCorners(img, pattern)
        if not ok:
            out.append(None)
            continue
        corners = cv2.cornerSubPix(
            img, corners, (5, 5), (-1, -1),
            (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3),
        )
        out.append(corners.reshape(-1, 2).astype(np.float32))
    return out


def _intrinsics_from_homographies(Hs: np.ndarray) -> np.ndarray:
    """Zhang's method: each H gives two constraints on B = K^-T K^-1."""
    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    rows = []
    for H in Hs:
        rows.append(v(H, 0, 1))
        rows.append(v(H, 0, 0) - v(H, 1, 1))
    A = np.asarray(rows)
    _, _, Vt = np.linalg.svd(A)
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return np.array([fx, fy, cx, cy], np.float64)


def _pose_from_homography(H: np.ndarray, K: np.ndarray):
    """Extrinsics for a z=0 plane view: H = K [r1 r2 t]."""
    M = np.linalg.inv(K) @ H
    s = 1.0 / np.linalg.norm(M[:, 0])
    if M[2, 2] * s < 0:  # board in front of camera
        s = -s
    r1 = M[:, 0] * s
    r2 = M[:, 1] * s
    t = M[:, 2] * s
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1, 1, -1]) @ Vt
    return R, t


def _residuals(p: torch.Tensor, X: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Reprojection residuals (V * N * 2,) of params p = [fx fy cx cy k1 k2]
    + 6 per view (axis-angle, translation) for board points X (N, 3)."""
    intr = p[:6]
    pose = p[6:].reshape(-1, 6)
    Xc = lie.rotate_aa(pose[:, None, :3], X[None]) + pose[:, None, 3:6]
    z = Xc[..., 2:3]
    xn = Xc[..., :2] / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    r2 = torch.sum(xn * xn, -1, keepdim=True)
    scale = 1.0 + r2 * (intr[4] + r2 * intr[5])
    proj = xn * scale * intr[:2] + intr[2:4]
    return (proj - uv).reshape(-1)


def calibrate_camera(corner_lists, pattern=(9, 6), square_size: float = 1.0,
                     image_size=None, refine_steps: int = 30, *, device="cuda"):
    """Calibrate from detected corners (list over views; None entries are
    skipped) on `device`.  Returns (intr (7,) [fx,fy,cx,cy,k1,k2,0],
    rms_px, n_views)."""
    del image_size
    dev = torch.device(device)
    obj = board_points(*pattern, square_size)  # (N, 3)
    views = [c for c in corner_lists if c is not None]
    if len(views) < 3:
        raise ValueError(f"need >= 3 chessboard views, got {len(views)}")

    # Closed-form init from homographies (one batched DLT over the views).
    uv = torch.as_tensor(np.stack(views).astype(np.float32), device=dev)  # (V, N, 2)
    V = uv.shape[0]
    board = torch.as_tensor(obj[:, :2].astype(np.float32), device=dev)
    Hs = homography.homography_dlt(board.expand(V, -1, -1), uv).cpu().numpy()
    Hs = Hs / Hs[:, 2:3, 2:3]
    fx, fy, cx, cy = _intrinsics_from_homographies(Hs)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    poses = [_pose_from_homography(H, K) for H in Hs]

    # Joint GN refinement: shared [fx fy cx cy k1 k2] + 6 per view.
    aa0 = lie.so3_log(torch.as_tensor(np.stack([R for R, _ in poses]).astype(np.float32)))
    t0 = np.stack([t for _, t in poses])
    p = torch.as_tensor(np.concatenate(
        [[fx, fy, cx, cy, 0.0, 0.0], np.concatenate([aa0.numpy(), t0], 1).ravel()]
    ).astype(np.float32), device=dev)
    X = torch.as_tensor(obj.astype(np.float32), device=dev)

    def res(q):
        return _residuals(q, X, uv)

    jac = torch.func.jacfwd(res)
    eye = 1e-6 * torch.eye(p.shape[0], dtype=p.dtype, device=dev)
    for _ in range(refine_steps):
        r = res(p)
        J = jac(p)
        dp = torch.linalg.solve(J.T @ J + eye, J.T @ r)
        p_new = p - dp
        # Accept a step only if it is not worse (no host read).
        better = torch.sum(res(p_new) ** 2) <= torch.sum(r ** 2)
        p = torch.where(better, p_new, p)
    rms = torch.sqrt(torch.mean(res(p) ** 2))
    p = p.cpu().numpy()
    intr = np.array([p[0], p[1], p[2], p[3], p[4], p[5], 0.0], np.float32)
    return intr, float(rms), V


def calibrate_camera_from_images(images, pattern=(9, 6), square_size: float = 1.0, *,
                                 device="cuda"):
    """End-to-end parity with common.h:74-139: images -> intrinsics."""
    corners = find_chessboard_corners(images, pattern)
    return calibrate_camera(corners, pattern, square_size, device=device)
