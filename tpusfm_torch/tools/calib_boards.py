"""Synthetic chessboard views with known intrinsics (host OpenCV).

The renderer of the reference's calibration test
(tests/test_calibration.py:13-48), carried here so that the port can
render the same boards where the JAX package is absent: checkerboards
warped through K [r1 r2 t] with cv2.warpPerspective, poses drawn from
`seed`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import lie


def render_board_views(n_views=6, pattern=(9, 6), img=(480, 640),
                       fx=600.0, fy=590.0, cx=325.0, cy=245.0, k1=-0.05, seed=0):
    """Returns (images (n_views, H, W) uint8, K_true (3, 3)).  k1 is not
    applied (the warp is a pure homography)."""
    import cv2

    del k1
    rng = np.random.default_rng(seed)
    cols, rows = pattern
    sq = 40
    board = np.zeros(((rows + 1) * sq, (cols + 1) * sq), np.uint8)
    for r in range(rows + 1):
        for c in range(cols + 1):
            if (r + c) % 2 == 0:
                board[r * sq: (r + 1) * sq, c * sq: (c + 1) * sq] = 255
    board = np.pad(board, sq, constant_values=128)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    images = []
    h, w = img
    for _ in range(n_views):
        aa = rng.normal(scale=0.25, size=3) * np.array([1, 1, 0.5])
        R = lie.so3_exp(torch.as_tensor(aa, dtype=torch.float32)).numpy()
        t = np.array([rng.normal(0, 0.6), rng.normal(0, 0.4), rng.uniform(9, 13)])
        Hplane = K @ np.column_stack([R[:, 0], R[:, 1], t])
        # Board pixel -> plane coordinates centred on the inner-corner grid
        # (corner (0, 0) sits at board pixel (2 sq, 2 sq)).
        ccx, ccy = (cols - 1) / 2.0, (rows - 1) / 2.0
        S = np.array([[1.0 / sq, 0, -2.0 - ccx], [0, 1.0 / sq, -2.0 - ccy], [0, 0, 1]])
        warped = cv2.warpPerspective(board, (Hplane @ S).astype(np.float64), (w, h),
                                     flags=cv2.INTER_LINEAR, borderValue=90)
        images.append(warped)
    return np.stack(images), K
