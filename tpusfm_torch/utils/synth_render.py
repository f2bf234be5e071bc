"""Synthetic image rendering for the port's tests and its GPU smoke run.

Port of ``tpusfm/utils/synth_render.py`` (host numpy + OpenCV, unchanged):
a textured "corner room" of three orthogonal quads seen from an orbiting
camera, with exact ground-truth poses.  Kept in the port so that nothing
here needs the JAX package; OpenCV is imported only when rendering.
"""

from __future__ import annotations

import numpy as np


def _multiscale_texture(size: int, seed: int) -> np.ndarray:
    """Distinctive smooth random texture in [0,1]: sum of band-passed noise."""
    import cv2

    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    for s, w in ((4, 0.2), (8, 0.35), (16, 0.5), (32, 0.7), (64, 1.0)):
        n = rng.normal(size=(s, s)).astype(np.float32)
        tex += w * cv2.resize(n, (size, size), interpolation=cv2.INTER_CUBIC)
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-9)
    return tex


def _orbit_poses(n_views, radius, arc_deg, height_amp=0.5):
    angles = np.radians(np.linspace(0, arc_deg, n_views))
    centers = np.stack(
        [radius * np.sin(angles), height_amp * np.sin(2 * angles), -radius * np.cos(angles)],
        axis=1,
    )
    Rs, ts = [], []
    for c in centers:
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=0)
        Rs.append(R)
        ts.append(-R @ c)
    return np.asarray(Rs, np.float32), np.asarray(ts, np.float32), centers.astype(np.float32)


def render_orbit_images(
    n_views: int = 20,
    img_h: int = 480,
    img_w: int = 640,
    focal: float = 600.0,
    radius: float = 8.0,
    arc_deg: float = 120.0,
    seed: int = 0,
    tex_size: int = 512,
    n_dots: int | None = None,  # kept for API compat; unused
):
    """Returns (images (V, H, W) float32 in [0,1], gt dict with
    intr (7,), R (V,3,3), t (V,3), centers (V,3))."""
    del n_dots
    import cv2
    R, t, centers = _orbit_poses(n_views, radius, arc_deg)
    intr = np.array([focal, focal, img_w / 2, img_h / 2, 0, 0, 0], np.float32)
    K = np.array([[focal, 0, img_w / 2], [0, focal, img_h / 2], [0, 0, 1]], np.float64)

    # Three orthogonal quads forming a corner around the origin, each a
    # (origin, U-axis, V-axis) frame with its own texture.
    e = 2.2  # half extent
    planes = [
        # back-left wall (normal +x side)
        dict(O=np.array([-e, -e, -e]), U=np.array([0, 0, 2 * e]), Vv=np.array([0, 2 * e, 0])),
        # back-right wall (normal +z side)
        dict(O=np.array([-e, -e, e]), U=np.array([2 * e, 0, 0]), Vv=np.array([0, 2 * e, 0])),
        # floor
        dict(O=np.array([-e, -e, -e]), U=np.array([2 * e, 0, 0]), Vv=np.array([0, 0, 2 * e])),
    ]
    for i, p in enumerate(planes):
        p["tex"] = _multiscale_texture(tex_size, seed + 7 * i)

    tex_corners = np.array(
        [[0, 0], [tex_size - 1, 0], [0, tex_size - 1], [tex_size - 1, tex_size - 1]],
        np.float32,
    )

    xs, ys = np.meshgrid(np.arange(img_w), np.arange(img_h))
    pix_h = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float64)  # (H, W, 3)

    images = np.full((n_views, img_h, img_w), 0.5, np.float32)
    depth = np.full((n_views, img_h, img_w), np.inf, np.float64)
    for v in range(n_views):
        P = K @ np.hstack([R[v], t[v][:, None]]).astype(np.float64)
        for p in planes:
            corners3d = np.stack(
                [p["O"], p["O"] + p["U"], p["O"] + p["Vv"], p["O"] + p["U"] + p["Vv"]]
            )
            proj = (P @ np.hstack([corners3d, np.ones((4, 1))]).T).T
            if np.any(proj[:, 2] <= 0.1):
                continue
            img_quad = (proj[:, :2] / proj[:, 2:3]).astype(np.float32)
            H = cv2.getPerspectiveTransform(tex_corners, img_quad)
            warped = cv2.warpPerspective(
                p["tex"], H, (img_w, img_h), flags=cv2.INTER_LINEAR,
                borderMode=cv2.BORDER_CONSTANT, borderValue=-1.0,
            )
            valid = warped >= 0
            if not valid.any():
                continue
            # Per-pixel depth: invert H to texture coords -> 3D -> camera z.
            Hinv = np.linalg.inv(H)
            uvw = pix_h @ Hinv.T
            uu = uvw[..., 0] / uvw[..., 2] / (tex_size - 1)
            vv = uvw[..., 1] / uvw[..., 2] / (tex_size - 1)
            X3 = (
                p["O"][None, None]
                + uu[..., None] * p["U"][None, None]
                + vv[..., None] * p["Vv"][None, None]
            )
            z = X3 @ R[v][2].astype(np.float64) + t[v][2]
            closer = valid & (z > 0.1) & (z < depth[v])
            images[v][closer] = warped[closer]
            depth[v][closer] = z[closer]
    images = np.clip(images, 0.0, 1.0)
    return images, dict(intr=intr, R=R, t=t, centers=centers, depth=depth.astype(np.float32))
