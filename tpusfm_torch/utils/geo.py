"""GPS priors and geo-registration (port of ``tpusfm/utils/geo.py``).

The EXIF GPS fixes that ``io.images`` reads (``ImageRecord.gps``) become a
similarity transform that places the reconstruction in a metric local
frame (east/north/up around the first fix), and soft camera-centre priors
for one more bundle adjustment.  The geodesy is host numpy, as in the
reference; the scene stays on its device and the prior BA runs there (at
more than 64 cameras through the kernel path: K2 held, K3, K4).
"""

from __future__ import annotations

import numpy as np
import torch

WGS84_A = 6378137.0
WGS84_E2 = 6.69437999014e-3


def lla_to_ecef(lat_deg, lon_deg, alt):
    lat = np.radians(np.asarray(lat_deg, np.float64))
    lon = np.radians(np.asarray(lon_deg, np.float64))
    alt = np.asarray(alt, np.float64)
    n = WGS84_A / np.sqrt(1 - WGS84_E2 * np.sin(lat) ** 2)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = (n * (1 - WGS84_E2) + alt) * np.sin(lat)
    return np.stack([x, y, z], axis=-1)


def lla_to_enu(lat_deg, lon_deg, alt, ref_lla):
    """Geodetic -> local east/north/up around ref_lla (lat, lon, alt)."""
    ecef = lla_to_ecef(lat_deg, lon_deg, alt)
    ref = lla_to_ecef(*ref_lla)
    lat0 = np.radians(ref_lla[0])
    lon0 = np.radians(ref_lla[1])
    R = np.array([
        [-np.sin(lon0), np.cos(lon0), 0],
        [-np.sin(lat0) * np.cos(lon0), -np.sin(lat0) * np.sin(lon0), np.cos(lat0)],
        [np.cos(lat0) * np.cos(lon0), np.cos(lat0) * np.sin(lon0), np.sin(lat0)],
    ])
    return (ecef - ref) @ R.T


def _gps_enu(scene, gps_list):
    """The registered views with a fix, the first such fix, and their ENU
    positions around it."""
    reg = scene.cam_mask.cpu().numpy()
    have = [i for i, g in enumerate(gps_list) if g is not None and reg[i]]
    if not have:
        return have, None, None
    ref = gps_list[have[0]]
    enu = lla_to_enu([gps_list[i][0] for i in have], [gps_list[i][1] for i in have],
                     [gps_list[i][2] for i in have], ref)
    return have, ref, enu


def _rms(scene, have, enu) -> float:
    resid = scene.camera_centers().cpu().numpy()[have] - enu
    return float(np.sqrt((resid ** 2).sum(axis=1).mean()))


def georegister_scene(scene, gps_list):
    """Similarity-align a reconstruction to GPS camera positions.

    gps_list: per-view (lat, lon, alt) or None.  Needs >= 3 registered views
    with GPS.  Returns (scene aligned into the local ENU metric frame, info
    dict); raises ValueError with too few fixes."""
    from ..core import lie
    from .metrics import umeyama_alignment

    have, ref, enu = _gps_enu(scene, gps_list)
    if len(have) < 3:
        raise ValueError(f"geo-registration needs >= 3 GPS views, got {len(have)}")
    dev = scene.points.device
    centers = scene.camera_centers().cpu().numpy()[have]
    s, R, t = umeyama_alignment(centers, enu, with_scale=True)

    # x' = s R x + t for points; for poses x_cam = (R_c R^T / s) x' + ...,
    # kept at metric depth by scaling t_c by s.
    pts = scene.points.cpu().numpy() @ (s * R).T + t
    R_cams = scene.rotations().cpu().numpy()
    R_new = np.einsum("vij,kj->vik", R_cams, R)
    t_new = scene.cam_t.cpu().numpy() * s - np.einsum("vij,j->vi", R_new, t)
    aa_new = lie.so3_log(torch.as_tensor(R_new.astype(np.float32)))
    out = scene.replace(
        points=torch.as_tensor(pts.astype(np.float32), device=dev),
        cam_rot=aa_new.to(dev),
        cam_t=torch.as_tensor(t_new.astype(np.float32), device=dev),
    )
    return out, {
        "n_gps": len(have),
        "scale": float(s),
        "rms_m": _rms(out, have, enu),
        "ref_lla": tuple(ref),
    }


def gps_prior_ba(scene, gps_list, sigma_m: float = 3.0, max_iters: int = 60):
    """GPS as soft priors during bundle adjustment: after
    ``georegister_scene``, re-run BA with camera-centre prior residuals at
    the fixes (weight 1/sigma_m^2) and the first camera free (the priors
    fix the gauge).  Returns (refined scene, info | None)."""
    from ..ba import bundle_adjust as ba

    have, _, enu = _gps_enu(scene, gps_list)
    if len(have) < 3:
        return scene, None
    dev = scene.points.device
    C = scene.intr.shape[0]
    prior = np.zeros((C, 3), np.float32)
    w = np.zeros(C, np.float32)
    prior[have] = np.asarray(enu, np.float32)
    w[have] = 1.0 / max(sigma_m, 1e-3) ** 2
    cfg = ba.BAConfig(max_iters=max_iters, cg_iters=100, fix_first_cam=False,
                      converge_rtol=1e-8)
    intr, rot, t, pts, info = ba.bundle_adjust(
        scene.intr, scene.cam_rot, scene.cam_t, scene.cam_mask,
        scene.points, scene.point_mask, scene.obs_cam, scene.obs_pt,
        scene.obs_uv, scene.obs_mask, cfg=cfg,
        prior_pos=torch.as_tensor(prior, device=dev),
        prior_weight=torch.as_tensor(w, device=dev),
    )
    out = scene.replace(intr=intr, cam_rot=rot, cam_t=t, points=pts)
    return out, {
        "n_gps": len(have),
        "sigma_m": sigma_m,
        "rms_m": _rms(out, have, np.asarray(enu)),
        "ba_final_cost": float(info["final_cost"]),
    }
