"""COLMAP sparse-model interop (text format; port of ``tpusfm/io/colmap.py``,
writing the same text for the same scene).

The reference exports its world to the OpenMVS ``.mvs`` scene via
``MVS::ARCHIVE::SerializeSave`` (src/denseBuilder/DenseBuilder.h:54-146) so
external MVS tooling can densify it.  The ``.mvs`` container is an
undocumented version-dependent binary; the portable, documented interchange
the same toolchain consumes is the COLMAP sparse model (OpenMVS ships
``InterfaceCOLMAP``; Meshroom/RealityCapture/nerfstudio all read it too).
This module writes and reads that format:

  cameras.txt    CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]
  images.txt     IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME
                 POINTS2D[] as (X, Y, POINT3D_ID)
  points3D.txt   POINT3D_ID X Y Z R G B ERROR TRACK[] as (IMAGE_ID, POINT2D_IDX)

Conventions match ours exactly: world->camera, ``x_cam = R @ x_world + t``,
quaternion scalar-first.  Camera model is PINHOLE when the distortion terms
are zero, else FULL_OPENCV (fx fy cx cy k1 k2 p1 p2 k3 k4 k5 k6) which embeds
our radial-k3 model with p/k4..k6 = 0 (reference default PINHOLE_CAMERA_RADIAL3,
src/sparseBuilder/sparseBuilder.cpp:480-482).

Only the ≥2-view-visible points are exported, sorted tracks, like the
reference's vertex filter (DenseBuilder.h:129-135).

Downstream usage (the exact invocation replacing the reference's
``system("openMVG_main_openMVG2openMVS ...")`` + ``DensifyPointCloud`` chain,
src/main.cpp:157-162): lay the export out as a COLMAP project —

    project/
      images/           the undistorted input images (undistort_image())
      sparse/           cameras.txt images.txt points3D.txt  (this module)

then convert and densify with stock OpenMVS:

    InterfaceCOLMAP -w project -i . -o scene.mvs
    DensifyPointCloud -w project scene.mvs

Format fidelity is pinned by a committed golden model authored from the
COLMAP text spec (tests/golden/colmap_text — includes COLMAP's
``# Number of ...`` header lines, ``-1`` POINT3D_IDs for unmatched
keypoints, and non-contiguous camera/image/point IDs), round-tripped
byte-stably in tests/test_colmap.py.  No external COLMAP/OpenMVS binary
exists in this image (zero egress), so spec-golden + byte-stable
round-trip is the strongest available interchange proof.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..sfm.scene import Scene


def _np(x, dtype=None) -> np.ndarray:
    a = x.detach().cpu().numpy()
    return a if dtype is None else a.astype(dtype)


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), numerically stable branch
    selection (Shepperd's method)."""
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s])
    elif m00 >= m11 and m00 >= m22:
        s = np.sqrt(1.0 + m00 - m11 - m22) * 2
        q = np.array([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s])
    elif m11 >= m22:
        s = np.sqrt(1.0 + m11 - m00 - m22) * 2
        q = np.array([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s])
    else:
        s = np.sqrt(1.0 + m22 - m00 - m11) * 2
        q = np.array([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s])
    return q / np.linalg.norm(q)


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def export_colmap(
    out_dir: str | Path,
    scene: Scene,
    image_names: list[str] | None = None,
    image_sizes: np.ndarray | None = None,
) -> Path:
    """Write the registered part of ``scene`` as a COLMAP text model.

    image_sizes: (C, 2) of (width, height); estimated from the principal
    point (w ~ 2*cx, h ~ 2*cy) when not given.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    intr = _np(scene.intr, np.float64)
    cam_mask = _np(scene.cam_mask)
    R_all = _np(scene.rotations(), np.float64)
    t_all = _np(scene.cam_t, np.float64)
    points = _np(scene.points, np.float64)
    colors = _np(scene.colors)
    point_mask = _np(scene.point_mask)
    obs_cam = _np(scene.obs_cam)
    obs_pt = _np(scene.obs_pt)
    obs_uv = _np(scene.obs_uv, np.float64)
    obs_mask = _np(scene.obs_mask)
    errs = _np(scene.reprojection_errors())

    cam_ids = np.flatnonzero(cam_mask)
    if image_names is None:
        image_names = [f"view_{i:04d}.jpg" for i in range(scene.max_cams)]

    # cameras.txt — one COLMAP camera per registered view (the engine keeps
    # per-view intrinsics; shared-intrinsic grouping collapses to identical rows).
    with open(out / "cameras.txt", "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for c in cam_ids:
            fx, fy, cx, cy, k1, k2, k3 = intr[c][:7]
            if image_sizes is not None:
                w, h = int(image_sizes[c][0]), int(image_sizes[c][1])
            else:
                w, h = int(round(2 * cx)), int(round(2 * cy))
            if k1 == k2 == k3 == 0.0:
                f.write(f"{c + 1} PINHOLE {w} {h} {fx:.10g} {fy:.10g} {cx:.10g} {cy:.10g}\n")
            else:
                f.write(
                    f"{c + 1} FULL_OPENCV {w} {h} {fx:.10g} {fy:.10g} {cx:.10g} {cy:.10g} "
                    f"{k1:.10g} {k2:.10g} 0 0 {k3:.10g} 0 0 0\n"
                )

    # Valid observations of valid points in registered cameras.
    ok = obs_mask & point_mask[obs_pt] & cam_mask[obs_cam]
    # ≥2-view visibility filter (DenseBuilder.h:129-130).
    vis = np.zeros(scene.max_points, np.int64)
    np.add.at(vis, obs_pt[ok], 1)
    pt_keep = point_mask & (vis >= 2)
    ok &= pt_keep[obs_pt]

    # Per-image 2D point lists; POINT2D_IDX = rank of the obs within its image.
    p2d_idx = np.zeros(scene.max_obs, np.int64)
    per_image: dict[int, list[int]] = {int(c): [] for c in cam_ids}
    for o in np.flatnonzero(ok):
        c = int(obs_cam[o])
        p2d_idx[o] = len(per_image[c])
        per_image[c].append(int(o))

    with open(out / "images.txt", "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for c in cam_ids:
            q = _rot_to_quat(R_all[c])
            t = t_all[c]
            name = image_names[c] if c < len(image_names) else f"view_{c:04d}.jpg"
            f.write(f"{c + 1} {q[0]:.10g} {q[1]:.10g} {q[2]:.10g} {q[3]:.10g} "
                    f"{t[0]:.10g} {t[1]:.10g} {t[2]:.10g} {c + 1} {name}\n")
            parts = [
                f"{obs_uv[o][0]:.6g} {obs_uv[o][1]:.6g} {int(obs_pt[o]) + 1}"
                for o in per_image[int(c)]
            ]
            f.write(" ".join(parts) + "\n")

    with open(out / "points3D.txt", "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        # mean track reprojection error, like COLMAP's ERROR column
        err_sum = np.zeros(scene.max_points)
        np.add.at(err_sum, obs_pt[ok], errs[ok])
        for p in np.flatnonzero(pt_keep):
            track = np.flatnonzero(ok & (obs_pt == p))
            track = track[np.argsort(obs_cam[track], kind="stable")]  # view-sorted (DenseBuilder.h:131)
            e = err_sum[p] / max(len(track), 1)
            x, y, z = points[p]
            r, g, b = (int(v) for v in colors[p][:3])
            tr = " ".join(f"{int(obs_cam[o]) + 1} {p2d_idx[o]}" for o in track)
            f.write(f"{p + 1} {x:.10g} {y:.10g} {z:.10g} {r} {g} {b} {e:.6g} {tr}\n")
    return out


def import_colmap(model_dir: str | Path, *, device):
    """Read a COLMAP text model back into a ``Scene`` on `device` (+ image
    names).

    Capacities equal the model's counts.  Returns (scene, image_names).
    """
    from ..core import lie
    from ..core.camera import NUM_INTR

    model = Path(model_dir)

    def data_lines(p):
        for line in p.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                yield line

    cams: dict[int, np.ndarray] = {}
    for line in data_lines(model / "cameras.txt"):
        tok = line.split()
        cid, mdl = int(tok[0]), tok[1]
        p = [float(v) for v in tok[4:]]
        row = np.zeros(NUM_INTR)
        if mdl == "PINHOLE":
            row[:4] = p[:4]
        elif mdl == "SIMPLE_PINHOLE":
            row[:4] = [p[0], p[0], p[1], p[2]]
        elif mdl == "SIMPLE_RADIAL":
            row[:4] = [p[0], p[0], p[1], p[2]]
            row[4] = p[3]
        elif mdl == "RADIAL":
            row[:4] = [p[0], p[0], p[1], p[2]]
            row[4:6] = p[3:5]
        elif mdl in ("OPENCV", "FULL_OPENCV"):
            row[:4] = p[:4]
            row[4:6] = p[4:6]  # k1 k2 (p1 p2 tangential dropped)
            if mdl == "FULL_OPENCV":
                row[6] = p[8]  # k3
        else:
            raise ValueError(f"unsupported COLMAP camera model {mdl}")
        cams[cid] = row

    img_pose: dict[int, tuple[np.ndarray, np.ndarray, int, str]] = {}
    img_p2d: dict[int, np.ndarray] = {}
    # Keep blank lines: an image with zero 2D points has an EMPTY second line,
    # which must still consume its slot in the two-line-per-image layout.
    lines = [ln.strip() for ln in (model / "images.txt").read_text().splitlines()
             if not ln.strip().startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        tok = lines[i].split()
        iid = int(tok[0])
        q = np.array([float(v) for v in tok[1:5]])
        t = np.array([float(v) for v in tok[5:8]])
        cam_id, name = int(tok[8]), tok[9]
        img_pose[iid] = (_quat_to_rot(q), t, cam_id, name)
        tok2 = lines[i + 1].split() if i + 1 < len(lines) else []
        arr = np.array([float(v) for v in tok2], np.float64).reshape(-1, 3) \
            if tok2 else np.zeros((0, 3))
        img_p2d[iid] = arr
        i += 2

    img_ids = sorted(img_pose)
    id2row = {iid: r for r, iid in enumerate(img_ids)}
    C = len(img_ids)
    intr = np.zeros((C, NUM_INTR), np.float32)
    rot = np.zeros((C, 3), np.float32)
    trans = np.zeros((C, 3), np.float32)
    names = []
    for iid in img_ids:
        R, t, cam_id, name = img_pose[iid]
        r = id2row[iid]
        intr[r] = cams[cam_id]
        rot[r] = lie.so3_log(torch.as_tensor(R[None], dtype=torch.float32))[0].numpy()
        trans[r] = t
        names.append(name)

    pts, cols, obs = [], [], []
    pid2row: dict[int, int] = {}
    for line in data_lines(model / "points3D.txt"):
        tok = line.split()
        pid = int(tok[0])
        pid2row[pid] = len(pts)
        pts.append([float(v) for v in tok[1:4]])
        cols.append([int(v) for v in tok[4:7]])
        track = tok[8:]
        for j in range(0, len(track), 2):
            iid, p2 = int(track[j]), int(track[j + 1])
            uv = img_p2d[iid][p2][:2]
            obs.append((id2row[iid], pid2row[pid], uv[0], uv[1]))

    P, O = max(len(pts), 1), max(len(obs), 1)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    scene = Scene(
        intr=t(intr, torch.float32),
        cam_rot=t(rot, torch.float32),
        cam_t=t(trans, torch.float32),
        cam_mask=t(np.ones((C,), bool), torch.bool),
        points=t(np.asarray(pts, np.float32).reshape(-1, 3)
                 if pts else np.zeros((1, 3), np.float32), torch.float32),
        colors=t(np.asarray(cols, np.uint8).reshape(-1, 3)
                 if cols else np.zeros((1, 3), np.uint8), torch.uint8),
        point_mask=t(np.arange(P) < len(pts), torch.bool),
        obs_cam=t(np.asarray([o[0] for o in obs] or [0], np.int32), torch.int32),
        obs_pt=t(np.asarray([o[1] for o in obs] or [0], np.int32), torch.int32),
        obs_uv=t(np.asarray([[o[2], o[3]] for o in obs], np.float32)
                 if obs else np.zeros((1, 2), np.float32), torch.float32),
        obs_mask=t(np.arange(O) < len(obs), torch.bool),
    )
    return scene, names
