"""Fixed-capacity struct-of-arrays scene container.

Port of ``tpusfm/sfm/scene.py``: cameras, points and the observation table
(the BA working set) live in flat tensors with validity masks.  Pose
convention: world -> camera, ``x_cam = R @ x_world + t``, rotation stored
as axis-angle.  Scenes go to and from numpy dicts and ``.npz`` files with
the reference's field names and dtypes, so either package reads the
other's files.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core import camera as cam
from ..core import lie


@dataclasses.dataclass
class Scene:
    intr: torch.Tensor        # (C, 7) fx fy cx cy k1 k2 k3
    cam_rot: torch.Tensor     # (C, 3) axis-angle world->cam
    cam_t: torch.Tensor       # (C, 3)
    cam_mask: torch.Tensor    # (C,) bool — registered cameras
    points: torch.Tensor      # (P, 3)
    colors: torch.Tensor      # (P, 3) uint8
    point_mask: torch.Tensor  # (P,) bool
    obs_cam: torch.Tensor     # (O,) int32 camera index
    obs_pt: torch.Tensor      # (O,) int32 point index
    obs_uv: torch.Tensor      # (O, 2) float32 pixel measurement
    obs_mask: torch.Tensor    # (O,) bool

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    @property
    def max_cams(self) -> int:
        return self.intr.shape[0]

    @property
    def max_points(self) -> int:
        return self.points.shape[0]

    @property
    def max_obs(self) -> int:
        return self.obs_cam.shape[0]

    @property
    def n_cams(self) -> torch.Tensor:
        return self.cam_mask.to(torch.int32).sum()

    @property
    def n_points(self) -> torch.Tensor:
        return self.point_mask.to(torch.int32).sum()

    @property
    def n_obs(self) -> torch.Tensor:
        return self.obs_mask.to(torch.int32).sum()

    def rotations(self) -> torch.Tensor:
        return lie.so3_exp(self.cam_rot)

    def camera_centers(self) -> torch.Tensor:
        return lie.camera_center(self.rotations(), self.cam_t)

    def project_obs(self) -> torch.Tensor:
        """Project every observation's point into its camera. (O, 2)."""
        oc = self.obs_cam.long()
        return cam.project(self.intr[oc], self.rotations()[oc], self.cam_t[oc],
                           self.points[self.obs_pt.long()])

    def reprojection_errors(self) -> torch.Tensor:
        """Masked per-observation reprojection error norms. (O,)"""
        d = torch.linalg.norm(self.project_obs() - self.obs_uv, dim=-1)
        return torch.where(self.obs_mask, d, torch.zeros_like(d))


def empty_scene(max_cams: int, max_points: int, max_obs: int, device) -> Scene:
    f32 = dict(dtype=torch.float32, device=device)
    return Scene(
        intr=torch.zeros((max_cams, cam.NUM_INTR), **f32),
        cam_rot=torch.zeros((max_cams, 3), **f32),
        cam_t=torch.zeros((max_cams, 3), **f32),
        cam_mask=torch.zeros((max_cams,), dtype=torch.bool, device=device),
        points=torch.zeros((max_points, 3), **f32),
        colors=torch.zeros((max_points, 3), dtype=torch.uint8, device=device),
        point_mask=torch.zeros((max_points,), dtype=torch.bool, device=device),
        obs_cam=torch.zeros((max_obs,), dtype=torch.int32, device=device),
        obs_pt=torch.zeros((max_obs,), dtype=torch.int32, device=device),
        obs_uv=torch.zeros((max_obs, 2), **f32),
        obs_mask=torch.zeros((max_obs,), dtype=torch.bool, device=device),
    )


def camera_centers(scene: Scene) -> torch.Tensor:
    """World-frame centers of every camera slot. (C, 3)"""
    return scene.camera_centers()


_DTYPES = {
    "intr": torch.float32, "cam_rot": torch.float32, "cam_t": torch.float32,
    "cam_mask": torch.bool, "points": torch.float32, "colors": torch.uint8,
    "point_mask": torch.bool, "obs_cam": torch.int32, "obs_pt": torch.int32,
    "obs_uv": torch.float32, "obs_mask": torch.bool,
}


def scene_to_numpy(scene: Scene) -> dict[str, np.ndarray]:
    """Every field as a host numpy array, by field name."""
    return {f.name: getattr(scene, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(scene)}


def scene_from_numpy(arrays, device) -> Scene:
    """A Scene on `device` from a mapping of arrays with the Scene field
    names (a dict, an npz file; other keys are ignored)."""
    return Scene(**{k: torch.as_tensor(np.asarray(arrays[k]), device=device).to(dt)
                    for k, dt in _DTYPES.items()})


def save_scene_npz(path: str, scene: Scene, extra: dict[str, Any] | None = None) -> None:
    """Write the scene's fields, plus any `extra` arrays, compressed."""
    arrays = scene_to_numpy(scene)
    if extra:
        arrays.update({k: np.asarray(v) for k, v in extra.items()})
    np.savez_compressed(path, **arrays)


def load_scene_npz(path: str, *, device) -> Scene:
    """Read a scene written by ``save_scene_npz`` (of either package)."""
    with np.load(path) as data:
        return scene_from_numpy(data, device)


def compact_points(scene: Scene) -> Scene:
    """Move valid points to the front, in order, and remap obs_pt."""
    P = scene.points.shape[0]
    order = torch.argsort((~scene.point_mask).to(torch.int8), stable=True)
    remap = torch.empty(P, dtype=torch.int32, device=order.device)
    remap[order] = torch.arange(P, dtype=torch.int32, device=order.device)
    return scene.replace(points=scene.points[order], colors=scene.colors[order],
                         point_mask=scene.point_mask[order],
                         obs_pt=remap[scene.obs_pt.long()])
