"""Fixed-capacity struct-of-arrays scene container.

Port of ``tpusfm/sfm/scene.py``: cameras, points and the observation table
(the BA working set) live in flat tensors with validity masks.  Pose
convention: world -> camera, ``x_cam = R @ x_world + t``, rotation stored
as axis-angle.
"""

from __future__ import annotations

import dataclasses

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
