"""Distributed bundle adjustment over a mesh (port of
``tpusfm/parallel/dist_ba.py``).

The observation table is cut into one contiguous block per rank; each rank
linearizes and reduces its block, the camera, group and point systems are
summed over the ranks (``BAConfig.axis_name``, the all_reduce hooks of
``ba/bundle_adjust.py``), and the replicated camera solve proceeds
identically on every rank.  The solver is ``ba.bundle_adjust`` itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ba import bundle_adjust as ba
from . import mesh as mesh_mod


def bundle_adjust_sharded(
    mesh: mesh_mod.Mesh,
    intr, cam_rot, cam_t, cam_mask,
    points, point_mask,
    obs_cam, obs_pt, obs_uv, obs_mask,
    cfg: ba.BAConfig = ba.BAConfig(),
    cam_free_mask=None,
    cam_group=None,
    n_groups: int | None = None,
    prior_pos=None,
    prior_weight=None,
    axis: str = "shard",
    max_iters: int | None = None,
):
    """``ba.bundle_adjust``'s contract with the observation table sharded
    over `axis`: every rank passes the whole table (its length a multiple of
    the mesh's size; pad with ``shard_obs_table``) and solves its
    contiguous block of rows; cameras, points and priors are replicated.
    Every rank returns the same (intr, cam_rot, cam_t, points, info)."""
    n = mesh.shape[axis]
    O = obs_cam.shape[0]
    if O % n:
        raise ValueError(f"obs table length {O} must be divisible by mesh axis {n} "
                         "(pad with shard_obs_table)")
    mesh_mod.register(mesh, axis)  # ba.bundle_adjust checks the ranks agree
    rows = slice(mesh.rank * (O // n), (mesh.rank + 1) * (O // n))
    return ba.bundle_adjust(
        intr, cam_rot, cam_t, cam_mask, points, point_mask,
        obs_cam[rows], obs_pt[rows], obs_uv[rows], obs_mask[rows],
        cfg=dataclasses.replace(cfg, axis_name=axis), cam_free_mask=cam_free_mask,
        cam_group=cam_group, n_groups=n_groups, prior_pos=prior_pos, prior_weight=prior_weight,
        max_iters=max_iters)


def shard_obs_table(obs_cam, obs_pt, obs_uv, obs_mask, n_dev: int, *, device="cuda"):
    """Pad the observation table so its length divides n_dev, as tensors on
    `device`.  Padded rows point at camera 0 and point 0 with weight 0, so
    the kernel path sorts them to the invalid rank."""
    obs_cam, obs_pt = np.asarray(obs_cam, np.int32), np.asarray(obs_pt, np.int32)
    obs_uv, obs_mask = np.asarray(obs_uv, np.float32), np.asarray(obs_mask, bool)
    O = len(obs_cam)
    pad = -O % n_dev
    if pad:
        obs_cam = np.concatenate([obs_cam, np.zeros(pad, np.int32)])
        obs_pt = np.concatenate([obs_pt, np.zeros(pad, np.int32)])
        obs_uv = np.concatenate([obs_uv, np.zeros((pad, 2), np.float32)])
        obs_mask = np.concatenate([obs_mask, np.zeros(pad, bool)])
    return tuple(torch.as_tensor(a, device=device) for a in (obs_cam, obs_pt, obs_uv, obs_mask))
