"""Carry state from the JAX package into the port: configuration, features
and scenes.

SfM has no learned weights; its state is configuration, features and the
scene.  These helpers read the reference's objects field by field
(``dataclasses.fields``) and take numpy arrays, so this module imports
nothing from jax or the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .features.sift import Features
from .pipeline.config import PipelineConfig
from .sfm.scene import Scene

_SCENE_DTYPES = {
    "intr": torch.float32, "cam_rot": torch.float32, "cam_t": torch.float32,
    "cam_mask": torch.bool, "points": torch.float32, "colors": torch.uint8,
    "point_mask": torch.bool, "obs_cam": torch.int32, "obs_pt": torch.int32,
    "obs_uv": torch.float32, "obs_mask": torch.bool,
}


def _convert_dataclass(src, dst_type):
    src_default = type(src)()
    dst_default = dst_type()
    dst_names = {f.name for f in dataclasses.fields(dst_type)}
    kw = {}
    for f in dataclasses.fields(src):
        value = getattr(src, f.name)
        if f.name not in dst_names:
            if value != getattr(src_default, f.name):
                raise NotImplementedError(
                    f"{type(src).__name__}.{f.name}={value!r} differs from the default and "
                    f"the port's {dst_type.__name__} has no such field yet")
            continue
        target = getattr(dst_default, f.name)
        if dataclasses.is_dataclass(value):
            kw[f.name] = _convert_dataclass(value, type(target))
        else:
            kw[f.name] = value
    return dst_type(**kw)


def config_from_jax(cfg) -> PipelineConfig:
    """A reference ``PipelineConfig`` as the port's, field by field.  A
    reference field the port lacks (such as ``dense``) raises only when it
    differs from the reference's default."""
    return _convert_dataclass(cfg, PipelineConfig)


def features_from_numpy(kp, desc, score, mask, device) -> Features:
    """Features from (..., N, 4) keypoints, (..., N, 128) descriptors,
    (..., N) scores and (..., N) validity."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    return Features(kp=t(kp, torch.float32), desc=t(desc, torch.float32),
                    score=t(score, torch.float32), mask=t(mask, torch.bool))


def scene_from_numpy(arrays: dict, device) -> Scene:
    """A Scene from a dict of numpy arrays with the Scene field names (for
    example ``tpusfm.sfm.scene.scene_to_numpy`` of a reference scene)."""
    return Scene(**{k: torch.as_tensor(np.asarray(arrays[k]), device=device).to(dt)
                    for k, dt in _SCENE_DTYPES.items()})


def scene_to_numpy(scene: Scene) -> dict[str, np.ndarray]:
    return {f.name: getattr(scene, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(scene)}
