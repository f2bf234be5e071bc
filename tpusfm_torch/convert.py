"""Carry state from the JAX package into the port: configuration, features
and scenes.

SfM has no learned weights; its state is configuration (the pipeline's and
the global engines'), features and the scene.  These helpers read the reference's objects field by field
(``dataclasses.fields``) and take numpy arrays, so this module imports
nothing from jax or the reference package.  Scenes go through
``sfm.scene.scene_from_numpy`` / ``scene_to_numpy`` (re-exported here).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .features.sift import Features
from .pipeline.config import PipelineConfig
from .sfm.global_sfm import GlobalConfig
from .sfm.scene import scene_from_numpy, scene_to_numpy  # noqa: F401 (re-exported)


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
    """A reference ``PipelineConfig`` as the port's, field by field, nested
    configs (``dense`` and its ``pm``) included.  A reference field the
    port lacks raises only when it differs from the reference's default."""
    return _convert_dataclass(cfg, PipelineConfig)


def global_config_from_jax(cfg) -> GlobalConfig:
    """A reference ``GlobalConfig`` (the global and stellar engines') as the
    port's, field by field."""
    return _convert_dataclass(cfg, GlobalConfig)


def features_from_numpy(kp, desc, score, mask, device) -> Features:
    """Features from (..., N, 4) keypoints, (..., N, 128) descriptors,
    (..., N) scores and (..., N) validity."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    return Features(kp=t(kp, torch.float32), desc=t(desc, torch.float32),
                    score=t(score, torch.float32), mask=t(mask, torch.bool))
