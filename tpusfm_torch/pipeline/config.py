"""Pipeline configuration (port of ``tpusfm/pipeline/config.py``).

Frozen dataclasses with the reference's field names and defaults.  The
dense stage's ``DenseConfig`` is not part of the port's config until the
dense slice is ported (``convert.config_from_jax`` raises if a reference
config changes it).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Literal

from ..features.sift import SiftConfig
from ..sfm.incremental import IncrementalConfig


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    pair_mode: Literal["exhaustive", "contiguous"] = "exhaustive"
    contiguous_window: int = 5
    ratio: float = 0.8                 # NN distance ratio
    cross_check: bool = True
    pair_chunk: int = 32               # pairs per device batch
    preemptive: bool = False           # not ported yet (raises)
    preemptive_features: int = 200
    preemptive_min_matches: int = 4
    loop_closure: bool = False         # not ported yet (raises)
    loop_top_k: int = 3
    loop_min_sim: float = 0.5


@dataclasses.dataclass(frozen=True)
class GeometricFilterConfig:
    model: Literal["f", "e", "h", "none"] = "f"
    thresh_px: float = 4.0
    max_iterations: int = 256
    min_matches: int = 50
    min_inlier_ratio: float = 0.3
    minimal_solver: bool = False       # 7-point F / 5-point E hypotheses
    adaptive: bool = False             # a-contrario (AC-RANSAC) scoring
    score_subset: int = 256            # hypothesis selection on this many matches; 0 = all


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    sift: SiftConfig = dataclasses.field(default_factory=SiftConfig)
    matching: MatchingConfig = dataclasses.field(default_factory=MatchingConfig)
    filter: GeometricFilterConfig = dataclasses.field(default_factory=GeometricFilterConfig)
    engine: IncrementalConfig = dataclasses.field(default_factory=IncrementalConfig)
    engine_type: Literal["incremental", "global", "stellar"] = "incremental"  # only incremental is ported
    focal_prior_px: float | None = None
    feature_batch: int = 8             # views per SIFT batch
    self_calibrate: bool = True        # refine one RADIAL3 block per camera group
    devices: int | None = None         # > 1 (data-parallel mesh) is not ported yet

    def to_json(self) -> str:
        def enc(o):
            if dataclasses.is_dataclass(o):
                return {f.name: enc(getattr(o, f.name)) for f in dataclasses.fields(o)}
            return o

        return json.dumps(enc(self), indent=2, default=str)


def config_from_overrides(**kw) -> PipelineConfig:
    """PipelineConfig with dotted overrides, e.g.
    config_from_overrides(**{'matching.ratio': 0.7, 'filter.model': 'e'})."""
    cfg = PipelineConfig()
    groups: dict[str, dict] = {}
    top: dict = {}
    for k, v in kw.items():
        if "." in k:
            g, f = k.split(".", 1)
            groups.setdefault(g, {})[f] = v
        else:
            top[k] = v
    for g, fields in groups.items():
        top[g] = dataclasses.replace(getattr(cfg, g), **fields)
    return dataclasses.replace(cfg, **top)
