"""Checkpoints of the full scene state for long reconstructions (port of
``tpusfm/pipeline/checkpoint.py``).

The reference saves through orbax and falls back to one flattened
``<path>.npz`` (keys ``scene/<field>``, ``step`` and ``extra/<name>``).  The
port writes and reads that npz form, so a checkpoint written by either
package without orbax loads in the other.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..sfm.scene import Scene, scene_from_numpy, scene_to_numpy


def save_checkpoint(path: str | Path, scene: Scene, step: int = 0,
                    extra: dict | None = None) -> Path:
    """Write the scene (+ step and small metadata) to ``<path>.npz``;
    returns that file's path."""
    out = Path(str(Path(path).resolve()) + ".npz")
    state = {"scene": scene_to_numpy(scene), "step": np.asarray(step)}
    if extra:
        state["extra"] = {k: np.asarray(v) for k, v in extra.items()}
    np.savez_compressed(out, **_flatten(state))
    return out


def load_checkpoint(path: str | Path, *, device):
    """Returns (scene on `device`, step, extra dict) from ``<path>.npz``."""
    with np.load(str(Path(path).resolve()) + ".npz") as data:
        state = _unflatten(dict(data))
    sc = scene_from_numpy(state["scene"], device)
    extra = state.get("extra") or {}
    return sc, int(state["step"]), extra


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflatten(d):
    out: dict = {}
    for k, v in d.items():
        parts = k.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out
