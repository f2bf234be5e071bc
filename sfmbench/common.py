"""Small helpers shared by the harness: seeds, files found by name, JSON."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

# Random streams derived from one --seed: the scene, each solve's start,
# the sample of solves that the reference re-solves.
STREAM_SCENE = 1
STREAM_START = 2
STREAM_SAMPLE = 3

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def sub_seed(seed: int, *stream: int) -> int:
    """A seed below 2**63 for one stream of one run, the same in every
    process: --seed may be any whole number, negative or past 32 bits."""
    x = _splitmix64(int(seed) & _MASK64)
    for s in stream:
        x = _splitmix64(x ^ (int(s) & _MASK64))
    return x >> 1


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


_LOADED: dict = {}


def load_module(path: Path):
    """Import one file of the harness by its path (names may hold dots),
    once a process."""
    key = str(Path(path).resolve())
    if key in _LOADED:
        return _LOADED[key]
    spec = importlib.util.spec_from_file_location(f"sfmbench_{path.stem.replace('.', '_')}",
                                                  path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up by name
    spec.loader.exec_module(mod)
    _LOADED[key] = mod
    return mod
