"""A tiny cell for the harness's CPU tests, added as new files only."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_root(tmp: Path, traffic: str = "solve", C: int = 24, P: int = 400, O: int = 2400,
              limits_from: str = "venice.solve", name: str = "tiny",
              ba: dict | None = None) -> tuple[Path, str]:
    """A checkout at `tmp` with the benchmark's files and one more cell,
    `<name>.<traffic>`, made of a new configuration (Venice's, at C cameras,
    P points and O observations), new limits (a copy of `limits_from`'s,
    but for solve_excess: 25 LM iterations leave a problem this small
    unconverged, and the program's CPU path solves it by dense Cholesky
    where the reference runs CG, so the two answers lie up to ~5% of the
    cost removed apart) and new entries in BENCHMARK.json.  `ba` overrides
    the configuration's solver settings.  Returns (root, cell name)."""
    root = Path(tmp)
    shutil.copytree(REPO / "sfmbench", root / "sfmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "sfmbench/configs/bal-venice-1778.json").read_text())
    cfg.update(name=name, problem={"cameras": C, "points": P, "observations": O})
    cfg["ba"].update(ba or {})
    (root / f"sfmbench/configs/{name}.json").write_text(json.dumps(cfg))
    cell = f"{name}.{traffic}"
    limits = json.loads((REPO / f"sfmbench/limits/{limits_from}.json").read_text())
    limits["solve_excess"] = 0.25
    (root / f"sfmbench/limits/{cell}.json").write_text(json.dumps(limits))
    bench["configs"].append({"name": name, "source": "a test size", "reduced": [],
                             "file": f"sfmbench/configs/{name}.json", "why": "CPU tests"})
    bench["workloads"].append({"name": cell, "config": name, "traffic": traffic, "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, cell
