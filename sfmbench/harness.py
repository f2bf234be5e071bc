"""The benchmark's cell runner: everything but the command line.

A cell is found by name in ``BENCHMARK.json``, and everything of its own
by name in files of its own: its configuration (a file of sizes, solver
settings and assumed geometry), its traffic mix (``traffic/<name>.json``,
which names the driver that runs it, ``drivers/<driver>.py``), its
correctness limits (``limits/<cell>.json``, each number read by
``checks/<number>.py``), and its metrics (``e2e/<name>.py`` for the
end-to-end metrics, ``metrics/<name>.py`` for the per-layer ones).  The
driver makes the problem from the seed, warms the cell's shapes up, drives
the window and hands back what the metric readers and the checks read; the
harness reads the metrics, judges the window (``compare.py``) and builds the
result.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from . import compare, tracesum
from .common import load_module, read_json


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list   # BENCHMARK.json's metric entries that this cell reports
    per_layer: list

    @property
    def bench_dir(self) -> Path:
        return self.root / "sfmbench"


@dataclasses.dataclass
class RunData:
    """What a driver hands back from one run, for the metric readers."""
    cell: Cell
    shape: tuple          # the problem's sizes, as the driver's readers take them
    settings: dict        # the solver settings that the window ran with
    setup_s: float
    setup_parts: dict     # set-up by phase, for standard error
    window_s: float
    latencies: list       # each answer's time from its call to its return
    iterations: list      # each answer's count of iterations
    device: dict          # the result's "device" object
    trace: tracesum.TraceSummary | None = None
    traced_solves: int = 0
    traced_iterations: int = 0
    traced_wall_s: float = 0.0


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _for_cell(metrics: list, name: str) -> list:
    return [m for m in metrics if "workloads" not in m or name in m["workloads"]]


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = read_json(root / "BENCHMARK.json")
    w = _named(bench["workloads"], workload, "workload")
    cfg = _named(bench["configs"], w["config"], "config")
    d = root / "sfmbench"
    return Cell(name=workload, root=root, config=read_json(root / cfg["file"]),
                traffic=read_json(d / "traffic" / f"{w['traffic']}.json"),
                limits=read_json(d / "limits" / f"{workload}.json"), chips=int(w["chips"]),
                end_to_end=_for_cell(bench["end_to_end"], workload),
                per_layer=_for_cell(bench["per_layer"], workload))


def driver(cell: Cell):
    """The module that runs the cell's traffic: ``drivers/<name>.py``."""
    return load_module(cell.bench_dir / "drivers" / f"{cell.traffic['driver']}.py")


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace_on: bool,
             device, t_start: float, solver=None) -> tuple[dict, dict]:
    """One run of a cell; returns the result object (the last line's JSON)
    and diagnostics for standard error (answer times, iterations, set-up by
    phase, the largest readings of each number compared).
    `t_start` is the process's start on the host clock (time.perf_counter),
    for setup_s.  `solver`, where given, takes the program's place under
    the driver: the control, or a planted fault."""
    cell = load_cell(root, workload)
    run, judging = driver(cell).run(cell, seed, seconds, trace_on, torch.device(device),
                                    t_start, solver)
    checks, failed, tails = compare.judge(cell, judging)
    del judging
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        sub = "metrics" if trace_on else "e2e"
        value = load_module(cell.bench_dir / sub / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    extra = {"breakdown": tracesum.breakdown(run.trace)} if run.trace is not None else {}
    result = {"correct": bool(correct), "attempted": len(run.latencies), "failed": failed,
              "metrics": metrics, "device": run.device, **extra, "checks": checks}
    return result, {"latencies": run.latencies, "iterations": run.iterations,
                    "setup_parts": run.setup_parts, "tails": tails}
