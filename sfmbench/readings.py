"""The readings that a cell's correctness limits are set from: the
program's numbers and the control's, seed by seed, in one process.

    python3 -m sfmbench.readings --workload <name> --seeds 1 2 3 [--solves 2]
        [--control-seeds N] [--control-solves M] [--fault KIND] [--out readings.jsonl]

The cell's problem is made once; for each seed the program (``tpusfm_torch``'s
bundle_adjust, warmed up) runs `--solves` solves of the cell's traffic,
and the control, the plain reference computed in bfloat16, one precision
below the configuration's float32, runs the same solves in its place.
Both are judged by ``compare.readings`` (every number that the cell's
limits file names, of every solve; the float64 reference re-solves the
first solve).  With `--fault`, the program runs with that fault planted
(``faults.py``) and no control runs.  One JSON line per seed and side.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from . import faults
from .compare import readings
from .gen import scene as gen
from .harness import driver, load_cell
from .reference import ba as ref


def control_solver(cell, scene):
    """The reference in bfloat16 put in the program's place."""
    drv = driver(cell)
    ba = drv.ba_settings(cell)
    cam_group, G = drv.groups(cell, scene)

    def solve(start):
        intr, rot, t, pts, info = ref.solve(start["intr"], start["cam_rot"], start["cam_t"],
                                            start["points"], scene.obs_cam, scene.obs_pt,
                                            scene.obs_uv, ba, cam_group=cam_group, n_groups=G,
                                            dtype=torch.bfloat16)
        return (intr.float(), rot.float(), t.float(), pts.float(),
                {k: (float(v) if k != "iterations" else v) for k, v in info.items()})

    return solve


def side(cell, scene, seed: int, solver, n: int, dev) -> dict:
    drv = driver(cell)
    solve = solver(cell, scene)
    solve(drv.start(cell, scene, seed, drv.WARMUP))
    drv.sync(dev)
    solves = []
    t0 = time.perf_counter()
    for k in range(n):
        ts = time.perf_counter()
        intr, rot, t, pts, info = solve(drv.start(cell, scene, seed, k))
        drv.sync(dev)
        solves.append(drv.Solve(k, time.perf_counter() - ts, (intr, rot, t, pts), info))
    t1 = time.perf_counter()
    got = readings(cell, drv.judging(cell, scene, seed, solves, sample=[0]), list(cell.limits))
    return {"numbers": {name: max(v.values()) for name, v in got.items()},
            "per_solve": {name: v for name, v in got.items()},
            "iterations": [int(s.info["iterations"]) for s in solves],
            "solve_s": [s.latency_s for s in solves], "solves_s": t1 - t0,
            "judge_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--solves", type=int, default=2)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first N seeds only (default: every seed)")
    ap.add_argument("--control-solves", type=int, default=None,
                    help="solves a seed for the control (default: --solves)")
    ap.add_argument("--fault", choices=faults.FAULTS, default=None,
                    help="run the program with this fault planted, and no control")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cell = load_cell(root, args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    n_control = len(args.seeds) if args.control_seeds is None else args.control_seeds
    scene = gen.generate(cell.config, dev)
    port_solver = driver(cell).port_solver
    for i, seed in enumerate(args.seeds):
        sides = [("program", port_solver, args.solves)]
        if args.fault:
            planted = faults.solver(args.fault, port_solver)
            sides = [(f"fault.{args.fault}", planted, args.solves)]
        elif i < n_control:
            sides.append(("control", control_solver, args.control_solves or args.solves))
        for name, solver, n in sides:
            row = {"workload": args.workload, "seed": seed, "side": name,
                   **side(cell, scene, seed, solver, n, dev)}
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
