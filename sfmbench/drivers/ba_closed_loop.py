"""Driver of the bundle-adjustment traffic: a closed loop with one client,
as one reconstruction job calls its final BA.

The traffic file gives ``clients`` (1), ``groups`` (``"one"``: one
intrinsic block shared by every camera, or ``"per_camera"``), ``ba``
(overrides of the configuration's solver settings), ``start`` (the
perturbation of each solve's start, ``gen.scene.start_state``),
``reference_solves`` (how many of the window's solves the reference solves
again) and ``trace_solves`` (how many solves a traced run profiles).

A run makes the problem on the device from the configuration, warms the
cell's shapes up with one solve, then starts solve after solve, each from
its own start drawn from (seed, solve index), while the window is open;
the window ends when the last one returns.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from sfmbench import tracesum
from sfmbench.compare import BAJudging
from sfmbench.gen import scene as gen
from sfmbench.harness import Cell, RunData

WARMUP = -1  # the warm-up solve's index: its start is no solve of the window


def ba_settings(cell: Cell) -> dict:
    """The configuration's solver settings with the traffic's overrides."""
    return {**cell.config["ba"], **cell.traffic.get("ba", {})}


def groups(cell: Cell, scene: gen.Scene):
    """(cam_group, n_groups) of the traffic."""
    C = scene.shape[0]
    dev = scene.points.device
    if cell.traffic["groups"] == "one":
        return torch.zeros(C, dtype=torch.int64, device=dev), 1
    if cell.traffic["groups"] == "per_camera":
        return torch.arange(C, device=dev), C
    raise ValueError(f"unknown groups {cell.traffic['groups']!r}")


def start(cell: Cell, scene: gen.Scene, seed: int, k: int) -> dict:
    return gen.start_state(scene, cell.traffic, seed, k)


def port_solver(cell: Cell, scene: gen.Scene):
    """The system under test: ``tpusfm_torch``'s public bundle_adjust on the
    camera-major table, which the port sorts, compacts and lays out itself
    on every solve.  Returns solve(start) -> (intr, cam_rot, cam_t, points,
    info)."""
    from tpusfm_torch.ba.bundle_adjust import BAConfig, bundle_adjust

    cfg = BAConfig(**ba_settings(cell))
    C, P, O = scene.shape
    dev = scene.points.device
    cam_group, n_groups = groups(cell, scene)
    if cell.traffic["groups"] == "per_camera":
        cam_group = None  # the port's own default: a group per camera
    ones = dict(dtype=torch.bool, device=dev)
    cam_mask, pt_mask = torch.ones(C, **ones), torch.ones(P, **ones)
    obs_mask = torch.ones(O, **ones)

    def solve(st):
        return bundle_adjust(st["intr"], st["cam_rot"], st["cam_t"], cam_mask, st["points"],
                             pt_mask, scene.obs_cam, scene.obs_pt, scene.obs_uv, obs_mask, cfg,
                             cam_group=cam_group, n_groups=n_groups)

    return solve


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Solve:
    k: int
    latency_s: float
    out: tuple        # (intr, cam_rot, cam_t, points) as returned
    info: dict


def _window(cell: Cell, scene, seed: int, seconds: float, solve, dev, trace_solves: int):
    """The closed loop.  The first `trace_solves` solves run under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    solves, prof, done_prof, traced_wall = [], None, None, 0.0
    if trace_solves:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    k = 0
    while k == 0 or time.perf_counter() - t0 < seconds:
        st = start(cell, scene, seed, k)
        with record_function(tracesum.SOLVE_SPAN):
            ts = time.perf_counter()
            intr, rot, t, pts, info = solve(st)
            sync(dev)
            te = time.perf_counter()
        solves.append(Solve(k, te - ts, (intr, rot, t, pts), info))
        k += 1
        if prof is not None and k == trace_solves:
            traced_wall = time.perf_counter() - t0
            prof.__exit__(None, None, None)
            done_prof, prof = prof, None
    window_s = time.perf_counter() - t0
    if prof is not None:  # fewer solves than trace_solves in the window
        traced_wall = window_s
        prof.__exit__(None, None, None)
        done_prof = prof
    return solves, window_s, done_prof, traced_wall


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, dev: torch.device,
        t_start: float, solver=None):
    """One run: (RunData, the BAJudging of the window's solves)."""
    if int(cell.traffic["clients"]) != 1:
        raise ValueError(f"{cell.name}: this driver runs one client")
    solver = solver or port_solver
    marks = [("start", t_start), ("imports", time.perf_counter())]
    scene = gen.generate(cell.config, dev)
    sync(dev)
    marks.append(("problem made", time.perf_counter()))
    solve = solver(cell, scene)
    warm = solve(start(cell, scene, seed, WARMUP))
    sync(dev)
    del warm
    marks.append(("warm-up solve", time.perf_counter()))

    trace_solves = int(cell.traffic["trace_solves"]) if trace_on else 0
    solves, window_s, prof, traced_wall = _window(cell, scene, seed, seconds, solve, dev,
                                                  trace_solves)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del solve
    C, P, O = scene.shape
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    data = RunData(cell=cell, shape=(C, P, O, groups(cell, scene)[1]), settings=ba_settings(cell),
                   setup_s=marks[-1][1] - t_start,
                   setup_parts={b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])},
                   window_s=window_s, latencies=[s.latency_s for s in solves],
                   iterations=[int(s.info["iterations"]) for s in solves], device=device)
    if prof is not None:
        ts = tracesum.summarize(prof)
        del prof
        n = min(trace_solves, len(solves))
        data.trace, data.traced_solves = ts, n
        data.traced_iterations, data.traced_wall_s = sum(data.iterations[:n]), traced_wall
        device.update(busy_s=ts.busy_s, window_s=ts.window_s)
    return data, judging(cell, scene, seed, solves)


def judging(cell: Cell, scene, seed: int, solves: list, sample: list[int] | None = None):
    """What the checks read of these solves (``compare.BAJudging``)."""
    cam_group, G = groups(cell, scene)
    return BAJudging(cell=cell, scene=scene, seed=seed, solves=solves,
                     settings=ba_settings(cell), cam_group=cam_group, n_groups=G,
                     start=lambda k: start(cell, scene, seed, k), sample=sample)
