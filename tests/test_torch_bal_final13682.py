"""BAL's largest problem, Final problem-13682-4456117-pre, as the benchmark
configures it (``sfmbench/configs/bal-final-13682.json``, cell
``final13682.solve``), on the CPU.

The configuration holds BAL's counts and source, and the solver and
precision of Final-4585's configuration, with nothing cut.  At that size
the segment layout of the camera column (13,682 segments) takes a plan no
other configuration takes: one warp a block, its tile not staged in shared
memory.

At a small size made by the benchmark's generator from this
configuration's assumed geometry (96 cameras, more than the dense solve's
64, and a few thousand points at BAL's mean track length), the port's
``bundle_adjust`` on the kernel path's CPU twins is held against the
benchmark's plain reference (``sfmbench/reference/ba.py``) in float64 on
seeded starts, by the three numbers that decide the cell's ``correct``:
the start cost, the end cost and how far the answer lies above the
reference's own solve.  The same comparison fails the reference computed
in bfloat16, one precision below the configuration's float32.
"""

import json
from pathlib import Path

import pytest
import torch

from sfmbench.gen import scene as gen
from sfmbench.reference import ba as ref
from tpusfm_torch.ba import bundle_adjust as tba
from tpusfm_torch.ops import obs_table as ot

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "sfmbench" / "configs"
SEEDS = (2**31 + 13682, 5_000_000_017, -77)
# A small problem at BAL Final's mean track length (28,987,644 / 4,456,117).
C, P = 96, 3000
O = round(P * 28987644 / 4456117)

# Tolerances, each a share of the float64 reference's number:
# - START_GAP, END_GAP: the program's initial and final costs are float32
#   sums over ~20k rows (pixels of ~1e3 px) against the reference's float64
#   costs of the same states; float32 rounding leaves ~1e-7 of them.
# - EXCESS: the program solves with W in bf16 and float32 CG, so its steps
#   differ from the reference's by rounding and each LM run stops where its
#   own test says; both end within ~1e-3 of the cost removed.
# A bfloat16 solve rounds every pixel (~1e3 px) to 4-8 px, which moves
# each of the three numbers by percents.
START_GAP = 1e-5
END_GAP = 1e-5
EXCESS = 0.01


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_configuration_is_bal_final_13682():
    cfg, final = _config("bal-final-13682"), _config("bal-final-4585")
    assert cfg["name"] == "bal-final-13682"
    assert cfg["problem"] == {"cameras": 13682, "points": 4456117, "observations": 28987644}
    assert cfg["source"] == ("BAL (Agarwal et al., ECCV 2010), grail.cs.washington.edu/projects/"
                             "bal, Final, problem-13682-4456117-pre")
    assert cfg["ba"] == final["ba"] and cfg["precision"] == final["precision"]
    assert cfg["reduced"] == []
    assert cfg["assumed"] == {**final["assumed"], "problem_seed": 13682}
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "bal-final-13682")
    assert entry["file"] == "sfmbench/configs/bal-final-13682.json"
    assert entry["source"] == cfg["source"] and entry["reduced"] == []
    cell = next(w for w in bench["workloads"] if w["name"] == "final13682.solve")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("bal-final-13682", "solve", 1)


@pytest.mark.parametrize("config,plan", [
    ("bal-venice-1778", (6, 512, 1629, True)),
    ("bal-final-4585", (2, 2560, 1783, True)),
    ("bal-final-13682", (1, 13824, 2097, False)),
])
def test_camera_layout_plan_at_the_configured_sizes(config, plan):
    """The layout kernel's plan for each configuration's camera column:
    warps a block, rows a warp, tiles, and whether a tile is staged.
    Final-13682's (n + 1) shared offsets take 54.7 KB, past the 48 KB that
    several warps share, so it alone runs one warp a block and scatters
    without a staged tile: the route its cell exists to measure."""
    pb = _config(config)["problem"]
    got = ot._layout_plan(pb["cameras"], pb["observations"])
    assert got == plan, (f"{config}: the camera layout's plan is now {got}, not {plan}; "
                         "final13682.solve was added to run the one-warp, unstaged plan")


@pytest.fixture(scope="module")
def small():
    """The small problem and its float64 reference table."""
    cfg = _config("bal-final-13682")
    cfg["problem"] = {"cameras": C, "points": P, "observations": O}
    scene = gen.generate(cfg, "cpu")
    groups = torch.arange(C)
    table = ref.make_table(scene.obs_cam, scene.obs_pt, scene.obs_uv, P, groups, C,
                           torch.float64)
    traffic = json.loads((REPO / "sfmbench" / "traffic" / "solve.json").read_text())
    return cfg, scene, table, traffic


def _numbers(small, seed, solver):
    """(start gap, end gap, excess) of one seeded start solved by `solver`,
    each against the float64 reference."""
    cfg, scene, table, traffic = small
    st = gen.start_state(scene, traffic, seed, 0)
    delta = cfg["ba"]["huber_delta"]
    intr, rot, t, pts, info = solver(st)
    c0 = float(ref.robust_cost(st["intr"], st["cam_rot"], st["cam_t"], st["points"], table,
                               delta))
    c1 = float(ref.robust_cost(intr, rot, t, pts, table, delta))
    _, _, _, _, rinfo = ref.solve(st["intr"], st["cam_rot"], st["cam_t"], st["points"],
                                  scene.obs_cam, scene.obs_pt, scene.obs_uv, cfg["ba"])
    c_ref = float(rinfo["final_cost"])
    return (abs(float(info["initial_cost"]) - c0) / c0,
            abs(float(info["final_cost"]) - c1) / c1, (c1 - c_ref) / (c0 - c_ref))


def _port(small):
    cfg, scene, _, _ = small
    ba = tba.BAConfig(**{**cfg["ba"], "impl": "pallas"})  # the kernel path's CPU twins
    ones = dict(dtype=torch.bool)

    def solve(st):
        return tba.bundle_adjust(st["intr"], st["cam_rot"], st["cam_t"], torch.ones(C, **ones),
                                 st["points"], torch.ones(P, **ones), scene.obs_cam,
                                 scene.obs_pt, scene.obs_uv, torch.ones(O, **ones), ba)

    return solve


@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_the_float64_reference_at_a_small_size(small, seed):
    start_gap, end_gap, excess = _numbers(small, seed, _port(small))
    assert start_gap <= START_GAP, start_gap
    assert end_gap <= END_GAP, end_gap
    assert abs(excess) <= EXCESS, excess


def test_the_comparison_fails_a_bfloat16_solve(small):
    """The reference in bfloat16 in the program's place fails each of the
    three tolerances: the comparison tells a solve one precision below the
    configuration's."""
    cfg, scene, _, _ = small

    def bf16(st):
        out = ref.solve(st["intr"], st["cam_rot"], st["cam_t"], st["points"], scene.obs_cam,
                        scene.obs_pt, scene.obs_uv, cfg["ba"], dtype=torch.bfloat16)
        return (*(x.float() for x in out[:4]), {k: float(v) for k, v in out[4].items()})

    start_gap, end_gap, excess = _numbers(small, SEEDS[0], bf16)
    assert start_gap > START_GAP and end_gap > END_GAP and abs(excess) > EXCESS, \
        (start_gap, end_gap, excess)
