"""The harness: the result line, BENCHMARK.json's names, a cell, a traffic
driver and a check made of new files, no fallback to the CPU, correct =
false under the control and under faults planted in the timed path, and
the linear-algebra faults of faults.py reaching the answer."""

import json
import re
import subprocess
import sys
import time

import pytest
import torch

from sfmbench import faults, harness, spansum, tracesum
from sfmbench.readings import control_solver
from sfmbench.run import emit
from sfmbench.tests.cells import REPO, tiny_root
from sfmbench.tests.events import Event, profile_of

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _run(root, cell, trace=False, solver=None, seconds=0.5):
    torch.set_num_threads(2)
    return harness.run_cell(root, cell, 2**31 + 77, seconds, trace, "cpu", time.perf_counter(),
                            solver=solver)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_exactly_the_result_keys(tiny, trace, capsys):
    root, cell = tiny
    result, diag = _run(root, cell, trace)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(result) == want + ["checks"]
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"ba_solve_s", "ba_solve_p90_s", "setup_s"}
        for m in result["metrics"].values():
            assert set(m) == {"value", "unit"} and m["value"] > 0
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    emit(result, diag)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == result
    assert err.strip().splitlines()[-len(result["checks"]):] == [
        f"check {n}: {c['value']!r} (limit {c['limit']!r})" for n, c in result["checks"].items()]


def test_benchmark_json_names_and_units():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(b) == KEYS
    assert b["command"][1].startswith("sfmbench/") and b["paths"] == ["sfmbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("sfmbench/")
        assert (REPO / c["file"]).is_file() and c["reduced"] == []
    names = [c["name"] for c in b["configs"]]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\t" not in w["why"]
        traffic = json.loads((REPO / f"sfmbench/traffic/{w['traffic']}.json").read_text())
        assert (REPO / f"sfmbench/drivers/{traffic['driver']}.py").is_file()
        for number in json.loads((REPO / f"sfmbench/limits/{w['name']}.json").read_text()):
            assert (REPO / f"sfmbench/checks/{number}.py").is_file()
        assert (REPO / f"sfmbench/limits/{w['name']}.json").is_file()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert (REPO / f"sfmbench/e2e/{m['name']}.py").is_file()
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] == "ba_solve_s" and set(m["workloads"]) <= cells
        assert (REPO / f"sfmbench/metrics/{m['name']}.py").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    every = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(every) == len(set(every))


def test_a_cell_made_of_new_files_runs(tiny):
    root, cell = tiny
    for path in (REPO / "sfmbench").rglob("*"):
        rel = path.relative_to(REPO)
        if path.is_file() and "tests" not in rel.parts and "__pycache__" not in rel.parts:
            assert (root / rel).read_bytes() == path.read_bytes(), rel
    result, _ = _run(root, cell)
    assert result["correct"], result


NEW_DRIVER = '''"""A driver added as a file: the closed loop, its set-up marked."""
from pathlib import Path

from sfmbench.common import load_module

base = load_module(Path(__file__).with_name("ba_closed_loop.py"))


def run(cell, seed, seconds, trace_on, dev, t_start, solver=None):
    data, judging = base.run(cell, seed, seconds, trace_on, dev, t_start, solver)
    data.setup_parts["new driver"] = 0.0
    return data, judging
'''

NEW_CHECK = '''"""A check added as a file: each solve's LM iterations over the cap."""


def read(j):
    return {s.k: s.info["iterations"] / j.settings["max_iters"] for s in j.solves}
'''


def test_a_new_kind_of_traffic_and_check_come_as_files(tiny):
    """A traffic mix that names a driver of its own and a limit read by a
    check of its own: new files and entries only, no edit to a file that is
    there."""
    root, _ = tiny
    d = root / "sfmbench"
    before = {p: p.read_bytes() for p in d.rglob("*.py") if "__pycache__" not in p.parts}
    traffic = json.loads((d / "traffic/solve.json").read_text())
    (d / "traffic/loop2.json").write_text(json.dumps(dict(traffic, driver="loop2")))
    (d / "drivers/loop2.py").write_text(NEW_DRIVER)
    (d / "checks/iteration_share.py").write_text(NEW_CHECK)
    limits = json.loads((d / "limits/tiny.solve.json").read_text())
    (d / "limits/tiny.loop2.json").write_text(json.dumps(dict(limits, iteration_share=1.0)))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.loop2", "config": "tiny", "traffic": "loop2",
                               "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.get("workloads", []).append("tiny.loop2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())
    result, diag = _run(root, "tiny.loop2")
    assert result["correct"], result
    assert 0 < result["checks"]["iteration_share"]["value"] <= 1.0
    assert "new driver" in diag["setup_parts"]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "sfmbench/run.py", "--workload", "venice.solve",
                          "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    assert out.returncode != 0
    assert out.stdout == ""


def _faulty(kind):
    def solver(cell, scene):
        drv = harness.driver(cell)
        solve = drv.port_solver(cell, scene)
        if kind == "half_batch":
            from tpusfm_torch.ba.bundle_adjust import BAConfig, bundle_adjust

            C, P, O = scene.shape
            keep = torch.arange(O) % 2 == 0
            cfg = BAConfig(**drv.ba_settings(cell))
            ones = lambda n: torch.ones(n, dtype=torch.bool)  # noqa: E731

        def faulty(start):
            if kind == "unchanged":
                info = solve(start)[4]
                return start["intr"], start["cam_rot"], start["cam_t"], start["points"], info
            if kind == "half_batch":  # half the observations, the sums scaled back up
                out = bundle_adjust(start["intr"], start["cam_rot"], start["cam_t"], ones(C),
                                    start["points"], ones(P), scene.obs_cam, scene.obs_pt,
                                    scene.obs_uv, keep, cfg)
                info = dict(out[4], initial_cost=2 * out[4]["initial_cost"],
                            final_cost=2 * out[4]["final_cost"])
                return (*out[:4], info)
            intr, rot, t, pts, info = solve(start)  # an answer altered where it is made
            return intr, rot, t + 0.01, pts, info
        return faulty
    return solver


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
def test_planted_faults_are_not_correct(tiny, kind):
    root, cell = tiny
    result, _ = _run(root, cell, solver=_faulty(kind))
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


@pytest.fixture(scope="module")
def tiny_kernels(tmp_path_factory):
    """The tiny cell on the kernel path (``impl="pallas"``), whose calls run
    the kernels' plain twins on the CPU."""
    return tiny_root(tmp_path_factory.mktemp("kernels"), name="tinyk", ba={"impl": "pallas"})


def test_the_kernel_path_is_correct(tiny_kernels):
    root, cell = tiny_kernels
    result, _ = _run(root, cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("kind", faults.FAULTS)
def test_linear_algebra_faults_reach_the_solve(tiny_kernels, kind):
    """Each fault of faults.py, planted under the window, moves the answer
    that the checks judge (at the cells' sizes the comparison reads them as
    correct: PERF.md)."""
    root, cell = tiny_kernels
    sound, _ = _run(root, cell)
    port = harness.driver(harness.load_cell(root, cell)).port_solver
    planted, _ = _run(root, cell, solver=faults.solver(kind, port))
    excess = [r["checks"]["solve_excess"]["value"] for r in (sound, planted)]
    assert abs(excess[1] - excess[0]) > 1e-3, excess


def test_the_control_is_not_correct(tiny):
    root, cell = tiny
    result, _ = _run(root, cell, solver=control_solver, seconds=0.1)
    assert not result["correct"], result["checks"]


def test_trace_sums():
    """Kernels by short name, launches, the busy union in the window, idle
    gaps by host op; every user annotation's device projection dropped, not
    only the solve record's; no program span, so no span sums."""
    ev = [Event(False, tracesum.SOLVE_SPAN, 0, 1000, ua=True),
          Event(True, tracesum.SOLVE_SPAN, 0, 1000, ua=True),
          Event(True, "an annotation", 100, 700, ua=True),
          Event(False, "aten::item", 100, 400), Event(False, "aten::mul", 600, 700),
          Event(True, "void k1<float, 6>(float*)", 0, 100),
          Event(True, "void k1<float, 6>(float*)", 400, 600),
          Event(True, "Memcpy DtoH", 650, 800), Event(True, "void (anonymous namespace)::k2()", 780, 900)]
    ts = tracesum.summarize(profile_of(ev))
    assert ts.kernels == {"k1<float, 6>": [2, pytest.approx(300e-9)],
                          "{anonymous}::k2": [1, pytest.approx(120e-9)]}
    assert ts.launches == 3
    assert ts.busy_s == pytest.approx(550e-9) and ts.window_s == pytest.approx(1000e-9)
    # Idle 100-400 (under aten::item) and 600-650 (under aten::mul); 900-1000 under none.
    assert ts.gaps == pytest.approx({"aten::item": 300e-9, "aten::mul": 50e-9,
                                     spansum.NO_OP: 100e-9})
    assert ts.spans == {}
