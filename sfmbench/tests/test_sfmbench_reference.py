"""The plain reference against the port's CPU path, its Jacobians against
autodiff, and the imports of the reference and of a run."""

import ast
import json
import subprocess
import sys

import pytest
import torch
from torch.func import jacfwd

from sfmbench.gen import scene as gen
from sfmbench.reference import ba as ref
from sfmbench.tests.cells import REPO


def _problem(traffic_name="solve", C=24, P=400, O=2400, seed=5, outliers=True):
    cfg = json.loads((REPO / "sfmbench/configs/bal-venice-1778.json").read_text())
    cfg["problem"] = {"cameras": C, "points": P, "observations": O}
    cfg["assumed"]["problem_seed"] = seed
    if not outliers:
        cfg["assumed"]["outlier_share"] = 0.0
    traffic = json.loads((REPO / f"sfmbench/traffic/{traffic_name}.json").read_text())
    sc = gen.generate(cfg, "cpu")
    return cfg, traffic, sc, gen.start_state(sc, traffic, seed, 0)


def _residuals(intr, rot, t, pts, sc):
    R = ref.so3_exp(rot.double())
    c, p = sc.obs_cam.long(), sc.obs_pt.long()
    r, _ = ref._residual_rows(R[c], t.double()[c], intr.double()[c], pts.double()[p],
                              sc.obs_uv.double())
    return r


@pytest.mark.parametrize("traffic_name", ["solve", "selfcal"])
def test_reference_reaches_the_ports_answer(traffic_name):
    from tpusfm_torch.ba.bundle_adjust import BAConfig, bundle_adjust

    torch.set_num_threads(2)
    # Without outliers: a point whose second observation is an outlier has
    # two basins under the Huber cost, and float32 and float64 steps may end
    # in different ones.
    cfg, traffic, sc, st = _problem(traffic_name, outliers=False)
    # Run to convergence with CG solving each step to round-off, so that the
    # reference and the port's CPU path (dense Cholesky) take the same steps.
    ba = {**cfg["ba"], **traffic["ba"], "max_iters": 200, "cg_iters": 1000, "cg_tol": 1e-10}
    C, P, O = sc.shape
    kw = {}
    if traffic["groups"] == "one":
        kw = dict(cam_group=torch.zeros(C, dtype=torch.int64), n_groups=1)
    ones = lambda n: torch.ones(n, dtype=torch.bool)  # noqa: E731
    port = bundle_adjust(st["intr"], st["cam_rot"], st["cam_t"], ones(C), st["points"], ones(P),
                         sc.obs_cam, sc.obs_pt, sc.obs_uv, ones(O), BAConfig(**ba), **kw)
    mine = ref.solve(st["intr"], st["cam_rot"], st["cam_t"], st["points"], sc.obs_cam,
                     sc.obs_pt, sc.obs_uv, ba, dtype=torch.float64, **kw)
    tab = ref.make_table(sc.obs_cam, sc.obs_pt, sc.obs_uv, P,
                         kw.get("cam_group", torch.arange(C)), kw.get("n_groups", C),
                         torch.float64)
    c_port = float(ref.robust_cost(*port[:4], tab, ba["huber_delta"]))
    c_ref = float(mine[4]["final_cost"])
    c0 = float(mine[4]["initial_cost"])
    assert c_ref < 0.1 * c0
    # float32 against float64: both stop once a step gains under 3e-6 of the
    # cost, which float32 reads only to about 1e-7 a term.
    assert abs(c_port - c_ref) / c_ref < 2e-4
    # Poses and points through their projections, which no gauge moves.
    r_port = _residuals(*port[:4], sc)
    r_ref = _residuals(*mine[:4], sc)
    d = (r_port - r_ref).norm(dim=1)
    noise = cfg["assumed"]["noise_px"]
    assert float(d.median()) < 0.1 * noise
    assert float(torch.quantile(d, 0.99)) < noise
    # The focal itself is not compared here: at 24 cameras it lies in a flat
    # valley (the two answers' focals differ by ~0.8% at costs 1e-4 apart).


def test_jacobians_match_autodiff():
    _, _, sc, _ = _problem()
    pose = torch.cat([sc.aa[3], sc.t[3]]).double() + 0.1
    intr = sc.intr[3].double().clone()
    intr[6] = 0.01
    X = sc.points[5].double()
    uv = torch.tensor([800.0, 600.0], dtype=torch.float64)

    def res(pose, intr, X):
        R = ref.so3_exp(pose[:3][None])
        return ref._residual_rows(R, pose[3:][None], intr[None], X[None], uv[None])[0][0]

    want = jacfwd(res, argnums=(0, 1, 2))(pose, intr, X)
    R, Jr = ref.so3_exp(pose[:3][None]), ref.right_jacobian(pose[:3][None])
    _, terms = ref._residual_rows(R, pose[3:][None], intr[None], X[None], uv[None])
    got = ref._jacobians(R, Jr, intr[None], X[None], terms, True)
    for g, w in zip(got, (want[0], want[2], want[1])):
        assert torch.allclose(g[0], w, rtol=1e-10, atol=1e-9)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("sub", ["reference", "gen", "counts"])
def test_reference_and_generator_import_nothing_of_the_port(sub):
    for path in (REPO / "sfmbench" / sub).rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"tpusfm_torch", "tpusfm", "jax", "jaxlib"}, path
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); import sfmbench.{sub}; "
            f"import sfmbench.reference.ba, sfmbench.gen.scene, sfmbench.counts.kernels; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'tpusfm_torch', 'tpusfm', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_rehearsed_run_loads_no_jax(tmp_path):
    """A run's internals, rehearsed on the CPU at a tiny size, load no module
    whose top-level name is jax, jaxlib, flax or tpusfm (compared whole:
    tpusfm_torch is the program)."""
    code = f"""
import sys, time
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
import torch
torch.set_num_threads(2)
from sfmbench.tests.cells import tiny_root
from sfmbench.harness import run_cell
from sfmbench.run import forbidden_modules
root, cell = tiny_root(Path({str(tmp_path)!r}))
result, _ = run_cell(root, cell, 11, 0.5, False, "cpu", time.perf_counter())
assert result["correct"], result
print(forbidden_modules(), "tpusfm_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
