"""The port's data-parallel pipeline (PipelineConfig.devices) on
tests/test_mesh_pipeline.py's 6-view scene and bars, in one spawned gloo
world of 2 CPU ranks (one torch thread each, no JAX): run_sparse with
devices=2 against devices=None (matching split over the ranks must give
the same match tables; registered views within one, ATE < 0.08, points
within 10%), again with the engine's mesh gate at one observation a rank
so that its full BAs shard, dense_reconstruct(mesh=) against the
single-device maps, and the CLI and the staged pipeline with --devices 2
(rank 0 alone writes; a resumed sparse stage takes rank 0's view of the
workspace on every rank).  Also a two-process initialize_distributed test
mirroring tests/test_multihost.py."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpusfm_torch.parallel import mesh as tmesh

WORLD = 2
OVERRIDES = {"sift.n_octaves": 3, "sift.max_per_octave": 512, "sift.max_features": 768,
             "matching.pair_chunk": 4, "filter.max_iterations": 128, "feature_batch": 3}


def _world(rank, images, intr, ws_root):
    import torch.distributed as dist

    from tpusfm_torch import cli
    from tpusfm_torch.dense import depth as tdepth
    from tpusfm_torch.tools.service_rung import png_bytes
    from tpusfm_torch.pipeline import config as tconfig
    from tpusfm_torch.pipeline import sparse as tsparse
    from tpusfm_torch.pipeline.staged import StagedPipeline
    from tpusfm_torch.tools.kernel_calls import recording

    out = {"jax_imported": "jax" in sys.modules}
    cfg1 = tconfig.config_from_overrides(**OVERRIDES)
    cfg2 = dataclasses.replace(cfg1, devices=WORLD)
    m = tsparse.get_mesh(cfg2, "cpu")

    def run(cfg):
        captured = {}
        with recording(captured):  # keeps the run's match table
            scene, rep = tsparse.run_sparse(images, intr, cfg, device="cpu")
        return scene, dict(reg=scene.cam_mask.numpy(), centers=scene.camera_centers().numpy(),
                           points=scene.points.numpy(), n_points=rep["n_points"],
                           ba_solves=rep["ba_solves"], log=rep["engine_log"],
                           matches=captured["matches"])

    scene1, out["single"] = run(cfg1)
    _, out["sharded"] = run(cfg2)
    gate1 = dataclasses.replace(cfg2, engine=dataclasses.replace(cfg2.engine,
                                                                 mesh_min_obs_per_device=1))
    _, out["sharded_gate1"] = run(gate1)

    cfg_d = tdepth.DenseConfig(n_planes=24, n_sources=3, patchmatch=False, view_batch=1)
    out["dense"] = [tdepth.dense_reconstruct(scene1, images, None, cfg=cfg_d, return_maps=True,
                                             mesh=mesh, device="cpu")
                    for mesh in (None, m)]

    # The CLI under a group of 2 (torchrun's environment is already joined
    # here), then the staged dense stage on its workspace.
    src, ws = Path(ws_root) / "frames", Path(ws_root) / "ws"
    if rank == 0:
        src.mkdir()
        for i, im in enumerate(images):
            (src / f"f{i:02d}.png").write_bytes(png_bytes(im))
    dist.barrier()
    cli.main(["reconstruct", str(src), "--workspace", str(ws), "--device", "cpu", "--devices",
              str(WORLD), "--focal", str(float(intr[0])), "--max-features", "768"])
    out["cli_kept_group"] = dist.is_initialized()  # the CLI leaves a group it did not make
    staged_cfg = dataclasses.replace(cfg2, dense=cfg_d)
    pipe = StagedPipeline(ws, staged_cfg, device="cpu")
    out["writer"] = pipe.writer

    # A resumed sparse stage: matches_putative.npz kept, the later files
    # gone.  Rank 1 sees the workspace as a rank that looks after rank 0 has
    # written would (every file there); it must still take rank 0's
    # branches, so it recomputes what rank 0 recomputes.
    putative = ws / "matches_putative.npz"
    if rank == 0:
        out["putative_ns"] = putative.stat().st_mtime_ns
        (ws / "matches_geometric.npz").unlink()
        (ws / "scene.npz").unlink()
    dist.barrier()
    if rank == 1:
        pipe._done = lambda name: True
    scene_r, rep_r = pipe.sparse()
    out["resumed"] = dict(reg=scene_r.cam_mask.numpy(), points=scene_r.points.numpy(),
                          log=rep_r["engine_log"], putative_ns=putative.stat().st_mtime_ns)
    if rank == 1:
        del pipe._done
    pts, _ = pipe.dense()
    out["staged_dense_points"] = len(pts)
    out["files"] = sorted(p.name for p in ws.iterdir())
    return out


@pytest.fixture(scope="module")
def scene6():
    from tpusfm_torch.utils.synth_render import render_orbit_images

    return render_orbit_images(n_views=6, img_h=240, img_w=320, focal=0.9 * 320, arc_deg=60.0,
                               seed=1)


@pytest.fixture(scope="module")
def port(scene6, tmp_path_factory):
    images, gt = scene6
    root = tmp_path_factory.mktemp("mesh_pipeline")
    return tmesh.run_ranks(_world, WORLD, backend="gloo", init_method=f"file://{root}/init",
                           args=(images, gt["intr"], str(root)), threads=1)


def test_world_imports_no_jax(port):
    assert not any(r["jax_imported"] for r in port)


@pytest.mark.parametrize("run", ["sharded", "sharded_gate1"])
def test_sharded_matching_equals_single_device(port, run):
    for r in port:
        (i1, v1), (i2, v2) = r["single"]["matches"], r[run]["matches"]
        np.testing.assert_array_equal(v1, v2)
        np.testing.assert_array_equal(i1, i2)
        assert v1.sum() > 0


@pytest.mark.parametrize("run", ["sharded", "sharded_gate1"])
def test_run_sparse_on_mesh_matches_single_device(port, scene6, run):
    from tpusfm_torch.utils import metrics

    gt = scene6[1]
    for r in port:
        one, many = r["single"], r[run]
        assert many["reg"].sum() >= one["reg"].sum() - 1, many["log"]
        reg = many["reg"]
        ate = metrics.ate_rmse(many["centers"][reg], gt["centers"][reg])
        assert ate < 0.08, ate
        assert abs(many["n_points"] - one["n_points"]) <= 0.1 * one["n_points"]
        sharded = [k for k in many["ba_solves"] if "sharded" in k]
        # The default gate (8192 live observations a rank) keeps this
        # scene's few hundred on one device; at one a rank every full BA
        # shards.
        assert bool(sharded) == (run == "sharded_gate1"), many["ba_solves"]
    # Every rank computes the same scene.
    np.testing.assert_array_equal(port[0][run]["points"], port[1][run]["points"])


def test_dense_on_mesh_matches_single_device(port):
    for r in port:
        (pts1, _, maps1), (pts2, _, maps2) = r["dense"]
        d1, d2 = maps1["depths"], maps2["depths"]
        nz = d1 > 0
        assert nz.any()
        # tests/test_mesh_pipeline.py's bars; the port's split computes the
        # same maps bit for bit.
        assert (np.abs(d2[nz] - d1[nz]) / np.maximum(d1[nz], 1e-6) < 2e-3).mean() > 0.99
        assert abs(len(pts2) - len(pts1)) <= 0.05 * max(len(pts1), 1)
        np.testing.assert_array_equal(d1, d2)


def test_cli_and_staged_pipeline_on_two_ranks(port):
    assert [r["writer"] for r in port] == [True, False]
    assert all(r["cli_kept_group"] for r in port)
    files = port[0]["files"]
    for name in ("scene.npz", "report.json", "features.npz", "matches_geometric.npz",
                 "dense.ply", "depth_maps.npz", "config.json"):
        assert name in files, files
    assert port[0]["staged_dense_points"] == port[1]["staged_dense_points"] > 0


def test_staged_sparse_resumes_on_two_ranks(port):
    """The resumed stage reuses matches_putative.npz, rewrites the files
    that were gone, and both ranks reconstruct the same scene."""
    one, two = port[0]["resumed"], port[1]["resumed"]
    assert one["putative_ns"] == two["putative_ns"] == port[0]["putative_ns"]
    for name in ("matches_geometric.npz", "scene.npz"):
        assert name in port[0]["files"]
    assert one["reg"].sum() >= 5
    untimed = [[line for line in r["log"] if not line.startswith("phase seconds")]
               for r in (one, two)]
    assert untimed[0] == untimed[1]
    np.testing.assert_array_equal(one["reg"], two["reg"])
    np.testing.assert_array_equal(one["points"], two["points"])


_INIT_WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from tpusfm_torch.parallel import mesh as tmesh, dist_ba
from tpusfm_torch.ba import bundle_adjust as tba
from tpusfm_torch.utils.synth_scene import point_sorted_ba_problem
pid = int(sys.argv[1])
assert tmesh.initialize_distributed({init!r}, 2, pid, device="cpu")
assert not tmesh.initialize_distributed({init!r}, 2, pid, device="cpu")  # idempotent
m = tmesh.make_mesh(2, device="cpu")
assert tmesh.psum(torch.ones(2), "shard").tolist() == [2.0, 2.0]
prob = point_sorted_ba_problem(12, 200, seed=5, vis_prob=0.5)
t = {{k: torch.as_tensor(v) for k, v in prob.items()}}
obs = dist_ba.shard_obs_table(prob["obs_cam"], prob["obs_pt"], prob["obs_uv"], prob["obs_mask"],
                              2, device="cpu")
rest = {{k: v for k, v in t.items() if not k.startswith("obs_")}}
cfg = tba.BAConfig(max_iters=6)
a = dist_ba.bundle_adjust_sharded(m, **rest, obs_cam=obs[0], obs_pt=obs[1], obs_uv=obs[2],
                                  obs_mask=obs[3], cfg=cfg)
b = tba.bundle_adjust(**t, cfg=cfg)
assert abs(float(a[4]["final_cost"]) - float(b[4]["final_cost"])) < 0.05 * float(b[4]["final_cost"])
assert float((a[2] - b[2]).abs().max()) < 5e-3
assert "jax" not in sys.modules
print(f"INIT_WORKER_OK pid={{pid}}")
"""


def test_two_process_initialize_distributed(tmp_path):
    """tests/test_multihost.py's shape: two OS processes join through
    initialize_distributed and run a sharded BA across the process
    boundary, each holding it to its own single-device solve."""
    repo = str(Path(__file__).resolve().parents[1])
    code = _INIT_WORKER.format(repo=repo, init=f"file://{tmp_path}/init")
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(pid)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-4000:]
        assert f"INIT_WORKER_OK pid={pid}" in out, out[-4000:]
