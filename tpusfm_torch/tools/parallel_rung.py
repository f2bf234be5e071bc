"""Multi-rank rungs of the port on one host (``parallel/`` on
torch.distributed), each held against its single-device run: the phases
that ``chip_smoke.py`` (phases 25-30) drives on the card after its
single-device runs.

``run_world`` spawns `world` ranks joined by gloo (NCCL refuses two ranks
on one card; gloo moves each collective's tensors through host memory, the
compute stays on the card) and runs, in that one world and in this order:

  sparse   run_sparse(devices=world) over the 200-view medium rung held
           (rung_inputs(200)): matching split over the ranks (K1), full
           BAs past the engine's gate sharded (K2, then K5 and K4 at D = 6
           in point space);
  ba500    bench.py:171-202's 500-camera BA sharded on the kernel path,
           at a fixed number of LM iterations;
  selfcal  a one-group self-calibrating BA over the sparse rung's scene,
           sharded (K2 refine, K5 and K4 at D = 6 and 7);
  dense    dense_reconstruct(mesh=) over the dense rung's 6 views
           (tools/dense_rung.py's config);
  ring     ring_match_all_pairs over 64 views x 1024 descriptors on SIFT's
           u8 grid (half of each view's near view 0's), every ordered pair
           against K1 run locally.

``nccl_solve`` then runs one NCCL world of one rank in the caller's process
around the ba500 solve, so that the NCCL path starts and all-reduces on the
card, and ``check`` holds every rank's phases to their bars.  Each phase
resets the kernels' launch counts on its rank just before it runs and reads
them just after (``tools.kernel_calls``).
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from . import kernel_calls as kc

PHASES = ("sparse", "ba500", "selfcal", "dense", "ring")
BA500_ITERS = 10


def _sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def to_device(x, dev):
    """x with every tensor in it (through tuples, lists, dicts and
    dataclasses such as ObsLayout) moved to `dev`."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: to_device(getattr(x, f.name), dev)
                                         for f in dataclasses.fields(x)})
    return x


def _u8_grid(shape, seed: int, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.floor(torch.rand(shape, generator=gen, device=dev) * 256.0).clamp(max=255.0)


def _ba_args(arrays: dict, dev) -> dict:
    import torch

    keys = ("intr", "cam_rot", "cam_t", "cam_mask", "points", "point_mask", "obs_cam", "obs_pt",
            "obs_uv", "obs_mask")
    return {k: torch.as_tensor(np.asarray(arrays[k]), device=dev) for k in keys}


def _sharded(mesh, args: dict, cfg, **kw):
    from ..parallel import dist_ba

    obs = dist_ba.shard_obs_table(*(args[k].cpu().numpy() for k in ("obs_cam", "obs_pt",
                                                                   "obs_uv", "obs_mask")),
                                  mesh.size, device=args["intr"].device)
    rest = {k: v for k, v in args.items() if not k.startswith("obs_")}
    return dist_ba.bundle_adjust_sharded(mesh, **rest, obs_cam=obs[0], obs_pt=obs[1],
                                         obs_uv=obs[2], obs_mask=obs[3], cfg=cfg, **kw)


def _timed(fn, dev):
    _sync(dev)
    t0 = time.time()
    out = fn()
    _sync(dev)
    return out, time.time() - t0


# ---------------------------------------------------------------------------
# Phases, run on every rank
# ---------------------------------------------------------------------------

def phase_sparse(mesh, spec: dict) -> dict:
    from ..pipeline.sparse import run_sparse
    from ..utils import metrics

    dev = mesh.device
    images = np.load(spec["rung_images"], mmap_mode="r")
    gt, cfg = spec["rung_gt"], dataclasses.replace(spec["rung_cfg"], devices=mesh.size)
    kc.reset_counts()
    captured = {}
    with kc.recording(captured) as (_, calls):
        (scene, report), wall = _timed(
            lambda: run_sparse(np.asarray(images), gt["intr"], cfg, device=dev, seed=0), dev)
    reg = scene.cam_mask.cpu().numpy()
    ate = metrics.ate_rmse(scene.camera_centers().cpu().numpy()[reg], gt["centers"][reg])
    sharded = {k: v for k, v in report["ba_solves"].items() if "sharded" in k}
    return {"registered": int(reg.sum()), "n_views": len(reg), "ate": float(ate),
            "points": report["n_points"], "n_obs": report["n_obs"], "wall_s": wall,
            "times_s": report["times_s"],
            "recon_phase_s": report["recon_phase_s"], "sharded_solves": sharded,
            "launches": kc.counts(), "calls": kc.named(calls), "matches": captured["matches"],
            "finite": bool(np.isfinite(scene.points.cpu().numpy()).all()),
            # K5's held mode, new with sharding: its last call, for the caller
            # to hold against its twin.
            "k5_call": to_device(captured.get(("schur_fwd_t", "D=6")), "cpu")}


def phase_ba500(mesh, spec: dict) -> dict:
    from ..ba import bundle_adjust as tba

    dev = mesh.device
    args = _ba_args(np.load(spec["ba500"]), dev)
    cfg = tba.BAConfig(max_iters=BA500_ITERS, cg_iters=30, converge_rtol=0.0)
    _sharded(mesh, args, dataclasses.replace(cfg, max_iters=1))  # warm-up
    kc.reset_counts()
    with kc.recording() as (_, calls):
        out, wall = _timed(lambda: _sharded(mesh, args, cfg), dev)
    res = {"cost": float(out[4]["final_cost"]), "initial": float(out[4]["initial_cost"]),
           "iterations": int(out[4]["iterations"]), "wall_s": wall, "launches": kc.counts(),
           "calls": kc.named(calls), "finite": bool(out[3].isfinite().all())}
    if mesh.rank == 0:
        single, wall1 = _timed(lambda: tba.bundle_adjust(**args, cfg=cfg), dev)
        res.update(single_cost=float(single[4]["final_cost"]), single_wall_s=wall1,
                   single_iterations=int(single[4]["iterations"]))
    return res


def phase_selfcal(mesh, spec: dict) -> dict:
    import torch

    from ..ba import bundle_adjust as tba

    dev = mesh.device
    args = _ba_args(np.load(spec["selfcal"]), dev)
    C = args["intr"].shape[0]
    kw = dict(cam_group=torch.zeros(C, dtype=torch.long, device=dev), n_groups=1)
    cfg = tba.BAConfig(max_iters=10, refine_intrinsics=True)
    kc.reset_counts()
    with kc.recording() as (_, calls):
        out, wall = _timed(lambda: _sharded(mesh, args, cfg, **kw), dev)
    single = tba.bundle_adjust(**args, cfg=cfg, **kw)
    return {"fx": float(out[0][0, 0]), "fx_true": float(spec["fx_true"]),
            "cost": float(out[4]["final_cost"]), "single_cost": float(single[4]["final_cost"]),
            "single_fx": float(single[0][0, 0]), "iterations": int(out[4]["iterations"]),
            "wall_s": wall, "launches": kc.counts(), "calls": kc.named(calls)}


def phase_dense(mesh, spec: dict) -> dict:
    from ..dense.depth import dense_reconstruct
    from ..sfm.scene import scene_from_numpy
    from . import dense_rung

    dev = mesh.device
    scene = scene_from_numpy(np.load(spec["dense_scene"]), dev)
    images = np.load(spec["dense_images"])
    views, gt = spec["dense_views"], spec["dense_gt"]
    cfg = dense_rung.dense_rung_config()
    (pts, _, maps), wall = _timed(lambda: dense_reconstruct(
        scene, images, None, cfg, views=views, seed=0, return_maps=True, mesh=mesh,
        device=dev), dev)
    scale = dense_rung.gt_scale(scene, gt)
    return {"seconds": wall, "points": int(len(pts)), "finite": bool(np.isfinite(pts).all()),
            "depth_med_rel_err": dense_rung.depth_quality(maps["depths"], views, gt, scale),
            "depths": maps["depths"][views], "valid": maps["valid"][views]}


def phase_ring(mesh, spec: dict) -> dict:
    import torch

    from ..matching.match import match_on_device
    from ..parallel.ring_match import ring_match_all_pairs

    dev = mesh.device
    V, N = spec["ring"]
    desc = _u8_grid((V, N, 128), 7, dev)
    # Half of every view's features are view 0's moved by a few grid steps,
    # so that pairs of views share matches.
    gen = torch.Generator(device=dev).manual_seed(8)
    step = torch.randint(-3, 4, (V, N // 2, 128), generator=gen, device=dev)
    desc[:, : N // 2] = (desc[0, : N // 2] + step).clamp(0.0, 255.0)
    mask = torch.ones((V, N), dtype=torch.bool, device=dev)
    mask[5, N // 2:] = False
    kc.reset_counts()
    (idx, ok), wall = _timed(lambda: ring_match_all_pairs(mesh, desc, mask), dev)
    launches = kc.counts()
    Vl = V // mesh.size
    a = (torch.arange(Vl, device=dev) + mesh.rank * Vl).repeat_interleave(V)
    b = torch.arange(V, device=dev).repeat(Vl)
    i_loc, ok_loc = match_on_device(desc[a], desc[b], mask[a], mask[b], cross_check=False)
    i_loc, ok_loc = i_loc.reshape(Vl, V, N), ok_loc.reshape(Vl, V, N)
    return {"seconds": wall, "launches": launches, "shape": list(idx.shape),
            "ok_equal": bool(torch.equal(ok, ok_loc)),
            "idx_equal": bool(torch.equal(torch.where(ok, idx, -1),
                                          torch.where(ok_loc, i_loc, -1))),
            "ok_share": float(ok.float().mean())}


PHASE_FNS = {"sparse": phase_sparse, "ba500": phase_ba500, "selfcal": phase_selfcal,
             "dense": phase_dense, "ring": phase_ring}


def rank_main(rank: int, spec: dict) -> dict:
    """One rank of the world: every phase of spec["phases"] in order."""
    import torch

    from ..parallel import mesh as mesh_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = mesh_mod.make_mesh(device=spec["device"])
    out = {"rank": rank, "backend": mesh.backend, "device": str(mesh.device)}
    for name in spec["phases"]:
        t0 = time.time()
        out[name] = PHASE_FNS[name](mesh, spec)
        out[name]["phase_wall_s"] = time.time() - t0
    return out


def run_world(spec: dict, world: int, tmp: str) -> list[dict]:
    """Spawn the gloo world and return each rank's results."""
    from ..parallel import mesh as mesh_mod

    return mesh_mod.run_ranks(rank_main, world, backend="gloo",
                              init_method=f"file://{tmp}/world_init", args=(spec,))


def nccl_solve(ba500_path: str, tmp: str, device="cuda:0") -> dict:
    """The ba500 solve in a one-rank NCCL world of this process, against the
    single-device solve; the group is destroyed before returning."""
    import torch
    import torch.distributed as dist

    from ..ba import bundle_adjust as tba
    from ..parallel import mesh as mesh_mod

    dev = torch.device(device)
    args = _ba_args(np.load(ba500_path), dev)
    cfg = tba.BAConfig(max_iters=BA500_ITERS, cg_iters=30, converge_rtol=0.0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_init", world_size=1, rank=0,
                            timeout=mesh_mod._timeout())
    try:
        mesh = mesh_mod.make_mesh(device=dev)
        out, wall = _timed(lambda: _sharded(mesh, args, cfg), dev)
        backend = mesh.backend
    finally:
        dist.destroy_process_group()
    single, wall1 = _timed(lambda: tba.bundle_adjust(**args, cfg=cfg), dev)
    return {"backend": backend, "cost": float(out[4]["final_cost"]), "wall_s": wall,
            "single_cost": float(single[4]["final_cost"]), "single_wall_s": wall1,
            "iterations": int(out[4]["iterations"])}


# ---------------------------------------------------------------------------
# Inputs and bars
# ---------------------------------------------------------------------------

def prepare(tmp: str, rung, rung_scene, dense_scene, dense_images, dense_views, dense_gt,
            device, ba_size=(500, 50000), ring=(64, 1024)) -> tuple[dict, str]:
    """Write the world's inputs under `tmp`: the 200-view rung's images,
    its single-device scene (the selfcal phase's problem), the 500-camera
    problem and the dense rung's scene and images.  Returns (spec, the
    500-camera problem's path)."""
    from ..sfm.scene import scene_to_numpy
    from ..utils.synth_scene import point_sorted_ba_problem

    images, gt, cfg = rung
    p = Path(tmp)
    np.save(p / "rung.npy", np.asarray(images, np.float32))
    np.savez(p / "selfcal.npz", **scene_to_numpy(rung_scene))
    np.savez(p / "ba500.npz", **point_sorted_ba_problem(*ba_size, seed=3, arc_deg=350.0,
                                                        vis_prob=0.06))
    np.savez(p / "dense_scene.npz", **scene_to_numpy(dense_scene))
    np.save(p / "dense_images.npy", np.asarray(dense_images, np.float32))
    spec = {"device": str(device), "phases": PHASES, "rung_images": str(p / "rung.npy"),
            "rung_gt": gt, "rung_cfg": cfg, "selfcal": str(p / "selfcal.npz"),
            "fx_true": float(gt["intr"][0]), "ba500": str(p / "ba500.npz"),
            "dense_scene": str(p / "dense_scene.npz"),
            "dense_images": str(p / "dense_images.npy"), "dense_views": list(dense_views),
            "dense_gt": {k: dense_gt[k] for k in ("centers", "depth")}, "ring": tuple(ring)}
    return spec, str(p / "ba500.npz")


def check(results: list[dict], ref: dict, nccl: dict, dense_max_err: float,
          dense_min_points: int) -> list[str]:
    """Hold every rank's phases to their bars; returns printable lines and
    raises AssertionError on the first bar missed.  `ref`: the
    single-device runs (registered, points, matches, dense depths)."""
    lines = []
    for r in results:
        k = r["rank"]
        s = r["sparse"]
        lines.append(f"rank {k} ({r['backend']}, {r['device']}) sparse: registered "
                     f"{s['registered']}/{s['n_views']}, ATE {s['ate']:.5f}, points {s['points']}, "
                     f"observations {s['n_obs']}, wall {s['wall_s']:.2f} s, sharded BAs "
                     f"{json.dumps(s['sharded_solves'])}, launches {json.dumps(s['launches'])}, "
                     f"calls {json.dumps(s['calls'])}, times_s {json.dumps(s['times_s'])}")
        if s["registered"] < 190 or not s["ate"] <= 0.10 or s["points"] <= 1000 \
                or not s["finite"]:
            raise AssertionError(f"rank {k} sparse quality: {s['registered']} views, ATE "
                                 f"{s['ate']}, {s['points']} points")
        if s["registered"] < ref["registered"] - 2 \
                or abs(s["points"] - ref["points"]) > 0.1 * ref["points"]:
            raise AssertionError(f"rank {k} sparse: {s['registered']} views, {s['points']} "
                                 f"points against one device's {ref['registered']}, "
                                 f"{ref['points']}")
        (i2, v2), (i1, v1) = s["matches"], ref["matches"]
        if not (np.array_equal(v1, v2) and np.array_equal(i1, i2)):
            raise AssertionError(f"rank {k}: the sharded match table differs from one device's")
        if not s["sharded_solves"]:
            raise AssertionError(f"rank {k}: no full BA ran sharded")
        need = ("topk2_match", "linearize_reduce_radial3_t", "schur_bwd_t", "schur_fwd_t")
        if any(s["launches"][n] == 0 for n in need) or not s["calls"].get("schur_fwd_t D=6"):
            raise AssertionError(f"rank {k}: K1, K2, K4 or K5 (D=6) did not launch: "
                                 f"{s['launches']} {s['calls']}")
        b = r["ba500"]
        line = (f"rank {k} ba500: {b['iterations']} LM iterations in {b['wall_s']:.3f} s = "
                f"{b['iterations'] / b['wall_s']:.3f} LM it/s, cost {b['initial']:.6g} -> "
                f"{b['cost']:.6g}, launches {json.dumps(b['launches'])}")
        if "single_cost" in b:
            line += (f"; one device {b['single_iterations']} iterations in "
                     f"{b['single_wall_s']:.3f} s = "
                     f"{b['single_iterations'] / b['single_wall_s']:.3f} LM it/s, cost "
                     f"{b['single_cost']:.6g}")
            if not abs(b["cost"] - b["single_cost"]) <= 0.01 * b["single_cost"]:
                raise AssertionError(f"ba500 sharded cost {b['cost']} vs one device "
                                     f"{b['single_cost']}: more than 1% apart")
        lines.append(line)
        if not b["finite"] or b["launches"]["schur_fwd_t"] == 0:
            raise AssertionError(f"rank {k} ba500: {b}")
        c = r["selfcal"]
        err = c["fx"] / c["fx_true"] - 1.0
        lines.append(f"rank {k} selfcal: fx {c['fx']:.4f} ({100 * err:+.3f}%), cost "
                     f"{c['cost']:.6g} (one device {c['single_cost']:.6g}, fx "
                     f"{c['single_fx']:.4f}), {c['iterations']} iterations in "
                     f"{c['wall_s']:.3f} s, calls {json.dumps(c['calls'])}")
        if not abs(err) <= 0.01 or not abs(c["cost"] - c["single_cost"]) <= 0.01 * c["single_cost"]:
            raise AssertionError(f"rank {k} selfcal: fx {err:+.4f}, cost {c['cost']} vs "
                                 f"{c['single_cost']}")
        need = ("linearize_reduce_radial3_t refine", "schur_fwd_t D=6", "schur_fwd_t D=7",
                "schur_bwd_t D=6", "schur_bwd_t D=7")
        if any(not c["calls"].get(n) for n in need):
            raise AssertionError(f"rank {k} selfcal: a kernel variant did not launch: "
                                 f"{c['calls']}")
        d = r["dense"]
        same = float(np.mean(d["depths"] == ref["dense_depths"]))
        lines.append(f"rank {k} dense: {d['seconds']:.3f} s, {d['points']} fused points, PM "
                     f"error {d['depth_med_rel_err']}, depths equal to one device's on "
                     f"{100 * same:.3f}% of pixels")
        if d["depth_med_rel_err"] is None or not d["depth_med_rel_err"] <= dense_max_err \
                or d["points"] < dense_min_points or not d["finite"] or same < 0.99:
            raise AssertionError(f"rank {k} dense: error {d['depth_med_rel_err']}, "
                                 f"{d['points']} points, equal share {same}")
        g = r["ring"]
        lines.append(f"rank {k} ring: rows {g['shape']}, {g['seconds']:.3f} s, K1 launches "
                     f"{g['launches']['topk2_match']}, ok share {g['ok_share']:.4f}, equal to "
                     f"K1 locally: ok {g['ok_equal']}, idx {g['idx_equal']}")
        if not (g["ok_equal"] and g["idx_equal"]) or g["launches"]["topk2_match"] == 0:
            raise AssertionError(f"rank {k} ring: {g}")
    lines.append(f"nccl world of 1: backend {nccl['backend']}, ba500 cost {nccl['cost']:.6g} "
                 f"in {nccl['wall_s']:.3f} s (one device {nccl['single_cost']:.6g} in "
                 f"{nccl['single_wall_s']:.3f} s)")
    if nccl["backend"] != "nccl" or \
            not abs(nccl["cost"] - nccl["single_cost"]) <= 0.01 * nccl["single_cost"]:
        raise AssertionError(f"nccl: {nccl}")
    return lines
