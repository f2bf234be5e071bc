"""The port's HTTP service over two ranks (``serve --devices 2``) on the CPU,
on tests/test_mesh_pipeline.py's 6-view 240x320 scene and overrides, in
spawned gloo worlds of 2 ranks (one torch thread each, no JAX in a rank):

(a) world A, rank 0 serving on 127.0.0.1 (start_background) and rank 1
    following (ServiceState.follow): the views uploaded as PNG, then
    /preprocessing, /sparse, /dense and /mesh.  Held against the port's
    single-device service and the reference's service on its 8-device CPU
    mesh (ServiceState with devices=8), both run in this process meanwhile,
    with test_mesh_pipeline's bars: registered within one, ATE < 0.08,
    points within 10%, and the putative match table equal to the port's
    single-device one;
(b) rank 1 holds its end of /preprocessing HOLD_S past rank 0's: busy
    stays, and /dense and /sparse answer 409, until rank 1 has ended;
(c) /dense before /sparse, which every rank raises alike: /status and the
    error event name both ranks, and /sparse then runs;
(d) world D, both ranks in serve() (the CLI's blocking entry), rank 1's
    sparse stage patched to raise alone: rank 0's /status names rank 1
    within GRACE_S plus a few seconds, later triggers answer 503, and both
    processes exit with code 1 within EXIT_S, not a collective's timeout;
(e) in world D before that, rank 1 idles IDLE_S, four periods of the
    stage barriers' wait (parallel.mesh.WAIT_S, shortened to WAIT_S in
    world D only), then both ranks run a stage through those barriers;
    then /mesh before /dense, which rank 0 runs alone and fails: rank 1
    learns it and raises too, and the service keeps serving;
(f) no rank imports jax.
PEER_GRACE_S and FAILED_LINGER_S are shortened in world D only.  Without a
world, in this process: rank 0 closing its server while a stage still runs
waits PEER_GRACE_S (shortened there) and then puts the ranks out of step,
which a follower's command wait sees.
"""

import json
import multiprocessing as mp
import socket
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 2
OVERRIDES = {"sift.n_octaves": 3, "sift.max_per_octave": 512, "sift.max_features": 768,
             "matching.pair_chunk": 4, "filter.max_iterations": 128, "feature_batch": 3}
FOCAL = 0.9 * 320
HOLD_S = 2.0                  # (b)
WAIT_S, IDLE_S = 1.5, 6.0     # (e)
GRACE_S, LINGER_S = 3.0, 2.0  # (d)
EXIT_S = 30.0                 # (d): both processes gone this long after the failing trigger


def _cfg(devices):
    from tpusfm_torch.dense.depth import DenseConfig
    from tpusfm_torch.pipeline.config import config_from_overrides

    return config_from_overrides(**OVERRIDES, focal_prior_px=FOCAL, devices=devices,
                                 dense=DenseConfig(n_planes=24, n_sources=3, patchmatch=False,
                                                   view_batch=1))


def _matches(ws):
    with np.load(Path(ws) / "matches_putative.npz") as d:
        return d["idx"], d["valid"]


def _world_a(rank, files, ws):
    from tpusfm_torch.service import http_server as hs
    from tpusfm_torch.tools.service_rung import Client

    cfg = _cfg(WORLD)
    if rank:
        state = hs.ServiceState(ws, cfg, device="cpu")
        sync, held = state.pipeline.sync, []

        def slow_sync():  # (b): the first stage ends HOLD_S later here
            sync()
            if not held:
                held.append(True)
                time.sleep(HOLD_S)

        state.pipeline.sync = slow_sync
        state.follow()
        return {"jax": "jax" in sys.modules, "writer": state.pipeline.writer}
    httpd, state, port = hs.start_background(ws, cfg, host="127.0.0.1", device="cpu")
    c = Client(port)
    out = {"jax": "jax" in sys.modules, "writer": state.pipeline.writer}
    try:
        out["upload"] = c.post_multipart("/upload", files)
        t0 = time.time()
        out["trigger"] = c.get("/preprocessing")
        while not (Path(ws) / "features.npz").exists() and time.time() - t0 < 120:
            time.sleep(0.05)
        time.sleep(0.5)  # rank 0's part has ended; rank 1's has HOLD_S to go
        out["held"] = {"status": c.get_json("/status")[1], "dense": c.get_json("/dense"),
                       "sparse": c.get("/sparse")}
        out["held"]["idle"] = c.wait_idle(120)
        out["held"]["wall_s"] = time.time() - t0
        out["early_dense"] = c.get_json("/dense"), c.wait_idle(120)
        out["early_dense_event"] = [e.payload for e in state.bus.history if e.type == "error"]
        for stage in ("sparse", "dense", "mesh"):
            out[stage] = c.get(f"/{stage}")[0], c.wait_idle(600)
        out["rank_stage_s"] = state.rank_stage_s
        out["matches"] = _matches(ws)
    finally:
        httpd.shutdown()
        httpd.server_close()  # stops rank 1
    return out


def _service_single(start, files, ws, cfg, **kw):
    from tpusfm_torch.tools.service_rung import Client, run_stages

    httpd, _, port = start(str(ws), cfg, host="127.0.0.1", **kw)
    try:
        c = Client(port)
        c.post_multipart("/upload", files)
        run_stages(c, ("preprocessing", "sparse"), 600)
    finally:
        httpd.shutdown()
        httpd.server_close()


def _serve_rank(rank, init, ws, port, out_dir):
    """One rank of world D: the CLI's entry, serve(), with the waits and
    graces shortened here only and rank 1's sparse stage raising."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from tpusfm_torch.parallel import mesh as tmesh
    from tpusfm_torch.pipeline.staged import StagedPipeline
    from tpusfm_torch.service import http_server as hs

    tmesh.WAIT_S = WAIT_S
    hs.PEER_GRACE_S, hs.FAILED_LINGER_S = GRACE_S, LINGER_S
    if rank == 1:
        def fail_alone(self, generator):
            raise RuntimeError("injected failure on rank 1")

        StagedPipeline._sparse = fail_alone
    dist.init_process_group("gloo", init_method=init, world_size=WORLD, rank=rank)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps({"jax": "jax" in sys.modules}))
    hs.serve(ws, _cfg(WORLD), host="127.0.0.1", port=port, device="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world_d(root):
    """Drive world D from this process as its HTTP client."""
    from tpusfm_torch.tools.service_rung import Client

    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_serve_rank, daemon=True,
                         args=(r, f"file://{root}/init", str(root / "ws"), port, str(root)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    out = {}
    try:
        c = Client(port)
        end = time.time() + 180
        while True:
            try:
                c.get_json("/status")
                break
            except OSError:
                if time.time() > end or any(p.exitcode is not None for p in procs):
                    raise
                time.sleep(0.2)
        time.sleep(IDLE_S)  # (e)
        out["after_idle"] = c.get_json("/dense"), c.wait_idle(60)
        out["mesh_first"] = c.get_json("/mesh"), c.wait_idle(60)
        t0 = time.time()
        out["trigger"] = c.get_json("/sparse")
        while True:
            st = c.get_json("/status")[1]
            if (st["error"] and "out of step" in st["error"]) or time.time() - t0 > 120:
                break
            time.sleep(0.1)
        out["failed"] = st, time.time() - t0
        out["later"] = [c.get_json(f"/{s}") for s in ("preprocessing", "sparse", "dense", "mesh")]
        out["later_s"] = time.time() - t0
        for p in procs:
            p.join(timeout=max(0.0, t0 + EXIT_S - time.time()))
        out["exit"] = [p.exitcode for p in procs], time.time() - t0
        out["ranks"] = [json.loads((root / f"rank{r}.json").read_text()) for r in range(WORLD)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return out


@pytest.fixture(scope="module")
def scene6():
    from tpusfm_torch.utils.synth_render import render_orbit_images

    return render_orbit_images(n_views=6, img_h=240, img_w=320, focal=FOCAL, arc_deg=60.0,
                               seed=1)


@pytest.fixture(scope="module")
def runs(scene6, tmp_path_factory):
    """World A and world D run in spawned processes while this process runs
    the port's single-device service and the reference's 8-device one."""
    from tpusfm.pipeline.config import config_from_overrides as jcfg
    from tpusfm.service import http_server as jserver
    from tpusfm_torch.parallel import mesh as tmesh
    from tpusfm_torch.service import http_server as tserver
    from tpusfm_torch.tools.service_rung import png_bytes

    images, _ = scene6
    files = [(f"view_{i:03d}.png", png_bytes(im)) for i, im in enumerate(images)]
    root_a, root_d = tmp_path_factory.mktemp("world_a"), tmp_path_factory.mktemp("world_d")
    got = {}

    def run(name, fn, *args):
        try:
            got[name] = fn(*args)
        except BaseException as e:  # re-raised below, in the fixture's thread
            got[name] = e

    world_a = (lambda: tmesh.run_ranks(_world_a, WORLD, backend="gloo",
                                       init_method=f"file://{root_a}/init",
                                       args=(files, str(root_a / "ws")), threads=1))
    threads = [threading.Thread(target=run, args=("a", world_a)),
               threading.Thread(target=run, args=("d", _world_d, root_d))]
    for t in threads:
        t.start()
    torch.set_num_threads(2)
    single = tmp_path_factory.mktemp("single") / "ws"
    _service_single(tserver.start_background, files, single, _cfg(None), device="cpu")
    ref = tmp_path_factory.mktemp("ref") / "ws"
    _service_single(jserver.start_background, files, ref,
                    jcfg(**OVERRIDES, focal_prior_px=FOCAL, devices=8))
    for t in threads:
        t.join()
    for v in got.values():
        if isinstance(v, BaseException):
            raise v
    return {"a": got["a"], "d": got["d"], "ws": root_a / "ws", "single": single, "ref": ref}


def test_two_ranks_run_every_stage(runs):
    r0, r1 = runs["a"]
    assert [r0["writer"], r1["writer"]] == [True, False]
    assert r0["upload"] == (200, {"saved": [f"view_{i:03d}.png" for i in range(6)]})
    for stage in ("sparse", "dense", "mesh"):
        code, st = r0[stage]
        assert code == 200 and st["error"] is None, (stage, st)
    st = r0["mesh"][1]
    assert set(st["stage_s"]) == {"preprocessing", "sparse", "dense", "mesh"}
    assert st["device"] == "cpu" and st["workspace"] == str(runs["ws"])
    for name in ("scene.npz", "colorized.ply", "report.json", "dense.ply", "depth_maps.npz",
                 "mesh.ply", "textured_mesh.obj"):
        assert name in st["artifacts"], name
    assert set(r0["rank_stage_s"]["mesh"]) == {0, 1}


@pytest.mark.parametrize("other", ["single", "ref"])
def test_two_ranks_match_one_device_and_the_reference(runs, scene6, other):
    """test_mesh_pipeline's bars against the port's single-device service
    and the reference's 8-device service; the match table bit-equal to the
    port's single-device one (sharded matching is exact per pair)."""
    from tpusfm_torch.tools.service_rung import scene_quality

    gt = scene6[1]
    two, one = scene_quality(runs["ws"], gt), scene_quality(runs[other], gt)
    assert abs(two["registered"] - one["registered"]) <= 1, (two, one)
    assert two["ate"] < 0.08 and two["finite"], two
    assert abs(two["points"] - one["points"]) <= 0.1 * one["points"], (two, one)
    if other == "single":
        for a, b in zip(runs["a"][0]["matches"], _matches(runs["single"])):
            np.testing.assert_array_equal(a, b)


def test_busy_until_every_rank_has_ended(runs):
    r0 = runs["a"][0]
    held = r0["held"]
    assert r0["trigger"] == (200, b"preprocessing begin")
    assert held["status"]["busy"] == "preprocessing"
    assert held["dense"] == (409, {"status": "busy", "result": "/files/dense.ply"})
    assert held["sparse"] == (409, b"busy")
    assert held["idle"]["error"] is None and held["wall_s"] >= HOLD_S
    s = r0["rank_stage_s"]["preprocessing"]
    assert s[1] >= HOLD_S and s[0] < s[1] - 1.0, s


def test_error_every_rank_raises_keeps_serving(runs):
    r0 = runs["a"][0]
    (code, body), st = r0["early_dense"]
    assert code == 200 and body["status"] == "dense begin"
    assert st["error"].startswith("ranks 0, 1: FileNotFoundError"), st["error"]
    ev = r0["early_dense_event"][-1]
    assert ev["stage"] == "dense" and ev["ranks"] == [0, 1] and ev["error"] == st["error"]
    assert r0["sparse"][0] == 200 and r0["sparse"][1]["error"] is None


def test_follower_outlives_idle_periods_of_the_stage_wait(runs):
    (code, body), st = runs["d"]["after_idle"]
    assert IDLE_S >= 4 * WAIT_S
    assert code == 200 and st["error"].startswith("ranks 0, 1: FileNotFoundError"), st


def test_error_in_rank0_solo_work_is_raised_by_every_rank(runs):
    """The mesh stage runs on rank 0 alone; its error reaches rank 1,
    which raises too, so the ranks stay in step (the next stage runs)."""
    (code, body), st = runs["d"]["mesh_first"]
    assert code == 200 and body["status"] == "mesh begin"
    assert st["error"].startswith("rank 0: "), st["error"]
    assert "rank 1: RuntimeError: rank 0 raised in work it does alone" in st["error"]
    assert runs["d"]["trigger"][0] == 200


def test_failure_on_one_rank_ends_the_world(runs):
    d = runs["d"]
    st, named_s = d["failed"]
    assert d["trigger"][0] == 200
    assert st["error"].startswith("rank 1: RuntimeError: injected failure on rank 1"), st
    assert "out of step" in st["error"] and st["busy"] is None
    assert named_s < GRACE_S + 10.0, named_s
    for code, body in d["later"]:
        assert code == 503 and body == {"status": "error", "error": st["error"]}
    codes, exit_s = d["exit"]
    assert codes == [1, 1] and exit_s < EXIT_S, d["exit"]


def test_no_rank_imports_jax(runs):
    assert not any(r["jax"] for r in runs["a"])
    assert not any(r["jax"] for r in runs["d"]["ranks"])


def test_close_during_a_stage_puts_the_ranks_out_of_step(tmp_path, monkeypatch):
    """Rank 0's close() waits for a running stage only PEER_GRACE_S, then
    records why on the command store, so that the followers leave."""
    import torch.distributed as dist

    from tpusfm_torch.pipeline.config import PipelineConfig
    from tpusfm_torch.service import http_server as hs

    monkeypatch.setattr(hs, "PEER_GRACE_S", 0.5)
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    ranks = []
    for rank in range(WORLD):
        r = object.__new__(hs._Ranks)
        r.rank, r.size, r.seq, r.store = rank, WORLD, 0, store
        ranks.append(r)
    state = hs.ServiceState(str(tmp_path / "ws"), PipelineConfig(), device="cpu")
    state.ranks, state.busy_stage = ranks[0], "sparse"  # a stage that never ends
    ranks[0].command("sparse")
    t0 = time.time()
    state.close()
    waited = time.time() - t0
    assert 0.5 <= waited < 5.0, waited
    assert state.failed.startswith("rank 0 stopped the service with stage sparse still running")
    assert state.world_down.is_set() and state.last_error == state.failed
    assert state.busy_stage is None
    assert ranks[1].next_command() == "sparse" and ranks[1].next_command() is None
    assert ranks[1].failed() == state.failed
