"""Where the launch time of the gather (K8/K9) and Schur-matvec (K3)
wrappers goes, on one card.

    python -m tpusfm_torch.tools.launch_probe

Part 1 times each host step of a K8 launch with the host clock, at the
gather run's 32,768 ids (a kernel of ~2 us, so the host sets the pace): the
wrapper's checks and conversions, the output allocation, the device guard
and stream lookup the wrappers used to make (``torch.cuda.device`` and
``torch.cuda.current_stream``) against the raw-stream lookup they make now,
the ctypes call that launches the kernel, the error check and the launch
count; then the whole wrapper, the same steps in the order the wrappers
used to run them, and ``index_select`` on the same ids.  Each step is run
in batches of ``--reps`` calls; the median batch's mean is printed in
microseconds.  Host steps only: the kernel's own time is
``chip_smoke.py``'s.

Part 2 gives torch.profiler's device time of each of K3's three passes
(mean over the recorded launches of ten calls) at two shapes: the 200-view
rung's final BA, (C, P, O) = (200, 2048, 32768) with padding rows on
camera 0 at rank 2^30 as the engine pads its table, and the 500-camera
bench problem (500, 50000, 1484375).  The tables are made from a seed; W
is random bf16.

Part 3 profiles the 500-camera kernel-path solve forced to 20 LM
iterations: its device kernel time by kernel and its busy share.

Part 4 gives the device time of each pass of K2 (rank, camera, group and
chunk finish; rows outside every rank are written by extra blocks of the
rank pass's launch) and of K4 (chunk sums and finish), as part 2 does, at
the 200-view shape (K2 held and refine, K4 at D = 6 on the cameras and
D = 7 on one group) and at the 500-camera shape (K2 held, K4 at D = 6 on
the cameras and D = 9 on one group), with the calls the BA path makes.
Where the layout carries `seg_ranks`, K4 on the cameras is also timed on a
segment-ordered W (lane-major and row-major) and K2 with that copy
written.  ``--parts 4`` runs this part alone.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np


def _host_us(fn, reps: int, batches: int = 7) -> float:
    """Median over `batches` of the mean host time of `reps` calls, in us."""
    import torch

    means = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            fn()
        means.append((time.perf_counter_ns() - t0) / reps / 1e3)
    torch.cuda.synchronize()
    return statistics.median(means)


def host_steps(rows: int, reps: int) -> dict:
    """Part 1 at a K8 call of `rows` ids into a (200, 6) pose table."""
    import torch

    from ..ops import cuda_build
    from ..ops import obs_table as ot

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((200, 6), generator=gen, device=dev)
    idx = torch.randint(0, 200, (rows,), generator=gen, device=dev, dtype=torch.int32)
    ids_long = idx.long()
    lib = cuda_build.kernels()
    out = torch.empty((rows, 6), dtype=torch.float32, device=dev)
    raw = ot._raw_stream(dev)

    def launch():
        return lib.tpusfm_ba_gather(dev.index, table.data_ptr(), 200, 6, idx.data_ptr(), rows,
                                    out.data_ptr(), raw)

    def guard():
        with torch.cuda.device(dev):
            pass

    def parent_wrapper():
        # The wrapper's steps as they ran before (each conversion through
        # torch, the device guard and a Stream object around the launch).
        ot._dispatch("gather_table", table, idx)
        tab, ids = table.to(torch.float32).contiguous(), idx.to(torch.int32).contiguous()
        o = torch.empty((rows, 6), dtype=torch.float32, device=tab.device)
        lb = cuda_build.kernels()
        with torch.cuda.device(tab.device):
            stream = torch.cuda.current_stream(tab.device).cuda_stream
            err = lb.tpusfm_ba_gather(tab.device.index, tab.data_ptr(), 200, 6, ids.data_ptr(),
                                      rows, o.data_ptr(), stream)
        cuda_build.check(lb, err, "gather_table launch")
        ot.LAUNCHES["gather_table"] += 1
        return o

    steps = {
        "_dispatch (device checks)": lambda: ot._dispatch("gather_table", table, idx),
        "two .to().contiguous() (before)": lambda: (table.to(torch.float32).contiguous(),
                                                   idx.to(torch.int32).contiguous()),
        "_f32 + _i32 (now)": lambda: (ot._f32(table), ot._i32(idx)),
        "torch.empty (O, 6)": lambda: torch.empty((rows, 6), dtype=torch.float32, device=dev),
        "torch.cuda.device guard (before)": guard,
        "current_stream().cuda_stream (before)": lambda: torch.cuda.current_stream(dev)
        .cuda_stream,
        "_raw_stream (now)": lambda: ot._raw_stream(dev),
        "cuda_build.kernels()": cuda_build.kernels,
        "ctypes call + launch": launch,
        "cuda_build.check": lambda: cuda_build.check(lib, 0, "probe"),
        "LAUNCHES += 1": lambda: ot.LAUNCHES.__setitem__("gather_table",
                                                         ot.LAUNCHES["gather_table"] + 1),
        "whole wrapper, before": parent_wrapper,
        "whole wrapper, now (gather_table)": lambda: ot.gather_table(table, idx),
        "index_select": lambda: table.index_select(0, ids_long),
    }
    res = {name: _host_us(fn, reps) for name, fn in steps.items()}
    print(f"Host time per step of a K8 launch, {rows} ids into a (200, 6) table "
          f"(median of 7 batches of {reps} calls):")
    for name, us in res.items():
        print(f"  {name:42s} {us:8.2f} us")
    return res


def _pad_engine_table(prob: dict, O: int) -> tuple:
    """obs_cam and sorted ranks of `prob`, padded to O rows with rows of
    camera 0 at rank 2^30, as the engine pads its tables."""
    import torch

    from ..ops import obs_table as ot

    cam = torch.as_tensor(prob["obs_cam"]).to(torch.int32)
    ranks = torch.as_tensor(prob["obs_pt"]).to(torch.int32)
    pad = O - cam.shape[0]
    cam = torch.cat([cam, torch.zeros(pad, dtype=torch.int32)])
    ranks = torch.cat([ranks, torch.full((pad,), ot.INVALID_RANK, dtype=torch.int32)])
    return cam, ranks, pad


def _shapes():
    """(label, problem, rows after padding or None) of parts 2 and 4."""
    from ..utils.synth_scene import point_sorted_ba_problem

    return (("200-view final BA (padded to 32,768 rows)",
             point_sorted_ba_problem(200, 2048, seed=2, arc_deg=120.0, vis_prob=0.06), 32768),
            ("500-camera bench problem",
             point_sorted_ba_problem(500, 50000, seed=3, arc_deg=350.0, vis_prob=0.06), None))


def _passes(label: str, fn, runs: int) -> None:
    """Prints torch.profiler's device time of each kernel of `fn` (mean
    over the recorded launches of `runs` calls, after two warm-ups) and
    their sum per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .profile_rung import _device_kernels

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = _device_kernels(prof)
    print(f"{label}: device {sum(us / n for _, n, us in rows):.2f} us per call")
    for name, n, us in rows:
        print(f"  {us / n:8.2f} us ({n} records)  {name[:90]}")


def k3_passes(runs: int = 10) -> None:
    """Part 2: K3's three passes at two shapes."""
    import torch

    from ..ops import obs_table as ot

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, prob, O in _shapes():
        cam, ranks, pad = _pad_engine_table(prob, O or len(prob["obs_cam"]))
        cam, ranks = cam.to(dev), ranks.to(dev)
        O, C, P = cam.shape[0], prob["intr"].shape[0], prob["points"].shape[0]
        lay = ot.obs_layout(cam, C, ranks, P)
        W = torch.randn((18, O), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((C, 6), generator=gen, device=dev)
        hinv = 0.1 * torch.randn((P, 3, 3), generator=gen, device=dev)
        hcc = torch.randn((C, 6, 6), generator=gen, device=dev)

        def call():
            return ot.schur_mv_t(W, cam, ranks, v, hinv, P, hcc_d=hcc, layout=lay)

        _passes(f"K3 at {label}: C={C} P={P} O={O}, {pad} padding rows on camera 0, "
                f"{int(lay.chunk_start[-1])} chunks (bound {lay.chunk_bound})", call, runs)


def k2_k4_passes(runs: int = 10) -> None:
    """Part 4: K2's and K4's passes at the 200-view and 500-camera shapes."""
    import torch

    from ..ba import bundle_adjust as tba
    from ..ops import obs_table as ot

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(4)
    for label, prob, O in _shapes():
        cam, ranks, pad = _pad_engine_table(prob, O or len(prob["obs_cam"]))
        cam, ranks = cam.to(dev), ranks.to(dev)
        O, C, P = cam.shape[0], prob["intr"].shape[0], prob["points"].shape[0]
        uv = torch.cat([torch.as_tensor(prob["obs_uv"]), torch.zeros((pad, 2))]).to(dev)
        w = torch.cat([torch.ones(O - pad), torch.zeros(pad)]).to(dev)
        ps = torch.as_tensor(np.concatenate([prob["cam_rot"], prob["cam_t"]], 1), device=dev)
        intr, pts = torch.as_tensor(prob["intr"], device=dev), torch.as_tensor(
            prob["points"], device=dev)
        grp = torch.zeros_like(cam)
        lay, glay = ot.obs_layout(cam, C, ranks, P), ot.obs_layout(grp, 1, ranks, P)
        seg = hasattr(lay, "seg_ranks")
        a2 = (tba.camera_table(ps), intr, pts, cam, cam, ranks, uv.T.contiguous(), w)
        held = dict(w_dtype="bf16", layout=lay)
        head = f"at {label}: C={C} P={P} O={O}, {pad} padding rows on camera 0"
        k2 = [("K2 held", held)]
        if seg:
            k2.append(("K2 held, segment-ordered W written", dict(held, seg_ordered_w=True)))
        if O <= 32768:
            refine = dict(held, refine=True, refine_mask=(1.0,) * 7, grp_layout=glay)
            k2.append(("K2 refine, one group", dict(refine, seg_ordered_w=True) if seg
                       else refine))
        for name, kw in k2:
            args = a2 if not kw.get("refine") else a2[:1] + (intr[:1],) + a2[2:4] + (grp,) + a2[5:]
            _passes(f"{name} {head}", lambda: ot.linearize_reduce_radial3_t(*args, **kw), runs)
        z = torch.randn((P, 3), generator=gen, device=dev)
        Wc = torch.randn((18, O), generator=gen, device=dev).to(torch.bfloat16)
        d_grp = 7 if O <= 32768 else 9
        Wg = torch.randn((3 * d_grp, O), generator=gen, device=dev).to(torch.bfloat16)
        k4 = [("K4 D=6, cameras", lambda: ot.schur_bwd_t(Wc, cam, ranks, z, C, layout=lay)),
              (f"K4 D={d_grp}, one group",
               lambda: ot.schur_bwd_t(Wg, grp, ranks, z, 1, layout=glay))]
        if seg:
            perm = lay.seg_perm.long()
            lane, row = Wc[:, perm].contiguous(), Wc.T[perm].contiguous().T
            k4 += [("K4 D=6, cameras, segment-ordered W lane-major",
                    lambda: ot.schur_bwd_t(Wc, cam, ranks, z, C, layout=lay, w_seg=lane)),
                   ("K4 D=6, cameras, segment-ordered W row-major",
                    lambda: ot.schur_bwd_t(Wc, cam, ranks, z, C, layout=lay, w_seg=row))]
        for name, fn in k4:
            _passes(f"{name} {head}", fn, runs)


def forced_solve_busy_share() -> None:
    """Part 3: the 500-camera kernel-path solve forced to 20 LM iterations
    (chip_smoke.py's "kernels, 20 forced"), once plain for its wall time
    and once under torch.profiler: device kernel time by kernel, and the
    busy share (kernel time over the plain wall time)."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ba import bundle_adjust as tba
    from ..utils.synth_scene import point_sorted_ba_problem
    from .profile_rung import _device_kernels

    prob = point_sorted_ba_problem(500, 50000, seed=3, arc_deg=350.0, vis_prob=0.06)
    bench = {k: torch.as_tensor(v, device="cuda") for k, v in prob.items()}
    cfg = tba.BAConfig(max_iters=20, cg_iters=30, assume_sorted=True, converge_rtol=0.0)
    tba.bundle_adjust(cfg=dataclasses.replace(cfg, max_iters=1), **bench)

    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tba.bundle_adjust(cfg=cfg, **bench)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    wall, out = solve()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof, _ = solve()
    rows = _device_kernels(prof)
    busy = sum(us for _, _, us in rows) / 1e6
    its = int(out[4]["iterations"])
    print(f"500-camera kernel-path solve, 20 forced: {its} LM iterations in {wall:.4f} s "
          f"({its / wall:.3f} LM it/s; {wall_prof:.4f} s profiled); device kernel time "
          f"{busy:.4f} s from {sum(n for _, n, _ in rows)} launches, busy {busy / wall:.3f}")
    for name, n, us in rows[:8]:
        print(f"  {us / 1e3:9.3f} ms  {n:6d}  {name[:90]}")


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=500)
    ap.add_argument("--parts", type=int, nargs="+", default=[1, 2, 3, 4])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("launch_probe: no CUDA device visible to torch")
    print(torch.cuda.get_device_name(0))
    parts = {1: lambda: host_steps(32768, args.reps), 2: k3_passes, 3: forced_solve_busy_share,
             4: k2_k4_passes}
    for part in args.parts:
        parts[part]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
