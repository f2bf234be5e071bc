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

Part 5 (``--parts 5``) splits the device time of the sublane entry points
that build their own layout (``segsum_table``, ``schur_bwd``) into the
layout's kernels and K6's or K4's, by kernel name, beside their time by
CUDA events: at path B's cameras (the 500-camera table, K6 at k = 96 and
K4 at D = 6, bf16 W) and at path A's one group (the 200-view padded table,
K4 at D = 7), and the layout alone (``obs_layout``) at both.  Then, with
one layout, K4 alone at path B in its reads, in turns: row-major permuted,
lane-major permuted and row-major segment-ordered; K7 at the gather path's
200-view shape and at path B (k = 12) with its input as the BA passed it
(a lane-major copy) and read in place (the row-major view), in turns; and
the host us per call of the wrappers of K6, K7 and K2 unreduced at the
200-view shape.
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


def _events_ms(fn, runs: int = 20) -> float:
    """Median CUDA-events time of one call, after two warm-ups, in ms."""
    import torch

    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _split(label: str, fn, own: tuple, runs: int = 10) -> dict:
    """Device us per call of `fn` split into the kernels whose names hold
    one of `own` and the rest (the layout's), each kernel's recorded time
    over `runs` calls, beside its events time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .profile_rung import _device_kernels

    ms = _events_ms(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = _device_kernels(prof)
    mine = sum(us for name, _, us in rows if any(k in name for k in own)) / runs
    rest = sum(us for name, _, us in rows if not any(k in name for k in own)) / runs
    print(f"{label}: events {ms:.4f} ms; device {(mine + rest) / 1e3:.4f} ms = layout "
          f"{rest / 1e3:.4f} + kernel {mine / 1e3:.4f}")
    for name, n, us in rows:
        tag = "kernel" if any(k in name for k in own) else "layout"
        print(f"  {tag} {us / runs:8.2f} us a call ({n} records)  {name[:80]}")
    return {"events_ms": ms, "device_ms": (mine + rest) / 1e3, "layout_ms": rest / 1e3,
            "kernel_ms": mine / 1e3}


def _device_call_ms(fn, runs: int = 10) -> float:
    """torch.profiler's device time of one call of `fn`, in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .profile_rung import _device_kernels

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(us for _, _, us in _device_kernels(prof)) / runs / 1e3


def _in_turns(label: str, forms: dict, order: tuple) -> None:
    """Device and events ms of each form of one call, measured in `order`."""
    res = {k: [] for k in forms}
    for k in order:
        res[k].append((_device_call_ms(forms[k]), _events_ms(forms[k])))
    print(f"{label}, in turns {order} (device ms, events ms):")
    for k, v in res.items():
        print(f"  {k:34s} " + "  ".join(f"{d:.4f} / {e:.4f}" for d, e in v))


# Kernel-name pieces of K6's and K4's own launches (csrc/ba_segsum.cu,
# csrc/ba_schur.cu); every other kernel of a sublane call is its layout's.
_K6 = ("segsum_rows_chunk_kernel", "chunk_finish_kernel")
_K4 = ("schur_bwd_kernel",)


def sublane_split(runs: int = 10, reps: int = 200) -> None:
    """Part 5 (see the module note)."""
    import torch

    from ..ops import obs_table as ot

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(5)
    (l200, p200, o200), (lb, pb, _) = _shapes()
    cam, ranks, pad = _pad_engine_table(p200, o200)
    cam, ranks = cam.to(dev), ranks.to(dev)
    grp = torch.zeros_like(cam)
    C, P = p200["intr"].shape[0], p200["points"].shape[0]
    camb = torch.as_tensor(pb["obs_cam"]).to(torch.int32).to(dev)
    ranksb = torch.as_tensor(pb["obs_pt"]).to(torch.int32).to(dev)
    Cb, Pb, Ob = pb["intr"].shape[0], pb["points"].shape[0], camb.shape[0]
    head = f"path B, cameras (C={Cb} P={Pb} O={Ob})"
    vals = torch.randn((Ob, 96), generator=gen, device=dev)
    wb = torch.randn((Ob, 18), generator=gen, device=dev).to(torch.bfloat16)
    zb = torch.randn((Pb, 3), generator=gen, device=dev)
    wa = torch.randn((cam.shape[0], 21), generator=gen, device=dev).to(torch.bfloat16)
    za = torch.randn((P, 3), generator=gen, device=dev)
    _split(f"K6 sublane segsum_table at {head}, k=96",
           lambda: ot.segsum_table(vals, camb, Cb), _K6, runs)
    _split(f"K4 sublane schur_bwd at {head}, D=6 bf16",
           lambda: ot.schur_bwd(wb, camb, ranksb, zb, Cb), _K4, runs)
    _split(f"K4 sublane schur_bwd at path A, one group ({l200}: O={cam.shape[0]}), D=7 bf16",
           lambda: ot.schur_bwd(wa, grp, ranks, za, 1), _K4, runs)
    _split(f"obs_layout alone at {head}", lambda: ot.obs_layout(camb, Cb), (), runs)
    _split(f"obs_layout alone at path A, one group", lambda: ot.obs_layout(grp, 1), (), runs)
    lay = ot.obs_layout(camb, Cb, ranksb, Pb)
    perm = lay.seg_perm.long()
    wseg = wb[perm].contiguous()
    _in_turns(f"K4 alone at {head}, D=6 bf16, one layout", {
        "row-major permuted": lambda: ot.schur_bwd_t(wb.T, camb, ranksb, zb, Cb, layout=lay),
        "lane-major permuted": (lambda wl=wb.T.contiguous(): ot.schur_bwd_t(
            wl, camb, ranksb, zb, Cb, layout=lay)),
        "row-major segment-ordered": lambda: ot.schur_bwd_t(wb.T, camb, ranksb, zb, Cb,
                                                            layout=lay, w_seg=wseg.T)},
        ("row-major permuted", "lane-major permuted", "row-major segment-ordered",
         "row-major segment-ordered", "lane-major permuted", "row-major permuted"))
    del vals, wseg
    lay200 = ot.obs_layout(cam, C, ranks, P)
    for label, rk, p, lt in ((f"the gather path ({l200})", ranks, P, lay200),
                             (head, ranksb, Pb, lay)):
        ptvals = torch.randn((rk.shape[0], 12), generator=gen, device=dev)
        _in_turns(f"K7 at {label}, k=12", {
            "copy, then lane-major read": lambda: ot.segsum_sorted_t(
                ptvals.T.contiguous(), rk, p, layout=lt),
            "row-major view read in place": lambda: ot.segsum_sorted_t(ptvals.T, rk, p,
                                                                       layout=lt)},
            ("copy, then lane-major read", "row-major view read in place",
             "row-major view read in place", "copy, then lane-major read"))
    from ..ba import bundle_adjust as tba

    O = cam.shape[0]
    uv = torch.cat([torch.as_tensor(p200["obs_uv"]), torch.zeros((pad, 2))]).to(dev)
    w = torch.cat([torch.ones(O - pad), torch.zeros(pad)]).to(dev)
    ps = torch.as_tensor(np.concatenate([p200["cam_rot"], p200["cam_t"]], 1), device=dev)
    a2 = (tba.camera_table(ps), torch.as_tensor(p200["intr"], device=dev),
          torch.as_tensor(p200["points"], device=dev), cam, cam, ranks, uv.T.contiguous(), w)
    v42 = torch.randn((O, 42), generator=gen, device=dev)
    v12 = torch.randn((O, 12), generator=gen, device=dev)
    calls = {"segsum_table_t (k=42, row-major view)":
             lambda: ot.segsum_table_t(v42.T, cam, C, layout=lay200),
             "segsum_sorted_t (k=12, row-major view)":
             lambda: ot.segsum_sorted_t(v12.T, ranks, P, layout=lay200),
             "linearize_radial3_t (held, bf16 W)":
             lambda: ot.linearize_radial3_t(*a2, w_dtype="bf16")}
    print(f"Host us per call at {l200} (median of 7 batches of {reps} calls):")
    for name, fn in calls.items():
        print(f"  {name:42s} {_host_us(fn, reps):8.2f} us")


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
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    parts = {1: lambda: host_steps(32768, args.reps), 2: k3_passes, 3: forced_solve_busy_share,
             4: k2_k4_passes, 5: sublane_split}
    for part in args.parts:
        parts[part]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
