"""GPU smoke run of the PyTorch/CUDA port (tpusfm_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught, nothing falls back):

1. device: requires CUDA; prints the card's name and power limit, the torch,
   CUDA and nvcc versions; turns TF32 off for matmuls and convolutions;
2. build: compiles the port's CUDA kernels from tpusfm_torch/csrc with nvcc
   (one nvcc per source, all started together);
3. kernel K1 (fused top-2 matcher) against its plain PyTorch twin on the
   card: bit-equal on SIFT's u8 grid at the 20-view path's chunk (192 pairs
   x 1024 x 1024 x 128) and at 32 pairs, at non-multiple shapes, with a
   fully masked B; the ratio-test/cross-check `ok` equal on random float
   descriptors; median times (CUDA events, 2 warm-ups, 10 runs);
4. the 20-view slice: run_sparse on cuda over the 20-view 480x640 rendered
   orbit scene with the reference bench's config, once; asserts >= 19/20
   views, ATE <= 0.05 (scene radius 8), > 1000 points, finite geometry,
   and K1 launches (counts reset just before the run, read just after);
5. the 200-view slice: run_sparse over the reference's medium rung (200
   views 240x320, contiguous pairs, bench.py:383-389), a first run in the
   process and a warm one; each asserts >= 190/200 views, ATE <= 0.10,
   > 1000 points, finite geometry, and that K1-K4 launched in it (counts
   reset just before each run).  Every BA of this rung is a 200-camera
   solve, so it takes the kernel path (_lm_kernels: K2, K3, K4); the first
   run keeps the last K1 call (its matching chunk) and the last K2/K3/K4
   call of its final BA as shape (a);
6. path kernels: K1 bit-equal to its twin at the 200-view chunk, both
   timed; K2, K3, K4 against their twins evaluated in float64 on the
   card, at shape (a) and at (b), the reference bench's 500-camera problem
   (bench.py:171-202, about 1.5M observations, point-sorted): each within
   4x the float32 twin's own error against float64 (bf16 W within one bf16
   ulp), bit-identical on a repeat call; median ms of kernel and float32
   twin;
7. BA solve at shape (b): bundle_adjust(max_iters=20, cg_iters=30,
   assume_sorted=True) through the kernels and through the plain path
   (impl="xla"), as configured and with converge_rtol=0 (all 20
   iterations, for a steadier rate); prints LM iterations per second and
   final costs, asserts the kernel path's cost within 1e-2 relative of the
   plain path's.

The second-to-last stdout line is a JSON object with one entry per kernel
(route, source, the TPU kernel it replaces, launches in its main-path run
-- the 20-view run for K1, the first 200-view run for K2-K4 --, max abs
error against the (float64 for K2-K4) twin at the main path's shape, kernel
and twin milliseconds there); the last line is {"ok": true, "device": {...}}.
Exits non-zero, printing no result, when no CUDA device is visible or the
port is not importable.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time


# The BA kernels' wrapper names in tpusfm_torch.ops.obs_table (K2, K3, K4).
BA_KERNELS = ("linearize_reduce_radial3_t", "schur_mv_t", "schur_bwd_t")


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def _median_ms(fn, warmup: int = 2, runs: int = 10) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch; nothing was run")
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    from tpusfm_torch.ops import cuda_build

    print(_run([cuda_build._nvcc(), "--version"]).splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from tpusfm_torch.ops import cuda_build

    t0 = time.time()
    path = cuda_build.build(verbose=True)
    cuda_build.kernels()
    print(f"build: {path.name} in {time.time() - t0:.2f} s")


def _u8_grid(shape, gen, dev):
    import torch

    return torch.floor(torch.rand(shape, generator=gen, device=dev) * 256.0).clamp(max=255.0)


def _twin_match(da, db, ma, mb, ratio=0.8):
    """match_descriptors_topk2 computed with the plain twin (oracle)."""
    import torch

    from tpusfm_torch.ops import topk2_match as k1

    d1, d2, i1 = k1.match_topk2_reference(da, db, mb)
    ok = ma & (d1 < (ratio * ratio) * d2) & (d1 < k1.INF)
    _, _, j1 = k1.match_topk2_reference(db, da, ma)
    ok = ok & (torch.gather(j1, -1, i1.long()) == torch.arange(da.shape[1], device=da.device))
    return i1, ok


def phase_kernel(card: str) -> dict:
    import torch

    from tpusfm_torch.ops import topk2_match as k1

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def check_bit_equal(P, na, nb, mask_frac, label):
        da = _u8_grid((P, na, 128), gen, dev)
        db = _u8_grid((P, nb, 128), gen, dev)
        mb = torch.rand((P, nb), generator=gen, device=dev) >= mask_frac
        got = k1.match_topk2(da, db, mb)
        torch.cuda.synchronize()
        want = k1.match_topk2_reference(da, db, mb)
        err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K1 differs from its twin on the u8 grid ({label}): max err {err}")
        print(f"K1 bit-equal to twin: {label}")
        return da, db, mb, err

    da, db, mb, err_main = check_bit_equal(192, 1024, 1024, 0.1, "192 pairs x 1024 x 1024, 10% B masked")
    da32, db32, mb32, _ = check_bit_equal(32, 1024, 1024, 0.1, "32 pairs x 1024 x 1024, 10% B masked")
    check_bit_equal(3, 130, 200, 0.1, "3 pairs x 130 x 200")
    d1 = k1.match_topk2(*check_bit_equal(2, 130, 200, 1.1, "fully masked B")[:3])[0]
    if not bool((d1 >= 1e38).all()):
        raise AssertionError("fully masked B must give d1 >= 1e38")

    fa = torch.randn((4, 300, 128), generator=gen, device=dev) * 20
    fb = torch.cat([fa[:, :250] + 0.3 * torch.randn((4, 250, 128), generator=gen, device=dev),
                    torch.randn((4, 210, 128), generator=gen, device=dev) * 20], dim=1)
    fma = torch.ones((4, 300), dtype=torch.bool, device=dev)
    fmb = torch.rand((4, 460), generator=gen, device=dev) > 0.05
    i_k, ok_k = k1.match_descriptors_topk2(fa, fb, fma, fmb)
    i_t, ok_t = _twin_match(fa, fb, fma, fmb)
    if not torch.equal(ok_k, ok_t) or not torch.equal(i_k[ok_k], i_t[ok_t]):
        raise AssertionError("K1 ratio test / cross-check differs from the twin on float descriptors")
    print(f"K1 ok equal to twin on float descriptors ({int(ok_k.sum())} matches)")

    ms = _median_ms(lambda: k1.match_topk2(da, db, mb))
    plain_ms = _median_ms(lambda: k1.match_topk2_reference(da, db, mb))
    ms32 = _median_ms(lambda: k1.match_topk2(da32, db32, mb32))
    plain_ms32 = _median_ms(lambda: k1.match_topk2_reference(da32, db32, mb32))
    flops = 2.0 * 1024 * 1024 * 128
    print(f"K1 timing on {card}: 192-pair chunk kernel {ms:.4f} ms ({192 * flops / ms / 1e9:.2f} "
          f"TFLOP/s) vs twin {plain_ms:.4f} ms; 32-pair chunk kernel {ms32:.4f} ms "
          f"({32 * flops / ms32 / 1e9:.2f} TFLOP/s) vs twin {plain_ms32:.4f} ms")
    return {"name": "topk2_match", "route": "cuda", "source": "tpusfm_torch/csrc/topk2_match.cu",
            "replaces": "tpusfm/ops/pallas_match.py:57", "launches": None,
            "max_abs_err": err_main, "ms": ms, "plain_ms": plain_ms}


def _check_quality(scene, report, gt, n_views, min_reg, max_ate, label):
    import numpy as np

    from tpusfm_torch.utils import metrics

    reg = scene.cam_mask.cpu().numpy()
    centers = scene.camera_centers().cpu().numpy()[reg]
    ate = metrics.ate_rmse(centers, gt["centers"][reg]) if reg.sum() >= 3 else float("nan")
    pts = scene.points[scene.point_mask].cpu().numpy()
    print(f"{label}: registered {int(reg.sum())}/{n_views}, points {report['n_points']}, "
          f"ATE {ate:.5f}")
    print(f"  times_s {json.dumps(report['times_s'])}")
    print(f"  recon_phase_s {json.dumps(report['recon_phase_s'])}")
    if reg.sum() < min_reg or not ate <= max_ate or report["n_points"] <= 1000:
        raise AssertionError(f"{label} quality: {int(reg.sum())}/{n_views} views, ATE {ate}, "
                             f"{report['n_points']} points; log {report['engine_log']}")
    if not (np.isfinite(pts).all() and np.isfinite(centers).all()):
        raise AssertionError(f"{label}: non-finite geometry in the reconstructed scene")


def _reset_counts():
    from tpusfm_torch.ops import obs_table as ot
    from tpusfm_torch.ops import topk2_match as k1

    k1.LAUNCHES = 0
    for name in ot.LAUNCHES:
        ot.LAUNCHES[name] = 0


def _counts() -> dict:
    from tpusfm_torch.ops import obs_table as ot
    from tpusfm_torch.ops import topk2_match as k1

    return {"topk2_match": k1.LAUNCHES, **ot.LAUNCHES}


def phase_slice20(entry: dict) -> None:
    import torch

    from tpusfm_torch.pipeline.config import config_from_overrides
    from tpusfm_torch.pipeline.sparse import run_sparse
    from tpusfm_torch.utils.synth_render import render_orbit_images

    n_views, h, w = 20, 480, 640
    images, gt = render_orbit_images(n_views=n_views, img_h=h, img_w=w, focal=0.9 * w,
                                     arc_deg=110.0, seed=0)
    cfg = config_from_overrides(**{
        "sift.n_octaves": 4, "sift.max_per_octave": 1024, "sift.max_features": 1024,
        "matching.pair_chunk": 32, "filter.max_iterations": 256, "feature_batch": 10,
    })
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    scene, report = run_sparse(images, gt["intr"], cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _counts()["topk2_match"]
    n_pairs = n_views * (n_views - 1) // 2
    ch = max(cfg.matching.pair_chunk, 32 * ((n_pairs + 31) // 32))
    n_chunks = (n_pairs + ch - 1) // ch
    if launches < 2 * n_chunks:
        raise AssertionError(f"K1 launched {launches} times for {n_chunks} matched chunks")
    entry["launches"] = launches
    _check_quality(scene, report, gt, n_views, 19, 0.05, "20-view run")
    print(f"  K1 launches {launches}, wall {wall:.2f} s (first run_sparse in the process)")


@contextlib.contextmanager
def _recording(capture: dict | None):
    """Yields the list of this run's _lm_kernels solves as (C, P, O); when
    `capture` is given, also keeps the arguments of the last call of each
    kernel wrapper (K1-K4) there.  Restores everything on exit."""
    from tpusfm_torch.ba import bundle_adjust as tba
    from tpusfm_torch.ops import obs_table as ot
    from tpusfm_torch.ops import topk2_match as k1

    solves = []
    saved = {(tba, "_lm_kernels"): tba._lm_kernels}

    def lm_kernels(*a, **k):
        solves.append((a[0].shape[0], a[2].shape[0], a[5].shape[0]))
        return saved[(tba, "_lm_kernels")](*a, **k)

    tba._lm_kernels = lm_kernels
    wrappers = [(k1, "match_topk2")] + [(ot, n) for n in BA_KERNELS]
    for mod, name in (wrappers if capture is not None else ()):
        saved[(mod, name)] = getattr(mod, name)

        def rec(*a, _key=(mod, name), **k):
            capture[_key[1]] = (a, k)
            return saved[_key](*a, **k)

        setattr(mod, name, rec)
    try:
        yield solves
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def phase_slice200(entries: dict) -> dict:
    """The medium rung twice; returns the first run's last K1-K4 calls."""
    from collections import Counter

    import torch

    from tpusfm_torch.pipeline.sparse import run_sparse
    from tpusfm_torch.tools.front_end_counts import rung_inputs

    n_views = 200
    images, gt, cfg = rung_inputs(n_views)
    captured = {}
    walls = []
    for run in range(2):
        _reset_counts()
        with _recording(captured if run == 0 else None) as solves:
            torch.cuda.synchronize()
            t0 = time.time()
            scene, report = run_sparse(images, gt["intr"], cfg, device="cuda", seed=run)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
        counts = _counts()
        _check_quality(scene, report, gt, n_views, 190, 0.10,
                       f"200-view run {run} ({'first' if run == 0 else 'warm'})")
        print(f"  tracks {report['n_tracks']}, observations {report['n_obs']}, "
              f"launches {json.dumps(counts)}, wall {walls[-1]:.2f} s")
        print(f"  _lm_kernels solves {len(solves)}, shapes (C, P, O): "
              f"{dict(Counter(solves))}")
        if any(n == 0 for n in counts.values()) or not solves:
            raise AssertionError(f"200-view run {run}: a kernel of the path did not launch: "
                                 f"{counts}, {len(solves)} kernel-path solves")
        if run == 0:
            for name in BA_KERNELS:
                entries[name]["launches"] = counts[name]
    print(f"200-view run_sparse wall seconds: first {walls[0]:.2f}, warm {walls[1]:.2f}")
    return captured


def _oracle(got, f32, f64, what):
    """Kernel output against the float64 twin: within 4x the float32 twin's
    own error against float64 (both sum float32 values, in other orders),
    floored at 1e-6 of the output's largest entry.  Returns the error."""
    scale = float(f64.abs().max())
    ref = float((f32.double() - f64).abs().max())
    err = float((got.double() - f64).abs().max())
    tol = max(4.0 * ref, 1e-6 * scale)
    print(f"    {what}: max abs err {err:.3e} (float32 twin {ref:.3e}, tol {tol:.3e}, "
          f"scale {scale:.3e})")
    if not err <= tol:
        raise AssertionError(f"{what}: kernel error {err} above {tol}")
    return err


def _repeat_equal(fn, what):
    import torch

    a, b = fn(), fn()
    torch.cuda.synchronize()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: two calls on the same inputs differ")
    return a


def _f64(args):
    """float32 tensors to float64; a bf16 W table stays as it is (the twins
    upcast it exactly)."""
    import torch

    return tuple(t.double() if isinstance(t, torch.Tensor) and t.dtype == torch.float32 else t
                 for t in args)


def _check_ba_kernels(label, k2, k3, k4, card) -> dict:
    """Each BA kernel at one shape: error against the float64 twin,
    bit-identical repeats, median ms of kernel and float32 twin."""
    import torch

    from tpusfm_torch.ops import obs_table as ot

    out = {}
    (a2, kw2), (a3, kw3), (a4, kw4) = k2, k3, k4
    C, P, O = a2[0].shape[0], a2[2].shape[0], a2[5].shape[0]
    print(f"BA kernels at shape {label}: C={C} P={P} O={O} on {card}")

    tw2 = {k: v for k, v in kw2.items() if k != "layout"}
    got = _repeat_equal(lambda: ot.linearize_reduce_radial3_t(*a2, **kw2), "K2")
    f32 = ot.linearize_reduce_radial3_t_reference(*a2, **tw2)
    f64 = ot.linearize_reduce_radial3_t_reference(*_f64(a2), **dict(tw2, w_dtype="f32"))
    err = max(_oracle(got[0], f32[0], f64[0], "K2 camred"),
              _oracle(got[1], f32[1], f64[1], "K2 ptred"))
    w64 = f64[2].double() if got[2].dtype == torch.float32 else \
        f64[2].to(torch.bfloat16).double()
    bound = torch.maximum(got[2].double().abs(), w64.abs()) * 2.0 ** -7  # >= one bf16 ulp
    w_err = float((got[2].double() - w64).abs().max())
    if not bool(((got[2].double() - w64).abs() <= bound + 1e-6 * float(w64.abs().max())).all()):
        raise AssertionError("K2: W differs from the float64 twin by more than one bf16 ulp")
    print(f"    K2 W ({got[2].dtype}): within one bf16 ulp of the float64 twin "
          f"(max abs diff {w_err:.3e})")
    out["linearize_reduce_radial3_t"] = (
        err, _median_ms(lambda: ot.linearize_reduce_radial3_t(*a2, **kw2)),
        _median_ms(lambda: ot.linearize_reduce_radial3_t_reference(*a2, **tw2)))

    tw3 = {k: v for k, v in kw3.items() if k != "layout"}
    got = _repeat_equal(lambda: ot.schur_mv_t(*a3, **kw3), "K3")
    f32 = ot.schur_mv_t_reference(*a3, **tw3)
    f64 = ot.schur_mv_t_reference(*_f64(a3), **{k: (v.double() if v is not None else None)
                                                 for k, v in tw3.items()})
    err = max(_oracle(got[0], f32[0], f64[0], "K3 S v" if tw3.get("hcc_d") is not None
                      else "K3 bc"),
              _oracle(got[1], f32[1], f64[1], "K3 y"))
    out["schur_mv_t"] = (err, _median_ms(lambda: ot.schur_mv_t(*a3, **kw3)),
                         _median_ms(lambda: ot.schur_mv_t_reference(*a3, **tw3)))

    got = _repeat_equal(lambda: ot.schur_bwd_t(*a4, **kw4), "K4")
    f32 = ot.schur_bwd_t_reference(*a4)
    f64 = ot.schur_bwd_t_reference(*_f64(a4))
    err = _oracle(got[0], f32, f64, "K4 out")
    out["schur_bwd_t"] = (err, _median_ms(lambda: ot.schur_bwd_t(*a4, **kw4)),
                          _median_ms(lambda: ot.schur_bwd_t_reference(*a4)))
    for name, (e, ms, pms) in out.items():
        print(f"  {name} at {label}: kernel {ms:.4f} ms, float32 twin {pms:.4f} ms, "
              f"max abs err vs float64 twin {e:.3e}")
    return out


def _bench_problem(dev):
    """bench.py:171-202's 500-camera BA problem on the card."""
    import torch

    from tpusfm_torch.utils.synth_scene import point_sorted_ba_problem

    prob = point_sorted_ba_problem(500, 50000, seed=3, arc_deg=350.0, vis_prob=0.06)
    return {k: torch.as_tensor(v, device=dev) for k, v in prob.items()}


def _bench_kernel_args(args):
    """K2-K4 arguments at the bench problem's shape: K2 at the perturbed
    start; K3 and K4 on its W with a seeded v and z = Hpp^-1 gp."""
    import torch

    from tpusfm_torch.ba import bundle_adjust as tba
    from tpusfm_torch.ops import obs_table as ot

    dev = args["intr"].device
    C, P = args["intr"].shape[0], args["points"].shape[0]
    cam = args["obs_cam"].to(torch.int32)
    ranks = args["obs_pt"].to(torch.int32)
    layout = ot.obs_layout(cam, C, ranks, P)
    ps = torch.cat([args["cam_rot"], args["cam_t"]], 1)
    a2 = (tba.camera_table(ps), args["intr"], args["points"], cam, cam, ranks,
          args["obs_uv"].T.contiguous(), args["obs_mask"].to(torch.float32))
    kw2 = dict(refine=False, refine_mask=(0.0,) * 7, huber_delta=4.0, w_dtype="bf16",
               layout=layout)
    camred, ptred, W = ot.linearize_reduce_radial3_t(*a2, **kw2)
    lam = torch.tensor(1e-4, device=dev)
    hcc_d = tba._damp_blocks(camred[:, list(ot._FULL66)].reshape(C, 6, 6), lam)
    hinv = tba._inv3(tba._damp_blocks(ptred[:, list(ot._FULL33)].reshape(P, 3, 3), lam))
    v = torch.randn((C, 6), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    z = torch.einsum("pij,pj->pi", hinv, ptred[:, 6:9])
    return ((a2, kw2), ((W, cam, ranks, v, hinv, P), dict(hcc_d=hcc_d, layout=layout)),
            ((W, cam, ranks, z, C), dict(layout=layout)))


def _check_k1_captured(captured: dict, card: str) -> None:
    """K1 at the 200-view path's own chunk (its last call, real SIFT
    descriptors on the u8 grid): bit-equal to the twin, both timed."""
    import torch

    from tpusfm_torch.ops import topk2_match as k1

    (da, db, mb), _ = captured["match_topk2"]
    label = f"{da.shape[0]} pairs x {da.shape[1]} x {db.shape[1]} (200-view chunk)"
    got = _repeat_equal(lambda: k1.match_topk2(da, db, mb), "K1")
    want = k1.match_topk2_reference(da, db, mb)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        raise AssertionError(f"K1 differs from its twin at {label}: max err {err}")
    ms = _median_ms(lambda: k1.match_topk2(da, db, mb))
    plain_ms = _median_ms(lambda: k1.match_topk2_reference(da, db, mb))
    print(f"K1 bit-equal to twin at {label}; on {card}: kernel {ms:.4f} ms vs twin "
          f"{plain_ms:.4f} ms")


def phase_ba_kernels(card, captured: dict, entries: dict) -> dict:
    import torch

    dev = torch.device("cuda")
    _check_k1_captured(captured, card)
    res_a = _check_ba_kernels("(a) 200-view final BA", *(captured[n] for n in BA_KERNELS), card)
    for name, (err, ms, pms) in res_a.items():
        entries[name].update(max_abs_err=err, ms=ms, plain_ms=pms)
    bench = _bench_problem(dev)
    _check_ba_kernels("(b) 500-camera bench problem", *_bench_kernel_args(bench), card)
    return bench


def phase_ba_solve(bench: dict, card: str) -> None:
    import torch

    from tpusfm_torch.ba import bundle_adjust as tba
    from tpusfm_torch.ops import obs_table as ot

    cfg = tba.BAConfig(max_iters=20, cg_iters=30, assume_sorted=True)
    forced = dataclasses.replace(cfg, converge_rtol=0.0)  # all 20 iterations, for the rate
    C, P, O = bench["intr"].shape[0], bench["points"].shape[0], bench["obs_cam"].shape[0]
    costs = {}
    for name, c in (("kernels", cfg), ("plain", dataclasses.replace(cfg, impl="xla")),
                    ("kernels, 20 forced", forced),
                    ("plain, 20 forced", dataclasses.replace(forced, impl="xla"))):
        tba.bundle_adjust(cfg=dataclasses.replace(c, max_iters=1), **bench)  # warm-up
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        out = tba.bundle_adjust(cfg=c, **bench)
        torch.cuda.synchronize()
        dt = time.time() - t0
        its = int(out[4]["iterations"])
        costs[name] = float(out[4]["final_cost"])
        print(f"BA solve at C={C} P={P} O={O} via {name} on {card}: {its} LM iterations in "
              f"{dt:.3f} s = {its / dt:.3f} LM it/s; cost {float(out[4]['initial_cost']):.6g} "
              f"-> {costs[name]:.6g}; launches {json.dumps(dict(ot.LAUNCHES))}")
        if not bool(torch.isfinite(out[3]).all()):
            raise AssertionError(f"BA via {name}: non-finite points")
        if name.startswith("kernels") and any(n == 0 for n in ot.LAUNCHES.values()):
            raise AssertionError(f"the kernel-path solve did not launch every kernel: "
                                 f"{ot.LAUNCHES}")
    for run in ("", ", 20 forced"):
        ck, cp = costs["kernels" + run], costs["plain" + run]
        if not abs(ck - cp) <= 1e-2 * cp:
            raise AssertionError(f"kernel-path final cost {ck} vs plain {cp}{run}: more than "
                                 "1e-2 apart")


def main() -> int:
    t_start = time.time()
    card = phase_device()
    phase_build()
    entries = {"topk2_match": phase_kernel(card)}
    for name, (src, line) in {
            "linearize_reduce_radial3_t": ("ba_linearize.cu", 1439),
            "schur_mv_t": ("ba_schur.cu", 2023),
            "schur_bwd_t": ("ba_schur.cu", 1891)}.items():
        entries[name] = {"name": name, "route": "cuda", "source": f"tpusfm_torch/csrc/{src}",
                         "replaces": f"tpusfm/ops/obs_table.py:{line}", "launches": None,
                         "max_abs_err": None, "ms": None, "plain_ms": None}
    phase_slice20(entries["topk2_match"])
    captured = phase_slice200(entries)
    bench = phase_ba_kernels(card, captured, entries)
    phase_ba_solve(bench, card)
    import torch

    print(f"chip_smoke total wall time {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
