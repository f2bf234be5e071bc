"""GPU smoke run of the PyTorch/CUDA port (tpusfm_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):

1. device: requires CUDA; prints the card's name and power limit, the torch,
   CUDA and nvcc versions; turns TF32 off for matmuls and convolutions;
2. build: compiles the port's CUDA kernels from tpusfm_torch/csrc with nvcc;
3. kernel K1 (fused top-2 matcher) against its plain PyTorch twin on the
   card: bit-equal on SIFT's u8 grid at the main path's chunk (192 pairs x
   1024 x 1024 x 128) and at 32 pairs, at non-multiple shapes, with a fully
   masked B; the ratio-test/cross-check `ok` equal on random float
   descriptors; median times (CUDA events, 2 warm-ups, 10 runs);
4. the slice: tpusfm_torch.pipeline.sparse.run_sparse on cuda over the
   20-view 480x640 rendered orbit scene with the reference bench's config,
   run twice; asserts >= 19/20 views registered, ATE <= 0.05 (scene radius
   8), > 1000 points, finite geometry, and that every kernel of the path
   launched during the run (launch counts reset just before it).

The second-to-last stdout line is a JSON object with one entry per kernel
(route, source, the TPU kernel it replaces, launches in the main-path run,
max abs error against the twin, kernel and twin milliseconds); the last line
is {"ok": true, "device": {...}}.  Exits non-zero, printing no result, when
no CUDA device is visible or the port is not importable.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


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


def phase_slice(entry: dict) -> None:
    import numpy as np
    import torch

    from tpusfm_torch.ops import topk2_match as k1
    from tpusfm_torch.pipeline.config import config_from_overrides
    from tpusfm_torch.pipeline.sparse import run_sparse
    from tpusfm_torch.utils import metrics
    from tpusfm_torch.utils.synth_render import render_orbit_images

    n_views, h, w = 20, 480, 640
    images, gt = render_orbit_images(n_views=n_views, img_h=h, img_w=w, focal=0.9 * w,
                                     arc_deg=110.0, seed=0)
    cfg = config_from_overrides(**{
        "sift.n_octaves": 4, "sift.max_per_octave": 1024, "sift.max_features": 1024,
        "matching.pair_chunk": 32, "filter.max_iterations": 256, "feature_batch": 10,
    })
    walls = []
    for run in range(2):
        k1.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.time()
        scene, report = run_sparse(images, gt["intr"], cfg, device="cuda", seed=run)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        launches = k1.LAUNCHES
        n_pairs = n_views * (n_views - 1) // 2
        ch = max(cfg.matching.pair_chunk, 32 * ((n_pairs + 31) // 32))
        n_chunks = (n_pairs + ch - 1) // ch
        if launches < 2 * n_chunks:
            raise AssertionError(f"K1 launched {launches} times for {n_chunks} matched chunks")
        if run == 0:
            entry["launches"] = launches
        reg = scene.cam_mask.cpu().numpy()
        pts = scene.points[scene.point_mask].cpu().numpy()
        centers = scene.camera_centers().cpu().numpy()[reg]
        ate = metrics.ate_rmse(centers, gt["centers"][reg]) if reg.sum() >= 3 else float("nan")
        print(f"run {run}: registered {int(reg.sum())}/{n_views}, points {report['n_points']}, "
              f"ATE {ate:.5f}, K1 launches {launches}, wall {walls[-1]:.2f} s")
        print(f"  times_s {json.dumps(report['times_s'])}")
        print(f"  recon_phase_s {json.dumps(report['recon_phase_s'])}")
        if reg.sum() < 19 or not ate <= 0.05 or report["n_points"] <= 1000:
            raise AssertionError(f"slice quality: {int(reg.sum())}/20 views, ATE {ate}, "
                                 f"{report['n_points']} points; log {report['engine_log']}")
        if not (np.isfinite(pts).all() and np.isfinite(centers).all()):
            raise AssertionError("non-finite geometry in the reconstructed scene")
    print(f"run_sparse wall seconds: first {walls[0]:.2f}, second {walls[1]:.2f}")


def main() -> int:
    card = phase_device()
    phase_build()
    entry = phase_kernel(card)
    phase_slice(entry)
    import torch

    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
