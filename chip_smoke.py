"""GPU smoke run of the PyTorch/CUDA port (tpusfm_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught, nothing falls back):

1. device: requires CUDA; prints the card's name and power limit, the torch,
   CUDA and nvcc versions; turns TF32 off for matmuls and convolutions;
2. build: compiles the port's CUDA kernels from tpusfm_torch/csrc with nvcc
   (one nvcc per source, all started together), and prints the first
   tensor-core instruction (HGMMA) of each of K1's kernels, bf16 and f32,
   from cuobjdump -sass of the built library (none is a failure);
3. kernel K1 (fused top-2 matcher) against its plain PyTorch twin on the
   card, both variants: the bf16 tensor-core kernel (quantized=True, the
   main path's) bit-equal to its twin and to the f32 kernel on SIFT's u8
   grid at the 20-view path's chunk (192 pairs x 1024 x 1024 x 128) and at
   32 pairs, at non-multiple shapes, with a fully masked B, the same bits
   on a repeat call; on off-grid float descriptors within 1e-5 x (|a|^2 +
   max |b|^2) of its twin (i1 equal where d2 - d1 exceeds that); the f32
   kernel (three TF32 products) bit-equal to its twin on the grid, its
   ratio-test/cross-check `ok` equal on float descriptors, and on the
   reference's float descriptor sets (4 x 1024 x 1024, 3 x 130 x 200,
   2 x 65 x 1, a fully masked B, every B row doubled) d1 and d2 within 4x
   the float32 twin's own error against the float64 twin (floored at 1e-6
   of the output's scale), i1 equal where the float64 twin's d2 - d1
   exceeds twice that, ties to the lower index, the same bits on a repeat;
   median times (CUDA events, 2 warm-ups, 10 runs) of both variants, their
   twins and, as yardsticks, torch.bmm on bf16 copies and on the float32
   inputs with TF32 off (the product only, not the function);
4. the 20-view slice: run_sparse on cuda over the 20-view 480x640 rendered
   orbit scene with the reference bench's config, once; asserts >= 19/20
   views, ATE <= 0.05 (scene radius 8), > 1000 points, finite geometry,
   and that K1 launched, its bf16 variant only (counts reset just before
   the run, read just after; every 200-view run below asserts the same);
   then the dense and mesh stages on that run's scene
   (tpusfm_torch.tools.dense_rung, the reference bench's dense rung,
   bench.py:243-349): dense_reconstruct over the first 6 registered views
   with DenseConfig(n_planes=64, n_sources=3, view_batch=2,
   pm=PatchMatchConfig(n_iters=3)) (half-resolution sweep and coarse
   PatchMatch, one fine full-resolution iteration) after a warm-up, and
   with patchmatch=False (full-resolution sweep); prints each stage's
   seconds (host clock, device sync at each stage end), views/s, fused
   points and the median relative depth error against the renderer's
   depth; asserts the PatchMatch error <= 0.006 and >= 300,000 finite fused
   points; writes and reads back dense.ply; then mesh_from_depths (grid
   128), refine_mesh, refine_mesh_photometric, texture_mesh and mesh.ply,
   with each stage's seconds, asserting > 1000 faces and a textured share
   above 0.5; then torch.profiler over one more dense_reconstruct: the 10
   device kernels with the most time, the launch count and the busy share
   (device time over an unprofiled run's wall time).  The dense and mesh
   stages have no hand-written kernel (the reference runs them as XLA);
5. the 200-view slice: run_sparse once over the reference's medium rung
   (200 views 240x320, contiguous pairs, bench.py:383-389) with the
   intrinsics held; asserts >= 190/200 views, ATE <= 0.10, > 1000 points,
   finite geometry, and that K1-K4 launched in it.  Every BA of this rung
   is a 200-camera solve, so it takes the kernel path (_lm_kernels: K2,
   K3, K4); the run keeps the last K1 call (its matching chunk) and the
   last K2/K3/K4 call of its final BA as shape (a);
6. path A, the self-calibrating 200-view rung: the same scene with one
   intrinsic group (cam_group = 0), every RADIAL3 lane refined, started
   from the true focal (FOCAL_START below says why); asserts the same
   quality bars, the refined fx within 1% of the truth, and that K2 ran in
   refine mode, K5 with D = 6 and D = 7 and K4 with D = 7 in this run;
   keeps the last call of each;
7. the gather path: the held rung again with engine.ba fused_linearize=
   False, pallas_gathers=True, precond="schur_diag" (the reference's
   BAConfig fields): the same bars; K8 (poses, intrinsics, Hpp^-1 rows),
   K9 (points by rank), K6, K7, K3 and K4 launched, K2 not; keeps the last
   call of each;
8. path kernels: K1's bf16 kernel bit-equal to its twin and to the f32
   kernel at the 200-view run's own chunk (real SIFT descriptors), the same
   bits on a repeat, within the off-grid tolerance of its twin on the same
   chunk moved off the grid, both kernels timed; K2, K3, K4 against their twins
   evaluated in float64 on the card, at shape (a) and at (b), the
   reference bench's 500-camera problem
   (bench.py:171-202, about 1.5M observations, point-sorted): each within
   4x the float32 twin's own error against float64 (bf16 W within one bf16
   ulp), bit-identical on a repeat call; median ms of kernel and float32
   twin, and device time from torch.profiler;
9. K2's unreduced mode: launched through the ops-layer composition the
   reference's CPU delegate runs (unreduced K2, then K6 and K7) at the two
   200-view shapes, counts reset just before; held and refine at those
   shapes and at (b): against its twins as in phase 8, and its K6 + K7
   sums against K2 reduced on the same inputs (rtol 2e-5, atol 1e-4 of
   scale, the reference's tests/test_obs_table.py:147-196);
10. BA solve at shape (b): bundle_adjust(max_iters=20, cg_iters=30,
   assume_sorted=True) through the kernels and through the plain path
   (impl="xla"), as configured and with converge_rtol=0 (all 20
   iterations, for a steadier rate); prints LM iterations per second and
   final costs, asserts the kernel path's cost within 1e-2 relative of the
   plain path's; then the same kernel-path solve with
   precond="schur_diag" (K6), within 1e-2 of the "hcc" solve;
11. path B, Brown-T2 self-calibration at shape (b): the bench scene seen
   through [k1 k2 k3 t1 t2] = [-0.10, 0.015, 0, 0.008, -0.006] plus 0.5 px
   noise, started from zero distortion with one group: the unfused kernel
   path (K6, K7, K5 and K4 with D = 6 and 9) and the plain path, both
   under 0.05 of the initial cost and within 1e-2 of each other, k1 within
   0.01 and t1, t2 within 0.003 of the lens; LM iterations per second;
   then the kernel path again with pallas_gathers=True (K8, K9), which
   must give the same intrinsics, poses, points and final cost bit for bit;
12. K2 refine, K4 (D = 6 and 7 at path A, 6 and 9 at path B; the camera
   calls on W in camera order), K5 (D = 6, 7, 9), K6, K7 against their
   twins at the shapes paths A and B gave them, as phase 8; K6 at path B
   on the captured row-major table and on a lane-major copy, bit-equal,
   both timed; then the reference's sublane entry points (segsum_table,
   segsum_sorted, schur_fwd, schur_bwd: the same tables row-major (O, k),
   launching K6, K7, K5 and K4; K6, K7 and K5 read the table in place, K4
   through its row-major permuted read) at path B's shapes and at path A's
   D = 7, as phase 8, and K5's row-major read bit-equal to its lane-major
   read at both, K5 alone timed with each read at path B in turns (no
   main path runs them: their launches are 0); segsum_table and schur_bwd,
   which build their own layout, run under
   torch.cuda.set_sync_debug_mode("error") (a host read raises) and give
   the bits of a call outside it, their device time split by kernel name
   into the layout kernel's and K6's or K4's; the layout kernel
   (csrc/ba_layout.cu) at path A's and path B's id columns (cameras and
   the one group) under the same mode, bit-equal to its torch.sort twin
   on the card and the same bits on a repeat, timed beside the twin and
   torch.sort;
13. K8 and K9 at the shapes the gather run and path B gave them: bit-equal
   to their twins with zero rows outside the table, timed beside
   index_select; K6 at the gather run's shapes (k = 42 and 36);
14. the preemptive prefilter on tests/test_preemptive.py's 8-view scene:
   its keep mask, from K1's bf16 variant (counts reset just before), equal
   to the plain matcher's on the same card tensors; kept rows equal full
   matching's, dropped rows all invalid, at least one pair dropped;
15. two_view_reconstruct on the card with tests/test_two_view.py's setup:
   K1 launched bf16 only, more than 40 inliers, rotation within 2 degrees,
   more than 95% of the inlier points in front;
16. the 1000-view pod rung (bench.py:481-503, uncut: 240x320, contiguous
   window 8 plus loop-closure retrieval top 5) through run_sparse once,
   counts reset just before: >= 950/1000 views, ATE <= 0.30, > 1000
   points, finite geometry, loop pairs proposed and kept, K1 bf16 only and
   K2-K4 launched; prints the stage and engine-phase times, observations,
   pair counts, BA solves by kind and shape (the windowed local share) and
   the wall time;
17. K1 at the pod run's matching chunk and K2-K4 at its final 1000-camera
   BA against their twins, as phase 8; K2 at its last kernel-path local
   step-BA: the padding rows (repeating the last point under
   assume_sorted) get zero W and change no sum, timed against the
   unpadded table;
18. tests/test_pod_scale.py's 1000-camera BA problem single-device through
   the kernels (BAConfig(max_iters=8, cg_iters=25, obs_chunk=32768)):
   rmse < 0.8 px, ATE < 0.01; LM iterations per second;
19. global 200: run_sparse over the medium rung with engine_type="global",
   intrinsics held (tools/engine_rung.py), counts reset just before: the
   bars set from the reference's own CPU run on the same scene (ENGINE_REF:
   views >= the reference's less 2% of V, ATE <= max(1.5x, +0.02) the
   reference's, points >= 80% of the reference's), K1 bf16 only, K2 held,
   K3 and K4 launched in its final BAs (_lm_kernels); rotation_averaging
   and translation_averaging called twice on the run's own edge tables,
   the same bits, each timed (CUDA events); K2-K4 at the run's last call
   against their twins as in phase 8;
20. stellar 200: the same scene with engine_type="stellar", self-
   calibrating one group from FOCAL_START x the truth: its bars (and fx
   within FX_TOL, as the reference's run meets it), K2 refine, K5 with
   D = 6 and 7 and K4 with D = 7 launched; rotation_averaging,
   edge_scale_solve and scaled_translation_solve repeat bit for bit and are
   timed; K2 refine, K5 (D = 7) and K4 (D = 7) against their twins;
21. calibration: tests/test_calibration.py's chessboards rendered on the
   host (tools/calib_boards.py), corners found by OpenCV, calibrate_camera
   on the card: rms < 0.5 px, fx and fy within 2%, cx and cy within 15 px,
   and within 1e-3 of the same solve on the CPU;
22. service A (tpusfm_torch.tools.service_rung rung A): the port's HTTP
   service on 127.0.0.1 at a free port with a fresh workspace; the 20-view
   480x640 orbit POSTed to /upload as PNG (multipart), focal prior at its
   focal, the dense rung's DenseConfig; GET /preprocessing, /sparse,
   /dense, /mesh in turn, each waited on through /status (busy None,
   error None, a deadline), one /event frame read; asserts from the
   workspace >= 19/20 registered, ATE <= 0.05, > 1000 points (scene.npz),
   the sparse, COLMAP, report, viewer, dense (>= 300,000 finite points in
   dense.ply), depth-map, mesh (> 1000 faces in mesh.ply) and textured
   OBJ/MTL/atlas artifacts present and non-empty, /files/colorized.ply
   downloaded, K1 launched bf16 only (counts reset just before); prints
   each stage's wall seconds;
23. service B (rung B): the medium rung's 200 views as EXIF JPEG
   photographs (quality 95: Make/Model of the sensor database, the focal
   as FocalLength, a GPS fix at each true centre, 1 unit = 1 m) through
   /upload, /preprocessing and /sparse: >= 190/200 registered, ATE <= 0.10,
   > 1000 points, refined fx within 1% of the truth, report.json's geo
   present with >= 190 fixes and rms under 1 m, K1 bf16 only, and K2 held
   and refine, K5 with D = 6 and 7, K3 and K4 launched in the run (counts
   reset just before); prints the decoders that ran (native or PIL), the
   stage and engine-phase seconds;
24. CLI: ``python -m tpusfm_torch.cli reconstruct`` as a child process
   over the first 6 frames of service A with --focal and no --device:
   exit 0, >= 5 registered in its report.json, which names a CUDA device,
   as does its stderr (the card is the default);
25-29. the parallel/ slice (tpusfm_torch.tools.parallel_rung): one world
   of 2 ranks spawned on the one card, joined by gloo (NCCL refuses two
   ranks on one device; gloo moves each collective through host memory),
   every rank resetting the launch counts just before each phase and
   reading them just after.  25: run_sparse(devices=2) over the held
   200-view rung: >= 190/200, ATE <= 0.10, > 1000 points, match tables
   bit-equal to phase 5's, registered >= phase 5's - 2 and points within
   10% of it, sharded full BAs ran, K1, K2, K4 and K5 (D = 6) launched on
   each rank; rank 0's last K5 call (held, D = 6, a new mode) is held
   against its twin as phase 8 holds K2-K4;  26: the 500-camera BA sharded
   on the kernel path at 10 forced LM iterations, its cost within 1% of one
   device's solve at 10, LM it/s printed beside it;  27: the one-group
   self-calibrating BA over phase 5's scene, sharded: K2 refine, K5 and K4
   at D = 6 and 7, fx within 1% of the truth and the cost within 1% of one
   device's;  28: dense_reconstruct(mesh=) over the dense rung's 6 views:
   PM error <= 0.006, >= 300,000 fused points, depth maps equal to phase
   4's on >= 99% of pixels;  29: ring_match_all_pairs at 64 views x 1024
   u8-grid descriptors, every ordered pair of each rank's rows bit-equal to
   K1 run locally;
30. one NCCL world of 1 rank in this process around phase 26's solve (the
   NCCL path starts and all-reduces on the card), its cost within 1% of
   one device's;
31. the HTTP service on 2 ranks (tpusfm_torch.tools.service_rung
   ranks_main): one world of 2 gloo ranks sharing the card, rank 0 serving
   on 127.0.0.1 and driving it as a client, rank 1 following its stage
   commands, each rank resetting the launch counts just before and reading
   them just after; service B's 200 photographs through /upload,
   /preprocessing and /sparse: phase 23's bars (>= 190/200, ATE <= 0.10,
   > 1000 points, fx within FX_TOL, geo rms < 1 m with >= 190 fixes), the
   putative match table bit-equal to phase 23's, registered >= phase 23's
   - 2, points within 10% of it, sharded BAs in report.json's ba_solves,
   and on each rank K1 bf16 only, K2 refine, K5 at D = 6 and 7 and K4
   launched; each rank's stage seconds printed; then service A's first 6
   frames through all four stages on the same two ranks: >= 5/6
   registered, ATE <= 0.05, >= 300,000 finite dense points, > 1000 mesh
   faces; then rank 0's last call of each kernel variant of service B (K1
   bf16 on its share of a chunk, K2 held and refine, K3, K4 and K5 at
   D = 6 and 7, on its half of the point-space tables) against the twins,
   as phases 8 and 12; the world is given SERVICE_RANKS_S to end.

The second-to-last stdout line is a JSON object with one entry per kernel
K1-K9 and K2's unreduced mode, second K3 and K2 entries at the 500-camera
shape, a second K4 entry at path B's cameras, a second K5 entry at path
B's one group (D = 9), a second K1 entry at the 200-view chunk, K1's f32
variant at the 20-view and 200-view chunks (launches 0: no main path
takes it), K1-K4 entries at the pod rung's shapes, K2-K4 entries at
the global run's final BA and K2 refine, K5 and K4 entries at the stellar
run's, K5's held mode (D = 6) at the sharded 200-view run's rank 0, K1,
K2 (held, refine), K3, K4 and K5 (D = 6, 7) at rank 0 of the two-rank
service B (their launches that rank's in phase 31), and
the four sublane entry points at path B's shapes (launches 0): route,
source,
the TPU kernel it replaces, launches in its main-path run (the 20-view run
for K1, the held 200-view run for the second K1 entry and K2-K4, the
500-camera kernel-path solve of phase 10 for the second K3 and K2 entries,
path A for K5, path B for K6, K7 and the second K4 and K5 entries, the
20-view and 200-view runs for K1's f32 entries, the gather run
for K8 and K9, the composition of phase 9 for K2 unreduced, the pod run
for the pod entries, the global and stellar runs for theirs), max abs error
against the (float64 for K2-K9) twin, kernel and twin milliseconds, the
device time from torch.profiler (with the kernels of a call printed), the
least time the card could take (bytes at 3.35 TB/s or operations at their
peak, whichever is larger: K1's bf16 products at 989 TFLOP/s on the
tensor cores, K1's f32 entries three TF32 products at 495 TFLOP/s,
everything else float32 at 67 TFLOP/s) and what bounds it (K1's entries
also carry a torch.bmm yardstick, the f32 ones the CUDA cores' bound too),
and the time of one PyTorch call computing the same
function where there is one (index_add_ for K6, K7, index_select for K8,
K9), by CUDA events and by torch.profiler (library_device_ms), all at the
kernel's main-path shape.  A seg_layout entry gives the layout kernel at
path B's cameras (the function is a stable sort into segments, so its
library call is torch.sort with stable=True), its launches those of the
held 200-view run, where each kernel-path BA solve builds one layout; the
sublane segsum_table and schur_bwd entries also carry their device time
split into the layout's and the kernel's (layout_device_ms,
kernel_device_ms).  The last line is {"ok": true, "device": {...}}.
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


# The BA kernels' wrapper names in tpusfm_torch.ops.obs_table (K2, K3, K4),
# and those of the self-calibrating and unfused paths (K5, K6, K7).
BA_KERNELS = ("linearize_reduce_radial3_t", "schur_mv_t", "schur_bwd_t")
NEW_KERNELS = ("schur_fwd_t", "segsum_table_t", "segsum_sorted_t")
# The gathers (K8, K9) and K2's unreduced mode.
GATHERS = ("gather_table", "gather_sorted")
UNREDUCED = "linearize_radial3_t"
# Second entries on the kernels line: K3 and K2 (held) at the 500-camera BA
# shape, their launches those of the 500-camera kernel-path solve; K4 on
# path B's cameras (D = 6, 1.48M rows), its launches path B's.
K3_BENCH = "schur_mv_t (500-camera BA)"
K2_BENCH = "linearize_reduce_radial3_t (500-camera BA)"
K4_PATH_B = "schur_bwd_t (path B, cameras)"
# A second K1 entry at the 200-view run's own chunk, its launches that run's.
K1_200 = "topk2_match (200-view chunk)"
# K1's f32 variant (three TF32 products) at the 20-view and 200-view chunks;
# no main path launches it (its launches are those runs' f32 count, 0).
K1_F32 = "topk2_match f32 (20-view chunk)"
K1_F32_200 = "topk2_match f32 (200-view chunk)"
# K5 on path B's one intrinsic group (D = 9), its launches path B's at D = 9.
K5_PATH_B = "schur_fwd_t (path B, D=9)"
# The pod rung's entries: K1 at its matching chunk, K2-K4 at its final
# 1000-camera BA, their launches those of the pod run.
POD = {"topk2_match": "topk2_match (pod rung chunk)",
       "linearize_reduce_radial3_t": "linearize_reduce_radial3_t (pod rung final BA)",
       "schur_mv_t": "schur_mv_t (pod rung final BA)",
       "schur_bwd_t": "schur_bwd_t (pod rung final BA)"}
# The global and stellar engines' entries: K2-K4 at the held global run's
# final BA, K2 refine, K5 (D = 7) and K4 (one group, D = 7) at the
# self-calibrating stellar run's; their launches those runs'.
GLOBAL = {"linearize_reduce_radial3_t": "linearize_reduce_radial3_t (global 200 final BA)",
          "schur_mv_t": "schur_mv_t (global 200 final BA)",
          "schur_bwd_t": "schur_bwd_t (global 200 final BA)"}
# K5 held (D = 6), the mode sharding adds: rank 0's last call in the
# sharded 200-view run, its launches that rank's in that run.
K5_SHARDED = "schur_fwd_t (sharded 200 held, D=6, rank 0 of 2)"
STELLAR = {"linearize_reduce_radial3_t": "linearize_reduce_radial3_t (stellar 200 final BA, "
                                         "refine)",
           "schur_fwd_t": "schur_fwd_t (stellar 200 final BA, D=7)",
           "schur_bwd_t": "schur_bwd_t (stellar 200 final BA, one group, D=7)"}
# How long phase 31's world of two ranks may take (its card run took 123 s).
SERVICE_RANKS_S = 600.0
# The two-rank service B's entries (phase 31): rank 0's last call of each
# kernel variant of its path, each held against its twin; their launches
# that rank's in the phase.
SERVICE_RANKS = {
    ("match_topk2", "quantized"): "topk2_match (two-rank service B chunk, rank 0 of 2)",
    ("linearize_reduce_radial3_t", "held"): "linearize_reduce_radial3_t (two-rank service B, "
                                            "held, rank 0 of 2)",
    ("linearize_reduce_radial3_t", "refine"): "linearize_reduce_radial3_t (two-rank service B, "
                                              "refine, rank 0 of 2)",
    ("schur_mv_t", ""): "schur_mv_t (two-rank service B, rank 0 of 2)",
    ("schur_fwd_t", "D=6"): "schur_fwd_t (two-rank service B, D=6, rank 0 of 2)",
    ("schur_fwd_t", "D=7"): "schur_fwd_t (two-rank service B, D=7, rank 0 of 2)",
    ("schur_bwd_t", "D=6"): "schur_bwd_t (two-rank service B, D=6, rank 0 of 2)",
    ("schur_bwd_t", "D=7"): "schur_bwd_t (two-rank service B, D=7, rank 0 of 2)"}
# The reference's own run_sparse over the medium rung on a CPU
# (scripts/selfcal_rung.py --views 200 --engine global --held, and --engine
# stellar --focal-start 1.0; PERF.md section 6), recorded before any card
# run of these engines: registered views, ATE, points and the refined fx's
# relative error.  The card runs are held to bars set from it
# (_engine_bars); its global engine misses the medium rung's own bars.
ENGINE_REF = {"global": {"registered": 200, "ate": 3.1109862795005183, "points": 58,
                         "fx_err": None},
              "stellar": {"registered": 200, "ate": 0.015944265696080647, "points": 1272,
                          "fx_err": -0.004865765571594238}}
# Published H100 SXM peaks (NVIDIA's data sheet, 700 W): device memory,
# float32 outside the tensor cores, which every kernel but K1's computes
# in, and dense bf16 and TF32 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12
TF32_TENSOR_FLOP_PER_S = 495e12
# The layout kernel replaces no TPU kernel: the reference sums by id with
# one-hot products and sorts nothing.
LAYOUT_REPLACES = "none (set-up of K2-K4 and K6; tpusfm/ops/obs_table.py:128 sums without a sort)"
# Kernel-name pieces of the layout kernel's three launches (csrc/ba_layout.cu).
LAYOUT_KERNELS = ("seg_count_kernel", "seg_tile_scan_kernel", "seg_scatter_kernel")
# Float operations per observation of K2's per-observation math (projection,
# distortion, Huber weight, closed-form Jacobians: ~290) and products (Hcc,
# gc, Hpp, gp, W, cost: ~160); refine mode adds Jg and its products (Hcg,
# Hgg, gg, Wg: ~315).  Counted from csrc/ba_linearize.cu, each done once.
K2_FLOPS_PER_OBS = {False: 450, True: 765}
# K2's unreduced mode writes full blocks: Hcc 36 and Hpp 9 products instead
# of 21 and 6 (+54), and in refine mode Hgg 49 instead of 28 (+63 more).
K2U_FLOPS_PER_OBS = {False: 504, True: 882}


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


def _device_ms(fn, runs: int = 10, attempts: int = 3) -> float | None:
    """Device time of one call from torch.profiler's kernel records over
    `runs` calls after two warm-ups: for each kernel the call launches
    (each wrapper here launches each of its kernels once), its mean
    recorded duration, summed.  A mean per kernel stays right where the
    profiler misses records, as it does late in this script's run on the
    card; kernels with fewer records than calls are printed.  A window in
    which it kept no kernel record is profiled again, up to `attempts`
    times; None if none kept one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpusfm_torch.tools.profile_rung import _device_kernels

    fn()
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        rows = _device_kernels(prof)
        if rows:
            break
        print(f"    profiler kept no kernel record of {runs} calls")
    else:
        return None
    short = [(name[:60], n) for name, n, _ in rows if n != runs]
    if short:
        print(f"    profiler kept {short} kernel records of {runs} calls")
    print(f"    {len(rows)} kernel(s) a call: {', '.join(_kernel_name(n) for n, _, _ in rows)}")
    return sum(us / n for _, n, us in rows) / 1e3


def _kernel_name(name: str) -> str:
    """A profiler kernel name without namespaces and parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("::")[-1]


def _dev(ms: float | None) -> str:
    """A device time for printing; None where the profiler kept no record."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
    from pathlib import Path

    from tpusfm_torch.ops import cuda_build

    t0 = time.time()
    path = cuda_build.build(verbose=True)
    cuda_build.kernels()
    print(f"build: {path.name} in {time.time() - t0:.2f} s")
    sass = _run([str(Path(cuda_build._nvcc()).with_name("cuobjdump")), "-sass", str(path)])
    for variant, name in (("bf16", "topk2_match_bf16_kernel"), ("f32", "topk2_match_tf32_kernel")):
        kernel = sass[sass.index(name):].split("Function :")[0]
        hgmma = [line.strip() for line in kernel.splitlines() if "HGMMA" in line]
        if not hgmma:
            raise AssertionError(f"K1's {variant} kernel has no tensor-core instruction in its SASS")
        print(f"K1 {variant} kernel SASS: {len(hgmma)} HGMMA, the first: {hgmma[0]}")


def _u8_grid(shape, gen, dev):
    import torch

    return torch.floor(torch.rand(shape, generator=gen, device=dev) * 256.0).clamp(max=255.0)


def _twin_match(da, db, ma, mb, ratio=0.8):
    """match_descriptors_topk2 (f32 variant) computed with the plain twin
    (oracle)."""
    import torch

    from tpusfm_torch.ops import topk2_match as k1

    d1, d2, i1 = k1.match_topk2_reference(da, db, mb)
    ok = ma & (d1 < (ratio * ratio) * d2) & (d1 < k1.INF)
    _, _, j1 = k1.match_topk2_reference(db, da, ma)
    ok = ok & (torch.gather(j1, -1, i1.long()) == torch.arange(da.shape[1], device=da.device))
    return i1, ok


def _k1_equal(da, db, mb, label: str) -> float:
    """K1's bf16 kernel on u8-grid inputs: bit-equal to its twin, to the f32
    kernel and to itself on a repeat; the f32 kernel bit-equal to its twin.
    Returns the bf16 kernel's max abs error against its twin (0)."""
    import torch

    from tpusfm_torch.ops import topk2_match as k1

    got = _repeat_equal(lambda: k1.match_topk2(da, db, mb, quantized=True), f"K1 bf16 at {label}")
    f32 = k1.match_topk2(da, db, mb)
    torch.cuda.synchronize()
    want = k1.match_topk2_reference(da, db, mb, quantized=True)
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    for what, x, y in (("the bf16 kernel and its twin", got, want),
                       ("the bf16 and f32 kernels", got, f32),
                       ("the f32 kernel and its twin", f32, k1.match_topk2_reference(da, db, mb))):
        if not all(torch.equal(g, w) for g, w in zip(x, y)):
            raise AssertionError(f"K1 at {label}: {what} differ (bf16 max err {err})")
    print(f"K1 bf16 kernel bit-equal to its twin, to the f32 kernel and on a repeat; f32 kernel "
          f"bit-equal to its twin: {label}")
    return err


def _k1_off_grid(da, db, mb, label: str) -> float:
    """K1's bf16 kernel on off-grid float descriptors against its twin, which
    sums the same bf16 products in another order: d1 and d2 within 1e-5 x
    (|a|^2 of the rounded row + the largest |b|^2 of the pair), i1 equal
    wherever d2 - d1 exceeds that.  Returns the largest error in units of
    that tolerance."""
    import torch

    from tpusfm_torch.ops import topk2_match as k1

    got = k1.match_topk2(da, db, mb, quantized=True)
    d1, d2, i1 = k1.match_topk2_reference(da, db, mb, quantized=True)
    ar = da.to(torch.bfloat16).double()
    tol = 1e-5 * ((ar * ar).sum(-1) + (db.double() ** 2).sum(-1).amax(-1, keepdim=True))
    rel = max(float(((g.double() - w.double()).abs() / tol).max()) for g, w in
              zip(got[:2], (d1, d2)))
    sep = (d2.double() - d1.double()) > tol
    if not rel <= 1.0 or not torch.equal(got[2][sep], i1[sep]):
        raise AssertionError(f"K1 bf16 at {label}, off the grid: error {rel} of the tolerance, "
                             f"i1 differs on {int((got[2] != i1)[sep].sum())} separated rows")
    print(f"K1 bf16 kernel within the off-grid tolerance of its twin at {label}: largest error "
          f"{rel:.3e} of it, i1 equal on {int(sep.sum())}/{sep.numel()} separated rows")
    return rel


def _k1_times(da, db, mb, label: str, card: str) -> dict:
    """K1's bf16 kernel on one chunk: CUDA-event and profiler times, its
    twin's, its bound (bf16 products at the tensor-core rate) and the
    product alone in torch.bmm on bf16 copies."""
    import torch

    from tpusfm_torch.ops import topk2_match as k1

    P, na, nb = da.shape[0], da.shape[1], db.shape[1]
    flops = 2.0 * P * na * nb * 128
    out = k1.match_topk2(da, db, mb, quantized=True)
    a16, b16t = da.to(torch.bfloat16), db.to(torch.bfloat16).transpose(1, 2)
    res = {"ms": _median_ms(lambda: k1.match_topk2(da, db, mb, quantized=True)),
           "plain_ms": _median_ms(lambda: k1.match_topk2_reference(da, db, mb, quantized=True)),
           "product_only_ms": _median_ms(lambda: torch.bmm(a16, b16t)),
           "device_ms": _device_ms(lambda: k1.match_topk2(da, db, mb, quantized=True))}
    res.update(_bound([da, db, mb], list(out), flops, BF16_TENSOR_FLOP_PER_S))
    del a16, b16t
    print(f"K1 bf16 kernel at {label} on {card}: {res['ms']:.4f} ms (device "
          f"{_dev(res['device_ms'])}, {flops / res['ms'] / 1e9:.1f} TFLOP/s) vs twin "
          f"{res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    print(f"torch.bmm on bf16 copies at {label}: {res['product_only_ms']:.4f} ms (product only, "
          f"not the function)")
    return res


def _k1_f32_times(da, db, mb, label: str, card: str) -> dict:
    """K1's f32 kernel on one chunk: CUDA-event and profiler times, its
    twin's, its bound (three TF32 products at the tensor-core rate, or the
    bytes, whichever is longer) beside the CUDA cores' (one float32 product
    at the float32 rate), and the product alone in torch.bmm on the float32
    inputs with TF32 off (not the function)."""
    import torch

    from tpusfm_torch.ops import topk2_match as k1

    P, na, nb = da.shape[0], da.shape[1], db.shape[1]
    flops = 2.0 * P * na * nb * 128
    out = k1.match_topk2(da, db, mb)
    bt = db.transpose(1, 2)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the float32 bmm yardstick needs TF32 off")
    res = {"ms": _median_ms(lambda: k1.match_topk2(da, db, mb)),
           "plain_ms": _median_ms(lambda: k1.match_topk2_reference(da, db, mb)),
           "product_only_ms": _median_ms(lambda: torch.bmm(da, bt)),
           "device_ms": _device_ms(lambda: k1.match_topk2(da, db, mb)),
           "library_ms": None, "library_device_ms": None}
    res.update(_bound([da, db, mb], list(out), 3 * flops, TF32_TENSOR_FLOP_PER_S))
    res["cuda_core_bound_ms"] = _bound([da, db, mb], list(out), flops)["bound_ms"]
    dev_ms = res["device_ms"] or res["ms"]
    print(f"K1 f32 kernel at {label} on {card}: {res['ms']:.4f} ms (device "
          f"{_dev(res['device_ms'])}, {3 * flops / dev_ms / 1e9:.1f} TFLOP/s of TF32 products) "
          f"vs twin {res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
          f"three TF32 products), {res['cuda_core_bound_ms']:.4f} ms on the CUDA cores; "
          f"torch.bmm float32, TF32 off: {res['product_only_ms']:.4f} ms (product only)")
    return res


def _k1_f32_off_grid(P, na, nb, mask_frac, gen, dev, dup: bool = False) -> float:
    """K1's f32 kernel on the reference's float descriptor sets
    (tests/test_pallas_match.py: A ~ 20 N(0, 1), B the first rows of A plus
    0.3 N(0, 1), then fresh rows; with `dup` every B row twice): d1 and d2
    each within 4x the float32 twin's own largest error against the float64
    twin, floored at 1e-6 of the output's scale; i1 equal to the float64
    twin's wherever its d2 - d1 exceeds twice that; the same bits on a
    repeat; with `dup`, d2 = d1 and i1 even (a tie keeps the lower index).
    Returns the larger error in units of its tolerance."""
    import torch

    from tpusfm_torch.ops import topk2_match as k1

    da = torch.randn((P, na, 128), generator=gen, device=dev) * 20
    k = min(na, nb)
    db = torch.cat([da[:, :k] + 0.3 * torch.randn((P, k, 128), generator=gen, device=dev),
                    torch.randn((P, nb - k, 128), generator=gen, device=dev) * 20], dim=1)
    if dup:
        db = torch.repeat_interleave(db, 2, dim=1)
    mb = torch.rand((P, db.shape[1]), generator=gen, device=dev) >= mask_frac
    label = f"{P} x {na} x {db.shape[1]}{', B rows doubled' if dup else ''}, mask {mask_frac}"
    got = _repeat_equal(lambda: k1.match_topk2(da, db, mb), f"K1 f32 at {label}")
    f32 = k1.match_topk2_reference(da, db, mb)
    f64 = k1.match_topk2_reference(da.double(), db.double(), mb)
    rel, tols = 0.0, []
    for i in range(2):
        tol = max(4 * float((f32[i].double() - f64[i]).abs().max()),
                  1e-6 * float(f64[i].abs().max()))
        err = float((got[i].double() - f64[i]).abs().max())
        if not err <= tol:
            raise AssertionError(f"K1 f32 at {label}: d{i + 1} error {err} above {tol}")
        rel, tols = max(rel, err / tol), tols + [tol]
    sep = (f64[1] - f64[0]) > 2 * max(tols)
    if not torch.equal(got[2][sep], f64[2][sep]):
        raise AssertionError(f"K1 f32 at {label}: i1 differs from the float64 twin on "
                             f"{int((got[2] != f64[2])[sep].sum())} separated rows")
    if dup and not (torch.equal(got[0], got[1]) and not bool((got[2] % 2).any())):
        raise AssertionError(f"K1 f32 at {label}: a tie lost its lower index or its d2")
    if mask_frac > 1 and not bool((got[0] >= 1e38).all()):
        raise AssertionError("K1 f32: fully masked B must give d1 >= 1e38")
    print(f"K1 f32 kernel within tolerance of the float64 twin off the grid at {label}: largest "
          f"error {rel:.3f} of it, i1 equal on {int(sep.sum())}/{sep.numel()} separated rows")
    return rel


def phase_kernel(card: str) -> tuple[dict, dict]:
    """K1's two variants against their twins; returns the bf16 and the f32
    kernels' entries at the 20-view chunk."""
    import torch

    from tpusfm_torch.ops import topk2_match as k1

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def grid_case(P, na, nb, mask_frac):
        da = _u8_grid((P, na, 128), gen, dev)
        db = _u8_grid((P, nb, 128), gen, dev)
        return da, db, torch.rand((P, nb), generator=gen, device=dev) >= mask_frac

    main = grid_case(192, 1024, 1024, 0.1)
    err_main = _k1_equal(*main, "192 pairs x 1024 x 1024, 10% B masked")
    c32 = grid_case(32, 1024, 1024, 0.1)
    _k1_equal(*c32, "32 pairs x 1024 x 1024, 10% B masked")
    _k1_equal(*grid_case(3, 130, 200, 0.1), "3 pairs x 130 x 200")
    _k1_equal(*grid_case(2, 65, 1, 0.0), "2 pairs x 65 x 1")
    masked = grid_case(2, 130, 200, 1.1)
    _k1_equal(*masked, "fully masked B")
    for quantized in (True, False):
        if not bool((k1.match_topk2(*masked, quantized=quantized)[0] >= 1e38).all()):
            raise AssertionError("fully masked B must give d1 >= 1e38")

    fa = torch.randn((4, 300, 128), generator=gen, device=dev) * 20
    fb = torch.cat([fa[:, :250] + 0.3 * torch.randn((4, 250, 128), generator=gen, device=dev),
                    torch.randn((4, 210, 128), generator=gen, device=dev) * 20], dim=1)
    fma = torch.ones((4, 300), dtype=torch.bool, device=dev)
    fmb = torch.rand((4, 460), generator=gen, device=dev) > 0.05
    _k1_off_grid(fa, fb, fmb, "4 pairs x 300 x 460 of float descriptors")
    i_k, ok_k = k1.match_descriptors_topk2(fa, fb, fma, fmb)
    i_t, ok_t = _twin_match(fa, fb, fma, fmb)
    if not torch.equal(ok_k, ok_t) or not torch.equal(i_k[ok_k], i_t[ok_t]):
        raise AssertionError("K1 f32 ratio test / cross-check differs from the twin on float "
                             "descriptors")
    print(f"K1 f32 kernel's ok equal to twin on float descriptors ({int(ok_k.sum())} matches)")

    rel = max(_k1_f32_off_grid(*shape, gen, dev) for shape in
              ((4, 1024, 1024, 0.1), (3, 130, 200, 0.1), (2, 65, 1, 0.0), (2, 130, 200, 1.1)))
    rel = max(rel, _k1_f32_off_grid(3, 300, 230, 0.0, gen, dev, dup=True))

    res = _k1_times(*main, "the 192-pair chunk", card)
    ms32 = _median_ms(lambda: k1.match_topk2(*c32, quantized=True))
    print(f"K1 bf16 kernel at the 32-pair chunk: {ms32:.4f} ms")
    common = {"route": "cuda", "source": "tpusfm_torch/csrc/topk2_match.cu",
              "replaces": "tpusfm/ops/pallas_match.py:57", "launches": None,
              "library_ms": None, "library_device_ms": None}
    f32 = {"name": K1_F32, **common, "variant": "quantized=False (three TF32 wgmma products)",
           "max_abs_err": err_main, "off_grid_err_of_tol": rel,
           **_k1_f32_times(*main, "the 192-pair chunk", card)}
    return ({"name": "topk2_match", **common, "max_abs_err": err_main,
             "variant": "quantized=True (bf16 wgmma)", **res}, f32)


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


_RUNG200: list = []


def _rung200():
    """The medium rung's images, ground truth and config (rung_inputs(200)),
    rendered once for every phase that runs it."""
    if not _RUNG200:
        from tpusfm_torch.tools.front_end_counts import rung_inputs

        _RUNG200.append(rung_inputs(200))
    return _RUNG200[0]


def _kc():
    """tpusfm_torch.tools.kernel_calls: the launch counts and the recorder of
    kernel-wrapper calls, the same in the parallel phases' ranks."""
    from tpusfm_torch.tools import kernel_calls

    return kernel_calls


def _only_bf16_k1(counts: dict, label: str) -> None:
    """The main path matches through K1's bf16 variant only."""
    if not counts["topk2_match"] or counts["topk2_match f32"]:
        raise AssertionError(f"{label}: K1 launched {counts['topk2_match']} times as bf16 and "
                             f"{counts['topk2_match f32']} as f32; the path takes bf16 only")


def phase_slice20(entries: dict):
    """Returns the run's scene, images and ground truth for the dense phase."""
    import torch

    from tpusfm_torch.pipeline.sparse import run_sparse
    from tpusfm_torch.tools.dense_rung import headline_inputs

    n_views = 20
    images, gt, cfg = headline_inputs(480, 640, n_views)
    _kc().reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    scene, report = run_sparse(images, gt["intr"], cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _kc().counts()
    _only_bf16_k1(counts, "20-view run")
    launches = counts["topk2_match"]
    n_pairs = n_views * (n_views - 1) // 2
    ch = max(cfg.matching.pair_chunk, 32 * ((n_pairs + 31) // 32))
    n_chunks = (n_pairs + ch - 1) // ch
    if launches < 2 * n_chunks:
        raise AssertionError(f"K1 launched {launches} times for {n_chunks} matched chunks")
    entries["topk2_match"]["launches"] = launches
    entries[K1_F32]["launches"] = counts["topk2_match f32"]
    _check_quality(scene, report, gt, n_views, 19, 0.05, "20-view run")
    print(f"  K1 launches {launches}, wall {wall:.2f} s (first run_sparse in the process)")
    return scene, images, gt


# The dense phase's bars: the PatchMatch median relative depth error of the
# matched CPU sweep in the reference's README (0.0061 there, round 5), the
# fused points and faces a dense rung must at least give, and the
# reference's texturing test's share (tests/test_texturing.py).
DENSE_MAX_ERR = 0.006
DENSE_MIN_POINTS = 300_000
MESH_MIN_FACES = 1000
MESH_MIN_TEXTURED = 0.5


def phase_dense(card: str, scene, images, gt) -> None:
    """The dense rung after the 20-view run: PatchMatch and sweep-only
    dense_reconstruct over its first 6 registered views, the mesh stage on
    the PatchMatch maps, and a torch.profiler table of one dense run."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from tpusfm_torch.io import ply
    from tpusfm_torch.tools import dense_rung

    t0 = time.time()
    out = dense_rung.run_dense(scene, images, gt, device="cuda")
    pm, sw = out["pm"], out["sweep_only"]
    for label, r in (("dense PM", pm), ("dense sweep-only", sw)):
        print(f"{label} ({card}): views {out['views']}, {r['seconds']:.3f} s, "
              f"{r['views_per_s']:.3f} views/s, fused points {r['points']}, median relative "
              f"depth error {r['depth_med_rel_err']}")
        print(f"  stage_s {json.dumps({k: round(v, 4) for k, v in r['stage_s'].items()})}")
    pts = out["points"]
    if pm["depth_med_rel_err"] is None or not pm["depth_med_rel_err"] <= DENSE_MAX_ERR:
        raise AssertionError(f"dense PM depth error {pm['depth_med_rel_err']} > {DENSE_MAX_ERR}")
    if pm["points"] < DENSE_MIN_POINTS or not np.isfinite(pts).all():
        raise AssertionError(f"dense PM: {pm['points']} fused points (< {DENSE_MIN_POINTS}) "
                             f"or non-finite")
    if sw["depth_med_rel_err"] is None or sw["points"] == 0:
        raise AssertionError(f"dense sweep-only: error {sw['depth_med_rel_err']}, "
                             f"{sw['points']} points")
    rgb = np.repeat((np.clip(images, 0, 1) * 255).astype(np.uint8)[..., None], 3, -1)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        n = ply.write_ply_points(Path(tmp) / "dense.ply", pts)
        back, _ = ply.read_ply_points(Path(tmp) / "dense.ply")
        if n != len(pts) or not np.array_equal(back, pts):
            raise AssertionError("dense.ply did not read back as written")
        mesh = dense_rung.run_mesh(out["maps"], rgb, tmp, device="cuda")
        if not (Path(tmp) / "mesh.ply").exists():
            raise AssertionError("mesh.ply was not written")
    print(f"mesh ({card}): {mesh['verts']} vertices, {mesh['faces']} faces, textured share "
          f"{mesh['textured_share']:.4f}")
    print(f"  stage_s {json.dumps({k: round(v, 4) for k, v in mesh['stage_s'].items()})}")
    if (mesh["faces"] <= MESH_MIN_FACES or not mesh["textured_share"] > MESH_MIN_TEXTURED
            or not mesh["finite"]):
        raise AssertionError(f"mesh: {mesh['faces']} faces, textured share "
                             f"{mesh['textured_share']}, finite {mesh['finite']}")
    prof = dense_rung.profile_dense(scene, images, out["views"], device="cuda")
    print(f"dense profile ({card}): wall {prof['wall_s']:.3f} s, device {prof['device_ms']:.1f} "
          f"ms in {prof['launches']} launches, busy share {prof['busy_share']:.4f}")
    for name, n, ms in prof["top"]:
        print(f"  {ms:10.3f} ms {n:7d} x {1e3 * ms / max(n, 1):8.1f} us  "
              f"{dense_rung.op_name(name)}")
    if not prof["launches"]:
        print("  the profiler kept no kernel record of the dense run")
    print(f"  dense phase wall {time.time() - t0:.1f} s")
    return out


def _run_rung(images, gt, cfg, label, captured, **kw):
    """One run_sparse of a 200-view rung on the card with the counts reset
    just before it; asserts its quality bars.  Returns (scene, counts,
    calls by variant)."""
    from collections import Counter

    import torch

    from tpusfm_torch.pipeline.sparse import run_sparse

    _kc().reset_counts()
    with _kc().recording(captured) as (solves, calls):
        torch.cuda.synchronize()
        t0 = time.time()
        scene, report = run_sparse(images, kw.pop("intr", gt["intr"]), cfg, device="cuda",
                                   seed=0, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
    counts = _kc().counts()
    _only_bf16_k1(counts, label)
    _check_quality(scene, report, gt, images.shape[0], 190, 0.10, label)
    print(f"  tracks {report['n_tracks']}, observations {report['n_obs']}, "
          f"launches {json.dumps(counts)}, wall {wall:.2f} s")
    print(f"  _lm_kernels solves {len(solves)}, shapes (C, P, O): {dict(Counter(solves))}")
    print(f"  kernel calls by variant: "
          f"{json.dumps(_kc().named(calls))}")
    if not solves:
        raise AssertionError(f"{label}: no kernel-path solve")
    return scene, counts, calls


def phase_slice200(entries: dict) -> tuple[dict, dict]:
    """The medium rung with intrinsics held; returns its last K1-K4 calls
    and (scene, registered views, points, match tables) for phase 25."""
    images, gt, cfg = _rung200()
    captured = {}
    scene, counts, _ = _run_rung(images, gt, cfg, "200-view run, intrinsics held", captured)
    if any(counts[n] == 0 for n in ("topk2_match",) + BA_KERNELS):
        raise AssertionError(f"200-view run: a kernel of the path did not launch: {counts}")
    if not counts["seg_layout"]:
        raise AssertionError(f"200-view run: no layout was built by the layout kernel: {counts}")
    for name in BA_KERNELS + ("seg_layout",):
        entries[name]["launches"] = counts[name]
    entries[K1_200]["launches"] = counts["topk2_match"]
    entries[K1_F32_200]["launches"] = counts["topk2_match f32"]
    return captured, {"scene": scene, "registered": int(scene.cam_mask.sum()),
                      "points": int(scene.point_mask.sum()),
                      "matches": captured.pop("matches")}


def phase_parallel(card: str, ref200: dict, scene20, images20, gt20, dense_out: dict,
                   entries: dict) -> None:
    """Phases 25-30 (see the docstring)."""
    import tempfile
    from pathlib import Path

    from tpusfm_torch.tools import parallel_rung as pr

    t0 = time.time()
    views = dense_out["views"]
    ref = {"registered": ref200["registered"], "points": ref200["points"],
           "matches": ref200["matches"], "dense_depths": dense_out["maps"]["depths"][views]}
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        spec, ba500 = pr.prepare(tmp, _rung200(), ref200["scene"], scene20, images20, views,
                                 gt20, "cuda:0")
        print(f"phases 25-29 ({card}): spawning 2 ranks on cuda:0 joined by gloo "
              f"(inputs written in {time.time() - t0:.1f} s)")
        t1 = time.time()
        results = pr.run_world(spec, 2, tmp)
        t_world = time.time() - t1
        print(f"phase 30 ({card}): one NCCL rank in this process around phase 26's solve")
        nccl = pr.nccl_solve(ba500, tmp, "cuda:0")
    for line in pr.check(results, ref, nccl, DENSE_MAX_ERR, DENSE_MIN_POINTS):
        print(f"  {line}")
    for r in results:
        print(f"  rank {r['rank']} phase seconds: "
              f"{json.dumps({n: round(r[n]['phase_wall_s'], 2) for n in pr.PHASES})}")
    print(f"  world of 2: {t_world:.1f} s, its results checked, parallel phases wall "
          f"{time.time() - t0:.1f} s")
    rank0 = results[0]["sparse"]
    entries[K5_SHARDED]["launches"] = rank0["launches"]["schur_fwd_t"]
    a, k = pr.to_device(rank0["k5_call"], "cuda:0")
    print(f"K5 held at the sharded 200-view run's rank 0 (O={a[0].shape[1]} rows of its shard, "
          f"P={a[4]}) on {card}")
    entries[K5_SHARDED].update(_check_kernel("schur_fwd_t", (a, k),
                                             "sharded 200 held, D=6, rank 0"))


def phase_selfcal200(entries: dict, focal_start: float) -> dict:
    """Path A: the medium rung self-calibrating one intrinsic group from a
    focal `focal_start` times the truth.  Returns its last kernel calls."""
    import numpy as np

    images, gt, cfg = _rung200()
    n_views = images.shape[0]
    intr = np.tile(np.asarray(gt["intr"], np.float32), (n_views, 1))
    intr[:, :2] *= focal_start
    captured = {}
    scene, counts, calls = _run_rung(
        images, gt, cfg, f"200-view run, self-calibrating (focal started x{focal_start})",
        captured, intr=intr, cam_group=np.zeros(n_views, np.int32))
    reg = scene.cam_mask.cpu().numpy()
    f = scene.intr.cpu().numpy()[reg][0]
    rel = f[:2] / np.asarray(gt["intr"][:2]) - 1.0
    print(f"  refined intrinsics {np.round(f, 4).tolist()}; focal (fx, fy) {f[0]:.3f}, "
          f"{f[1]:.3f} vs true {float(gt['intr'][0]):.3f}: relative error {rel[0]:+.5f}, "
          f"{rel[1]:+.5f}")
    if not abs(rel[0]) <= FX_TOL:
        raise AssertionError(f"self-calibrated fx off by {rel[0]:+.5f} (limit {FX_TOL})")
    need = [("linearize_reduce_radial3_t", "refine"), ("schur_fwd_t", "D=6"),
            ("schur_fwd_t", "D=7"), ("schur_bwd_t", "D=7")]
    if any(calls[k] == 0 for k in need) or any(counts[n] == 0 for n in
                                                ("topk2_match",) + BA_KERNELS + ("schur_fwd_t",)):
        raise AssertionError(f"self-calibrating run: a kernel of the path did not launch: "
                             f"{counts}, {dict(calls)}")
    entries["schur_fwd_t"]["launches"] = counts["schur_fwd_t"]
    return captured


def phase_gathers200(entries: dict) -> dict:
    """The held medium rung through the reference's gather path: engine.ba
    with fused_linearize=False, pallas_gathers=True, precond="schur_diag"
    (jacfwd linearization on rows gathered by K8 and K9, reduced by K6 and
    K7; the preconditioner's Hpp^-1 rows gathered by K8).  Returns its last
    kernel calls."""
    from tpusfm_torch.ba.bundle_adjust import BAConfig
    images, gt, cfg = _rung200()
    ba = BAConfig(max_iters=8, fix_first_cam=False, fused_linearize=False, pallas_gathers=True,
                  precond="schur_diag")
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(cfg.engine, ba=ba))
    captured = {}
    _, counts, calls = _run_rung(images, gt, cfg, "200-view run, gather path (unfused, "
                                 "pallas_gathers, schur_diag)", captured)
    path = GATHERS + ("segsum_table_t", "segsum_sorted_t", "schur_mv_t", "schur_bwd_t")
    print(f"  K8, K9, K6, K7, K3, K4 launches: {json.dumps({n: counts[n] for n in path})}")
    need = [("gather_table", "D=6"), ("gather_table", "D=7"), ("gather_table", "D=9"),
            ("gather_sorted", "D=3")]
    if (any(counts[n] == 0 for n in path) or any(calls[k] == 0 for k in need)
            or counts["linearize_reduce_radial3_t"]):
        raise AssertionError(f"gather-path run: not the unfused path through K8 and K9: {counts}, "
                             f"{dict(calls)}")
    for name in GATHERS:
        entries[name]["launches"] = counts[name]
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


def _bound(inputs, outputs, flops: float, rate: float = FP32_FLOP_PER_S) -> dict:
    """The least time the card could take for one call: its inputs read
    once and its outputs written once at the memory rate, or its operations
    at their peak `rate` (float32 unless given), whichever is longer."""
    nbytes = sum(t.numel() * t.element_size() for t in list(inputs) + list(outputs))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations"}


def _flops(name: str, a: tuple, k: dict) -> float:
    """Float operations of one call of a BA kernel on these inputs."""
    if name == "linearize_reduce_radial3_t":
        return K2_FLOPS_PER_OBS[bool(k.get("refine", False))] * a[5].shape[0]
    if name == UNREDUCED:
        return K2U_FLOPS_PER_OBS[bool(k.get("refine", False))] * a[5].shape[0]
    if name in GATHERS:  # copies
        return 0.0
    if name == "schur_mv_t":  # W^T v and W z (36 each), Hpp^-1 y per rank, Hcc v per camera
        return 72 * a[0].shape[1] + 15 * a[5] + 78 * a[3].shape[0]
    if name in ("schur_bwd_t", "schur_fwd_t", "schur_bwd", "schur_fwd"):  # a multiply-add per W entry
        return 2 * a[0].shape[0] * a[0].shape[1]
    return a[0].numel()  # K6, K7: one add per value


def _index_add(a: tuple):
    """The one PyTorch call that computes K6's or K7's function on the
    same inputs (index_add_ of the value columns by id), its index and
    output made beforehand; rows with an id outside [0, n) are left out."""
    import torch

    valsT, idx, n = a
    ok = (idx >= 0) & (idx < n)
    src, ids = (valsT.T, idx.long()) if bool(ok.all()) else (valsT[:, ok].T, idx[ok].long())
    out = torch.zeros((n, valsT.shape[0]), dtype=valsT.dtype, device=valsT.device)
    return lambda: out.index_add_(0, ids, src)


def _index_select(a: tuple):
    """The one PyTorch call that computes K8's or K9's function on the
    in-range ids (index_select of the table's rows), those ids picked
    beforehand."""
    table, idx = a
    ids = idx[(idx >= 0) & (idx < table.shape[0])].long()
    return lambda: table.index_select(0, ids)


def _index_add_rows(a: tuple):
    """_index_add for the sublane entry points' row-major (O, k) values."""
    return _index_add((a[0].T,) + tuple(a[1:]))


# The PyTorch call that computes a kernel's function, where there is one.
LIBRARY = {"segsum_table_t": (_index_add, "index_add_"),
           "segsum_sorted_t": (_index_add, "index_add_"),
           "segsum_table": (_index_add_rows, "index_add_"),
           "segsum_sorted": (_index_add_rows, "index_add_"),
           "gather_table": (_index_select, "index_select"),
           "gather_sorted": (_index_select, "index_select")}


def _check_kernel(name: str, call, label: str, w_outputs=()) -> dict:
    """One kernel at one captured call (args, kwargs): bit-identical on a
    repeat, each output within 4x the float32 twin's error against the
    float64 twin (the W tables of `w_outputs` within one bf16 ulp; K8 and
    K9 bit-equal to the float32 twin), median ms of kernel, float32 twin
    and, where one PyTorch call computes the same function, that call; the
    device time from torch.profiler of the kernel and of that call; its
    bound."""
    import torch

    from tpusfm_torch.ops import obs_table as ot

    a, kw = call
    fn, twin = getattr(ot, name), getattr(ot, name + "_reference")
    # The twins take neither layouts nor K4's segment-ordered W (the same
    # values as wT), so the bound counts the same bytes whatever the read.
    tw = {k: v for k, v in kw.items() if k not in ("layout", "grp_layout", "w_seg")}
    if kw.get("seg_ordered_w"):  # K2's camera-ordered W follows its outputs
        w_outputs = tuple(w_outputs) + (5 if kw.get("refine") else 3,)
    tw64 = {k: (v.double() if isinstance(v, torch.Tensor) else v) for k, v in tw.items()}
    if "w_dtype" in tw64:
        tw64["w_dtype"] = "f32"
    got = _repeat_equal(lambda: fn(*a, **kw), f"{name} at {label}")
    f32, f64 = twin(*a, **tw), twin(*_f64(a), **tw64)
    f32 = f32 if isinstance(f32, tuple) else (f32,)
    f64 = f64 if isinstance(f64, tuple) else (f64,)
    if name in GATHERS:
        if not torch.equal(got[0], f32[0]):
            raise AssertionError(f"{name} at {label}: differs from its twin")
        out = (a[1] < 0) | (a[1] >= a[0].shape[0])
        print(f"    {name}: bit-equal to its twin, {int(out.sum())} rows outside the table zero")
    errs = []
    for i, (g, lo, hi) in enumerate(zip(got, f32, f64)):
        if i not in w_outputs:
            errs.append(_oracle(g, lo, hi, f"{name} output {i}"))
            continue
        w64 = hi.double() if g.dtype == torch.float32 else hi.to(torch.bfloat16).double()
        ulp = torch.maximum(g.double().abs(), w64.abs()) * 2.0 ** -7  # >= one bf16 ulp
        diff = (g.double() - w64).abs()
        if not bool((diff <= ulp + 1e-6 * float(w64.abs().max())).all()):
            raise AssertionError(f"{name} at {label}: W output {i} differs from the float64 "
                                 "twin by more than one bf16 ulp")
        print(f"    {name} output {i} ({g.dtype}): within one bf16 ulp of the float64 twin "
              f"(max abs diff {float(diff.max()):.3e})")
    library = LIBRARY[name][0](a) if name in LIBRARY else None
    res = {"max_abs_err": max(errs), "ms": _median_ms(lambda: fn(*a, **kw)),
           "plain_ms": _median_ms(lambda: twin(*a, **tw)),
           "library_ms": None if library is None else _median_ms(library),
           "device_ms": _device_ms(lambda: fn(*a, **kw)),
           "library_device_ms": None if library is None else _device_ms(library)}
    ins = [t for t in list(a) + list(tw.values()) if isinstance(t, torch.Tensor)]
    res.update(_bound(ins, got, _flops(name, a, kw)))
    lib = "" if library is None else (f", {LIBRARY[name][1]} {res['library_ms']:.4f} ms "
                                      f"(device {_dev(res['library_device_ms'])})")
    print(f"  {name} at {label}: kernel {res['ms']:.4f} ms (device {_dev(res['device_ms'])}), "
          f"float32 twin {res['plain_ms']:.4f} ms{lib}, bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}), max abs err vs float64 twin {res['max_abs_err']:.3e}")
    return res


def _check_ba_kernels(label, k2, k3, k4, card) -> dict:
    """K2, K3 and K4 at one shape (see _check_kernel)."""
    a2 = k2[0]
    print(f"BA kernels at shape {label}: C={a2[0].shape[0]} P={a2[2].shape[0]} "
          f"O={a2[5].shape[0]} on {card}")
    return {"linearize_reduce_radial3_t": _check_kernel("linearize_reduce_radial3_t", k2, label,
                                                        w_outputs=(2,)),
            "schur_mv_t": _check_kernel("schur_mv_t", k3, label),
            "schur_bwd_t": _check_kernel("schur_bwd_t", k4, label)}


def _bench_problem(dev):
    """bench.py:171-202's 500-camera BA problem on the card."""
    import torch

    from tpusfm_torch.utils.synth_scene import point_sorted_ba_problem

    prob = point_sorted_ba_problem(500, 50000, seed=3, arc_deg=350.0, vis_prob=0.06)
    return {k: torch.as_tensor(v, device=dev) for k, v in prob.items()}


def _bench_kernel_args(args):
    """K2-K4 arguments at the bench problem's shape, as the kernel path
    calls them: K2 at the perturbed start, with W in camera order too; K3
    and K4 (on that ordered W) with a seeded v and z = Hpp^-1 gp."""
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
               layout=layout, seg_ordered_w=True)
    camred, ptred, W, W_seg = ot.linearize_reduce_radial3_t(*a2, **kw2)
    lam = torch.tensor(1e-4, device=dev)
    hcc_d = tba._damp_blocks(camred[:, list(ot._FULL66)].reshape(C, 6, 6), lam)
    hinv = tba._inv3(tba._damp_blocks(ptred[:, list(ot._FULL33)].reshape(P, 3, 3), lam))
    v = torch.randn((C, 6), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    z = torch.einsum("pij,pj->pi", hinv, ptred[:, 6:9])
    return ((a2, kw2), ((W, cam, ranks, v, hinv, P), dict(hcc_d=hcc_d, layout=layout)),
            ((W, cam, ranks, z, C), dict(layout=layout, w_seg=W_seg)))


def _check_k1_captured(captured: dict, card: str, run: str = "200-view") -> dict:
    """K1 at a run's own chunk (its last call, real SIFT descriptors on the
    u8 grid): the bf16 kernel bit-equal to its twin and to the f32 kernel,
    the same bits on a repeat; the same chunk moved off the grid by a
    seeded offset in (-0.5, 0.5) within the off-grid tolerance; the bf16
    kernel timed.  Returns the entry's numbers."""
    import torch

    da, db, mb = captured["match_topk2", "quantized"][0][:3]
    label = f"{da.shape[0]} pairs x {da.shape[1]} x {db.shape[1]} ({run} chunk)"
    err = _k1_equal(da, db, mb, label)
    gen = torch.Generator(device=da.device).manual_seed(1)
    off = [x + torch.rand(x.shape, generator=gen, device=x.device) - 0.5 for x in (da, db)]
    _k1_off_grid(off[0], off[1], mb, label + ", moved off the grid")
    del off
    return {"max_abs_err": err, **_k1_times(da, db, mb, label, card)}


def phase_ba_kernels(card, captured: dict, entries: dict) -> dict:
    import torch

    dev = torch.device("cuda")
    entries[K1_200].update(_check_k1_captured(captured, card))
    da, db, mb = captured["match_topk2", "quantized"][0][:3]
    entries[K1_F32_200].update(max_abs_err=0.0, off_grid_err_of_tol=None, **_k1_f32_times(
        da, db, mb, f"{da.shape[0]} pairs x {da.shape[1]} x {db.shape[1]} (200-view chunk)", card))
    res_a = _check_ba_kernels("(a) 200-view final BA", *(captured[n] for n in BA_KERNELS), card)
    for name, res in res_a.items():
        entries[name].update(res)
    bench = _bench_problem(dev)
    res_b = _check_ba_kernels("(b) 500-camera bench problem", *_bench_kernel_args(bench), card)
    entries[K3_BENCH].update(res_b["schur_mv_t"])
    entries[K2_BENCH].update(res_b["linearize_reduce_radial3_t"])
    return bench


def _timed_solve(bench: dict, cfg, label: str, card: str, **kw):
    """One bundle_adjust after a one-iteration warm-up, counts reset just
    before it; prints LM it/s.  Returns (output, launches)."""
    import torch

    from tpusfm_torch.ba import bundle_adjust as tba
    from tpusfm_torch.ops import obs_table as ot

    tba.bundle_adjust(cfg=dataclasses.replace(cfg, max_iters=1), **bench, **kw)
    _kc().reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    out = tba.bundle_adjust(cfg=cfg, **bench, **kw)
    torch.cuda.synchronize()
    dt = time.time() - t0
    its = int(out[4]["iterations"])
    launches = dict(ot.LAUNCHES)
    C, P, O = bench["intr"].shape[0], bench["points"].shape[0], bench["obs_cam"].shape[0]
    print(f"BA solve at C={C} P={P} O={O} via {label} on {card}: {its} LM iterations in "
          f"{dt:.3f} s = {its / dt:.3f} LM it/s; cost {float(out[4]['initial_cost']):.6g} "
          f"-> {float(out[4]['final_cost']):.6g}; launches {json.dumps(launches)}")
    if not bool(torch.isfinite(out[3]).all()):
        raise AssertionError(f"BA via {label}: non-finite points")
    return out, launches


def phase_ba_solve(bench: dict, card: str, entries: dict) -> None:
    from tpusfm_torch.ba import bundle_adjust as tba

    cfg = tba.BAConfig(max_iters=20, cg_iters=30, assume_sorted=True)
    forced = dataclasses.replace(cfg, converge_rtol=0.0)  # all 20 iterations, for the rate
    costs = {}
    for name, c in (("kernels", cfg), ("plain", dataclasses.replace(cfg, impl="xla")),
                    ("kernels, 20 forced", forced),
                    ("plain, 20 forced", dataclasses.replace(forced, impl="xla")),
                    ("kernels, schur_diag", dataclasses.replace(cfg, precond="schur_diag"))):
        out, launches = _timed_solve(bench, c, name, card)
        costs[name] = float(out[4]["final_cost"])
        if name == "kernels":
            entries[K3_BENCH]["launches"] = launches["schur_mv_t"]
            entries[K2_BENCH]["launches"] = launches["linearize_reduce_radial3_t"]
        need = BA_KERNELS + (("segsum_table_t",) if "schur_diag" in name else ())
        if name.startswith("kernels") and any(launches[n] == 0 for n in need):
            raise AssertionError(f"the {name} solve did not launch every kernel: {launches}")
    for run in ("", ", 20 forced"):
        ck, cp = costs["kernels" + run], costs["plain" + run]
        if not abs(ck - cp) <= 1e-2 * cp:
            raise AssertionError(f"kernel-path final cost {ck} vs plain {cp}{run}: more than "
                                 "1e-2 apart")
    sd, hcc = costs["kernels, schur_diag"], costs["kernels"]
    if not abs(sd - hcc) <= 1e-2 * hcc:
        raise AssertionError(f"schur_diag solve's cost {sd} vs hcc {hcc}: more than 1e-2 apart")


def _packed_close(got, want, what):
    """The reference's oracle tolerance for sums taken in other orders
    (tests/test_obs_table.py:147-196): rtol 2e-5, atol 1e-4 of the
    output's largest entry."""
    tol = 2e-5 * want.abs() + 1e-4 * float(want.abs().max())
    err = float((got - want).abs().max())
    if not bool(((got - want).abs() <= tol).all()):
        raise AssertionError(f"{what}: K6/K7 over the unreduced tables differ from K2 reduced "
                             f"by {err}")
    return err


def _unreduced_kw(kw: dict) -> dict:
    """K2's keyword arguments that its unreduced mode takes too."""
    return {k: v for k, v in kw.items() if k not in ("layout", "grp_layout", "seg_ordered_w")}


def _unreduced_then_reduce(a, kw):
    """The reference's CPU delegate of K2 (obs_table.py:1556-1580) through
    the port's ops entry points: K2's unreduced mode, then K6 per camera
    (and group) and K7 per rank.  Returns the reduced mode's outputs
    rebuilt from those sums: (camred, ptred[, grpred]) packed."""
    from tpusfm_torch.ops import obs_table as ot

    refine = kw.get("refine", False)
    lay, glay = kw.get("layout"), kw.get("grp_layout")
    outs = ot.linearize_radial3_t(*a, **_unreduced_kw(kw))
    C, G, P = a[0].shape[0], a[1].shape[0], a[2].shape[0]
    cam = ot.segsum_table_t(outs[0], a[3], C, layout=lay)
    pt = ot.segsum_sorted_t(outs[1], a[5], P, layout=lay)
    pck6 = [i * 6 + j for i in range(6) for j in range(i, 6)]
    pck3 = [i * 3 + j for i in range(3) for j in range(i, 3)]
    camred = cam[:, pck6 + list(range(36, cam.shape[1]))]
    ptred = pt[:, pck3 + [9, 10, 11]]
    if not refine:
        return camred, ptred
    grp = ot.segsum_table_t(outs[3], a[4], G, layout=glay)
    pck7 = [i * 7 + j for i in range(7) for j in range(i, 7)]
    return camred, ptred, grp[:, pck7 + list(range(49, 56))]


def _check_unreduced(call, label, card) -> dict:
    """K2's unreduced mode at one shape: against its twins (as
    _check_kernel), and its K6 + K7 reduction against K2 reduced on the
    same inputs.  Frees its tables before returning."""
    import torch

    from tpusfm_torch.ops import obs_table as ot

    a, kw = call
    ukw = _unreduced_kw(kw)
    print(f"K2 unreduced at {label}: C={a[0].shape[0]} G={a[1].shape[0]} P={a[2].shape[0]} "
          f"O={a[5].shape[0]} on {card}")
    res = _check_kernel(UNREDUCED, (a, ukw), label, w_outputs=(2, 4))
    red = ot.linearize_reduce_radial3_t(*a, **kw)
    sums = _unreduced_then_reduce(a, kw)
    errs = [_packed_close(got, want, f"{label}, {what}")
            for got, want, what in zip(sums, red[:2] + red[3:4], ("camred", "ptred", "grpred"))]
    print(f"    K6 + K7 over the unreduced tables = K2 reduced (rtol 2e-5, atol 1e-4 of scale): "
          f"max abs diff {max(errs):.3e}")
    del red, sums
    torch.cuda.empty_cache()
    return res


def phase_unreduced(card: str, captured: dict, cap_a: dict, bench: dict, entries: dict) -> None:
    """K2's unreduced mode, held and refine, at the 200-view shapes (the
    held run's and path A's last K2 calls) and at the 500-camera shape;
    its launches counted over the ops-layer composition (unreduced K2, then
    K6 and K7) at the two 200-view shapes."""
    import torch

    from tpusfm_torch.ops import obs_table as ot

    held_a, refine_a = captured["linearize_reduce_radial3_t"], \
        cap_a["linearize_reduce_radial3_t", "refine"]
    _kc().reset_counts()
    for a, kw in (held_a, refine_a):
        _unreduced_then_reduce(a, kw)
    torch.cuda.synchronize()
    counts = _kc().counts()
    print(f"K2 unreduced, then K6 and K7, at the 200-view shapes (held, path A refine): launches "
          f"{json.dumps({n: counts[n] for n in (UNREDUCED, 'segsum_table_t', 'segsum_sorted_t')})}")
    if counts[UNREDUCED] != 2 or not counts["segsum_table_t"] or not counts["segsum_sorted_t"]:
        raise AssertionError(f"the unreduced composition did not launch its kernels: {counts}")
    entries[UNREDUCED]["launches"] = counts[UNREDUCED]
    entries[UNREDUCED].update(_check_unreduced(held_a, "(a) 200-view final BA, held", card))
    _check_unreduced(refine_a, "path A, refine", card)
    (a2, kw2), _, _ = _bench_kernel_args(bench)
    _check_unreduced((a2, kw2), "(b) 500-camera bench problem, held", card)
    grp = torch.zeros_like(a2[4])
    a2r = (a2[0], a2[1][:1], a2[2], a2[3], grp) + a2[5:]
    kw2r = dict(kw2, refine=True, refine_mask=(1.0,) * 7, grp_layout=ot.obs_layout(grp, 1))
    _check_unreduced((a2r, kw2r), "(b) 500-camera bench problem, refine, one group", card)


def _check_k6_layouts(call, label: str) -> None:
    """K6 on a captured row-major table (the (k, O) view of the producer's
    (O, k) table) and on a lane-major copy of it, which K6 first transposes:
    bit-equal, both timed."""
    import torch

    from tpusfm_torch.ops import obs_table as ot

    (valsT, idx, n), kw = call
    lane = valsT.contiguous()
    if ot.segsum_lane_major(valsT) or not ot.segsum_lane_major(lane):
        raise AssertionError(f"K6 at {label}: the captured table is not row-major")
    row_out = ot.segsum_table_t(valsT, idx, n, **kw)
    lane_out = ot.segsum_table_t(lane, idx, n, **kw)
    torch.cuda.synchronize()
    if not torch.equal(row_out, lane_out):
        raise AssertionError(f"K6 at {label}: row-major and lane-major tables give other sums")
    t = {name: (_median_ms(f), _device_ms(f)) for name, f in
         (("row", lambda: ot.segsum_table_t(valsT, idx, n, **kw)),
          ("lane", lambda: ot.segsum_table_t(lane, idx, n, **kw)))}
    print(f"  segsum_table_t layouts at {label}: row-major view {t['row'][0]:.4f} ms (device "
          f"{_dev(t['row'][1])}), lane-major {t['lane'][0]:.4f} ms (device {_dev(t['lane'][1])}, "
          f"its transpose included); sums bit-equal")
    del lane
    torch.cuda.empty_cache()


def phase_gather_kernels(card: str, cap_g: dict, cap_b: dict, entries: dict) -> None:
    """K8 and K9 at the shapes the 200-view gather run and path B's gather
    solve gave them: bit-equal to their twins, zero rows outside the
    table, repeats identical; timed beside index_select.  K6 at the gather
    run's shapes (32,768 rows: per camera k = 42, schur_diag k = 36)."""
    print(f"Gather kernels at their path shapes on {card}")
    _check_kernel("segsum_table_t", cap_g["segsum_table_t", "k=42"],
                  "200-view gather run, cameras, k=42")
    _check_kernel("segsum_table_t", cap_g["segsum_table_t", "k=36"],
                  "200-view gather run, schur_diag blocks, k=36")
    entries["gather_table"].update(_check_kernel("gather_table", cap_g["gather_table", "D=6"],
                                                 "200-view run, poses D=6"))
    _check_kernel("gather_table", cap_g["gather_table", "D=7"], "200-view run, intrinsics D=7")
    _check_kernel("gather_table", cap_g["gather_table", "D=9"],
                  "200-view run, schur_diag Hpp^-1 rows D=9")
    entries["gather_sorted"].update(_check_kernel("gather_sorted", cap_g["gather_sorted", "D=3"],
                                                  "200-view run, points by rank"))
    _check_kernel("gather_table", cap_b["gather_table", "D=6"], "path B, poses D=6")
    _check_kernel("gather_table", cap_b["gather_table", "D=9"], "path B, one group D=9")
    _check_kernel("gather_sorted", cap_b["gather_sorted", "D=3"], "path B, points by rank")


PRE_BASE = {"sift.n_octaves": 3, "sift.max_features": 512, "sift.max_per_octave": 256,
            "matching.pair_chunk": 8}  # tests/test_preemptive.py:13-16


def phase_preemptive() -> None:
    """The preemptive prefilter on tests/test_preemptive.py's 8-view scene
    (240x320, 200-degree arc, exhaustive pairs): its keep mask, computed by
    K1's bf16 variant, equals the plain full-matrix matcher's on the same
    card tensors; with the prefilter, kept pairs' matches equal full
    matching's and dropped rows are all invalid; every pair with 50
    putative matches survives and at least one pair drops."""
    import numpy as np
    import torch

    from tpusfm_torch.matching import match as tmatch
    from tpusfm_torch.pipeline import sparse
    from tpusfm_torch.pipeline.config import config_from_overrides
    from tpusfm_torch.utils.synth_render import render_orbit_images

    images, _ = render_orbit_images(n_views=8, img_h=240, img_w=320, arc_deg=200.0)
    full = config_from_overrides(**PRE_BASE)
    pre = config_from_overrides(**PRE_BASE, **{"matching.preemptive": True})
    feats = sparse.detect_features(images, full, device="cuda")
    pl = sparse.generate_pairs(8, full)
    _kc().reset_counts()
    keep = sparse.preemptive_filter_pairs(feats, pl, pre)
    torch.cuda.synchronize()
    counts = _kc().counts()
    _only_bf16_k1(counts, "preemptive prefilter")
    K = pre.matching.preemptive_features
    ia, ib = (torch.as_tensor(pl[:, i], device="cuda").long() for i in (0, 1))
    desc, mask = feats.desc[:, :K], feats.mask[:, :K]
    _, ok = tmatch.match_descriptors(desc[ia], desc[ib], mask[ia], mask[ib])
    plain = (ok.sum(-1) >= pre.matching.preemptive_min_matches).cpu().numpy()
    if not np.array_equal(keep, plain):
        raise AssertionError(f"preemptive keep mask from K1 {keep.astype(int).tolist()} differs "
                             f"from the plain matcher's {plain.astype(int).tolist()}")
    mi0, mv0 = sparse.match_pairs(feats, pl, full)
    mi1, mv1 = sparse.match_pairs(feats, pl, pre)
    if (not np.array_equal(mv1[keep], mv0[keep]) or not np.array_equal(mi1[keep], mi0[keep])
            or mv1[~keep].any()):
        raise AssertionError("matching with the prefilter: kept rows differ from full matching's "
                             "or dropped rows are not all invalid")
    if not (~keep).any() or not (keep | (mv0.sum(1) < 50)).all():
        raise AssertionError(f"preemptive prefilter: kept {keep.astype(int).tolist()} for "
                             f"putative counts {mv0.sum(1).tolist()}")
    print(f"preemptive prefilter, 8 views, {len(pl)} pairs: kept {int(keep.sum())}, K1 bf16 "
          f"launches {counts['topk2_match']}; keep mask equal to the plain matcher's on the same "
          f"card tensors; kept rows equal full matching's, dropped rows all invalid")


def phase_two_view() -> None:
    """two_view_reconstruct on the card with tests/test_two_view.py's setup
    (two 240x320 views 10 degrees apart): K1 launched, bf16 only; more than
    40 inliers, relative rotation within 2 degrees, more than 95% of the
    inlier points in front."""
    import numpy as np
    import torch

    from tpusfm_torch.core import camera as tcam
    from tpusfm_torch.features.sift import SiftConfig
    from tpusfm_torch.sfm.two_view import two_view_reconstruct
    from tpusfm_torch.utils.synth_render import render_orbit_images

    images, gt = render_orbit_images(n_views=2, img_h=240, img_w=320, focal=0.9 * 320,
                                     arc_deg=10.0, seed=3)
    intr = tcam.make_intrinsics(0.9 * 320, cx=160.0, cy=120.0, device="cuda")
    _kc().reset_counts()
    t0 = time.time()
    out = two_view_reconstruct(images, intr, sift_cfg=SiftConfig(n_octaves=3, max_per_octave=512,
                                                                 max_features=768),
                               ransac_iters=256, device="cuda", seed=0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = _kc().counts()
    _only_bf16_k1(counts, "two-view")
    R_rel = gt["R"][1] @ gt["R"][0].T
    cos = (np.trace(out["R"].cpu().numpy() @ R_rel.T) - 1) / 2
    err = float(np.degrees(np.arccos(np.clip(cos, -1, 1))))
    X = out["points"][out["inliers"]].cpu().numpy()
    front = float((X[:, 2] > 0).mean()) if len(X) else 0.0
    n_inl, n_match = int(out["n_inliers"]), int(out["n_matches"])
    print(f"two-view: {n_inl} inliers of {n_match} matches, rotation error {err:.4f} deg, "
          f"{front:.4f} of the inlier points in front, K1 bf16 launches {counts['topk2_match']}, "
          f"wall {wall:.2f} s")
    if not (n_inl > 40 and err < 2.0 and front > 0.95):
        raise AssertionError(f"two-view bars: {n_inl} inliers, {err} deg, {front} in front")


@contextlib.contextmanager
def _local_k2_calls(local: dict):
    """Keeps the last K2 call made inside a windowed local step-BA in
    local["linearize_reduce_radial3_t"] (the other wrappers stay as they
    are).  Restores both patches on exit."""
    from tpusfm_torch.ops import obs_table as ot
    from tpusfm_torch.sfm.incremental import IncrementalEngine

    inside = [False]
    run_local, k2 = IncrementalEngine._run_ba_local, ot.linearize_reduce_radial3_t

    def run_ba_local(self, *a, **k):
        inside[0] = True
        try:
            return run_local(self, *a, **k)
        finally:
            inside[0] = False

    def k2_rec(*a, **k):
        if inside[0]:
            local["linearize_reduce_radial3_t"] = (a, k)
        return k2(*a, **k)

    IncrementalEngine._run_ba_local, ot.linearize_reduce_radial3_t = run_ba_local, k2_rec
    try:
        yield
    finally:
        IncrementalEngine._run_ba_local, ot.linearize_reduce_radial3_t = run_local, k2


def phase_pod(entries: dict) -> tuple[dict, dict]:
    """The reference's 1000-view pod rung (bench.py:481-503, uncut; see
    tools/pod_rung.py) through run_sparse once: at least 950/1000 views,
    ATE <= 0.30, more than 1000 points, finite geometry; loop pairs
    proposed by retrieval (more than 16 views apart) and at least one kept
    by the geometric filter; K1 launched bf16 only, K2, K3 and K4
    launched.  Returns the run's last kernel calls and the last K2 call of
    a windowed local step-BA."""
    import torch

    from tpusfm_torch.pipeline.sparse import run_sparse
    from tpusfm_torch.tools.pod_rung import pod_inputs, pod_summary

    t0 = time.time()
    images, gt, cfg = pod_inputs(1000)
    render_s = time.time() - t0
    captured, local = {}, {}
    _kc().reset_counts()
    with _kc().recording(captured) as (solves, calls), _local_k2_calls(local):
        torch.cuda.synchronize()
        t0 = time.time()
        scene, report = run_sparse(images, gt["intr"], cfg, device="cuda", seed=0)
        torch.cuda.synchronize()
        wall = time.time() - t0
    counts = _kc().counts()
    _only_bf16_k1(counts, "pod rung")
    s = pod_summary(scene, report, gt, cfg.matching.contiguous_window)
    local_cams = s["local_ba_cams"]
    dense = sum(n for c, n in local_cams.items() if c * 6 <= cfg.engine.ba.dense_schur_max_dim)
    print(f"pod rung (1000 views 240x320, window 8 + loop closure top 5): registered "
          f"{s['registered']}/1000, ATE {s['ate']:.5f}, points {s['points']}, observations "
          f"{s['n_obs']}, render {render_s:.1f} s, wall {wall:.2f} s")
    print(f"  pairs {json.dumps(s['pairs'])}")
    print(f"  times_s {json.dumps(s['times_s'])}")
    print(f"  recon_phase_s {json.dumps(s['recon_phase_s'])}")
    print(f"  BA solves {json.dumps(s['ba_solves'])}; windowed local share of step-BAs "
          f"{s['local_step_ba_share']:.4f}; local solves by camera bucket {local_cams} "
          f"({dense} dense-Schur, {sum(local_cams.values()) - dense} through the kernels)")
    print(f"  launches {json.dumps(counts)}")
    print(f"  _lm_kernels solves {len(solves)}, kernel calls by variant: "
          f"{json.dumps(_kc().named(calls))}")
    if (s["registered"] < 950 or not s["ate"] <= 0.30 or s["points"] <= 1000
            or not s["finite"]):
        raise AssertionError(f"pod rung quality: {s}; log {report['engine_log'][-5:]}")
    if not s["pairs"]["loop_proposed"] or not s["pairs"]["loop_kept"]:
        raise AssertionError(f"pod rung: no loop pair proposed or kept: {s['pairs']}")
    if any(counts[n] == 0 for n in ("topk2_match",) + BA_KERNELS):
        raise AssertionError(f"pod rung: a kernel of the path did not launch: {counts}")
    if "linearize_reduce_radial3_t" not in local:
        raise AssertionError(f"pod rung: no windowed local step-BA ran through K2: {local_cams}")
    entries[POD["topk2_match"]]["launches"] = counts["topk2_match"]
    for name in BA_KERNELS:
        entries[POD[name]]["launches"] = counts[name]
    return captured, local


def _check_local_padding(call, card: str) -> None:
    """K2 at the pod run's last kernel-path local step-BA, whose table is
    point-sorted under assume_sorted and padded to its bucket with weight-0
    rows that repeat the last point: the padding's W columns are zero, and
    the reduced outputs and the real rows' W equal K2's on the table
    without the padding (within 1e-6 of each output's largest entry, the
    chunks of the real rows being the same); both timed."""
    import torch

    from tpusfm_torch.ops import obs_table as ot

    a, kw = call
    w = a[7]
    n = int(torch.nonzero(w).max()) + 1
    C, P = a[0].shape[0], a[2].shape[0]
    cut = a[:3] + (a[3][:n], a[4][:n], a[5][:n], a[6][:, :n].contiguous(), w[:n])
    kw_cut = dict(kw, layout=ot.obs_layout(cut[3], C, cut[5], P))
    got = ot.linearize_reduce_radial3_t(*a, **kw)
    ref = ot.linearize_reduce_radial3_t(*cut, **kw_cut)
    torch.cuda.synchronize()
    pad_w = got[2][:, n:]
    errs = [float((g[..., :r.shape[-1]].double() - r.double()).abs().max())
            / max(float(r.double().abs().max()), 1e-30) for g, r in zip(got[:3], ref[:3])]
    ms = _median_ms(lambda: ot.linearize_reduce_radial3_t(*a, **kw))
    ms_cut = _median_ms(lambda: ot.linearize_reduce_radial3_t(*cut, **kw_cut))
    print(f"K2 at a pod local step-BA (C={C}, P={P}, O={w.shape[0]}: {n} real rows, "
          f"{w.shape[0] - n} padding rows repeating rank {int(a[5][-1])}) on {card}: padding W "
          f"columns all zero {bool((pad_w == 0).all())}; camred, ptred, real W within "
          f"{max(errs):.3e} of scale of the unpadded table's; {ms:.4f} ms padded vs "
          f"{ms_cut:.4f} ms unpadded")
    if not bool((pad_w == 0).all()) or not max(errs) <= 1e-6:
        raise AssertionError(f"K2's padding rows at the pod local BA did work: {errs}")


def phase_pod_kernels(card: str, captured: dict, local: dict, entries: dict) -> None:
    """K1 at the pod run's own matching chunk, K2-K4 at its final
    1000-camera BA (as phase 8), and K2's padding at a local step-BA."""
    entries[POD["topk2_match"]].update(_check_k1_captured(captured, card, "pod rung"))
    res = _check_ba_kernels("pod rung final BA", *(captured[n] for n in BA_KERNELS), card)
    for name, r in res.items():
        entries[POD[name]].update(r)
    _check_local_padding(local["linearize_reduce_radial3_t"], card)


def phase_pod_ba(card: str) -> None:
    """tests/test_pod_scale.py's 1000-camera problem (40,000 points, more
    than 200k observations) single-device through the kernels with its
    BAConfig(max_iters=8, cg_iters=25, obs_chunk=32768): rmse under 0.8 px
    and ATE under 0.01; LM it/s."""
    import numpy as np
    import torch

    from tpusfm_torch.ba import bundle_adjust as tba
    from tpusfm_torch.core import lie
    from tpusfm_torch.utils import metrics
    from tpusfm_torch.utils.synth_scene import pod_ba_problem

    prob, centers = pod_ba_problem()
    O = len(prob["obs_cam"])
    bench = {k: torch.as_tensor(v, device="cuda") for k, v in prob.items()}
    cfg = tba.BAConfig(max_iters=8, cg_iters=25, obs_chunk=32768)
    with _kc().recording(None) as (solves, _):
        out, launches = _timed_solve(bench, cfg, "kernels, 1000-camera pod problem", card)
    rmse = float(np.sqrt(2 * float(out[4]["final_cost"]) / O))
    ate = metrics.ate_rmse(lie.camera_center(lie.so3_exp(out[1]), out[2]).cpu().numpy(), centers)
    print(f"  1000-camera BA: O={O}, rmse {rmse:.5f} px, ATE {ate:.6f}, _lm_kernels solves "
          f"{len(solves)}")
    if O <= 200_000 or not rmse < 0.8 or not ate < 0.01:
        raise AssertionError(f"1000-camera BA: O {O}, rmse {rmse}, ATE {ate}")
    if not solves or any(launches[n] == 0 for n in BA_KERNELS):
        raise AssertionError(f"1000-camera BA: not the kernel path: {launches}")


def _engine_bars(engine: str, n_views: int, s: dict, label: str) -> None:
    """The card run against the reference's (ENGINE_REF): registered views
    >= the reference's less 2% of V, ATE <= max(1.5 x, + 0.02) the
    reference's, points >= 80% of the reference's, finite geometry, and
    under self-calibration fx within FX_TOL where the reference met it,
    else within the reference's error + 0.5%."""
    ref = ENGINE_REF[engine]
    bars = {"registered": ref["registered"] - 0.02 * n_views,
            "ate": max(1.5 * ref["ate"], ref["ate"] + 0.02), "points": 0.8 * ref["points"]}
    ok = (s["registered"] >= bars["registered"] and s["ate"] <= bars["ate"]
          and s["points"] >= bars["points"] and s["finite"])
    if ref["fx_err"] is not None:
        bars["fx_err"] = FX_TOL if abs(ref["fx_err"]) <= FX_TOL else abs(ref["fx_err"]) + 0.005
        ok = ok and abs(s["fx_err"]) <= bars["fx_err"]
    print(f"  bars from the reference's CPU run {json.dumps(ref)}: {json.dumps(bars)}")
    if not ok:
        got = {k: s[k] for k in ("registered", "ate", "points", "fx_err", "finite")}
        raise AssertionError(f"{label} quality: {json.dumps(got)} against {json.dumps(bars)}; "
                             f"log {s['engine_log'][-3:]}")


# The averaging functions of the global and stellar engines, by module.
AVERAGING = (("global_sfm", "rotation_averaging"), ("global_sfm", "translation_averaging"),
             ("stellar", "edge_scale_solve"), ("stellar", "scaled_translation_solve"))


@contextlib.contextmanager
def _averaging_calls(captured: dict):
    """Keeps the arguments of the last call of each averaging function in
    `captured` under its name; restores the functions on exit."""
    from tpusfm_torch.sfm import global_sfm, stellar

    mods = {"global_sfm": global_sfm, "stellar": stellar}
    saved = {}
    for m, name in AVERAGING:
        fn = saved[m, name] = getattr(mods[m], name)

        def rec(*a, _fn=fn, _name=name, **k):
            captured[_name] = (a, k)
            return _fn(*a, **k)

        setattr(mods[m], name, rec)
    try:
        yield
    finally:
        for (m, name), fn in saved.items():
            setattr(mods[m], name, fn)


def _check_averaging(captured: dict, label: str, card: str) -> None:
    """Each averaging function the run called, on the run's own edge
    tables: the same bits on two calls; its median ms (CUDA events)."""
    from tpusfm_torch.sfm import global_sfm, stellar

    mods = {"global_sfm": global_sfm, "stellar": stellar}
    for m, name in AVERAGING:
        if name not in captured:
            continue
        a, k = captured[name]
        fn = getattr(mods[m], name)
        out = _repeat_equal(lambda: fn(*a, **k), f"{name} at {label}")
        ms = _median_ms(lambda: fn(*a, **k), warmup=1, runs=5)
        shapes = [tuple(t.shape) for t in a if hasattr(t, "shape")]
        print(f"  {name} at {label} ({card}): inputs {shapes}, the same bits on two calls, "
              f"{ms:.3f} ms (CUDA events, median of 5), output finite "
              f"{bool(out[0].isfinite().all())}")


def _run_engine(engine: str, self_calibrate: bool, label: str, captured: dict):
    """One run_sparse of the medium rung with `engine` on the card, counts
    reset just before it: K1 bf16 only, at least one kernel-path solve, the
    bars from the reference's run, the averaging functions' repeatability.
    Returns (counts, calls by variant)."""
    import torch

    from tpusfm_torch.pipeline.sparse import run_sparse
    from tpusfm_torch.tools.engine_rung import engine_args, engine_summary

    images, gt, cfg = _rung200()
    n_views = images.shape[0]
    cfg, intr, group = engine_args(gt, cfg, engine, self_calibrate, FOCAL_START)
    averaging = {}
    _kc().reset_counts()
    with _kc().recording(captured) as (solves, calls), _averaging_calls(averaging):
        torch.cuda.synchronize()
        t0 = time.time()
        scene, report = run_sparse(images, intr, cfg, device="cuda", seed=0, cam_group=group)
        torch.cuda.synchronize()
        wall = time.time() - t0
    counts = _kc().counts()
    _only_bf16_k1(counts, label)
    s = engine_summary(scene, report, gt)
    print(f"{label}: registered {s['registered']}/{n_views}, ATE {s['ate']:.5f}, points "
          f"{s['points']}, observations {s['n_obs']}, fx {s['fx_err']:+.5f}, fy "
          f"{s['fy_err']:+.5f}, wall {wall:.2f} s")
    print(f"  times_s {json.dumps(s['times_s'])}")
    print(f"  recon_phase_s {json.dumps(s['recon_phase_s'])}")
    print(f"  BA solves {json.dumps(s['ba_solves'])}; _lm_kernels solves {len(solves)}")
    print(f"  launches {json.dumps(counts)}; kernel calls by variant "
          f"{json.dumps(_kc().named(calls))}")
    _engine_bars(engine, n_views, s, label)
    if not solves:
        raise AssertionError(f"{label}: no kernel-path solve")
    _check_averaging(averaging, label, torch.cuda.get_device_name(0))
    return counts, calls


def phase_global200(card: str, entries: dict) -> None:
    """The global engine over the medium rung, intrinsics held: its bars,
    K2 held, K3 and K4 launched, each held against its twins at the run's
    last call (its final BA)."""
    captured = {}
    counts, calls = _run_engine("global", False, "global 200 (intrinsics held)", captured)
    if not calls["linearize_reduce_radial3_t", "held"] or any(counts[n] == 0 for n in BA_KERNELS):
        raise AssertionError(f"global 200: a kernel of the path did not launch: {counts}")
    res = _check_ba_kernels("global 200 final BA", *(captured[n] for n in BA_KERNELS), card)
    for name, r in res.items():
        entries[GLOBAL[name]].update(r, launches=counts[name])


def phase_stellar200(card: str, entries: dict) -> None:
    """The stellar engine over the medium rung, self-calibrating one group
    from FOCAL_START x the truth: its bars, K2 refine, K5 with D = 6 and 7
    and K4 with D = 7 launched, each held against its twins at the run's
    last call of that variant."""
    captured = {}
    counts, calls = _run_engine("stellar", True, f"stellar 200 (self-calibrating, focal "
                                f"started x{FOCAL_START})", captured)
    need = [("linearize_reduce_radial3_t", "refine"), ("schur_fwd_t", "D=6"),
            ("schur_fwd_t", "D=7"), ("schur_bwd_t", "D=7")]
    if any(calls[k] == 0 for k in need):
        raise AssertionError(f"stellar 200: a kernel of the path did not launch: {counts}, "
                             f"{dict(calls)}")
    k2 = captured["linearize_reduce_radial3_t", "refine"]
    a2 = k2[0]
    print(f"Stellar 200 kernels at C={a2[0].shape[0]} P={a2[2].shape[0]} O={a2[5].shape[0]} on "
          f"{card}")
    for name, key, label, w in (
            ("linearize_reduce_radial3_t", "refine", "stellar 200 final BA, refine", (2, 4)),
            ("schur_fwd_t", "D=7", "stellar 200, D=7", ()),
            ("schur_bwd_t", "D=7", "stellar 200, one group, D=7", ())):
        entries[STELLAR[name]].update(_check_kernel(name, captured[name, key], label,
                                                    w_outputs=w), launches=counts[name])


def phase_calibration(card: str) -> None:
    """The boards of tests/test_calibration.py rendered on the host, their
    corners found by OpenCV, calibrate_camera on the card: that test's bars
    (rms < 0.5 px, fx and fy within 2%, cx and cy within 15 px), and within
    1e-3 relative (k1, k2 within 1e-3) and 1e-3 px rms of the same solve on
    the CPU."""
    import numpy as np
    import torch

    from tpusfm_torch.tools.calib_boards import render_board_views
    from tpusfm_torch.utils import calibration

    images, K = render_board_views()
    t0 = time.time()
    corners = calibration.find_chessboard_corners(images, (9, 6))
    detect_s = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    intr, rms, V = calibration.calibrate_camera(corners, (9, 6), device="cuda")
    solve_s = time.time() - t0
    cpu, cpu_rms, _ = calibration.calibrate_camera(corners, (9, 6), device="cpu")
    err = [abs(intr[0] / K[0, 0] - 1), abs(intr[1] / K[1, 1] - 1), abs(intr[2] - K[0, 2]),
           abs(intr[3] - K[1, 2])]
    print(f"calibration ({card}): {V} of {len(images)} boards found in {detect_s:.2f} s (host "
          f"OpenCV), solve {solve_s:.2f} s on the card (homographies + 30 Gauss-Newton steps): "
          f"intr {np.round(intr, 4).tolist()}, rms {rms:.4f} px; fx, fy relative error "
          f"{err[0]:.5f}, {err[1]:.5f}; cx, cy {err[2]:.3f}, {err[3]:.3f} px; the CPU solve "
          f"{np.round(cpu, 4).tolist()}, rms {cpu_rms:.4f}")
    if V < 4 or not rms < 0.5 or not err[0] < 0.02 or not err[1] < 0.02 or not err[2] < 15 \
            or not err[3] < 15:
        raise AssertionError(f"calibration on the card: {V} boards, rms {rms}, errors {err}")
    if not (np.allclose(intr[:4], cpu[:4], rtol=1e-3, atol=0) and
            np.allclose(intr[4:], cpu[4:], rtol=0, atol=1e-3) and abs(rms - cpu_rms) < 1e-3):
        raise AssertionError(f"calibration: the card's {intr} (rms {rms}) against the CPU's "
                             f"{cpu} (rms {cpu_rms})")


BROWN_LENS = (-0.10, 0.015, 0.0, 0.008, -0.006)  # [k1 k2 k3 t1 t2], test_camera_models.py:153


def phase_brown(card: str, entries: dict) -> dict:
    """Path B: Brown-T2 self-calibration of the bench problem through the
    unfused kernel path and the plain path, then the kernel path again
    with pallas_gathers=True (K8, K9), which must give the first kernel
    solve's bits.  Returns the kernel solves' last kernel calls."""
    import numpy as np
    import torch

    from tpusfm_torch.ba import bundle_adjust as tba
    from tpusfm_torch.utils.synth_scene import point_sorted_ba_problem

    prob = point_sorted_ba_problem(500, 50000, seed=3, arc_deg=350.0, vis_prob=0.06,
                                   brown=BROWN_LENS)
    bench = {k: torch.as_tensor(v, device="cuda") for k, v in prob.items()}
    group = dict(cam_group=torch.zeros(bench["intr"].shape[0], dtype=torch.long, device="cuda"),
                 n_groups=1)
    cfg = tba.BAConfig(max_iters=20, cg_iters=30, assume_sorted=True, refine_intrinsics=True,
                       camera_model="brown")
    captured, res, outs = {}, {}, {}
    for name, c in (("kernels (unfused), Brown-T2 self-calibrating", cfg),
                    ("plain, Brown-T2 self-calibrating", dataclasses.replace(cfg, impl="xla")),
                    ("kernels (unfused, pallas_gathers), Brown-T2 self-calibrating",
                     dataclasses.replace(cfg, pallas_gathers=True))):
        with _kc().recording(captured if name.startswith("kernels") else None) as (_, calls):
            out, launches = _timed_solve(bench, c, name, card, **group)
        outs[name] = out
        g = out[0][0].cpu().numpy()
        init, final = float(out[4]["initial_cost"]), float(out[4]["final_cost"])
        print(f"  refined lens [k1 k2 k3 t1 t2] {np.round(g[4:], 5).tolist()} vs "
              f"{list(BROWN_LENS)}; focal {g[0]:.3f}, {g[1]:.3f}; cost ratio {final / init:.5f}")
        res[name] = final
        if not final < 0.05 * init:
            raise AssertionError(f"{name}: final cost {final} not under 0.05 x {init}")
        for lane, bar in ((4, 0.01), (7, 0.003), (8, 0.003)):
            if not abs(g[lane] - BROWN_LENS[lane - 4]) < bar:
                raise AssertionError(f"{name}: lane {lane} = {g[lane]}, truth "
                                     f"{BROWN_LENS[lane - 4]}, bar {bar}")
        if name.startswith("kernels"):
            need = [("schur_fwd_t", "D=6"), ("schur_fwd_t", "D=9"), ("schur_bwd_t", "D=6"),
                    ("schur_bwd_t", "D=9"), ("segsum_table_t", "k=96"),
                    ("segsum_table_t", "k=90"), ("segsum_sorted_t", "k=12")]
            print(f"  kernel calls by variant: "
                  f"{json.dumps({f'{n} {v}': c for (n, v), c in sorted(calls.items())})}")
            if any(calls[k] == 0 for k in need) or launches["linearize_reduce_radial3_t"]:
                raise AssertionError(f"Brown-T2 solve: not the unfused kernel path: {dict(calls)}")
            if "pallas_gathers" in name:
                if not (launches["gather_table"] and launches["gather_sorted"]):
                    raise AssertionError(f"{name}: K8 or K9 not launched: {launches}")
            else:
                for n in NEW_KERNELS[1:]:
                    entries[n]["launches"] = launches[n]
                entries[K4_PATH_B]["launches"] = calls["schur_bwd_t", "D=6"]
                entries[K5_PATH_B]["launches"] = calls["schur_fwd_t", "D=9"]
    first, gathered = (outs[n] for n in outs if n.startswith("kernels"))
    same = [torch.equal(x, y) for x, y in zip(first[:4], gathered[:4])]
    print(f"  pallas_gathers vs plain gathers: intrinsics, rotations, translations, points "
          f"bit-equal {same}; final cost {float(gathered[4]['final_cost'])!r} vs "
          f"{float(first[4]['final_cost'])!r}")
    if not all(same) or float(gathered[4]["final_cost"]) != float(first[4]["final_cost"]):
        raise AssertionError("path B with pallas_gathers differs from path B without it")
    ck, cp, _ = res.values()
    if not abs(ck - cp) <= 1e-2 * cp:
        raise AssertionError(f"Brown-T2 kernel-path cost {ck} vs plain {cp}: more than 1e-2 apart")
    return captured


def phase_new_kernels(card: str, cap_a: dict, cap_b: dict, entries: dict) -> None:
    """K2's refine mode, K4 at D = 7 and 9, K5 at D = 6, 7 and 9, K6 and
    K7 at the shapes paths A and B gave them."""
    print(f"Self-calibrating and unfused kernels at their path shapes on {card}")
    a2 = cap_a["linearize_reduce_radial3_t", "refine"][0]
    _check_kernel("linearize_reduce_radial3_t", cap_a["linearize_reduce_radial3_t", "refine"],
                  f"path A (C={a2[0].shape[0]} P={a2[2].shape[0]} O={a2[5].shape[0]}), refine",
                  w_outputs=(2, 4))
    _check_kernel("schur_bwd_t", cap_a["schur_bwd_t", "D=6"],
                  "path A, cameras, D=6 (camera-ordered W)")
    _check_kernel("schur_bwd_t", cap_a["schur_bwd_t", "D=7"], "path A, one group, D=7")
    entries[K4_PATH_B].update(_check_kernel("schur_bwd_t", cap_b["schur_bwd_t", "D=6"],
                                            "path B, cameras, D=6 (camera-ordered W)"))
    _check_kernel("schur_bwd_t", cap_b["schur_bwd_t", "D=9"], "path B, one group, D=9")
    _check_kernel("schur_fwd_t", cap_a["schur_fwd_t", "D=6"], "path A, D=6")
    entries["schur_fwd_t"].update(_check_kernel("schur_fwd_t", cap_a["schur_fwd_t", "D=7"],
                                                "path A, D=7"))
    entries[K5_PATH_B].update(_check_kernel("schur_fwd_t", cap_b["schur_fwd_t", "D=9"],
                                            "path B, one group, D=9 (lane-major W)"))
    entries["segsum_table_t"].update(_check_kernel(
        "segsum_table_t", cap_b["segsum_table_t", "k=96"], "path B, cameras, k=96"))
    _check_kernel("segsum_table_t", cap_b["segsum_table_t", "k=90"], "path B, one group, k=90")
    for key, label in ((("segsum_table_t", "k=96"), "path B, cameras, k=96"),
                       (("segsum_table_t", "k=90"), "path B, one group, k=90")):
        _check_k6_layouts(cap_b[key], label)
    entries["segsum_sorted_t"].update(_check_kernel(
        "segsum_sorted_t", cap_b["segsum_sorted_t", "k=12"], "path B, point ranks, k=12"))


def _sublane_call(call):
    """A captured (k, O)-layout call as its sublane entry point's: the table
    row-major (O, k), no layout."""
    a, _ = call
    return (a[0].T.contiguous(),) + tuple(a[1:]), {}


def phase_sublane_kernels(card: str, cap_a: dict, cap_b: dict, entries: dict) -> None:
    """The reference's sublane entry points (segsum_table, segsum_sorted,
    schur_fwd, schur_bwd: row-major (O, k) tables) at the shapes paths A
    and B gave K6, K7, K5 and K4, which they launch; no main path runs
    them."""
    import torch

    from tpusfm_torch.ops import obs_table as ot

    print(f"Sublane entry points (row-major tables) at path shapes on {card}")
    for name, cap, key, label in (
            ("segsum_table", cap_b, ("segsum_table_t", "k=96"), "path B, cameras, k=96"),
            ("segsum_sorted", cap_b, ("segsum_sorted_t", "k=12"), "path B, point ranks, k=12"),
            ("schur_fwd", cap_b, ("schur_fwd_t", "D=9"), "path B, D=9"),
            ("schur_bwd", cap_b, ("schur_bwd_t", "D=6"), "path B, cameras, D=6")):
        entries[name].update(_check_kernel(name, _sublane_call(cap[key]), label), launches=0)
    for cap, label in ((cap_b, "D=9"), (cap_a, "D=7")):
        a, kw = cap["schur_fwd_t", label]
        row = _sublane_call((a, kw))[0]
        got, lane = ot.schur_fwd(*row), ot.schur_fwd_t(*a, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, lane):
            raise AssertionError(f"schur_fwd at {label}: K5's row-major read differs from its "
                                 "lane-major read")
        print(f"  schur_fwd at {label}: K5's row-major read bit-equal to its lane-major read")
        if cap is cap_b:  # K5 alone, both reads with the layout, in turns
            reads = {"lane": lambda: ot.schur_fwd_t(*a, **kw),
                     "row": lambda: ot.schur_fwd_t(row[0].T, *a[1:], **kw)}
            ms = {k: [] for k in reads}
            for k in ("lane", "row", "row", "lane"):
                ms[k].append(_device_ms(reads[k]))
            entries["schur_fwd"]["k5_read_device_ms"] = ms
            print(f"  K5 alone at path B, D=9, device ms in turns: lane-major {ms['lane']}, "
                  f"row-major {ms['row']}")
        del row
    _check_kernel("schur_fwd", _sublane_call(cap_a["schur_fwd_t", "D=7"]), "path A, D=7")
    _check_kernel("schur_bwd", _sublane_call(cap_a["schur_bwd_t", "D=7"]), "path A, one group, D=7")
    for name, cap, key, label, entry in (
            ("segsum_table", cap_b, ("segsum_table_t", "k=96"), "path B, cameras, k=96", True),
            ("schur_bwd", cap_b, ("schur_bwd_t", "D=6"), "path B, cameras, D=6", True),
            ("schur_bwd", cap_a, ("schur_bwd_t", "D=7"), "path A, one group, D=7", False)):
        split = _no_host_read_split(name, _sublane_call(cap[key])[0], label)
        if entry:
            entries[name].update(split)
    for cap, key, label, entry in ((cap_b, ("schur_bwd_t", "D=6"), "path B, cameras", True),
                                   (cap_b, ("schur_bwd_t", "D=9"), "path B, one group", False),
                                   (cap_a, ("schur_bwd_t", "D=6"), "path A, cameras", False),
                                   (cap_a, ("schur_bwd_t", "D=7"), "path A, one group", False)):
        a = cap[key][0]
        res = _check_layout(a[1], a[4], label)
        if entry:
            entries["seg_layout"].update(res)


@contextlib.contextmanager
def _no_host_read():
    """torch.cuda.set_sync_debug_mode("error") inside the block: a call that
    makes the host wait for the device raises."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _no_host_read_split(name: str, a: tuple, label: str) -> dict:
    """A sublane entry point that builds its own layout: one call under
    _no_host_read, bit-equal to a call outside it, and its device time
    split by kernel name into the layout kernel's and the rest (K6's or
    K4's), each kernel's mean record over 10 calls (one launch each a
    call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpusfm_torch.ops import obs_table as ot
    from tpusfm_torch.tools.profile_rung import _device_kernels

    fn = getattr(ot, name)
    with _no_host_read():
        got = fn(*a)
    if not torch.equal(got, fn(*a)):
        raise AssertionError(f"{name} at {label}: the call under sync debug mode 'error' differs")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn(*a)
        torch.cuda.synchronize()
    rows = _device_kernels(prof)
    lay = sum(us / n for k, n, us in rows if any(p in k for p in LAYOUT_KERNELS)) / 1e3
    rest = sum(us / n for k, n, us in rows if not any(p in k for p in LAYOUT_KERNELS)) / 1e3
    print(f"  {name} at {label}: no host read (sync debug mode 'error'); device "
          f"{lay + rest:.4f} ms = layout {lay:.4f} + kernel {rest:.4f} "
          f"({', '.join(_kernel_name(k) for k, _, _ in rows)})")
    return {"layout_device_ms": lay, "kernel_device_ms": rest}


def _check_layout(ids, n: int, label: str) -> dict:
    """The layout kernel at one id column, two calls under _no_host_read:
    each bit-equal to its torch.sort twin on the card; events ms of kernel,
    twin and torch.sort(stable=True) of the same keys, their device ms, and
    the bound (the ids read once, the layout written once)."""
    import torch

    from tpusfm_torch.ops import obs_table as ot

    with _no_host_read():
        got, again = ot.seg_layout(ids, n), ot.seg_layout(ids, n)
    twin = ot.seg_layout_reference(ids, n)
    torch.cuda.synchronize()
    err = 0
    for g, r, w, part in zip(got, again, twin, ("seg_perm", "seg_start", "chunk_start",
                                                "arrivals", "in_order")):
        if not (torch.equal(g, w) and torch.equal(r, g)):
            raise AssertionError(f"seg_layout at {label}: {part} differs from the twin's")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    key = torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))

    def sort():
        return torch.sort(key, stable=True)

    res = {"max_abs_err": float(err), "ms": _median_ms(lambda: ot.seg_layout(ids, n)),
           "plain_ms": _median_ms(lambda: ot.seg_layout_reference(ids, n)),
           "library_ms": _median_ms(sort), "device_ms": _device_ms(lambda: ot.seg_layout(ids, n)),
           "library_device_ms": _device_ms(sort)}
    res.update(_bound([ids], got, 0.0))
    print(f"  seg_layout at {label} (O={ids.shape[0]}, n={n}, in order "
          f"{int(got[4])}): bit-equal to its twin, twice, with no host read; kernel "
          f"{res['ms']:.4f} ms (device {_dev(res['device_ms'])}), twin {res['plain_ms']:.4f} ms, "
          f"torch.sort {res['library_ms']:.4f} ms (device {_dev(res['library_device_ms'])}), "
          f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res


# Path A starts from the true focal and holds fx to 1%.  On this sandbox's
# CPU the reference's own run_sparse at 60 views of this rung, one group,
# ended at fx -0.86%, fy -0.94% from a focal 2% off and from the truth alike
# (PERF.md, PR 3): it cannot recover the focal to 0.5% here.  fy is printed
# and not held: the orbit turns about the vertical axis with its cameras
# near one horizontal plane, so stretching the scene vertically by s and fy
# by 1/s leaves every projection unchanged up to the orbit's 0.3-unit
# vertical wobble.
FOCAL_START = 1.0
FX_TOL = 0.01


def _mesh_faces(path) -> int:
    """The face count in a PLY mesh header."""
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"element face"):
                return int(line.split()[2])
            if line.startswith(b"end_header"):
                break
    return 0


SERVICE_ARTIFACTS = (
    "scene.npz", "colorized.ply", "report.json", "report.html", "viewer.html", "dense.ply",
    "depth_maps.npz", "mesh.ply", "textured_mesh.obj", "textured_mesh.mtl", "textured_mesh.png",
    "colmap/cameras.txt", "colmap/images.txt", "colmap/points3D.txt")


def _service_common(out: dict, label: str, card: str) -> None:
    """Every service run: the upload saved every file, the colorized PLY
    downloaded, an /event frame came, and what ran where."""
    if not out["colorized_download"] or not out["sse"]:
        raise AssertionError(f"{label}: /files/colorized.ply {out['colorized_download']}, "
                             f"/event frames {out['sse']}")
    print(f"{label} ({card}): uploaded {out['uploaded']} in {out['upload_s']:.2f} s; stage "
          f"seconds (service) {json.dumps(out['stage_s'])}, (client, trigger to idle) "
          f"{json.dumps(out['client_stage_s'])}; decoders {json.dumps(out['decoders'])}; "
          f"first /event frame {json.dumps(out['sse'][0])}")


def phase_service_a(card: str) -> tuple:
    """Service A: the reference service's whole user flow on the 20-view
    orbit.  Returns the uploaded files, the truth and the config, for the
    CLI phase and phase 31."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from tpusfm_torch.io import ply
    from tpusfm_torch.tools import service_rung as sr

    files, gt, cfg = sr.rung_a_inputs()
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        ws = Path(tmp)
        _kc().reset_counts()
        out = sr.drive(files, cfg, ("preprocessing", "sparse", "dense", "mesh"), ws,
                       device="cuda", deadline_s=900)
        counts = _kc().counts()
        _only_bf16_k1(counts, "service A")
        _service_common(out, "service A", card)
        q = sr.scene_quality(ws, gt)
        print(f"  registered {q['registered']}/{q['views']}, ATE {q['ate']:.5f}, points "
              f"{q['points']}, K1 launches {counts['topk2_match']}")
        if q["registered"] < 19 or not q["ate"] <= 0.05 or q["points"] <= 1000 or not q["finite"]:
            raise AssertionError(f"service A quality: {q}")
        empty = [a for a in SERVICE_ARTIFACTS if not (ws / a).is_file()
                 or (ws / a).stat().st_size == 0]
        if empty:
            raise AssertionError(f"service A: missing or empty artifacts {empty}")
        pts, _ = ply.read_ply_points(ws / "dense.ply")
        faces = _mesh_faces(ws / "mesh.ply")
        n_fin = int(np.isfinite(pts).all(axis=1).sum())
        print(f"  dense.ply {len(pts)} points ({n_fin} finite), mesh.ply {faces} faces")
        if n_fin < DENSE_MIN_POINTS or n_fin != len(pts) or faces <= MESH_MIN_FACES:
            raise AssertionError(f"service A: dense {len(pts)} points ({n_fin} finite), "
                                 f"mesh {faces} faces")
    return files, gt, cfg


def _check_service_b(q: dict, geo, gt, label: str) -> None:
    """Service B's bars on a workspace's scene quality and geo block."""
    fx_rel = q["intr"][0] / float(gt["intr"][0]) - 1.0
    print(f"  {label}: registered {q['registered']}/{q['views']}, ATE {q['ate']:.5f}, points "
          f"{q['points']}, refined fx {q['intr'][0]:.3f} ({fx_rel:+.5f}), geo {json.dumps(geo)}")
    if (q["registered"] < 190 or not q["ate"] <= 0.10 or q["points"] <= 1000
            or not q["finite"] or not abs(fx_rel) <= FX_TOL):
        raise AssertionError(f"{label} quality: {q}, fx {fx_rel:+.5f}")
    if geo is None or geo["n_gps"] < 190 or not geo["rms_m"] < 1.0:
        raise AssertionError(f"{label} geo-registration: {geo}")


def _putative(ws):
    import numpy as np

    with np.load(ws / "matches_putative.npz") as d:
        return d["idx"], d["valid"]


def phase_service_b(card: str) -> dict:
    """Service B: the 200-view rung as a user's EXIF+GPS photographs.
    Returns its registered views, points and putative match table for
    phase 31."""
    import tempfile
    from pathlib import Path

    from tpusfm_torch.tools import service_rung as sr

    t0 = time.time()
    files, gt, cfg = sr.rung_b_inputs(200)
    print(f"service B inputs: {len(files)} JPEGs, {sum(len(b) for _, b in files)} bytes, "
          f"{time.time() - t0:.1f} s to render and encode")
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        ws = Path(tmp)
        _kc().reset_counts()
        with _kc().recording(None) as (solves, calls):
            out = sr.drive(files, cfg, ("preprocessing", "sparse"), ws, device="cuda",
                           deadline_s=900)
        counts = _kc().counts()
        _only_bf16_k1(counts, "service B")
        _service_common(out, "service B", card)
        q = sr.scene_quality(ws, gt)
        report = json.loads((ws / "report.json").read_text())
        matches = _putative(ws)
    _check_service_b(q, report["geo"], gt, "service B")
    print(f"  recon_phase_s {json.dumps(report['recon_phase_s'])}, sparse elapsed_s "
          f"{report['elapsed_s']}, device {report['device']}, BA solves "
          f"{json.dumps(report['ba_solves'])}")
    print(f"  launches {json.dumps(counts)}; kernel calls by variant "
          f"{json.dumps(_kc().named(calls))}; "
          f"_lm_kernels solves {len(solves)}")
    need = [("linearize_reduce_radial3_t", "held"), ("linearize_reduce_radial3_t", "refine"),
            ("schur_fwd_t", "D=6"), ("schur_fwd_t", "D=7")]
    if any(calls[k] == 0 for k in need) or not counts["schur_mv_t"] or not counts["schur_bwd_t"]:
        raise AssertionError(f"service B: a kernel of the path did not launch: {counts}, "
                             f"{dict(calls)}")
    return {"registered": q["registered"], "points": q["points"], "matches": matches}


def phase_service_ranks(card: str, ref_b: dict, files_a: list, gt_a: dict, cfg_a,
                        entries: dict) -> None:
    """Phase 31 (see the docstring)."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from tpusfm_torch.io import ply
    from tpusfm_torch.parallel import mesh as mesh_mod
    from tpusfm_torch.tools import service_rung as sr

    t0 = time.time()
    files_b, gt_b, cfg_b = sr.rung_b_inputs(200)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        root = Path(tmp)
        spec = {"device": "cuda:0", "root": tmp, "hold": list(SERVICE_RANKS),
                "rungs": [("service_b", files_b, cfg_b, ("preprocessing", "sparse")),
                          ("service_a6", files_a[:6], cfg_a,
                           ("preprocessing", "sparse", "dense", "mesh"))]}
        print(f"phase 31 ({card}): the service on 2 ranks sharing cuda:0, joined by gloo: "
              f"service B, then service A's first 6 frames (inputs in {time.time() - t0:.1f} s)")
        t1 = time.time()
        results = mesh_mod.run_ranks(sr.ranks_main, 2, backend="gloo",
                                     init_method=f"file://{tmp}/init", args=(spec,),
                                     timeout_s=SERVICE_RANKS_S)
        t_world = time.time() - t1
        q = sr.scene_quality(root / "service_b", gt_b)
        report = json.loads((root / "service_b" / "report.json").read_text())
        idx, valid = _putative(root / "service_b")
        q_a = sr.scene_quality(root / "service_a6", {"centers": gt_a["centers"][:6]})
        pts, _ = ply.read_ply_points(root / "service_a6" / "dense.ply")
        faces = _mesh_faces(root / "service_a6" / "mesh.ply")
    out_b, out_a = results[0]["service_b"], results[0]["service_a6"]
    _service_common(out_b, "two-rank service B", card)
    for r in results:
        b = r["service_b"]
        print(f"  rank {r['rank']} service B: wall {b['wall_s']:.1f} s, launches "
              f"{json.dumps(b['launches'])}, calls {json.dumps(b['calls'])}")
    print(f"  stage seconds by rank: service B {json.dumps(out_b['rank_stage_s'])}, service A "
          f"(6 frames) {json.dumps(out_a['rank_stage_s'])}")
    _check_service_b(q, report["geo"], gt_b, "two-rank service B")
    sharded = {k: v for k, v in report["ba_solves"].items() if "sharded" in k}
    print(f"  report: sparse elapsed_s {report['elapsed_s']}, recon_phase_s "
          f"{json.dumps(report['recon_phase_s'])}, sharded BAs {json.dumps(sharded)}; against "
          f"one device (phase 23): registered {ref_b['registered']}, points {ref_b['points']}")
    if q["registered"] < ref_b["registered"] - 2 \
            or abs(q["points"] - ref_b["points"]) > 0.1 * ref_b["points"]:
        raise AssertionError(f"two-rank service B: {q['registered']} views, {q['points']} points "
                             f"against one device's {ref_b['registered']}, {ref_b['points']}")
    if not (np.array_equal(idx, ref_b["matches"][0]) and np.array_equal(valid, ref_b["matches"][1])):
        raise AssertionError("two-rank service B: the putative match table differs from one "
                             "device's")
    if not sharded:
        raise AssertionError(f"two-rank service B: no sharded BA in {report['ba_solves']}")
    need = ("linearize_reduce_radial3_t refine", "schur_fwd_t D=6", "schur_fwd_t D=7")
    for r in results:
        b = r["service_b"]
        _only_bf16_k1(b["launches"], f"two-rank service B, rank {r['rank']}")
        if any(not b["calls"].get(n) for n in need) or not b["launches"]["schur_bwd_t"] \
                or r["jax_imported"]:
            raise AssertionError(f"two-rank service B, rank {r['rank']}: K2 refine, K5 at D = 6 "
                                 f"and 7 or K4 did not launch, or JAX was imported: {b['calls']}")
    n_fin = int(np.isfinite(pts).all(axis=1).sum())
    print(f"  two-rank service A (6 frames): registered {q_a['registered']}/6, ATE "
          f"{q_a['ate']:.5f}, stage seconds {json.dumps(out_a['stage_s'])}, dense.ply {len(pts)} "
          f"points ({n_fin} finite), mesh.ply {faces} faces")
    if q_a["registered"] < 5 or not q_a["ate"] <= 0.05 or n_fin < DENSE_MIN_POINTS \
            or n_fin != len(pts) or faces <= MESH_MIN_FACES:
        raise AssertionError(f"two-rank service A: {q_a}, dense {len(pts)} points ({n_fin} "
                             f"finite), mesh {faces} faces")
    _check_service_kernels(card, out_b["held"], out_b["launches"], entries)
    print(f"  phase 31: world {t_world:.1f} s, wall {time.time() - t0:.1f} s")


def _check_service_kernels(card: str, held: dict, launches: dict, entries: dict) -> None:
    """Phase 31's kernels at rank 0's last call of each variant of the
    two-rank service B (its share of the tables), held against their twins
    as phase 8 holds them."""
    from tpusfm_torch.tools import parallel_rung as pr

    missing = [k for k in SERVICE_RANKS if k not in held]
    if missing:
        raise AssertionError(f"two-rank service B: rank 0 made no call of {missing}")
    print(f"Two-rank service B kernels at rank 0's last calls on {card}")
    for (name, variant), label in SERVICE_RANKS.items():
        call = pr.to_device(held[name, variant], "cuda:0")
        where = f"two-rank service B, rank 0, {variant}".rstrip(", ")
        if name == "match_topk2":
            res = _check_k1_captured({(name, variant): call}, card,
                                     run="two-rank service B, rank 0's")
            res["launches"] = launches["topk2_match"]
        else:
            w = {"held": (2,), "refine": (2, 4)}.get(variant, ())
            res = {**_check_kernel(name, call, where, w_outputs=w), "launches": launches[name]}
        entries[label].update(res)


def phase_cli(card: str, files: list) -> None:
    """The CLI as a child process with no --device: the card by default."""
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        imgs = Path(tmp) / "frames"
        imgs.mkdir()
        for name, data in files[:6]:
            (imgs / name).write_bytes(data)
        ws = Path(tmp) / "ws"
        focal = 0.9 * 640
        t0 = time.time()
        r = subprocess.run([sys.executable, "-m", "tpusfm_torch.cli", "reconstruct", str(imgs),
                            "--workspace", str(ws), "--focal", str(focal)],
                           cwd=root, capture_output=True, text=True, timeout=600)
        wall = time.time() - t0
        if r.returncode != 0:
            raise AssertionError(f"CLI exited {r.returncode}: {r.stderr[-2000:]}")
        report = json.loads((ws / "report.json").read_text())
    named = [line for line in r.stderr.splitlines() if "device" in line]
    print(f"CLI reconstruct ({card}): exit 0 in {wall:.1f} s (a fresh process), registered "
          f"{report['n_registered']}/{report['n_views']}, points {report['n_points']}, "
          f"report device {report['device']}; stderr: {named}")
    if report["n_registered"] < 5 or not report["device"].startswith("cuda") \
            or not any("cuda" in line for line in named):
        raise AssertionError(f"CLI run: {report['n_registered']} registered on "
                             f"{report['device']}, stderr {named}")


def main() -> int:
    t_start = time.time()
    card = phase_device()
    phase_build()
    k1_bf16, k1_f32 = phase_kernel(card)
    entries = {"topk2_match": k1_bf16, K1_F32: k1_f32}
    entries[K1_200] = {**entries["topk2_match"], "name": K1_200, "launches": None}
    entries[K1_F32_200] = {**k1_f32, "name": K1_F32_200, "launches": None}
    entries[POD["topk2_match"]] = {**entries["topk2_match"], "name": POD["topk2_match"],
                                   "launches": None}
    k1_service = SERVICE_RANKS["match_topk2", "quantized"]
    entries[k1_service] = {**entries["topk2_match"], "name": k1_service, "launches": None}
    sources = {
            "linearize_reduce_radial3_t": ("ba_linearize.cu", 1439),
            "schur_mv_t": ("ba_schur.cu", 2023),
            "schur_bwd_t": ("ba_schur.cu", 1891),
            "schur_fwd_t": ("ba_schur.cu", 1796),
            "segsum_table_t": ("ba_segsum.cu", 1679),
            "segsum_sorted_t": ("ba_segsum.cu", 1724),
            "gather_table": ("ba_gather.cu", 95),
            "gather_sorted": ("ba_gather.cu", 173),
            UNREDUCED: ("ba_linearize.cu", 1262),
            K3_BENCH: ("ba_schur.cu", 2023),
            K2_BENCH: ("ba_linearize.cu", 1439),
            K4_PATH_B: ("ba_schur.cu", 1891),
            K5_PATH_B: ("ba_schur.cu", 1796),
            POD["linearize_reduce_radial3_t"]: ("ba_linearize.cu", 1439),
            POD["schur_mv_t"]: ("ba_schur.cu", 2023),
            POD["schur_bwd_t"]: ("ba_schur.cu", 1891),
            GLOBAL["linearize_reduce_radial3_t"]: ("ba_linearize.cu", 1439),
            GLOBAL["schur_mv_t"]: ("ba_schur.cu", 2023),
            GLOBAL["schur_bwd_t"]: ("ba_schur.cu", 1891),
            STELLAR["linearize_reduce_radial3_t"]: ("ba_linearize.cu", 1439),
            STELLAR["schur_fwd_t"]: ("ba_schur.cu", 1796),
            STELLAR["schur_bwd_t"]: ("ba_schur.cu", 1891),
            K5_SHARDED: ("ba_schur.cu", 1796),
            # The sublane entry points: K6, K7, K5, K4 on row-major tables.
            "segsum_table": ("ba_segsum.cu", 128),
            "segsum_sorted": ("ba_segsum.cu", 224),
            "schur_fwd": ("ba_schur.cu", 851),
            "schur_bwd": ("ba_schur.cu", 964),
            # The segment layout, which replaces no TPU kernel.
            "seg_layout": ("ba_layout.cu", None)}
    sources.update({label: sources[name] for (name, _), label in SERVICE_RANKS.items()
                    if name in sources})
    for name, (src, line) in sources.items():
        entries[name] = {"name": name, "route": "cuda", "source": f"tpusfm_torch/csrc/{src}",
                         "replaces": f"tpusfm/ops/obs_table.py:{line}" if line else
                         LAYOUT_REPLACES, "launches": None,
                         "max_abs_err": None, "ms": None, "plain_ms": None, "bound_ms": None,
                         "bound_by": None, "library_ms": None, "device_ms": None,
                         "library_device_ms": None}
    scene20, images20, gt20 = phase_slice20(entries)
    dense_out = phase_dense(card, scene20, images20, gt20)
    captured, ref200 = phase_slice200(entries)
    cap_a = phase_selfcal200(entries, FOCAL_START)
    cap_g = phase_gathers200(entries)
    bench = phase_ba_kernels(card, captured, entries)
    phase_unreduced(card, captured, cap_a, bench, entries)
    phase_ba_solve(bench, card, entries)
    del bench
    cap_b = phase_brown(card, entries)
    phase_new_kernels(card, cap_a, cap_b, entries)
    phase_sublane_kernels(card, cap_a, cap_b, entries)
    phase_gather_kernels(card, cap_g, cap_b, entries)
    del cap_a, cap_b, cap_g, captured
    phase_preemptive()
    phase_two_view()
    cap_pod, local = phase_pod(entries)
    phase_pod_kernels(card, cap_pod, local, entries)
    del cap_pod, local
    phase_pod_ba(card)
    t_eng = time.time()
    phase_global200(card, entries)
    phase_stellar200(card, entries)
    phase_calibration(card)
    print(f"engine and calibration phases wall {time.time() - t_eng:.1f} s")
    t_svc = time.time()
    files, gt_a, cfg_a = phase_service_a(card)
    ref_b = phase_service_b(card)
    phase_cli(card, files)
    print(f"service and CLI phases wall {time.time() - t_svc:.1f} s")
    phase_parallel(card, ref200, scene20, images20, gt20, dense_out, entries)
    phase_service_ranks(card, ref_b, files, gt_a, cfg_a, entries)
    import torch

    print(f"chip_smoke total wall time {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
