"""The sparse reconstruction pipeline: images -> colorized sparse scene.

Port of ``tpusfm/pipeline/sparse.py``, stage for stage:

  detect_features   batched SIFT on the device
  generate_pairs    exhaustive / contiguous pair lists (host), plus
                    loop-closure pairs by descriptor retrieval
  match_pairs       ratio-test matching with cross-check through
                    ``matching.match.match_on_device``: on a CUDA device
                    the fused top-2 kernel K1, on the CPU the plain
                    full-distance-matrix matcher; optionally after the
                    preemptive prefilter
  filter_pairs      robust F/E/H RANSAC per pair, batched over pairs
  reconstruct       tracks + the engine of cfg.engine_type (incremental,
                    global or stellar) with bundle adjustment
  colorize          mean track color

``run_sparse`` takes its device explicitly and picks none itself.  It turns
TF32 off for float32 matrix products and convolutions (the SIFT blur would
otherwise run in TF32 on the card and move extrema).  Chunk sizes follow
the reference's rule so that both packages batch alike.

``cfg.devices = N`` runs the pipeline data-parallel: this process is one of
the N ranks of an initialised ``torch.distributed`` group (``torchrun
--nproc-per-node N``, or ``parallel.mesh.initialize_distributed``), every
rank runs this program on the same inputs with the same seed, matching is
split over the ranks by pairs (``parallel.dist_matching``) and full BAs
past the engine's size gate by observations (``parallel.dist_ba``).
Every rank returns the same scene.  The dense and mesh stages that follow
are ``dense.depth.dense_reconstruct`` and ``dense.meshing``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from functools import partial

import numpy as np
import torch

from ..core import camera as cam_mod
from ..core import epipolar, homography
from ..features import sift
from ..matching import match as match_mod
from ..matching import pairs as pairs_mod
from ..sfm import global_sfm, incremental, stellar
from ..sfm import ransac as ransac_mod
from ..sfm import tracks as tracks_mod
from .config import PipelineConfig


def _noop_progress(type, progress, **kw):
    del type, progress, kw


def get_mesh(cfg: PipelineConfig, device=None):
    """The mesh of the pipeline's data-parallel mode (cfg.devices > 1) over
    the initialised process group, with `device` as this rank's device, or
    None for one device.  Outside a group of cfg.devices ranks it raises."""
    if not cfg.devices or cfg.devices <= 1:
        return None
    from ..parallel import mesh as mesh_mod

    return mesh_mod.make_mesh(cfg.devices, device=device)


def detect_features(images, cfg: PipelineConfig, progress=_noop_progress, masks=None, *,
                    device) -> sift.Features:
    """Batched SIFT over all views in chunks of cfg.feature_batch views.
    images (V, H, W[, 3]) host array; masks (V, H, W), optional (nonzero =
    detect here).  The features stay on `device`."""
    images = np.asarray(images)
    V = images.shape[0]
    out = []
    bs = cfg.feature_batch
    for i in range(0, V, bs):
        chunk = torch.as_tensor(images[i: i + bs], device=device)
        mchunk = None if masks is None else torch.as_tensor(np.asarray(masks)[i: i + bs],
                                                            device=device)
        out.append(sift.detect_and_describe(chunk, cfg.sift, mchunk))
        progress("features", min(1.0, (i + bs) / V))
    if len(out) == 1:
        return out[0]
    return sift.Features(*(torch.cat([getattr(o, f) for o in out])
                           for f in ("kp", "desc", "score", "mask")))


def generate_pairs(n_views: int, cfg: PipelineConfig, feats: sift.Features | None = None) -> np.ndarray:
    """The pair list of cfg.matching.pair_mode.  Contiguous pairs with
    loop_closure (and features, and more than two views) add the retrieval
    pairs more than 2 * contiguous_window views apart, merged by np.unique."""
    mcfg = cfg.matching
    if mcfg.pair_mode == "contiguous":
        pairs = pairs_mod.contiguous_pairs(n_views, mcfg.contiguous_window)
        if mcfg.loop_closure and feats is not None and n_views > 2:
            loops = pairs_mod.retrieval_pairs(feats.desc, feats.mask,
                                              exclude=2 * mcfg.contiguous_window,
                                              top_k=mcfg.loop_top_k, min_sim=mcfg.loop_min_sim)
            if len(loops):
                pairs = np.unique(np.concatenate([pairs, loops]), axis=0)
        return pairs
    return pairs_mod.exhaustive_pairs(n_views)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad a chunk to n rows by repeating its first row."""
    return np.concatenate([a, np.repeat(a[:1], n - len(a), 0)]) if len(a) < n else a


def _chunk_pairs(desc, mask, pl_pad):
    """The descriptors and masks of a padded chunk of pairs, on their device."""
    dev = desc.device
    ia = torch.as_tensor(pl_pad[:, 0], device=dev).long()
    ib = torch.as_tensor(pl_pad[:, 1], device=dev).long()
    return desc[ia], desc[ib], mask[ia], mask[ib]


def preemptive_filter_pairs(feats: sift.Features, pair_list: np.ndarray, cfg: PipelineConfig,
                            progress=_noop_progress) -> np.ndarray:
    """Preemptive matching prefilter: match only the strongest
    K = min(preemptive_features, N) features of each view (features are
    score-sorted) in chunks of max(4 * pair_chunk, 32) pairs, and keep the
    pairs with at least preemptive_min_matches accepted matches.  Returns
    keep (P,) bool.

    The reference runs this pass through its plain XLA matcher on every
    backend; here it goes through ``match_on_device`` like full matching,
    so on the card it is kernel K1's bf16 variant.  SIFT descriptors lie on
    the u8 grid, where every squared distance is an exact integer in both,
    so the keep mask is the same."""
    mcfg = cfg.matching
    K = min(mcfg.preemptive_features, feats.desc.shape[1])
    P = len(pair_list)
    keep = np.zeros(P, bool)
    ch = max(mcfg.pair_chunk * 4, 32)
    desc = feats.desc[:, :K].contiguous()
    mask = feats.mask[:, :K].contiguous()
    for s in range(0, P, ch):
        pl = pair_list[s: s + ch]
        idx, ok = match_mod.match_on_device(*_chunk_pairs(desc, mask, _pad_rows(pl, ch)),
                                            mcfg.ratio, mcfg.cross_check)
        counts = match_mod.match_counts(idx, ok).cpu().numpy()[: len(pl)]
        keep[s: s + len(pl)] = counts >= mcfg.preemptive_min_matches
        progress("preemptive", min(1.0, (s + ch) / P))
    return keep


def match_pairs(feats: sift.Features, pair_list: np.ndarray, cfg: PipelineConfig,
                progress=_noop_progress, mesh=None):
    """Ratio-test matching for every pair, chunked over the pair list.
    Returns (match_idx (P, N) int32, match_valid (P, N) bool) on the host.
    With cfg.matching.preemptive, the pairs the prefilter drops are not
    matched: their rows come back all invalid.  With a mesh, each chunk
    (scaled by the mesh's size, so every rank matches a full batch) is split
    over the ranks."""
    P = len(pair_list)
    N = feats.kp.shape[1]
    idx_out = np.zeros((P, N), np.int32)
    valid_out = np.zeros((P, N), bool)
    ch = cfg.matching.pair_chunk
    if P >= 16 * ch:
        ch = min(8 * ch, 256)
    elif P <= 256:
        ch = max(ch, 32 * ((P + 31) // 32))  # one batch for small collections
    match = match_mod.match_on_device
    if mesh is not None:
        from ..parallel import dist_matching

        ch *= mesh.shape["shard"]
        match = partial(dist_matching.match_pairs_sharded, mesh)
    rows = np.arange(P)
    if cfg.matching.preemptive and P > 0:
        rows = rows[preemptive_filter_pairs(feats, pair_list, cfg, progress)]
    work = pair_list[rows]
    for s in range(0, len(work), ch):
        pl = work[s: s + ch]
        idx, ok = match(*_chunk_pairs(feats.desc, feats.mask, _pad_rows(pl, ch)),
                        cfg.matching.ratio, cfg.matching.cross_check)
        out_rows = rows[s: s + len(pl)]
        idx_out[out_rows] = idx.cpu().numpy()[: len(pl)]
        valid_out[out_rows] = ok.cpu().numpy()[: len(pl)]
        progress("matching", min(1.0, (s + ch) / max(len(work), 1)))
    return idx_out, valid_out


def _filter_chunk(gen, x0, x1, valid, model: str, n_iters: int, thresh, minimal=False,
                  adaptive=False, alpha0=1.0, score_subset: int = 0):
    """Robust pixel-space F/H fit over a chunk of pairs.  minimal uses the
    7-point solver for 'f'; adaptive scores by a-contrario NFA."""
    extra = {}
    if model == "h":
        solver, scorer, sample, err_dim = (homography.homography_dlt,
                                           homography.homography_transfer_error, 4, 2)
    elif minimal:
        solver, scorer, sample, err_dim = epipolar.fundamental_7pt, epipolar.sampson_error, 7, 1
        extra = dict(n_candidates=3, refit_solver=epipolar.fundamental_8pt)
    else:
        solver, scorer, sample, err_dim = epipolar.fundamental_8pt, epipolar.sampson_error, 8, 1
    if adaptive:
        _, inl, n_inl, _, _ = ransac_mod.ransac_ac(
            gen, x0, x1, valid, solver=solver, scorer=scorer, sample_size=sample,
            n_iters=n_iters, error_dim=err_dim, alpha0=alpha0, max_thresh=thresh,
            min_thresh=1.0, **extra)
        return inl, n_inl
    _, inl, n_inl = ransac_mod.ransac(
        gen, x0, x1, valid, solver=solver, scorer=scorer, sample_size=sample, n_iters=n_iters,
        inlier_thresh=thresh, score_subset=score_subset, **extra)
    return inl, n_inl


def _filter_chunk_essential(gen, x0, x1, valid, intr_a, intr_b, n_iters: int, thresh_px,
                            minimal=False, adaptive=False, alpha0_px=1.0, score_subset: int = 0):
    """Essential-model filter: correspondences normalized with each view's
    intrinsics, thresholds scaled by the pair's mean focal length."""
    extra = {}
    solver, sample = epipolar.essential_8pt, 8
    if minimal:
        solver, sample = epipolar.essential_5pt, 5
        extra = dict(n_candidates=10, refit_solver=epipolar.essential_8pt)
    an = cam_mod.pixel_to_normal(intr_a[:, None, :], x0)
    bn = cam_mod.pixel_to_normal(intr_b[:, None, :], x1)
    f_mean = 0.25 * (intr_a[:, 0] + intr_a[:, 1] + intr_b[:, 0] + intr_b[:, 1])
    if adaptive:
        _, inl, n_inl, _, _ = ransac_mod.ransac_ac(
            gen, an, bn, valid, solver=solver, scorer=epipolar.sampson_error,
            sample_size=sample, n_iters=n_iters, error_dim=1, alpha0=alpha0_px * f_mean,
            max_thresh=thresh_px / f_mean, min_thresh=1.0 / f_mean, **extra)
        return inl, n_inl
    _, inl, n_inl = ransac_mod.ransac(
        gen, an, bn, valid, solver=solver, scorer=epipolar.sampson_error, sample_size=sample,
        n_iters=n_iters, inlier_thresh=thresh_px / f_mean, score_subset=score_subset, **extra)
    return inl, n_inl


def filter_pairs(feats: sift.Features, pair_list, match_idx, match_valid, cfg: PipelineConfig,
                 generator: torch.Generator | None = None, progress=_noop_progress,
                 intr=None, img_hw=None):
    """Geometric verification per pair: prunes matches to RANSAC inliers and
    drops pairs with < min_matches or < min_inlier_ratio support.  Model 'e'
    needs per-view intrinsics (falls back to 'f' without them).  Returns
    (match_idx, valid (P, N), pair_ok (P,)) on the host."""
    if cfg.filter.model == "none":
        return match_idx, match_valid, np.ones(len(pair_list), bool)
    model = cfg.filter.model
    if model == "e" and intr is None:
        model = "f"
    dev = feats.kp.device
    if img_hw is None:
        kp_np = feats.kp.cpu().numpy()
        img_hw = (float(kp_np[..., 1].max()) + 1.0, float(kp_np[..., 0].max()) + 1.0)
    area = float(img_hw[0]) * float(img_hw[1])
    diag = float(np.hypot(img_hw[0], img_hw[1]))
    alpha0 = (np.pi / area) if model == "h" else (2.0 * diag / area)
    P = len(pair_list)
    N = feats.kp.shape[1]
    ch = cfg.matching.pair_chunk
    if P >= 16 * ch:
        ch = min(8 * ch, 256)
    elif P <= 128:
        ch = max(ch, 32 * ((min(P, 128) + 31) // 32))
    out_valid = np.zeros_like(match_valid)
    for s in range(0, P, ch):
        pl = pair_list[s: s + ch]
        n = len(pl)
        pl_pad = _pad_rows(pl, ch)
        mi = _pad_rows(match_idx[s: s + ch], ch)
        mv = match_valid[s: s + ch]
        if n < ch:
            mv = np.concatenate([mv, np.zeros((ch - n, N), bool)])
        ia = torch.as_tensor(pl_pad[:, 0], device=dev).long()
        ib = torch.as_tensor(pl_pad[:, 1], device=dev).long()
        mv_t = torch.as_tensor(mv, device=dev)
        x0, x1, _ = match_mod.gather_matched_points(
            feats.kp[ia], feats.kp[ib], torch.as_tensor(mi, device=dev), mv_t)
        if model == "e":
            intr_np = np.asarray(intr, np.float32)
            inl, _ = _filter_chunk_essential(
                generator, x0, x1, mv_t,
                torch.as_tensor(intr_np[pl_pad[:, 0]], device=dev),
                torch.as_tensor(intr_np[pl_pad[:, 1]], device=dev),
                cfg.filter.max_iterations, cfg.filter.thresh_px, cfg.filter.minimal_solver,
                cfg.filter.adaptive, alpha0, score_subset=cfg.filter.score_subset)
        else:
            inl, _ = _filter_chunk(
                generator, x0, x1, mv_t, model, cfg.filter.max_iterations, cfg.filter.thresh_px,
                cfg.filter.minimal_solver, cfg.filter.adaptive, alpha0,
                score_subset=cfg.filter.score_subset)
        out_valid[s: s + n] = inl.cpu().numpy()[:n] & mv[:n]
        progress("filtering", min(1.0, (s + ch) / P))
    n_put = match_valid.sum(axis=1)
    n_geo = out_valid.sum(axis=1)
    ratio = n_geo / np.maximum(n_put, 1)
    pair_ok = (n_geo >= cfg.filter.min_matches) & (ratio >= cfg.filter.min_inlier_ratio)
    out_valid[~pair_ok] = False
    return match_idx, out_valid, pair_ok


def reconstruct(feats: sift.Features, intr, pair_list, match_idx, match_valid,
                cfg: PipelineConfig, generator: torch.Generator | None = None,
                progress=_noop_progress, cam_group=None, mesh=None, init_scene=None):
    """Tracks + the engine of cfg.engine_type on the features' device.
    cam_group: optional (V,) intrinsic-group ids (one self-calibrating BA
    block each); mesh: optional, shards the engine's large full BAs;
    init_scene: optional prior Scene over the same track table, which seeds
    the incremental engine (the others start from scratch)."""
    V, N = feats.mask.shape
    track_ids, n_tracks = tracks_mod.build_tracks(V, N, pair_list, match_idx, match_valid)
    eng_cfg = cfg.engine
    if cfg.self_calibrate and cam_group is not None:
        eng_cfg = dataclasses.replace(eng_cfg, ba=dataclasses.replace(
            eng_cfg.ba, refine_intrinsics=True, refine_params="all"))
    kp = feats.kp.cpu().numpy()
    if cfg.engine_type in ("global", "stellar"):
        cls = global_sfm.GlobalEngine if cfg.engine_type == "global" else stellar.StellarEngine
        engine = cls(kp, np.asarray(intr), track_ids, n_tracks, progress=progress,
                     cam_group=cam_group, inc_cfg=eng_cfg, mesh=mesh, device=feats.kp.device)
    else:
        engine = incremental.IncrementalEngine(
            kp, np.asarray(intr), track_ids, n_tracks, eng_cfg,
            progress=progress, cam_group=cam_group, mesh=mesh, device=feats.kp.device)
        if init_scene is not None:
            engine.seed_from_scene(init_scene)
    scene = engine.run(generator)
    return scene, engine


def run_sparse(images, intr, cfg: PipelineConfig = PipelineConfig(), *, device,
               generator: torch.Generator | None = None, seed: int = 0,
               progress=_noop_progress, cam_group=None):
    """Full sparse pipeline on `device`: images (V, H, W[, 3]) -> colorized
    sparse scene.  intr (7,) shared or (V, 7); cam_group optional (V,)
    shared-intrinsic group ids.  Random draws come from `generator` (a
    torch.Generator on `device`), made from `seed` when none is given.
    With cfg.devices > 1 this process is one rank of the mesh (get_mesh)
    and `device` its device.  Returns (scene, report dict)."""
    device = torch.device(device)
    mesh = get_mesh(cfg, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.time()
    images = np.asarray(images)
    intr = np.asarray(intr, np.float32)
    if intr.ndim == 1:
        intr = np.tile(intr, (images.shape[0], 1))
    times = {}

    progress("preprocessing", 0.0)
    feats = detect_features(images, cfg, progress, device=device)
    sync()
    times["features"] = time.time() - t0
    progress("preprocessing", 1.0)

    t1 = time.time()
    pair_list = generate_pairs(images.shape[0], cfg, feats=feats)
    match_idx, match_valid = match_pairs(feats, pair_list, cfg, progress, mesh=mesh)
    times["matching"] = time.time() - t1

    t2 = time.time()
    match_idx, match_valid, pair_ok = filter_pairs(
        feats, pair_list, match_idx, match_valid, cfg, generator, progress, intr=intr,
        img_hw=images.shape[1:3])
    times["filtering"] = time.time() - t2

    t3 = time.time()
    scene, engine = reconstruct(
        feats, intr, pair_list[pair_ok], match_idx[pair_ok], match_valid[pair_ok],
        cfg, generator, progress, cam_group=cam_group, mesh=mesh)
    times["reconstruction"] = time.time() - t3

    t4 = time.time()
    if images.ndim == 3:
        rgb = np.repeat((np.clip(images, 0, 1) * 255).astype(np.uint8)[..., None], 3, -1)
    else:
        rgb = images.astype(np.uint8)
    scene = engine.colorize(scene, rgb)
    sync()
    times["colorize"] = time.time() - t4
    times["total"] = time.time() - t0
    report = {
        "n_views": int(images.shape[0]),
        "n_registered": int(scene.cam_mask.sum()),
        "n_points": int(scene.point_mask.sum()),
        "n_tracks": int(engine.T),
        "n_obs": int(scene.obs_mask.sum()),
        "n_pairs_kept": int(pair_ok.sum()),
        "pair_list": pair_list,
        "pair_ok": pair_ok,
        "times_s": {k: round(v, 3) for k, v in times.items()},
        "recon_phase_s": {k: round(v, 3) for k, v in sorted(engine.timings.items())},
        "ba_solves": dict(Counter(f"{kind} {c}x{p}x{o}" for kind, c, p, o in engine.ba_solves)),
        "engine_log": engine.log,
    }
    progress("done", 1.0, n_points=report["n_points"])
    return scene, report
