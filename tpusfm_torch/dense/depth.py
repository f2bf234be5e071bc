"""Dense multi-view stereo: plane-sweep depth maps, PatchMatch refinement,
cross-view consistency filtering and a fused coloured point cloud.

Port of ``tpusfm/dense/depth.py``.  Per reference view, the nearest source
views are warped through fronto-parallel plane homographies, the cost is a
box-filtered product of locally normalised images (zero-mean NCC) kept over
the best k sources, and the argmin over planes with a parabolic sub-plane
step gives the depth.  PatchMatch (``dense.patchmatch``) refines it into
slanted planes, coarse to fine above ``pm_coarse_px`` pixels a view.  A
geometric consistency vote across neighbour maps filters the maps before
they are back-projected into one cloud.

The sweep, PatchMatch and the consistency filter run on ``device``; source
selection, depth ranges and fusion run on the host in numpy, as in the
reference.  The reference's loops over planes and views (``lax.map``) are
batches of planes here and a loop over views.  ``view_batch`` and
``pm_batch_px`` (the reference's dispatch sizes) are kept for config parity
and change nothing the port computes; with a mesh, a batch of
``view_batch`` views per rank is split over the ranks
(``parallel.dist_dense``).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..core import lie
from . import patchmatch as pm_mod
from .patchmatch import PatchMatchConfig, make_sampler

# Upper bound on the values of one batch of sweep planes (sources x planes
# x pixels).
_SWEEP_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class DenseConfig:
    n_planes: int = 64
    n_sources: int = 4          # source views per reference view
    window: int = 5             # NCC window
    best_k: int = 2             # best-k source aggregation
    min_consistent: int = 2     # cross-view consistency votes
    rel_depth_tol: float = 0.02
    cost_thresh: float = 0.6    # max accepted (1 - NCC) cost
    depth_margin: float = 0.25  # widen the sparse depth range by this factor
    subsample: int = 1          # pixel stride for fusion
    # Plane-warp sampling (PatchMatchConfig.sampling's modes).
    sweep_sampling: str = "up4"
    # Slanted-plane PatchMatch refinement of the sweep's depth.
    patchmatch: bool = True
    pm: PatchMatchConfig = dataclasses.field(default_factory=PatchMatchConfig)
    # The reference's views per device dispatch and its one-view-per-
    # dispatch threshold for PatchMatch; the port computes view by view.
    view_batch: int = 4
    pm_batch_px: int = 200_000
    # Coarse-to-fine PatchMatch above this many pixels a view: the full
    # candidate schedule at half resolution, then one fine full-resolution
    # iteration with the reduced candidate set.
    pm_multiscale: bool = True
    pm_coarse_px: int = 120_000
    # With multiscale PatchMatch the sweep only seeds the coarse level, so
    # it runs at half resolution too; patchmatch=False always sweeps at
    # full resolution.
    sweep_coarse: bool = True


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _box_mean(x: torch.Tensor, w: int) -> torch.Tensor:
    """Box filter over the trailing 2 dims, same size: zero padding, always
    divided by w * w (``reduce_window`` "SAME")."""
    lead = x.shape[:-2]
    H, W = x.shape[-2:]
    lo = (w - 1) // 2
    hi = w - 1 - lo
    y = F.pad(x.reshape(-1, 1, H, W), (lo, hi, lo, hi))
    return F.avg_pool2d(y, w, stride=1).reshape(*lead, H, W)


def local_normalize(img: torch.Tensor, w: int) -> torch.Tensor:
    """Zero-mean, unit-variance per window: NCC becomes a box-filtered dot
    product of normalised images."""
    m = _box_mean(img, w)
    v = _box_mean(img * img, w) - m * m
    return (img - m) / torch.sqrt(torch.clamp(v, min=1e-6))


def _pixel_rays(Kinv: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(..., 3, H*W): Kinv @ [x, y, 1] for every pixel, row-major."""
    dev = Kinv.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    return torch.stack([Kinv[..., i, 0, None] * xs + Kinv[..., i, 1, None] * ys
                        + Kinv[..., i, 2, None] for i in range(3)], dim=-2)


def plane_sweep_depth(ref_img, src_imgs, K_ref, K_src, R_rel, t_rel, inv_depths,
                      cfg: DenseConfig = DenseConfig()):
    """ref_img (H, W) and src_imgs (S, H, W) locally normalised; K_ref
    (3, 3); K_src (S, 3, 3); R_rel (S, 3, 3), t_rel (S, 3) ref-cam ->
    src-cam; inv_depths (D,) inverse-depth planes.  Returns (depth (H, W),
    cost (H, W)): the best plane's depth, parabolic sub-plane refined, and
    its aggregated cost."""
    H, W = ref_img.shape
    S = src_imgs.shape[0]
    D = inv_depths.shape[0]
    rays = _pixel_rays(torch.linalg.inv(K_ref), H, W)          # (3, HW)
    sample = make_sampler(src_imgs, cfg.sweep_sampling)
    k = min(cfg.best_k, S)
    # R_rel @ rays is plane-independent; the plane adds t_rel * inv_d.
    Rr = [R_rel[:, i, 0, None] * rays[0] + R_rel[:, i, 1, None] * rays[1]
          + R_rel[:, i, 2, None] * rays[2] for i in range(3)]   # 3 x (S, HW)
    chunk = max(1, min(D, _SWEEP_ELEMS // (S * H * W)))
    costs = []
    for d0 in range(0, D, chunk):
        inv_d = inv_depths[d0:d0 + chunk][None, :, None]        # (1, Dc, 1)
        p = [Rr[i][:, None, :] + t_rel[:, i, None, None] * inv_d for i in range(3)]
        uv = [K_src[:, i, 0, None, None] * p[0] + K_src[:, i, 1, None, None] * p[1]
              + K_src[:, i, 2, None, None] * p[2] for i in range(3)]  # (S, Dc, HW)
        z = uv[2]
        zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        u = uv[0] / zs
        v = uv[1] / zs
        inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1) & (z > 0)
        dc = z.shape[1]
        warped = sample(v, u).reshape(S, dc, H, W)
        ncc = _box_mean(warped * ref_img, cfg.window)
        cost_s = torch.where(inb.reshape(S, dc, H, W), 1.0 - ncc, torch.full_like(ncc, 2.0))
        costs.append(pm_mod._best_k_mean(cost_s, k))
    costs = torch.cat(costs)                                     # (D, H, W)
    best = torch.argmin(costs, dim=0)
    best_cost = torch.amin(costs, dim=0)
    bm = torch.clamp(best, 1, D - 2)
    c0 = torch.take_along_dim(costs, (bm - 1)[None], dim=0)[0]
    c1 = torch.take_along_dim(costs, bm[None], dim=0)[0]
    c2 = torch.take_along_dim(costs, (bm + 1)[None], dim=0)[0]
    denom = c0 - 2 * c1 + c2
    delta = torch.where(torch.abs(denom) > 1e-9, 0.5 * (c0 - c2) / denom,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    step = inv_depths[1] - inv_depths[0]
    inv_d = inv_depths[bm] + delta * step
    depth = 1.0 / torch.clamp(inv_d, min=1e-9)
    return depth, best_cost


def select_source_views(scene, ref: int, n: int) -> list[int]:
    """Nearest registered views by camera-centre distance with a nonzero
    baseline."""
    reg = np.nonzero(_np(scene.cam_mask))[0]
    centers = _np(scene.camera_centers())
    d = np.linalg.norm(centers[reg] - centers[ref], axis=1)
    order = [int(reg[i]) for i in np.argsort(d) if reg[i] != ref and d[i] > 1e-6]
    return order[:n]


def depth_ranges_all(scene, margin: float):
    """Per-view depth search ranges from the sparse scene in one pass over
    the observations.  Returns (lo (V,), hi (V,), valid (V,))."""
    obs_mask = _np(scene.obs_mask)
    ocam = _np(scene.obs_cam)[obs_mask]
    opt = _np(scene.obs_pt)[obs_mask]
    V = scene.intr.shape[0]
    R = _np(lie.so3_exp(scene.cam_rot))
    t = _np(scene.cam_t)
    pts = _np(scene.points)[opt]
    z = np.einsum("oj,oj->o", R[ocam][:, 2, :], pts) + t[ocam][:, 2]
    keep = z > 1e-3
    ocam, z = ocam[keep], z[keep]
    lo = np.zeros(V)
    hi = np.zeros(V)
    valid = np.zeros(V, bool)
    order = np.argsort(ocam, kind="stable")
    ocam_s, z_s = ocam[order], z[order]
    uniq, starts, counts = np.unique(ocam_s, return_index=True, return_counts=True)
    for v, s, c in zip(uniq, starts, counts):
        if c < 5:
            continue
        zl, zh = np.percentile(z_s[s:s + c], [2, 98])
        span = zh - zl
        lo[v] = max(zl - margin * span, 0.05 * zl)
        hi[v] = zh + margin * span
        valid[v] = True
    return lo, hi, valid


def depth_range_from_sparse(scene, view: int, margin: float):
    """Depth search range (lo, hi) for one view from its sparse
    observations, or None with fewer than 5 in front."""
    mask = _np(scene.obs_mask) & (_np(scene.obs_cam) == view)
    pts = _np(scene.points)[_np(scene.obs_pt)[mask]]
    R = _np(lie.so3_exp(scene.cam_rot[view]))
    t = _np(scene.cam_t[view])
    z = pts @ R[2] + t[2]
    z = z[z > 1e-3]
    if len(z) < 5:
        return None
    lo, hi = np.percentile(z, [2, 98])
    span = hi - lo
    return max(lo - margin * span, 0.05 * lo), hi + margin * span


def consistency_filter(depths, costs, K, R, t, neighbors, cfg: DenseConfig = DenseConfig()):
    """Geometric cross-view consistency: a pixel survives if at least
    min_consistent neighbour maps agree on its 3D location.  depths, costs
    (V, H, W) (depth 0 = invalid); K (V, 3, 3) or (3, 3); R (V, 3, 3), t
    (V, 3) world -> cam; neighbors (V, S).  Returns valid (V, H, W)."""
    V, H, W = depths.shape
    if K.dim() == 2:
        K = K.expand(V, 3, 3)
    nbr = torch.as_tensor(neighbors, device=depths.device).long()
    rays = _pixel_rays(torch.linalg.inv(K), H, W)            # (V, 3, HW)
    d = depths.reshape(V, -1)
    Xc = rays * d[:, None]
    Xc = Xc - t[:, :, None]
    Xw = torch.stack([R[:, 0, i, None] * Xc[:, 0] + R[:, 1, i, None] * Xc[:, 1]
                      + R[:, 2, i, None] * Xc[:, 2] for i in range(3)], dim=1)  # cam -> world
    flat = depths.reshape(-1)
    votes = torch.zeros((V, H * W), dtype=torch.int32, device=depths.device)
    for s in range(nbr.shape[1]):
        nv = nbr[:, s]
        Rn, tn, Kn = R[nv], t[nv], K[nv]
        Xn = [Rn[:, i, 0, None] * Xw[:, 0] + Rn[:, i, 1, None] * Xw[:, 1]
              + Rn[:, i, 2, None] * Xw[:, 2] + tn[:, i, None] for i in range(3)]
        uvn = [Kn[:, i, 0, None] * Xn[0] + Kn[:, i, 1, None] * Xn[1]
               + Kn[:, i, 2, None] * Xn[2] for i in range(3)]
        w3 = torch.where(torch.abs(uvn[2]) < 1e-6, torch.full_like(uvn[2], 1e-6), uvn[2])
        un = uvn[0] / w3
        vn = uvn[1] / w3
        zn = Xn[2]
        inb = (un >= 0) & (un <= W - 1) & (vn >= 0) & (vn <= H - 1) & (zn > 0)
        ui = pm_mod._index(torch.round(un), 0, W - 1)
        vi = pm_mod._index(torch.round(vn), 0, H - 1)
        dn = flat[nv[:, None] * (H * W) + vi * W + ui]
        ok = inb & (dn > 0) & (torch.abs(dn - zn) < cfg.rel_depth_tol * zn)
        votes += ok.to(torch.int32)
    valid = (votes >= cfg.min_consistent) & (d > 0) & (costs.reshape(V, -1) < cfg.cost_thresh)
    return valid.reshape(V, H, W)


def _up2(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Nearest 2x upsample of (B, h, w[, k]) to (B, H, W[, k]), edge-padded."""
    x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    ph, pw = H - x.shape[1], W - x.shape[2]
    if ph > 0:
        x = torch.cat([x, x[:, -1:].expand(-1, ph, *x.shape[2:])], dim=1)
    if pw > 0:
        x = torch.cat([x, x[:, :, -1:].expand(-1, -1, pw, *x.shape[3:])], dim=2)
    return x[:, :H, :W]


def dense_reconstruct(scene, images, rgb_images, cfg: DenseConfig = DenseConfig(),
                      progress=None, views: list[int] | None = None,
                      return_maps: bool = False, generator: torch.Generator | None = None,
                      seed: int = 0, mesh=None, device="cuda", timings: dict | None = None):
    """Dense stage over the registered views (or `views`) -> (points (N, 3)
    float32, colors (N, 3) uint8)[, maps dict when return_maps].

    scene: the port's Scene (any device); images (V, H, W) float grey;
    rgb_images (V, H, W, 3) uint8 or None.  The sweep, PatchMatch and the
    consistency filter run on `device`.  PatchMatch's draws for view v at
    level L (0 coarse, 1 fine) come from a CPU torch.Generator seeded with
    base + 2 * v + L, base = `seed` or a draw from `generator`, so a seed
    gives the same maps on every device.  `timings`, when a dict, receives
    seconds per stage (setup, sweep, pm_coarse, pm_fine, consistency_fetch,
    fusion) taken with a device sync at each stage end.  With a `mesh`
    (``parallel.mesh``), each batch holds view_batch views per rank, padded
    with repeated views, and its sweep and PatchMatch are split over the
    ranks (``parallel.dist_dense``); every rank returns the same result."""
    from ..parallel import dist_dense

    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    progress = progress or (lambda *a, **k: None)
    base = int(seed) if generator is None else int(torch.randint(
        0, 2 ** 62, (1,), generator=generator, device=generator.device).item())
    stage_s = {k: 0.0 for k in ("setup", "sweep", "pm_coarse", "pm_fine", "consistency_fetch",
                                "fusion")}
    clock = [time.time()]

    def mark(stage):
        if timings is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.time()
            stage_s[stage] += now - clock[0]
            clock[0] = now

    images = np.asarray(images, np.float32)
    V, H, W = images.shape
    cam_mask = _np(scene.cam_mask)
    reg = np.nonzero(cam_mask)[0]
    views = [int(v) for v in (views if views is not None else reg) if cam_mask[v]]
    intr = _np(scene.intr)
    Ks = np.zeros((V, 3, 3), np.float32)
    Ks[:, 0, 0] = intr[:V, 0]
    Ks[:, 1, 1] = intr[:V, 1]
    Ks[:, 0, 2] = intr[:V, 2]
    Ks[:, 1, 2] = intr[:V, 3]
    Ks[:, 2, 2] = 1.0
    R_all = _np(lie.so3_exp(scene.cam_rot))
    t_all = _np(scene.cam_t)

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    lo_all, hi_all, rng_ok = depth_ranges_all(scene, cfg.depth_margin)
    computed = [v for v in views
                if rng_ok[v] and len(select_source_views(scene, v, cfg.n_sources)) >= 2]
    depths_t = torch.zeros((V, H, W), dtype=torch.float32, device=device)
    costs_t = torch.full((V, H, W), 2.0, dtype=torch.float32, device=device)
    if computed:
        src_idx, R_rel, t_rel, inv_d, inv_lo, inv_hi = dist_dense.pack_sweep_inputs(
            scene, computed, cfg, cfg.n_planes, ranges=(lo_all, hi_all, rng_ok))
        src_idx, R_rel, t_rel, inv_d = dev(src_idx), dev(R_rel), dev(t_rel), dev(inv_d)
        inv_lo, inv_hi = dev(inv_lo), dev(inv_hi)
        imgs_t = dev(images)
        Ks_t = dev(Ks)
        pm_ms = cfg.patchmatch and cfg.pm_multiscale and H * W > cfg.pm_coarse_px
        sweep_half = pm_ms and cfg.sweep_coarse
        if pm_ms:
            H2, W2 = H // 2, W // 2
            imgs_half_t = dev(images[:, :H2 * 2, :W2 * 2].reshape(V, H2, 2, W2, 2).mean((2, 4)))
            Ks_half = Ks.copy()
            # Pixel-centre mapping u_half = (u_full - 0.5) / 2.
            Ks_half[:, 0, 0] /= 2
            Ks_half[:, 1, 1] /= 2
            Ks_half[:, 0, 2] = (Ks[:, 0, 2] - 0.5) / 2
            Ks_half[:, 1, 2] = (Ks[:, 1, 2] - 0.5) / 2
            Ks_half_t = dev(Ks_half)
        if sweep_half:
            sw_norm, sw_K = local_normalize(imgs_half_t, cfg.window), Ks_half_t
        else:
            sw_norm, sw_K = local_normalize(imgs_t, cfg.window), Ks_t
        fine_cfg = dataclasses.replace(cfg.pm, n_iters=1, fine=True) if pm_ms else cfg.pm
        mark("setup")
        n_dev = mesh.shape["shard"] if mesh is not None else 1
        B = max(cfg.view_batch, 1) * n_dev
        if mesh is not None:
            sweep = partial(dist_dense.plane_sweep_sharded, mesh)
            refine = partial(dist_dense.patchmatch_sharded, mesh)
        else:
            sweep, refine = dist_dense.plane_sweep_all_views, dist_dense.patchmatch_all_views
        for s in range(0, len(computed), B):
            vids = computed[s: s + B]
            # A sharded batch is padded with repeats of its first view.
            idx = list(range(s, s + len(vids))) + [s] * (B - len(vids) if mesh is not None else 0)
            rows = torch.as_tensor(idx, dtype=torch.long, device=device)
            vids_p = [computed[i] for i in idx]
            args = (src_idx[rows], R_rel[rows], t_rel[rows])
            d, c = sweep(sw_norm, sw_K, *args, inv_d[rows], cfg=cfg)
            mark("sweep")
            if cfg.patchmatch:
                inv_init = 1.0 / torch.clamp(d, min=1e-9)
                lo_p, hi_p = inv_lo[rows], inv_hi[rows]
                n_up = None
                if pm_ms:
                    inv_c = inv_init if sweep_half else inv_init[:, ::2, ::2]
                    gens = [torch.Generator().manual_seed(base + 2 * v) for v in vids_p]
                    dch, _cch, nch = refine(imgs_half_t, Ks_half_t, *args, inv_c, lo_p, hi_p,
                                            gens, cfg.pm)
                    inv_init = _up2(1.0 / torch.clamp(dch, min=1e-9), H, W)
                    inv_init = torch.minimum(torch.maximum(inv_init, lo_p[:, None, None]),
                                             hi_p[:, None, None])
                    n_up = _up2(nch, H, W)
                    mark("pm_coarse")
                gens = [torch.Generator().manual_seed(base + 2 * v + 1) for v in vids_p]
                d, c, _n = refine(imgs_t, Ks_t, *args, inv_init, lo_p, hi_p, gens, fine_cfg,
                                  n_init=n_up)
                mark("pm_fine")
            vt = torch.as_tensor(vids, dtype=torch.long, device=device)
            depths_t[vt] = d[:len(vids)]
            costs_t[vt] = c[:len(vids)]
            progress("dense", min(1.0, (s + B) / len(computed)) * 0.8)

    # Consistency neighbours must themselves have computed depth maps.
    centers = _np(scene.camera_centers())
    n_nb = max(1, min(cfg.n_sources, len(computed) - 1))
    neighbors = np.zeros((V, n_nb), np.int32)
    for v in computed:
        others = [c_ for c_ in computed if c_ != v]
        order = np.argsort(np.linalg.norm(centers[others] - centers[v], axis=1))
        nb = [others[o] for o in order[:n_nb]]
        while len(nb) < n_nb:
            nb.append(nb[-1] if nb else v)
        neighbors[v] = nb

    valid_t = consistency_filter(depths_t, costs_t, dev(Ks), dev(R_all.astype(np.float32)),
                                 dev(t_all.astype(np.float32)), dev(neighbors), cfg)
    # One host fetch: f16 depths (5e-4 relative) and the valid mask.
    valid = valid_t.cpu().numpy()
    depths = depths_t.to(torch.float16).cpu().numpy().astype(np.float32)
    progress("dense", 0.9)
    mark("consistency_fetch")

    # Fusion: back-project the surviving pixels (per-view K).
    pts_out, col_out = [], []
    Kinv_all = np.linalg.inv(Ks)
    ss = cfg.subsample
    for v in computed:
        m = valid[v][::ss, ::ss]
        if not m.any():
            continue
        ys, xs = np.nonzero(m)
        ys = ys * ss
        xs = xs * ss
        d = depths[v][ys, xs]
        pix = np.stack([xs, ys, np.ones_like(xs)], 0).astype(np.float64)
        Xc = Kinv_all[v] @ pix * d[None]
        Xw = R_all[v].T @ (Xc - t_all[v][:, None])
        pts_out.append(Xw.T.astype(np.float32))
        if rgb_images is not None:
            col_out.append(np.asarray(rgb_images)[v, ys, xs])
    if not pts_out:
        pts = np.zeros((0, 3), np.float32)
        cols = np.zeros((0, 3), np.uint8)
    else:
        pts = np.concatenate(pts_out)
        cols = (np.concatenate(col_out) if col_out
                else np.full((len(pts), 3), 200, np.uint8))
    mark("fusion")
    if timings is not None:
        timings.update(stage_s)
    if return_maps:
        maps = dict(depths=depths, costs=costs_t.cpu().numpy(), valid=valid, K=Ks, R=R_all,
                    t=t_all, computed=np.asarray(computed, np.int32))
        return pts, cols, maps
    return pts, cols
