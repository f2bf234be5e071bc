"""View-cluster sharded dense depth estimation (port of
``tpusfm/parallel/dist_dense.py``).

The per-view sweep inputs (source poses, depth ranges) are packed into
per-view arrays so that one call runs a batch of reference views:
``src_idx`` is (V, S+1) int32 with the S source view ids followed by the
reference view id in the last slot, and the intrinsics are per view (V, 3,
3).  The sharded forms give each rank its contiguous block of the packed
views (the images replicated: a view's sources are arbitrary) and return
the maps of every view to every rank through one all_gather.  PatchMatch's
draws come per view, so which rank computes a view changes nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import lie
from ..dense import depth as depth_mod
from ..dense import patchmatch as pm_mod
from . import mesh as mesh_mod


def plane_sweep_all_views(norm_images, Ks, src_idx, R_rel, t_rel, inv_depths,
                          cfg: depth_mod.DenseConfig = depth_mod.DenseConfig()):
    """Sweep a batch of packed views, one after another: norm_images
    (V_all, H, W) locally normalised, Ks (V_all, 3, 3), src_idx (B, S+1),
    R_rel (B, S, 3, 3), t_rel (B, S, 3), inv_depths (B, D).  Returns
    (depths (B, H, W), costs (B, H, W))."""
    out_d, out_c = [], []
    for b in range(src_idx.shape[0]):
        s = src_idx[b].long()
        d, c = depth_mod.plane_sweep_depth(norm_images[s[-1]], norm_images[s[:-1]], Ks[s[-1]],
                                           Ks[s[:-1]], R_rel[b], t_rel[b], inv_depths[b], cfg)
        out_d.append(d)
        out_c.append(c)
    return torch.stack(out_d), torch.stack(out_c)


def _block(mesh, axis: str, src_idx, what: str) -> slice:
    """This rank's contiguous block of the packed views."""
    n = mesh.shape[axis]
    B = src_idx.shape[0]
    if B % n:
        raise ValueError(f"view count {B} must divide mesh axis {n} (pad with repeated views)")
    mesh_mod.check_same(mesh, what, views=B)
    return slice(mesh.rank * (B // n), (mesh.rank + 1) * (B // n))


def plane_sweep_sharded(mesh, norm_images, Ks, src_idx, R_rel, t_rel, inv_depths,
                        cfg: depth_mod.DenseConfig = depth_mod.DenseConfig(),
                        axis: str = "shard"):
    """``plane_sweep_all_views`` with the packed views split over the mesh
    (their count a multiple of its size; pad with repeated views).  Every
    rank gets (depths (B, H, W), costs (B, H, W))."""
    sl = _block(mesh, axis, src_idx, "plane_sweep_sharded")
    d, c = plane_sweep_all_views(norm_images, Ks, src_idx[sl], R_rel[sl], t_rel[sl],
                                 inv_depths[sl], cfg)
    return mesh_mod.all_gather(mesh, d), mesh_mod.all_gather(mesh, c)


def patchmatch_all_views(images_raw, Ks, src_idx, R_rel, t_rel, inv_init, inv_lo, inv_hi,
                         generators, pm_cfg, n_init=None, draws=None):
    """PatchMatch over a batch of packed views, one after another.
    inv_init (B, H, W) is the inverse-depth init, inv_lo/inv_hi (B,) the
    per-view search range, generators one torch.Generator per view (or
    None), draws optional per-view draw lists (see
    patchmatch.patchmatch_refine).  Returns (depth, cost, normal) stacked
    over the batch."""
    outs = []
    for b in range(src_idx.shape[0]):
        s = src_idx[b].long()
        outs.append(pm_mod.patchmatch_refine(
            images_raw[s[-1]], images_raw[s[:-1]], Ks[s[-1]], Ks[s[:-1]], R_rel[b], t_rel[b],
            inv_init[b], inv_lo[b], inv_hi[b],
            None if generators is None else generators[b], pm_cfg,
            None if n_init is None else n_init[b], None if draws is None else draws[b]))
    return tuple(torch.stack(x) for x in zip(*outs))


def patchmatch_sharded(mesh, images_raw, Ks, src_idx, R_rel, t_rel, inv_init, inv_lo, inv_hi,
                       generators, pm_cfg, n_init=None, draws=None, axis: str = "shard"):
    """``patchmatch_all_views`` with the packed views split over the mesh:
    each rank refines its block with those views' generators (or draws).
    Every rank gets (depth, cost, normal) of all B views."""
    sl = _block(mesh, axis, src_idx, "patchmatch_sharded")

    def part(x):
        return None if x is None else x[sl]

    outs = patchmatch_all_views(images_raw, Ks, src_idx[sl], R_rel[sl], t_rel[sl], inv_init[sl],
                                inv_lo[sl], inv_hi[sl], part(generators), pm_cfg,
                                n_init=part(n_init), draws=part(draws))
    return tuple(mesh_mod.all_gather(mesh, x) for x in outs)


def pack_sweep_inputs(scene, views, cfg: depth_mod.DenseConfig, n_planes: int, ranges=None):
    """Host-side packing of per-view sweep inputs.  Returns numpy (src_idx
    (V, S+1) with the ref id in the last slot, R_rel (V, S, 3, 3), t_rel
    (V, S, 3), inv_depths (V, D), inv_lo (V,), inv_hi (V,)) over `views`.
    ranges: optional (lo (V,), hi (V,), valid (V,)) from
    depth.depth_ranges_all."""
    R_all = depth_mod._np(lie.so3_exp(scene.cam_rot))
    t_all = depth_mod._np(scene.cam_t)
    S = cfg.n_sources
    out_idx = np.zeros((len(views), S + 1), np.int32)
    out_R = np.zeros((len(views), S, 3, 3), np.float32)
    out_t = np.zeros((len(views), S, 3), np.float32)
    out_d = np.zeros((len(views), n_planes), np.float32)
    out_lo = np.zeros(len(views), np.float32)
    out_hi = np.zeros(len(views), np.float32)
    for k, v in enumerate(views):
        srcs = depth_mod.select_source_views(scene, v, S)
        while len(srcs) < S:
            srcs.append(srcs[-1] if srcs else v)
        if ranges is not None:
            lo_a, hi_a, ok_a = ranges
            lo, hi = (lo_a[v], hi_a[v]) if ok_a[v] else (1.0, 10.0)
        else:
            rng = depth_mod.depth_range_from_sparse(scene, v, cfg.depth_margin)
            lo, hi = rng if rng else (1.0, 10.0)
        out_idx[k, :S] = srcs
        out_idx[k, S] = v
        R_rel = np.einsum("sij,kj->sik", R_all[srcs], R_all[v])
        out_R[k] = R_rel
        out_t[k] = t_all[srcs] - np.einsum("sij,j->si", R_rel, t_all[v])
        out_d[k] = np.linspace(1.0 / hi, 1.0 / lo, n_planes)
        out_lo[k] = 1.0 / hi
        out_hi[k] = 1.0 / lo
    return out_idx, out_R, out_t, out_d, out_lo, out_hi
