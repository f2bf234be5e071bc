"""Stellar structure-from-motion: pod-scale fusion of two-view geometries.

Port of ``tpusfm/sfm/stellar.py`` (the reference's STELLAR engine option,
OpenMVG's SfMSceneInitializerStellar), as one sparse linear problem in
place of per-pod bundle adjustments:

1. Two-view relative poses and their unit-baseline triangulated depths
   come from the global engine's batched pair step.
2. Pod scale links (host): for every view, two incident edges that share
   tracks give log s_e1 - log s_e2 = median(log z2 - log z1), over the
   strongest ``MAX_POD_DEGREE`` edges pairwise plus a star link from every
   other incident edge to the strongest.
3. The log-scale system (edges = unknowns, links = rows) is solved by
   matrix-free CG over deterministic segment sums (``edge_scale_solve``).
4. Rotation averaging as in the global engine.
5. Camera centers minimize sum_e w_e |C_j - C_i - s_e d_e|², a graph
   Laplacian solved by CG (``scaled_translation_solve``).
6. Structure and BA through the global engine's tail.
"""

from __future__ import annotations

import numpy as np
import torch

from . import incremental as inc_mod
from .global_sfm import GlobalEngine, Segments, _cg, _component_edges, _edge_tables
from .global_sfm import GlobalConfig, rotation_averaging  # noqa: F401  (the reference's names)
from .scene import Scene


def edge_scale_solve(link_a, link_b, rhs, w, n_edges: int, cg_iters: int = 100):
    """Least-squares log-scales: minimize sum_l w_l (s_a - s_b - rhs_l)^2
    with a soft mean(s) = 0 gauge.  link_a/b (L,) edge indices, rhs (L,),
    w (L,).  Edges in no link are pinned to 0.  Returns log-scales (E,)."""
    la, lb = link_a.long(), link_b.long()
    seg_a, seg_b = Segments(la, n_edges), Segments(lb, n_edges)
    linked = torch.zeros(n_edges, dtype=torch.bool, device=rhs.device)
    linked[la] = True
    linked[lb] = True
    free = linked.to(rhs.dtype)

    def AtA(s):
        s = s * free
        u = w * (s[la] - s[lb])
        out = seg_a(u) - seg_b(u)
        # The mean gauge as a soft penalty keeps the system full-rank per
        # connected component.
        return (out + 1e-3 * torch.mean(s) + 1e-5 * s) * free + (1.0 - free) * s

    wr = w * rhs
    b = (seg_a(wr) - seg_b(wr)) * free
    x = _cg(AtA, b, torch.zeros(n_edges, dtype=rhs.dtype, device=rhs.device), 1e-16, cg_iters)
    n_linked = torch.clamp(torch.sum(free), min=1.0)
    return (x - torch.sum(x * free) / n_linked) * free


def scaled_translation_solve(edge_i, edge_j, tvec, w, n_views: int, cg_iters: int = 100):
    """Camera centers from scaled relative translations: minimize
    sum_e w_e |C_j - C_i - tvec_e|^2 with C_0 = 0.  Matrix-free CG on the
    weighted graph Laplacian.  Returns (V, 3)."""
    ei, ej = edge_i.long(), edge_j.long()
    seg_i, seg_j = Segments(ei, n_views), Segments(ej, n_views)
    free = torch.ones((n_views, 1), dtype=tvec.dtype, device=tvec.device)
    free[0] = 0.0
    wc = w[:, None]

    def L(C):
        u = wc * (C[ej] - C[ei])
        return seg_j(u) - seg_i(u)

    wt = wc * tvec
    b = (seg_j(wt) - seg_i(wt)) * free
    return _cg(lambda v: L(v * free) * free + 1e-8 * v * free, b,
               torch.zeros((n_views, 3), dtype=tvec.dtype, device=tvec.device), 1e-14,
               cg_iters)


def pod_links(E, n_views: int, max_degree: int):
    """Scale links of every pod (host): (link_a, link_b, rhs, weight) lists
    over edge indices of E, whose entries are (i, j, R, t, n_inliers,
    (tracks, z_i, z_j))."""
    incident: dict[int, list[int]] = {v: [] for v in range(n_views)}
    for eidx, e in enumerate(E):
        incident[e[0]].append(eidx)
        incident[e[1]].append(eidx)
    link_a, link_b, link_rhs, link_w = [], [], [], []
    for v, eidxs in incident.items():
        eidxs = sorted(eidxs, key=lambda k: -E[k][4])
        # Track -> depth-in-view-v map per edge.
        depth_maps = []
        for k in eidxs:
            i, j, _R, _t, _w, (tr, z_i, z_j) = E[k]
            z = z_i if i == v else z_j
            pos = z > 1e-6
            depth_maps.append(dict(zip(tr[pos].tolist(), z[pos].tolist())))
        # All pairs among the strongest edges, plus a star link from every
        # remaining incident edge to the pod's strongest: capping alone can
        # disconnect a view's edge cluster from the link graph.
        top = min(len(eidxs), max_degree)
        pairs = [(a, b) for a in range(top) for b in range(a + 1, top)]
        pairs += [(0, b) for b in range(top, len(eidxs))]
        for a, b in pairs:
            da, db = depth_maps[a], depth_maps[b]
            shared = da.keys() & db.keys()
            if len(shared) < 5:
                continue
            # Z = z_a s_a = z_b s_b  =>  log s_a - log s_b = log z_b - log z_a
            ratios = [np.log(db[t]) - np.log(da[t]) for t in shared]
            link_a.append(eidxs[a])
            link_b.append(eidxs[b])
            link_rhs.append(float(np.median(ratios)))
            link_w.append(float(len(shared)))
    return link_a, link_b, link_rhs, link_w


class StellarEngine(GlobalEngine):
    """Stellar pipeline: pod-consistent scales + scaled translation fusion."""

    MAX_POD_DEGREE = 8  # strongest edges per pod considered for scale links

    def run(self, gen: torch.Generator | None = None) -> Scene:
        gen = self._default_gen(gen)
        edges = self._timed("relative_poses", self.relative_poses, gen, keep_structure=True)
        if not edges:
            raise RuntimeError("stellar SfM: no usable pairs")
        vids, E = self._timed("view_graph", _component_edges, self.V, edges)
        Ne, Vc = len(E), len(vids)
        link_a, link_b, link_rhs, link_w = self._timed("stellar_pods", pod_links, E, Vc,
                                                       self.MAX_POD_DEGREE)
        if not link_a:
            # No pod overlap: fall back to the direction-only global path.
            self.log.append("stellar: no pod scale links; falling back to global")
            return super().run(gen)
        self.progress("stellar_pods", 1.0)

        dev = self.device
        log_s = self._timed("edge_scale", lambda: inc_mod._to_host(edge_scale_solve(
            torch.as_tensor(link_a, device=dev), torch.as_tensor(link_b, device=dev),
            torch.as_tensor(np.asarray(link_rhs, np.float32), device=dev),
            torch.as_tensor(np.asarray(link_w, np.float32), device=dev),
            n_edges=Ne, cg_iters=max(Ne, 50))))
        scales = np.exp(log_s.astype(np.float64))
        # Scales are positive multiplicative quantities; an edge in no link
        # keeps scale 1 but carries no scale information.
        scales = np.clip(scales, 1e-3, 1e3).astype(np.float32)
        linked = np.zeros(Ne, bool)
        linked[np.asarray(link_a)] = True
        linked[np.asarray(link_b)] = True

        ei, ej, R_rel, w_np, R_init = self._timed("view_graph", _edge_tables, Vc, E)
        Rg = self._timed("rotation_averaging", self._rotations, ei, ej, R_rel, w_np, R_init)
        self.progress("rotation_averaging", 1.0)

        # World-frame scaled baselines: C_j - C_i = -s_e * R_j^T t_rel.
        tvec = -np.einsum("eji,ej->ei", Rg[ej], np.stack([e[3] for e in E]))
        nrm = np.linalg.norm(tvec, axis=1, keepdims=True)
        tvec = tvec / np.maximum(nrm, 1e-12) * scales[:, None]
        # Unlinked edges carry no scale information: they enter the center
        # solve only where they are needed for connectivity.
        keep = linked.copy()
        cov = set()
        for eidx in np.nonzero(keep)[0]:
            cov.add(E[eidx][0])
            cov.add(E[eidx][1])
        for eidx in np.nonzero(~keep)[0]:
            if E[eidx][0] not in cov or E[eidx][1] not in cov:
                keep[eidx] = True
                cov.add(E[eidx][0])
                cov.add(E[eidx][1])
        w_t = np.where(keep, w_np, 0.0).astype(np.float32)
        centers = self._timed("translation_averaging", lambda: inc_mod._to_host(
            scaled_translation_solve(
                torch.as_tensor(ei, device=dev), torch.as_tensor(ej, device=dev),
                torch.as_tensor(tvec.astype(np.float32), device=dev),
                torch.as_tensor(w_t, device=dev), n_views=Vc, cg_iters=max(3 * Vc, 100))))
        self.progress("translation_averaging", 1.0)
        return self._install_and_finish(vids, Rg, centers)
