"""Global structure-from-motion: rotation averaging + translation averaging.

Port of ``tpusfm/sfm/global_sfm.py`` (the reference's GLOBAL engine option,
OpenMVG's GlobalSfMReconstructionEngine):

1. Pairwise relative poses come from the incremental engine's batched
   E/H two-view step, one device call per chunk of ``pair_chunk`` pairs.
2. Rotation averaging is a Jacobi relaxation: every iteration gathers the
   neighbour estimates R_relᵀR_j / R_rel R_i over the edge table, sums
   them per view and projects back onto SO(3) with a batched SVD.
3. Translation averaging minimizes |[d_ij]ₓ (C_j - C_i)|² over camera
   centers with two anchored cameras (gauge and scale), matrix-free CG
   over the edge table, then one round without cheirality-flipped edges.
4. Structure: triangulate every track against the global poses, wash
   outliers and run global bundle adjustments, through the incremental
   engine's machinery.

The segment sums are deterministic (``Segments``: a padded gather summed
along a fixed axis), so a solve gives the same bits on every call on the
card, where ``index_add_`` sums by float atomics in a varying order.  The
CG loops keep the reference's stopping rule: an iteration that the rule
stops leaves the state as it was, and the host reads the rule only every
``_CG_CHECK`` iterations, so the result is the while-loop's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import lie
from . import incremental as inc_mod
from .scene import Scene

# CG iterations between two host reads of the stopping rule.
_CG_CHECK = 64


@dataclasses.dataclass(frozen=True)
class GlobalConfig:
    ransac_iters: int = 256
    min_pair_inliers: int = 30
    # Pairs whose median inlier parallax is below this carry no usable
    # translation direction (rotation-dominant / planar-far regime).
    min_pair_parallax_deg: float = 0.5
    essential_thresh_px: float = 4.0
    rot_iters: int = 40
    trans_cg_iters: int = 100
    reproj_outlier_px: float = 4.0
    min_tri_angle_deg: float = 1.5
    max_views_per_track: int = 8
    ba_iters: int = 30
    pair_chunk: int = 32


class Segments:
    """Deterministic segment sums by a fixed id vector (E,) into n segments:
    the rows of each segment gathered into a padded (n, width) table, in
    their order in the id vector, and summed along it."""

    def __init__(self, ids: torch.Tensor, n: int):
        ids = ids.long()
        E = ids.shape[0]
        order = torch.argsort(ids, stable=True)
        counts = torch.bincount(ids, minlength=n)
        width = int(counts.max()) if E else 0
        starts = torch.cumsum(counts, 0) - counts
        sorted_ids = ids[order]
        pos = torch.arange(E, device=ids.device) - starts[sorted_ids]
        # Row E of the padded values is zero.
        self.table = torch.full((n, width), E, dtype=torch.long, device=ids.device)
        self.table[sorted_ids, pos] = order

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        pad = torch.cat([u, torch.zeros_like(u[:1])])
        return pad[self.table].sum(1)


def _cg(mv, b, x, tol: float, iters: int):
    """Conjugate gradients from x under the reference's rule: iterate while
    it < iters and |r|² > tol; a stopped iteration changes nothing."""
    r = b - mv(x)
    p = r
    rs = torch.sum(r * r)
    for it in range(iters):
        if it % _CG_CHECK == 0 and it and not bool(rs > tol):
            break
        go = rs > tol
        Ap = mv(p)
        alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-20)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        rs_n = torch.sum(r_n * r_n)
        p_n = r_n + (rs_n / torch.clamp(rs, min=1e-20)) * p
        x, r, p, rs = (torch.where(go, a, b_) for a, b_ in
                       ((x_n, x), (r_n, r), (p_n, p), (rs_n, rs)))
    return x


# ---------------------------------------------------------------------------
# Rotation averaging
# ---------------------------------------------------------------------------

def rotation_averaging(edge_i, edge_j, R_rel, w, R_init, n_views: int, iters: int):
    """Jacobi relaxation of sum_e w_e |R_j - R_rel R_i|_F^2.

    edge_i/j (E,) int, R_rel (E, 3, 3) with R_j ~ R_rel R_i, w (E,),
    R_init (V, 3, 3), all on one device.  Returns (V, 3, 3) with R_0 = I."""
    seg_i, seg_j = Segments(edge_i, n_views), Segments(edge_j, n_views)
    ei, ej = edge_i.long(), edge_j.long()
    wr = w[:, None, None]
    ones = torch.ones(n_views, 2, dtype=R_init.dtype, device=R_init.device)
    R = R_init
    for _ in range(iters):
        est_i = torch.einsum("eji,ejk->eik", R_rel, R[ej])  # R_rel^T R_j
        est_j = torch.einsum("eij,ejk->eik", R_rel, R[ei])  # R_rel R_i
        acc = seg_i(est_i * wr) + seg_j(est_j * wr)
        # Keep inertia for poorly connected nodes.
        acc = acc + 1e-3 * R
        U, _, Vt = torch.linalg.svd(acc)
        det = torch.linalg.det(U @ Vt)
        D = torch.cat([ones, det[:, None]], 1)
        R = torch.einsum("vij,vj,vjk->vik", U, D, Vt)
    # Gauge: express everything relative to view 0 (R_0 = I).
    return torch.einsum("vij,kj->vik", R, R[0])


# ---------------------------------------------------------------------------
# Translation averaging
# ---------------------------------------------------------------------------

def translation_averaging(edge_i, edge_j, dirs, w, anchor_j, n_views: int, cg_iters: int,
                          irls_iters: int = 1):
    """Camera centers from pairwise directions d_ij ~ (C_j - C_i)/|.|.

    Minimizes sum_e w_e |[d]_x (C_j - C_i)|^2 with C_0 = 0 (gauge) and
    C_{anchor_j} = d_{0,anchor} (scale), then re-solves without the
    cheirality-flipped edges (solved displacement anti-parallel to the
    measured direction), irls_iters times.  Matrix-free CG per round.
    Returns (V, 3)."""
    dev, dt = dirs.device, dirs.dtype
    ei, ej = edge_i.long(), edge_j.long()
    seg_i, seg_j = Segments(ei, n_views), Segments(ej, n_views)
    Dx = lie.hat(dirs)
    DtD = torch.einsum("eji,ejk->eik", Dx, Dx)  # [d]x^T [d]x

    anchor = torch.as_tensor(anchor_j, device=dev).long()
    fixed = torch.zeros(n_views, dtype=torch.bool, device=dev)
    fixed[0] = True
    fixed[anchor] = True
    free = (~fixed).to(dt)[:, None]
    sel = ((ei == 0) & (ej == anchor))[:, None]
    anchor_dir = torch.sum(torch.where(sel, dirs, torch.zeros_like(dirs)), 0)
    C_fixed = torch.zeros((n_views, 3), dtype=dt, device=dev)
    C_fixed[anchor] = anchor_dir

    def solve(we, x0):
        wD = (w * we)[:, None, None] * DtD

        def AtA(C):
            u = torch.einsum("eij,ej->ei", wD, C[ej] - C[ei])
            return seg_j(u) - seg_i(u)

        b = -AtA(C_fixed) * free
        return _cg(lambda v: AtA(v * free) * free + 1e-8 * v * free, b, x0 * free, 1e-14,
                   cg_iters)

    x = solve(torch.ones_like(w), torch.zeros((n_views, 3), dtype=dt, device=dev))
    for _ in range(irls_iters):
        C = x + C_fixed
        diff = C[ej] - C[ei]
        nrm = torch.linalg.norm(diff, dim=1)
        cos_a = torch.sum(diff * dirs, 1) / torch.clamp(nrm, min=1e-9)
        x = solve((cos_a >= 0.0).to(dt), x)
    return x + C_fixed


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _largest_component(V: int, edges) -> set:
    """The largest connected component of the view graph (host)."""
    adj = {v: set() for v in range(V)}
    for e in edges:
        adj[e[0]].add(e[1])
        adj[e[1]].add(e[0])
    seen = set()
    comps = []
    for s0 in range(V):
        if s0 in seen or not adj[s0]:
            continue
        stack, comp = [s0], set()
        while stack:
            u = stack.pop()
            if u in comp:
                continue
            comp.add(u)
            stack.extend(adj[u] - comp)
        seen |= comp
        comps.append(comp)
    return max(comps, key=len)


def _component_edges(V: int, edges):
    """The largest connected component's views (sorted) and its edges with
    view ids remapped to positions in that list (host)."""
    comp = _largest_component(V, edges)
    vids = sorted(comp)
    vmap_ = {v: k for k, v in enumerate(vids)}
    E = [(vmap_[e[0]], vmap_[e[1]]) + tuple(e[2:]) for e in edges
         if e[0] in comp and e[1] in comp]
    return vids, E


def _edge_tables(Vc: int, E):
    """Edge ids, relative rotations, weights normalized to the strongest
    edge, and the rotations composed along a depth-first spanning tree from
    view 0 (host)."""
    ei = np.asarray([e[0] for e in E], np.int64)
    ej = np.asarray([e[1] for e in E], np.int64)
    R_rel = np.stack([e[2] for e in E]).astype(np.float32)
    w = np.asarray([e[4] for e in E], np.float32)
    w = w / w.max()
    R_init = np.tile(np.eye(3, dtype=np.float32), (Vc, 1, 1))
    tree_adj: dict[int, list[tuple[int, int, int]]] = {k: [] for k in range(Vc)}
    for eidx, (i, j) in enumerate(zip(ei.tolist(), ej.tolist())):
        tree_adj[i].append((j, eidx, +1))
        tree_adj[j].append((i, eidx, -1))
    visited = {0}
    stack = [0]
    while stack:
        u = stack.pop()
        for (v, eidx, sgn) in tree_adj[u]:
            if v in visited:
                continue
            visited.add(v)
            if sgn > 0:  # edge (u -> v): R_v = R_rel R_u
                R_init[v] = R_rel[eidx] @ R_init[u]
            else:  # edge (v -> u): R_u = R_rel R_v
                R_init[v] = R_rel[eidx].T @ R_init[u]
            stack.append(v)
    return ei, ej, R_rel, w, R_init


class GlobalEngine:
    """Global pipeline over the same inputs as the incremental engine, on
    `device`.  Random draws come from the torch.Generator given to run().
    ``timings`` (phase seconds), ``ba_solves`` and ``log`` are the inner
    incremental engine's, whose machinery builds the structure."""

    def __init__(self, kp, intr, track_ids, n_tracks, cfg: GlobalConfig = GlobalConfig(),
                 progress=None, cam_group=None, inc_cfg=None, mesh=None, *, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.intr = np.asarray(intr, np.float32)
        self.track_ids = np.asarray(track_ids)
        self.V, self.N = self.track_ids.shape
        self.T = int(n_tracks)
        self.progress = progress or (lambda *a, **k: None)
        self._inc = inc_mod.IncrementalEngine(
            kp, intr, track_ids, n_tracks, inc_cfg or inc_mod.IncrementalConfig(),
            cam_group=cam_group, mesh=mesh, device=self.device)
        # The reference rebinds its log to the inner engine's at the end of
        # a run, which drops lines logged before (the stellar fallback's);
        # here both are one list from the start.
        self.log = self._inc.log

    @property
    def timings(self) -> dict[str, float]:
        return self._inc.timings

    @property
    def ba_solves(self) -> list[tuple[str, int, int, int]]:
        return self._inc.ba_solves

    def _timed(self, name, fn, *a, **k):
        return self._inc._timed(name, fn, *a, **k)

    def relative_poses(self, gen: torch.Generator, keep_structure: bool = False):
        """Batched two-view relative pose on every view pair with at least
        8 shared tracks.  Returns the kept edges (i, j, R, t, n_inliers),
        with keep_structure=True also (inlier track ids, their depths in
        view i's and view j's frames at the pair's unit-baseline scale)."""
        cfg = self.cfg
        inc = self._inc
        iu = np.triu_indices(self.V, 1)
        sel = inc._pair_counts[iu] >= 8
        cand = list(zip(iu[0][sel].tolist(), iu[1][sel].tolist()))
        edges = []
        ch = cfg.pair_chunk
        for s in range(0, len(cand), ch):
            chunk = cand[s: s + ch]
            x0s, x1s, valids, trs = [], [], [], []
            for (i, j) in chunk:
                uvi, uvj, tr = inc._pair_correspondences(i, j)
                x0, x1, valid = inc._pad_pair(uvi, uvj, i, j)
                x0s.append(x0)
                x1s.append(x1)
                valids.append(valid)
                trs.append(tr)
            while len(x0s) < ch:
                x0s.append(x0s[-1])
                x1s.append(x1s[-1])
                valids.append(np.zeros_like(valids[-1]))
            f = float(self.intr[chunk[0][0], 0])
            out = inc_mod._init_pairs_batched(
                gen, inc._dev(np.stack(x0s)), inc._dev(np.stack(x1s)),
                inc._dev(np.stack(valids)), cfg.ransac_iters, cfg.essential_thresh_px / f)
            R_np, t_np, X_np, good_b, _, ang_np = inc_mod._to_host(out)
            for ci, (i, j) in enumerate(chunk):
                n_good = int(good_b[ci].sum())
                if n_good < cfg.min_pair_inliers:
                    continue
                med_ang = float(np.median(ang_np[ci][good_b[ci]])) if n_good else 0.0
                if med_ang < cfg.min_pair_parallax_deg:
                    continue
                edge = [i, j, R_np[ci], t_np[ci], n_good]
                if keep_structure:
                    tr = trs[ci]
                    good = good_b[ci][: len(tr)]
                    X = X_np[ci][: len(tr)][good]  # frame-i points, |t| = 1
                    z_i = X[:, 2]
                    z_j = (X @ R_np[ci].T + t_np[ci])[:, 2]
                    edge.append((tr[good], z_i.astype(np.float64), z_j.astype(np.float64)))
                edges.append(tuple(edge))
            self.progress("global_pairs", min(1.0, (s + ch) / max(len(cand), 1)))
        return edges

    def _default_gen(self, gen):
        return torch.Generator(device=self.device).manual_seed(0) if gen is None else gen

    def run(self, gen: torch.Generator | None = None) -> Scene:
        gen = self._default_gen(gen)
        edges = self._timed("relative_poses", self.relative_poses, gen)
        if not edges:
            raise RuntimeError("global SfM: no usable pairs")
        vids, E = self._timed("view_graph", _component_edges, self.V, edges)
        Vc = len(vids)
        ei, ej, R_rel, w_np, R_init = self._timed("view_graph", _edge_tables, Vc, E)
        self.progress("rotation_averaging", 0.5)
        Rg = self._timed("rotation_averaging", self._rotations, ei, ej, R_rel, w_np, R_init)
        self.progress("rotation_averaging", 1.0)

        # Directions in world frame: C_j - C_i = -R_j^T t_rel.
        dirs = -np.einsum("eji,ej->ei", Rg[ej], np.stack([e[3] for e in E]))
        nrm = np.linalg.norm(dirs, axis=1, keepdims=True)
        dirs = dirs / np.maximum(nrm, 1e-12)
        # Scale anchor: the strongest edge incident to node 0.
        e0 = [k for k, e in enumerate(E) if e[0] == 0]
        anchor = E[e0[int(np.argmax([E[k][4] for k in e0]))]][1] if e0 else int(ej[0])
        dev = self.device
        centers = self._timed("translation_averaging", lambda: inc_mod._to_host(
            translation_averaging(
                torch.as_tensor(ei, device=dev), torch.as_tensor(ej, device=dev),
                torch.as_tensor(dirs.astype(np.float32), device=dev),
                torch.as_tensor(w_np, device=dev), anchor, Vc, self.cfg.trans_cg_iters)))
        self.progress("translation_averaging", 1.0)
        return self._install_and_finish(vids, Rg, centers)

    def _rotations(self, ei, ej, R_rel, w_np, R_init) -> np.ndarray:
        """rotation_averaging on the engine's device, read back."""
        dev = self.device
        return inc_mod._to_host(rotation_averaging(
            torch.as_tensor(ei, device=dev), torch.as_tensor(ej, device=dev),
            torch.as_tensor(R_rel, device=dev), torch.as_tensor(w_np, device=dev),
            torch.as_tensor(R_init, device=dev), len(R_init), self.cfg.rot_iters))

    def _install_and_finish(self, vids, Rg, C_np) -> Scene:
        """Install global poses into the shared obs-table machinery and
        build structure like the incremental engine's tail: three rounds of
        triangulate / wash / BA / wash, then a shorter last one."""
        cfg = self.cfg
        inc = self._inc
        aa = lie.so3_log(torch.as_tensor(np.asarray(Rg, np.float32))).numpy()
        for k, v in enumerate(vids):
            inc.aa[v] = aa[k]
            inc.t[v] = -Rg[k] @ C_np[k]
            inc.registered[v] = True
            inc._reg_order.append(int(v))
        inc.n_registered = len(vids)
        inc.gauge_cam = vids[0]
        inc.cfg = dataclasses.replace(
            inc.cfg,
            reproj_outlier_px=cfg.reproj_outlier_px,
            min_tri_angle_deg=cfg.min_tri_angle_deg,
            max_views_per_track=cfg.max_views_per_track,
        )
        # Each BA round tightens the averaged centers and lets the next
        # triangulation admit more structure.
        for it in range(4):
            # Re-mark every installed view: triangulation is dirty-gated,
            # and each BA round can turn gate-failed tracks valid.
            for v in vids:
                inc._mark_dirty_view(int(v))
            inc._timed("triangulate", inc.triangulate_new)
            inc._timed("wash", inc.wash_outliers)
            inc._timed("final_ba", inc.run_ba,
                       cfg.ba_iters if it < 3 else max(cfg.ba_iters // 3, 5))
            if it < 3:
                inc._timed("wash", inc.wash_outliers)
        self.progress("reconstruction", 1.0)
        return inc.to_scene()

    def colorize(self, scene, images):
        return self._inc.colorize(scene, images)
