"""Incremental structure-from-motion engine.

Port of ``tpusfm/sfm/incremental.py``: E/H two-view bootstrap, batched
P3P-RANSAC resection, masked N-view triangulation, periodic and final
bundle adjustment, outlier washing and colorization.  The host keeps the
reference's integer scheduling in numpy unchanged (the observation table is
preallocated from the track table; registration and triangulation only flip
masks and fill values); every numeric step runs on the engine's device as a
batched tensor program, and its results come back with one ``.cpu()`` per
step at the places where the reference reads back.  Random draws come from
one ``torch.Generator`` on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ba import bundle_adjust as ba
from ..core import camera as cam
from ..core import epipolar, homography, lie, triangulate
from . import pnp as pnp_mod
from . import ransac as ransac_mod
from .scene import Scene, empty_scene


@dataclasses.dataclass(frozen=True)
class IncrementalConfig:
    # Parity values (see SURVEY.md §3.2/§3.4):
    min_init_matches: int = 50          # pair prune threshold (sparseBuilder.cpp:1204)
    min_pnp_inliers: int = 30           # frame-drop (SequentialActuator.h:193)
    essential_thresh_px: float = 4.0    # AC-RANSAC precision default (.cpp:1039)
    pnp_thresh_px: float = 8.0          # solvePnPRansac 8px (SequentialActuator.h:176)
    reproj_outlier_px: float = 4.0      # outlier washing threshold
    min_tri_angle_deg: float = 2.0
    ransac_iters: int = 512
    pnp_iters: int = 256
    # "p3p" samples 3-point Grunert hypotheses (OpenMVG P3P-resection
    # parity — the reference engine resects with P3P AC-RANSAC); "dlt" is
    # the 6-point linear sample.  P3P default: 3-point samples survive
    # contamination far more often (measured: registers views the 6-point
    # DLT drops on weakly-connected scenes).
    pnp_minimal: str = "p3p"
    max_views_per_track: int = 6        # N-view triangulation capacity
    # Views resected per cycle in one batched PnP call (then one
    # triangulation + BA-cadence step per cycle).  Batching k independent
    # resections against the same map is equivalent per view and cuts the
    # host<->device round trips k-fold; 1 = strictly sequential order.
    register_batch: int = 8
    ba_every: int = 4                   # global BA every k registrations
    final_ba_iters: int = 25
    step_ba_iters: int = 8
    # Multi-device (mesh) BA gate of the reference; read only when the
    # pipeline runs on more than one device, which is not ported yet.
    mesh_min_obs_per_device: int = 8192
    # Windowed local step-BA: once the live map exceeds `ba_local_from_obs`
    # observations, periodic step-BAs optimize only the last
    # `ba_local_window` registered views plus the points they see (all
    # observations of those points kept as constraints, older cameras
    # frozen — COLMAP-style local bundle adjustment).  The subproblem is
    # COMPACTED into fixed-bucket camera/point/obs buffers, so per-step
    # cost is O(window), not O(map).  Below the threshold (every existing
    # test scene) step-BAs remain full-map — behavior unchanged.  Final BAs
    # are always full-map.
    ba_local_from_obs: int = 65536
    ba_local_window: int = 24
    ba: ba.BAConfig = dataclasses.field(
        default_factory=lambda: ba.BAConfig(max_iters=8, fix_first_cam=False)
    )
    init_candidates: int = 5


class NoInitialPair(RuntimeError):
    """No candidate pair yields a usable two-view bootstrap.  Caught only
    around the bootstrap, so device and kernel errors still propagate."""


def _np_pixel_to_normal(intr: np.ndarray, uv: np.ndarray, iters: int = 8) -> np.ndarray:
    """Host-side pixel -> normalized coords (numpy twin of
    core.camera.pixel_to_normal), where the reference computes it."""
    intr = np.asarray(intr, np.float64)
    f = intr[..., :2]
    c = intr[..., 2:4]
    k = intr[..., 4:7]
    t = intr[..., 7:9] if intr.shape[-1] >= 9 else np.zeros_like(intr[..., :2])
    xd = (np.asarray(uv, np.float64) - c) / f
    xn = xd.copy()
    if np.any(k != 0) or np.any(t != 0):
        for _ in range(iters):
            r2 = np.sum(xn * xn, axis=-1, keepdims=True)
            scale = 1.0 + r2 * (k[..., 0:1] + r2 * (k[..., 1:2] + r2 * k[..., 2:3]))
            x, y = xn[..., 0:1], xn[..., 1:2]
            # Brown tangential terms (zero for the RADIAL3 7-vector).
            dx = 2 * t[..., 0:1] * x * y + t[..., 1:2] * (r2 + 2 * x * x)
            dy = t[..., 0:1] * (r2 + 2 * y * y) + 2 * t[..., 1:2] * x * y
            xn = (xd - np.concatenate([dx, dy], -1)) / np.maximum(scale, 1e-8)
    return xn.astype(np.float32)


def _to_host(out):
    """Copy a (nested) tuple/dict of tensors to host numpy in one pass."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if isinstance(out, dict):
        return {k: _to_host(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_to_host(v) for v in out)
    return out


# ---------------------------------------------------------------------------
# Batched device steps
# ---------------------------------------------------------------------------

def _init_pairs_batched(gen, x0n, x1n, valid, n_iters: int, thresh: float):
    """Two-view relative pose with H/E model selection + triangulation for a
    batch of candidate seed pairs: x0n, x1n (B, N, 2) normalized coords,
    valid (B, N).  An essential matrix and a homography are both fitted;
    when the homography's support rivals the essential's (planar or
    low-parallax), the pose comes from its decomposition.  Returns
    (R, t, X, good, n_inl, ang) batched over B."""
    E, inl_e, n_e = ransac_mod.ransac(
        gen, x0n, x1n, valid, solver=epipolar.essential_8pt, scorer=epipolar.sampson_error,
        sample_size=8, n_iters=n_iters, inlier_thresh=thresh)
    R_e, t_e, _, front_e, X_e = epipolar.recover_pose(E, x0n, x1n, w=inl_e.to(x0n.dtype))
    H, inl_h, n_h = ransac_mod.ransac(
        gen, x0n, x1n, valid, solver=homography.homography_dlt,
        scorer=homography.homography_transfer_error, sample_size=4,
        n_iters=max(n_iters // 2, 64), inlier_thresh=thresh)
    Rs_h, ts_h, _ = homography.decompose_homography(H)
    # Unit-baseline convention like the essential path.
    ts_h = ts_h / torch.clamp(torch.linalg.norm(ts_h, dim=-1, keepdim=True), min=1e-6)
    R_h, t_h, _, front_h, X_h = epipolar.pose_from_candidates(
        Rs_h, ts_h, x0n, x1n, w=inl_h.to(x0n.dtype))
    planar = n_h.to(torch.float32) > 0.9 * n_e.to(torch.float32)
    R = torch.where(planar[:, None, None], R_h, R_e)
    t = torch.where(planar[:, None], t_h, t_e)
    X = torch.where(planar[:, None, None], X_h, X_e)
    inl = torch.where(planar[:, None], inl_h, inl_e)
    front = torch.where(planar[:, None], front_h, front_e)
    n_inl = torch.where(planar, n_h, n_e)
    good = inl & front
    # Per-point parallax angle of the seed cloud (for host-side scoring).
    c1 = lie.camera_center(R, t)
    a0 = X / torch.clamp(torch.linalg.norm(X, dim=-1, keepdim=True), min=1e-12)
    a1 = X - c1[:, None, :]
    a1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=1e-12)
    ang = torch.rad2deg(torch.arccos(torch.clamp(torch.sum(a0 * a1, -1), -1.0, 1.0)))
    return R, t, X, good, n_inl, ang


def _triangulate_tracks(rot_aa, cam_t, intr, view_idx, uv, vmask):
    """Masked N-view triangulation for a batch of tracks.  rot_aa/cam_t/intr
    (C, ...) camera state; view_idx (T, Vm), uv (T, Vm, 2), vmask (T, Vm).
    Returns X (T, 3), max reprojection error in px (T,), and the widest
    parallax angle in degrees (T,)."""
    R = lie.so3_exp(rot_aa)
    P = torch.cat([R, cam_t[..., None]], dim=-1)
    vi = view_idx.long()
    Pv = P[vi]
    intr_v = intr[vi]
    xn = cam.pixel_to_normal(intr_v, uv)
    X = triangulate.triangulate_n_view(Pv, xn, vmask.to(xn.dtype))

    Xc = torch.einsum("tvij,tj->tvi", Pv[..., :3], X) + Pv[..., 3]
    z = Xc[..., 2]
    zs = z[..., None]
    proj = Xc[..., :2] / torch.where(torch.abs(zs) < 1e-9, torch.full_like(zs, 1e-9), zs)
    err_px = torch.linalg.norm(proj - xn, dim=-1) * 0.5 * (intr_v[..., 0] + intr_v[..., 1])
    err_px = torch.where(vmask & (z > 1e-4), err_px,
                         torch.where(vmask, torch.full_like(err_px, 1e9), torch.zeros_like(err_px)))
    max_err = torch.amax(err_px, dim=-1)

    centers = lie.camera_center(R, cam_t)[vi]
    rays = centers - X[:, None, :]
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True), min=1e-12)
    cosm = torch.einsum("tvi,twi->tvw", rays, rays)
    pair_ok = vmask[:, :, None] & vmask[:, None, :]
    cosm = torch.where(pair_ok, cosm, torch.ones_like(cosm))
    min_cos = torch.amin(cosm, dim=(-2, -1))
    angle = torch.rad2deg(torch.arccos(torch.clamp(min_cos, -1.0, 1.0)))
    return X, max_err, angle


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class IncrementalEngine:
    """Host-side scheduler over batched device steps.

    Inputs: per-view keypoints kp (V, N, >=2) pixel coords, per-view
    intrinsics (V, 7), the track table from tracks.build_tracks
    (track_ids (V, N) int32, n_tracks), and the device the numeric steps
    run on.  Random draws come from the torch.Generator given to run().
    """

    def __init__(self, kp, intr, track_ids, n_tracks, cfg: IncrementalConfig = IncrementalConfig(),
                 progress=None, cam_group=None, *, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.kp = np.asarray(kp)[..., :2].astype(np.float32)
        self.intr = np.asarray(intr, np.float32)
        self.track_ids = np.asarray(track_ids)
        self.V, self.N = self.track_ids.shape
        self.T = int(n_tracks)
        self.progress = progress or (lambda *a, **k: None)
        # Shared intrinsic groups (GroupSharedIntrinsics parity,
        # sparseBuilder.cpp:554-556): all views with the same group id share
        # one BA intrinsic block.  None = one group per view.
        if cam_group is not None:
            self.cam_group = np.asarray(cam_group, np.int32)
            self.n_groups = int(self.cam_group.max()) + 1
        else:
            self.cam_group = None
            self.n_groups = None

        # Preallocated observation table: one row per (view, feat) with a
        # track.  The capacities (obs in 8k steps, points in 1k steps) are
        # the reference's, so both packages solve identically padded
        # problems; padding rows carry zero weight.
        vs, fs = np.nonzero(self.track_ids >= 0)
        n_real = len(vs)
        cap = max(8192 * ((n_real + 8191) // 8192), 1024)
        self.obs_cam = np.zeros(cap, np.int32)
        self.obs_pt = np.zeros(cap, np.int32)
        self.obs_uv = np.zeros((cap, 2), np.float32)
        self.obs_cam[:n_real] = vs
        self.obs_pt[:n_real] = self.track_ids[vs, fs]
        self.obs_uv[:n_real] = self.kp[vs, fs]
        self.O = cap
        self._obs_real = np.zeros(cap, bool)
        self._obs_real[:n_real] = True

        # Mutable reconstruction state (host).
        self.registered = np.zeros(self.V, bool)
        self._T_cap = max(1024 * ((self.T + 1023) // 1024), 1024)
        self.point_active = np.zeros(self._T_cap, bool)
        self.obs_ok = self._obs_real.copy()       # not washed out (padding off)
        self.obs_inlier = np.zeros(self.O, bool)  # passes current gating
        self.aa = np.zeros((self.V, 3), np.float32)
        self.t = np.zeros((self.V, 3), np.float32)
        self.points = np.zeros((self._T_cap, 3), np.float32)
        self.gauge_cam = 0
        self.n_registered = 0
        # track -> feature-index scratch for _pair_correspondences (kept
        # all -1 between calls).
        self._track_feat_scratch = np.full(self._T_cap, -1, np.int64)
        self.barred = np.zeros(self.V, bool)  # views that failed registration
        self.log: list[str] = []
        # Per-phase wall-clock accumulators (seconds).
        self.timings: dict[str, float] = {}

        # Row-index structures (host, static for the run — registration only
        # flips masks): obs rows are view-major by construction, so each
        # view's rows are one contiguous slice; a track-sorted permutation
        # (CSR over tracks) gives each track's rows, so per-cycle host work
        # follows the rows touched, not the table capacity.
        self._view_start = np.searchsorted(
            self.obs_cam[:n_real], np.arange(self.V + 1)).astype(np.int64)
        order = np.argsort(self.obs_pt[:n_real], kind="stable").astype(np.int64)
        self._pt_order = order
        self._pt_start = np.searchsorted(
            self.obs_pt[:n_real][order], np.arange(self._T_cap + 1)
        ).astype(np.int64)
        # Dirty-track worklist: triangulation only reconsiders tracks
        # touched since its last call (marked at registration / wash), not
        # every inactive track in the map.
        self._tri_dirty = np.zeros(self._T_cap, bool)
        self._tri_fail = np.zeros(self._T_cap, np.int8)
        self._pt_map_scratch = np.full(self._T_cap, -1, np.int32)
        self._reg_order: list[int] = []
        # Local-BA sticky bucket sizes (cams, points, obs) — see _run_ba_local.
        self._local_buckets = [64, 4096, 32768]

        # Pairwise correspondence counts from shared tracks.
        self._pair_counts = self._count_shared_tracks()

    def _dev(self, a) -> torch.Tensor:
        """A host array as a tensor on the engine's device."""
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # -- bookkeeping ------------------------------------------------------

    def _count_shared_tracks(self):
        """(V, V) number of shared tracks between view pairs — one sparse
        incidence-matrix product instead of per-track Python loops (the dense
        (T, V) incidence would be ~0.5 GB at 1000 views)."""
        if not self._obs_real.any():
            return np.zeros((self.V, self.V), np.int32)
        from scipy import sparse

        r = self._obs_real
        inc = sparse.csr_matrix(
            (np.ones(int(r.sum()), np.int32),
             (self.obs_pt[r], self.obs_cam[r])),
            shape=(max(self.T, 1), self.V))
        counts = np.asarray((inc.T @ inc).todense(), np.int32)
        np.fill_diagonal(counts, 0)
        return counts

    def _pair_correspondences(self, i, j):
        """Matched keypoints between views i and j via shared tracks.
        Returns (uv_i, uv_j, track_ids) as numpy arrays.

        Vectorized track join (a per-feature Python dict here is O(V^2 N)
        interpreter time across the global engine's pair sweep): invert
        view i's track row into a preallocated track->feature scratch,
        then one fancy-index lookup for view j's features."""
        ti = self.track_ids[i]
        tj = self.track_ids[j]
        inv = self._track_feat_scratch
        vi = ti >= 0
        inv[ti[vi]] = np.nonzero(vi)[0]
        bj = np.nonzero(tj >= 0)[0]
        fi = inv[tj[bj]]
        sel = fi >= 0
        inv[ti[vi]] = -1  # restore the scratch for the next call
        if not sel.any():
            return (np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32),
                    np.zeros(0, np.int32))
        b = bj[sel]
        a = fi[sel]
        tr = tj[b]
        return self.kp[i, a], self.kp[j, b], tr.astype(np.int32)

    def _obs_mask(self):
        return (
            self.registered[self.obs_cam]
            & self.point_active[self.obs_pt]
            & self.obs_ok
            & self.obs_inlier
        )

    def _rows_of_tracks(self, tracks: np.ndarray) -> np.ndarray:
        """Concatenated obs-row indices of the given track ids (CSR lookup;
        O(result), independent of table capacity)."""
        tracks = np.asarray(tracks, np.int64)
        if len(tracks) == 0:
            return np.zeros(0, np.int64)
        starts = self._pt_start[tracks]
        counts = self._pt_start[tracks + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        base = np.repeat(starts, counts)
        off = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        return self._pt_order[base + off]

    def _view_rows(self, v: int) -> np.ndarray:
        """Obs-row slice of view v (rows are view-major by construction)."""
        return np.arange(self._view_start[v], self._view_start[v + 1])

    def _mark_dirty_view(self, v: int):
        """Queue view v's tracks for (re)triangulation consideration."""
        s, e = self._view_start[v], self._view_start[v + 1]
        tr = self.obs_pt[s:e][self.obs_ok[s:e]]
        self._tri_dirty[tr] = True
        self._tri_fail[tr] = 0

    # -- pipeline stages --------------------------------------------------

    def select_init_pair(self, gen):
        """Best seed pair: high correspondence count and non-degenerate
        geometry (scene-initializer parity: MAX_PAIR / STELLAR scoring,
        sparseBuilder.cpp:1443-1467)."""
        cfg = self.cfg
        iu = np.triu_indices(self.V, 1)
        counts = self._pair_counts[iu]
        ranked = [oi for oi in np.argsort(counts)[::-1]
                  if counts[oi] >= cfg.min_init_matches]
        if not ranked:
            raise NoInitialPair("no valid initial pair (scene too degenerate)")
        # Walk the count ranking in chunks: on densely-sampled sequences the
        # highest-count pairs are adjacent views whose triangulation angle
        # fails min_tri_angle_deg — wider-baseline (lower-count but valid)
        # pairs sit further down the ranking (COLMAP-style two-criteria
        # seeding; scene-initializer parity sparseBuilder.cpp:1443-1467).
        for chunk_start in range(0, min(len(ranked), 8 * cfg.init_candidates),
                                 cfg.init_candidates):
            order = ranked[chunk_start: chunk_start + cfg.init_candidates]
            best = self._score_init_candidates(order, iu, gen)
            if best is not None:
                return best
        raise NoInitialPair("no valid initial pair (scene too degenerate)")

    def _score_init_candidates(self, order, iu, gen):
        """Score one chunk of candidate pairs in one batched device call;
        returns the best tuple or None."""
        cfg = self.cfg
        cand = []
        x0s, x1s, valids = [], [], []
        for oi in order:
            i, j = int(iu[0][oi]), int(iu[1][oi])
            uvi, uvj, tr = self._pair_correspondences(i, j)
            x0, x1, valid = self._pad_pair(uvi, uvj, i, j)
            cand.append((i, j, tr))
            x0s.append(x0)
            x1s.append(x1)
            valids.append(valid)
        # Fixed candidate capacity (padding rows are all-invalid).
        nc = cfg.init_candidates
        while len(x0s) < nc:
            x0s.append(x0s[-1])
            x1s.append(x1s[-1])
            valids.append(np.zeros_like(valids[-1]))
        f = float(self.intr[cand[0][0], 0])
        out = _init_pairs_batched(
            gen, self._dev(np.stack(x0s)), self._dev(np.stack(x1s)),
            self._dev(np.stack(valids)), cfg.ransac_iters, cfg.essential_thresh_px / f,
        )
        R_b, t_b, X_b, good_b, n_inl_b, ang_b = _to_host(out)
        best = None
        for ci, (i, j, tr) in enumerate(cand):
            good_np = good_b[ci][: len(tr)]
            n_good = int(good_np.sum())
            if n_good < cfg.min_init_matches:
                continue
            ang = ang_b[ci][: len(tr)][good_np]
            med_ang = float(np.median(ang)) if len(ang) else 0.0
            if med_ang < cfg.min_tri_angle_deg:
                continue
            score = n_good * min(med_ang, 20.0)
            if best is None or score > best[0]:
                best = (score, i, j, R_b[ci], t_b[ci], X_b[ci], good_np, tr)
        return None if best is None else best[1:]

    def _pad_pair(self, uvi, uvj, i, j):
        n = self.N
        x0 = np.zeros((n, 2), np.float32)
        x1 = np.zeros((n, 2), np.float32)
        valid = np.zeros(n, bool)
        m = len(uvi)
        x0[:m] = _np_pixel_to_normal(self.intr[i], uvi)
        x1[:m] = _np_pixel_to_normal(self.intr[j], uvj)
        valid[:m] = True
        return x0, x1, valid

    def bootstrap(self, gen):
        i, j, R, t, X, good, tr = self.select_init_pair(gen)
        self.gauge_cam = i
        self.registered[[i, j]] = True
        self.aa[i] = 0.0
        self.t[i] = 0.0
        self.aa[j] = lie.so3_log(torch.as_tensor(R)).numpy()
        self.t[j] = np.asarray(t)
        tr_good = tr[good]
        self.points[tr_good] = np.asarray(X)[: len(tr)][good]
        self.point_active[tr_good] = True
        # Activate the seed observations.
        rows = self._rows_of_tracks(tr_good)
        sel = rows[np.isin(self.obs_cam[rows], [i, j])]
        self.obs_inlier[sel] = True
        self.n_registered = 2
        self._reg_order += [i, j]
        self._mark_dirty_view(i)
        self._mark_dirty_view(j)
        self.log.append(f"bootstrap views ({i},{j}): {len(tr_good)} seed points")
        self.progress("reconstruction", 2.0 / self.V)

    def seed_from_scene(self, scene) -> int:
        """EXISTING_POSES initialization (parity: ESfMSceneInitializer::
        INITIALIZE_EXISTING_POSES, sparseBuilder.cpp:188-193): seed the
        engine from a previously reconstructed scene over the SAME track
        table (the staged workspace resume case — same matches produce the
        same track ids), so run() registers only the remaining views.

        Returns the number of seeded views."""
        reg = _to_host(scene.cam_mask)[: self.V]
        if reg.sum() < 2:
            return 0
        self.registered[: len(reg)] = reg
        self.aa[reg] = _to_host(scene.cam_rot)[: self.V][reg]
        self.t[reg] = _to_host(scene.cam_t)[: self.V][reg]
        si = _to_host(scene.intr)[: self.V]
        self.intr[reg] = si[reg]
        pm = _to_host(scene.point_mask)
        n = min(len(pm), len(self.point_active))
        self.point_active[:n] = pm[:n]
        self.points[:n][pm[:n]] = _to_host(scene.points)[:n][pm[:n]]
        # Re-activate observations supported by the seeded map.
        sel = (
            self.registered[self.obs_cam]
            & self.point_active[self.obs_pt]
            & self.obs_ok
        )
        self.obs_inlier |= sel
        self.gauge_cam = int(np.nonzero(reg)[0][0])
        self.n_registered = int(reg.sum())
        for v in np.nonzero(reg)[0]:
            self._reg_order.append(int(v))
            self._mark_dirty_view(int(v))
        self.log.append(
            f"seeded from existing scene: {self.n_registered} views, "
            f"{int(self.point_active.sum())} points"
        )
        return self.n_registered

    def next_views(self, k: int):
        """Up to k unregistered views, best-first by active-point count.

        The best candidate only needs enough 2D-3D support to possibly pass
        the PnP inlier gate; further batch members must be *comfortably*
        supported (2x the gate) — weakly-supported views register later,
        after intermediate triangulation has grown the map (preserving the
        sequential schedule's behavior where it matters)."""
        score = np.zeros(self.V, np.int64)
        usable = self.point_active[self.obs_pt] & self.obs_ok
        np.add.at(score, self.obs_cam[usable], 1)
        score[self.registered | self.barred] = -1
        order = np.argsort(score)[::-1][:k]
        gate = self.cfg.min_pnp_inliers
        out = [int(v) for v in order[:1] if score[v] >= gate]
        out += [int(v) for v in order[1:] if score[v] >= 2 * gate]
        return out

    def register_views(self, views, gen):
        """PnP-RANSAC registration of a batch of views against the current
        map in one batched device call (each resection is independent
        given the map, so batching preserves per-view results).

        Returns the number of views accepted."""
        cfg = self.cfg
        n = self.N
        B = cfg.register_batch  # fixed batch capacity, as in the reference
        X = np.zeros((B, n, 3), np.float32)
        xn = np.zeros((B, n, 2), np.float32)
        valid = np.zeros((B, n), bool)
        threshs = np.full(B, 1e-2, np.float32)
        rows_per = []
        for bi, v in enumerate(views):
            vr = self._view_rows(v)
            seg = slice(self._view_start[v], self._view_start[v + 1])
            rows = vr[self.point_active[self.obs_pt[seg]] & self.obs_ok[seg]]
            m = min(len(rows), n)
            X[bi, :m] = self.points[self.obs_pt[rows[:m]]]
            xn[bi, :m] = _np_pixel_to_normal(self.intr[v], self.obs_uv[rows[:m]])
            valid[bi, :m] = True
            threshs[bi] = cfg.pnp_thresh_px / float(self.intr[v, 0])
            rows_per.append(rows[:m])
        out = pnp_mod.pnp_ransac(
            gen, self._dev(X), self._dev(xn), self._dev(valid),
            n_iters=cfg.pnp_iters, thresh_norm=self._dev(threshs), minimal=cfg.pnp_minimal,
        )
        # One batched host readback per register batch.
        aa_b, t_b, inl_b, n_inl_b = _to_host(out)
        accepted = 0
        for bi, v in enumerate(views):
            n_inl = int(n_inl_b[bi])
            if n_inl < cfg.min_pnp_inliers:
                self.log.append(
                    f"view {v}: dropped ({n_inl} PnP inliers < {cfg.min_pnp_inliers})"
                )
                self.barred[v] = True
                continue
            self.registered[v] = True
            self.aa[v] = aa_b[bi]
            self.t[v] = t_b[bi]
            rows = rows_per[bi]
            self.obs_inlier[rows[inl_b[bi, : len(rows)]]] = True
            self.n_registered += 1
            accepted += 1
            self._reg_order.append(int(v))
            self._mark_dirty_view(int(v))
            self.log.append(f"view {v}: registered with {n_inl} PnP inliers")
        return accepted

    def triangulate_new(self):
        """Triangulate dirty inactive tracks with >= 2 registered views.

        Incremental worklist: only tracks marked dirty — touched by a
        registration or starved by washing since the last call — are
        considered, so per-cycle cost follows the new work, not the map
        size.  Tracks failing
        the reprojection/angle gates are retried up to twice, then parked
        until a new view registration re-dirties them (registration is the
        only event that can add parallax)."""
        cfg = self.cfg
        Vm = cfg.max_views_per_track
        cand_tracks = np.nonzero(self._tri_dirty & ~self.point_active)[0]
        if len(cand_tracks) == 0:
            return 0
        rows_all = self._rows_of_tracks(cand_tracks)
        usable = self.registered[self.obs_cam[rows_all]] & self.obs_ok[rows_all]
        cand_rows = rows_all[usable]
        self._tri_dirty[cand_tracks] = False  # re-marked below if retrying
        if len(cand_rows) == 0:
            return 0
        # Group rows by track, widest-baseline observations first: tracks
        # longer than max_views_per_track truncate, so order each group by
        # camera-center distance from the group centroid (descending) —
        # the truncated subset keeps the widest-baseline views instead of
        # an arbitrary first-Vm (better-conditioned triangulation).
        from scipy.spatial.transform import Rotation

        reg_views = np.unique(self.obs_cam[cand_rows])
        R_reg = Rotation.from_rotvec(self.aa[reg_views]).as_matrix()
        centers_v = np.zeros((self.V, 3))
        centers_v[reg_views] = -np.einsum("vij,vi->vj", R_reg, self.t[reg_views])
        c_obs = centers_v[self.obs_cam[cand_rows]]
        pts0 = self.obs_pt[cand_rows]
        # Compact local track indexing (host cost follows the worklist).
        loc_of = self._pt_map_scratch
        loc_of[cand_tracks] = np.arange(len(cand_tracks), dtype=np.int32)
        pl = loc_of[pts0]
        nl = len(cand_tracks)
        cnt = np.bincount(pl, minlength=nl)[:, None]
        centroid = np.zeros((nl, 3))
        np.add.at(centroid, pl, c_obs)
        centroid = centroid / np.maximum(cnt, 1)
        dist = np.linalg.norm(c_obs - centroid[pl], axis=1)
        order = np.lexsort((-dist, pl))
        loc_of[cand_tracks] = -1  # restore scratch
        rows = cand_rows[order]
        pts = self.obs_pt[rows]
        uniq, starts, counts = np.unique(pts, return_index=True, return_counts=True)
        sel = counts >= 2
        uniq, starts, counts = uniq[sel], starts[sel], counts[sel]
        if len(uniq) == 0:
            return 0
        Tb = len(uniq)
        # Batch capacity: the next power-of-two bucket >= 1024 (the
        # reference's; padding rows are masked out).
        cap = 1024
        while cap < Tb:
            cap *= 2
        view_idx = np.zeros((cap, Vm), np.int32)
        uv = np.zeros((cap, Vm, 2), np.float32)
        vmask = np.zeros((cap, Vm), bool)
        # Vectorized group fill: element k of the expanded range belongs to
        # group grp[k] at in-group position off[k]; positions >= Vm truncate.
        grp = np.repeat(np.arange(Tb), counts)
        off = np.arange(len(grp)) - np.repeat(np.cumsum(counts) - counts, counts)
        row_pos = np.repeat(starts, counts) + off
        keep_pos = off < Vm
        g = grp[keep_pos]
        p_ = off[keep_pos]
        rr = rows[row_pos[keep_pos]]
        view_idx[g, p_] = self.obs_cam[rr]
        uv[g, p_] = self.obs_uv[rr]
        vmask[g, p_] = True
        X, max_err, angle = _to_host(_triangulate_tracks(
            self._dev(self.aa), self._dev(self.t), self._dev(self.intr),
            self._dev(view_idx), self._dev(uv), self._dev(vmask),
        ))
        X = X[:Tb]
        ok = (
            (max_err[:Tb] < cfg.reproj_outlier_px)
            & (angle[:Tb] > cfg.min_tri_angle_deg)
            & np.isfinite(X).all(axis=-1)
        )
        new_tracks = uniq[ok]
        self.points[new_tracks] = np.asarray(X)[ok]
        self.point_active[new_tracks] = True
        # Gate-failed tracks: bounded retries, then wait for new support.
        failed = uniq[~ok]
        self._tri_fail[failed] += 1
        retry = failed[self._tri_fail[failed] <= 2]
        self._tri_dirty[retry] = True
        # Activate the new tracks' registered-view observations.
        nrows = self._rows_of_tracks(new_tracks)
        act = nrows[self.registered[self.obs_cam[nrows]] & self.obs_ok[nrows]]
        self.obs_inlier[act] = True
        return int(ok.sum())

    # -- BA + washing ------------------------------------------------------

    def _scene_arrays(self):
        mask = self._obs_mask()
        return dict(
            intr=self._dev(self.intr),
            cam_rot=self._dev(self.aa),
            cam_t=self._dev(self.t),
            cam_mask=self._dev(self.registered),
            points=self._dev(self.points),
            point_mask=self._dev(self.point_active),
            obs_cam=self._dev(self.obs_cam),
            obs_pt=self._dev(self.obs_pt),
            obs_uv=self._dev(self.obs_uv),
            obs_mask=self._dev(mask),
        )

    def step_ba(self):
        """Periodic BA during registration.  Small maps refine the full map
        (existing behavior); past `ba_local_from_obs` table capacity the
        step-BA becomes a WINDOWED LOCAL solve (_run_ba_local) so per-step
        cost tracks the registration window, not the map."""
        cfg = self.cfg
        if (self.O > cfg.ba_local_from_obs
                and len(self._reg_order) > cfg.ba_local_window):
            return self._run_ba_local(cfg.step_ba_iters)
        return self.run_ba(cfg.step_ba_iters)

    def _run_ba_local(self, iters: int):
        """Local bundle adjustment (COLMAP-style): optimize the last
        `ba_local_window` registered views and every point they observe;
        ALL live observations of those points participate, with cameras
        outside the window frozen (they carry the gauge).  The subproblem
        is compacted into bucketed camera/point/obs buffers, so per-solve
        work and host<->device traffic are O(window).
        Intrinsics are never refined locally (self-calibration needs the
        global support; the final full BAs do it)."""
        cfg = self.cfg
        recent = np.asarray(sorted(set(self._reg_order[-cfg.ba_local_window:])),
                            np.int64)
        segs = []
        for v in recent:
            s, e = self._view_start[v], self._view_start[v + 1]
            seg = self.obs_pt[s:e][
                self.obs_ok[s:e] & self.obs_inlier[s:e]
                & self.point_active[self.obs_pt[s:e]]]
            segs.append(seg)
        if not segs:
            return None
        pts_local = np.unique(np.concatenate(segs))
        if len(pts_local) == 0:
            return None
        rows = self._rows_of_tracks(pts_local)
        m = (self.registered[self.obs_cam[rows]] & self.obs_ok[rows]
             & self.obs_inlier[rows])
        rows = rows[m]
        cams = np.unique(self.obs_cam[rows])
        in_window = np.isin(cams, recent)
        free = in_window.copy()
        if free.all():
            free[0] = False  # frozen cameras carry the gauge
        # Compact local index maps.
        cam_of = np.full(self.V, -1, np.int32)
        cam_of[cams] = np.arange(len(cams), dtype=np.int32)
        pt_of = self._pt_map_scratch
        pt_of[pts_local] = np.arange(len(pts_local), dtype=np.int32)
        # Bucketed capacities that only ever grow (the reference's rule).
        b = self._local_buckets
        b[0] = max(b[0], 64 * ((len(cams) + 63) // 64))
        b[1] = max(b[1], 4096 * ((len(pts_local) + 4095) // 4096))
        b[2] = max(b[2], 32768 * ((len(rows) + 32767) // 32768))
        Cl, Pl, Ol = b
        intr_l = np.zeros((Cl, self.intr.shape[1]), np.float32)
        aa_l = np.zeros((Cl, 3), np.float32)
        t_l = np.zeros((Cl, 3), np.float32)
        cmask = np.zeros(Cl, bool)
        cfree = np.zeros(Cl, bool)
        intr_l[: len(cams)] = self.intr[cams]
        aa_l[: len(cams)] = self.aa[cams]
        t_l[: len(cams)] = self.t[cams]
        cmask[: len(cams)] = True
        cfree[: len(cams)] = free
        pts_l = np.zeros((Pl, 3), np.float32)
        pmask = np.zeros(Pl, bool)
        pts_l[: len(pts_local)] = self.points[pts_local]
        pmask[: len(pts_local)] = True
        ocam = np.zeros(Ol, np.int32)
        # Padding keeps obs_pt non-decreasing (assume_sorted contract).
        opt = np.full(Ol, max(len(pts_local) - 1, 0), np.int32)
        ouv = np.zeros((Ol, 2), np.float32)
        omask = np.zeros(Ol, bool)
        ocam[: len(rows)] = cam_of[self.obs_cam[rows]]
        opt[: len(rows)] = pt_of[self.obs_pt[rows]]
        ouv[: len(rows)] = self.obs_uv[rows]
        omask[: len(rows)] = True
        pt_of[pts_local] = -1  # restore scratch
        # The track-CSR row gathering yields a point-sorted, densely relabeled
        # table, so the kernel path skips its per-solve sort.
        bcfg = dataclasses.replace(self.cfg.ba, fix_first_cam=False, refine_intrinsics=False,
                                   assume_sorted=True)
        _, rot, t, pts, info = _to_host(ba.bundle_adjust(
            cfg=bcfg, max_iters=iters,
            intr=self._dev(intr_l), cam_rot=self._dev(aa_l),
            cam_t=self._dev(t_l), cam_mask=self._dev(cmask),
            points=self._dev(pts_l), point_mask=self._dev(pmask),
            obs_cam=self._dev(ocam), obs_pt=self._dev(opt),
            obs_uv=self._dev(ouv), obs_mask=self._dev(omask),
            cam_free_mask=self._dev(cfree),
        ))
        upd = cams[free]
        self.aa[upd] = rot[: len(cams)][free]
        self.t[upd] = t[: len(cams)][free]
        self.points[pts_local] = pts[: len(pts_local)]
        return info

    def run_ba(self, iters: int):
        # Self-calibration gate: refining intrinsics off 2-3 registered
        # views is degenerate (focal/depth trade freely on a near-planar
        # bootstrap); freeze intrinsics until the map has enough views.
        refine = self.cfg.ba.refine_intrinsics and int(self.registered.sum()) >= 4
        cfg = dataclasses.replace(self.cfg.ba,
                                  fix_first_cam=False, refine_intrinsics=refine)
        free = self.registered.copy()
        free[self.gauge_cam] = False
        args = self._scene_arrays()
        kw = {}
        if self.cam_group is not None:
            kw = dict(cam_group=self._dev(self.cam_group), n_groups=self.n_groups)
        intr, rot, t, pts, info = _to_host(ba.bundle_adjust(
            cfg=cfg, max_iters=iters, cam_free_mask=self._dev(free), **args, **kw))
        # One batched host readback per BA call.
        self.aa = np.array(rot)
        self.t = np.array(t)
        self.points = np.array(pts)
        if refine:
            self.intr = np.array(intr)
        return info

    def _np_reproj_errors(self, rows=None) -> np.ndarray:
        """Host-side reprojection errors over the obs table (numpy, as in
        the reference).  `rows` limits
        the computation to a subset of obs rows (washing only ever needs
        the live rows; the full-table sweep is O(capacity) per call)."""
        from scipy.spatial.transform import Rotation

        ocam = self.obs_cam if rows is None else self.obs_cam[rows]
        opt = self.obs_pt if rows is None else self.obs_pt[rows]
        ouv = self.obs_uv if rows is None else self.obs_uv[rows]
        R = Rotation.from_rotvec(self.aa).as_matrix()  # (V, 3, 3)
        Xc = (
            np.einsum("oij,oj->oi", R[ocam], self.points[opt])
            + self.t[ocam]
        )
        z = Xc[:, 2:3]
        xn = Xc[:, :2] / np.where(np.abs(z) < 1e-9, 1e-9, z)
        intr = self.intr[ocam]
        k = intr[:, 4:7]
        r2 = np.sum(xn * xn, axis=-1, keepdims=True)
        scale = 1.0 + r2 * (k[:, 0:1] + r2 * (k[:, 1:2] + r2 * k[:, 2:3]))
        uv = xn * scale * intr[:, :2] + intr[:, 2:4]
        return np.linalg.norm(uv - ouv, axis=-1)

    def recover_observations(self) -> int:
        """Re-admit washed-out observations that fit the CURRENT (refined)
        camera model within the wash threshold.  Complements wash_outliers:
        washing is greedy against the model of its time; after
        self-calibration refines distortion, periphery observations washed
        for pre-calibration residuals become inliers again."""
        errs = self._np_reproj_errors()
        cand = (
            self._obs_real
            & self.registered[self.obs_cam]
            & self.point_active[self.obs_pt]
            & ~(self.obs_ok & self.obs_inlier)
            & (errs < self.cfg.reproj_outlier_px)
        )
        self.obs_ok[cand] = True
        self.obs_inlier[cand] = True
        return int(cand.sum())

    def wash_outliers(self):
        """Deactivate high-residual observations and starved points
        (parity: the engine-internal outlier rejection, SURVEY.md §3.2)."""
        rows = np.nonzero(self._obs_mask())[0]
        errs = self._np_reproj_errors(rows)
        bad = rows[errs > self.cfg.reproj_outlier_px]
        self.obs_ok[bad] = False
        self.obs_inlier[bad] = False
        # Deactivate points with < 2 surviving observations; mark them for
        # retriangulation once new support arrives.
        alive = self._obs_mask()
        cnt = np.bincount(self.obs_pt[alive], minlength=len(self.point_active))
        starved = self.point_active & (cnt < 2)
        self.point_active[starved] = False
        starved_ids = np.nonzero(starved)[0]
        self._tri_dirty[starved_ids] = True
        self._tri_fail[starved_ids] = 0
        return int(len(bad)), int(starved.sum())

    # -- main loop ---------------------------------------------------------

    def _timed(self, name, fn, *a, **k):
        import time as _time

        t0 = _time.time()
        out = fn(*a, **k)
        self.timings[name] = self.timings.get(name, 0.0) + (_time.time() - t0)
        return out

    def run(self, gen: torch.Generator | None = None) -> Scene:
        cfg = self.cfg
        if self.n_registered >= 2:
            # EXISTING_POSES resume (seed_from_scene): skip the two-view
            # bootstrap and go straight to registering remaining views.
            pass
        else:
            try:
                self.bootstrap(gen)
            except NoInitialPair as e:
                # Graceful degradation (the reference crash-exits via
                # ensure(), common.h:13-23): an unreconstructable input
                # produces an empty scene + log entry, and the service
                # reports it as a stage error.
                self.log.append(f"reconstruction aborted: {e}")
                self.progress("reconstruction", 1.0)
                return self.to_scene()
        self._timed("triangulate", self.triangulate_new)
        self._timed("step_ba", self.step_ba)
        self._timed("wash", self.wash_outliers)

        since_ba = 0
        max_steps = 3 * self.V  # hard stop: every view gets ~3 attempts
        steps = 0
        while self.n_registered < self.V and steps < max_steps:
            steps += 1
            views = self._timed("next_views", self.next_views, cfg.register_batch)
            if not views:
                # Out of candidates.  If some views were dropped earlier,
                # refine the map (BA + wash) and give them another chance —
                # the map has since grown by other registrations.
                if self.barred.any() and self.n_registered > 2:
                    if since_ba > 0:
                        self._timed("step_ba", self.step_ba)
                        self._timed("wash", self.wash_outliers)
                        since_ba = 0
                    self.barred[:] = False
                    views = self._timed("next_views", self.next_views,
                                        cfg.register_batch)
                if not views:
                    break
            # Batched resection: views failing the inlier gate are barred
            # inside register_views (frame-drop parity,
            # SequentialActuator.h:193-196) and retried after the map grows.
            accepted = self._timed("register", self.register_views, views, gen)
            if accepted == 0:
                continue
            self._timed("triangulate", self.triangulate_new)
            since_ba += accepted
            if since_ba >= cfg.ba_every:
                self._timed("step_ba", self.step_ba)
                self._timed("wash", self.wash_outliers)
                since_ba = 0
            self.progress("reconstruction", self.n_registered / self.V)
            # Give previously dropped views another chance once the map grew.
            if self.barred.any() and since_ba == 0:
                self.barred[:] = False

        info = self._timed("final_ba", self.run_ba, cfg.final_ba_iters)
        self._timed("wash", self.wash_outliers)
        self._timed("final_ba", self.run_ba, cfg.step_ba_iters)
        if self.cfg.ba.refine_intrinsics:
            # Observation-recovery pass (COLMAP-style iterative refinement):
            # pre-calibration residuals at the image periphery exceed the
            # wash threshold (a k1 of -0.2 is ~10 px at the corners), so the
            # very observations that best constrain distortion get washed
            # before self-calibration converges.  Re-admit any washed
            # observation that fits the refined RADIAL3 model, then re-run
            # BA on the recovered support.
            recovered = self.recover_observations()
            if recovered:
                self.run_ba(cfg.step_ba_iters)
                self.wash_outliers()
                self.run_ba(cfg.step_ba_iters)
                self.log.append(f"recovered {recovered} observations after "
                                "self-calibration")
        self.log.append(
            f"final: {self.n_registered}/{self.V} views, "
            f"{int(self.point_active.sum())} points, cost {float(info['final_cost']):.1f}"
        )
        self.log.append("phase seconds: " + ", ".join(
            f"{k}={v:.2f}" for k, v in sorted(self.timings.items())))
        self.progress("reconstruction", 1.0)
        return self.to_scene()

    def to_scene(self) -> Scene:
        sc = empty_scene(self.V, len(self.points), self.O, self.device)
        return sc.replace(**self._scene_arrays())

    def colorize(self, scene: Scene, images: np.ndarray) -> Scene:
        """Mean track color (parity: ColorizeTracks, sparseBuilder.cpp:1620).
        images: (V, H, W, 3) uint8."""
        images = np.asarray(images)
        mask = _to_host(scene.obs_mask)
        acc = np.zeros((len(self.points), 3), np.float64)
        cnt = np.zeros(len(self.points), np.int64)
        uv = np.clip(
            self.obs_uv.astype(int),
            0,
            [images.shape[2] - 1, images.shape[1] - 1],
        )
        rows = np.nonzero(mask)[0]
        samples = images[self.obs_cam[rows], uv[rows, 1], uv[rows, 0]].astype(np.float64)
        np.add.at(acc, self.obs_pt[rows], samples)
        np.add.at(cnt, self.obs_pt[rows], 1)
        colors = (acc / np.maximum(cnt[:, None], 1)).astype(np.uint8)
        return scene.replace(colors=self._dev(colors))
