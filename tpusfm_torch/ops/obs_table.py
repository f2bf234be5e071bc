"""Observation-table primitives of the bundle-adjustment kernel path:
wrappers of the CUDA kernels K2, K3 and K4 and their plain PyTorch twins.

Port of the part of ``tpusfm/ops/obs_table.py`` that ``_lm_pallas`` runs
for a single-device solve with intrinsics held:

- ``sort_and_rank_payload`` (XLA in the reference, plain torch here): the
  per-solve point sort and rank compaction of the observation table;
- ``linearize_reduce_radial3_t`` (K2): RADIAL3 residuals, closed-form pose
  and point Jacobians, Huber IRLS weights and cost for every observation,
  reduced to packed per-camera and per-rank normal-equation rows, with the
  Schur coupling blocks W written per observation;
- ``schur_mv_t`` (K3): the Schur matvec of one CG iteration,
  S v = Hcc_d v - W Hpp^-1 W^T v, returning W^T v per rank as well;
- ``schur_bwd_t`` (K4): out[n] = sum over the observations of id n of
  W_o z[rank_o].

Each wrapper keeps the reference's name, argument order and return
contract.  For CPU tensors it returns its twin ``<name>_reference``; for
CUDA tensors it launches the kernel of ``csrc/ba_linearize.cu`` or
``csrc/ba_schur.cu`` or raises.  The kernels reach rows through two index
layouts (``ObsLayout``): the rows of each rank (the table is rank-sorted,
so a range) and the rows of each camera (a stable permutation).  A solve
builds the layout once and passes it to every call; a call without one
builds its own.

Conventions shared with the reference: the table is sorted by rank; a row
whose rank is >= the rank-table size (invalid rows carry 2^30) reads a
zero point and adds nothing to any per-rank sum; a row whose camera (or
segment) id is outside [0, n) adds nothing to any per-camera sum.  Ranks
need not be dense.
"""

from __future__ import annotations

import dataclasses

import torch

from . import cuda_build

INVALID_RANK = 2 ** 30
LIN_CAM_DIM = 21  # per-camera row: [t (3) | R row-major (9) | Jr row-major (9)]
Z_EPS = 1e-8      # |z| floor of the projection (obs_table.py:1377)

# Kernel launches (one per wrapper call) since the last reset.
LAUNCHES = {"linearize_reduce_radial3_t": 0, "schur_mv_t": 0, "schur_bwd_t": 0}


# ---------------------------------------------------------------------------
# Packed symmetric layouts (reference obs_table.py:1417-1436)
# ---------------------------------------------------------------------------

def _pack_pos(n):
    pos, k = {}, 0
    for i in range(n):
        for j in range(i, n):
            pos[(i, j)] = k
            k += 1
    return pos


def _full_idx(n):
    """Gather indices rebuilding a full (n, n) block from packed
    upper-triangular columns ((i, j), j >= i, row-major)."""
    pos = _pack_pos(n)
    return tuple(pos[(min(i, j), max(i, j))] for i in range(n) for j in range(n))


_FULL66 = _full_idx(6)   # 36 ints into 21 packed columns
_FULL33 = _full_idx(3)   # 9 ints into 6 packed columns
_FULL77 = _full_idx(7)   # 49 ints into 28 packed columns


# ---------------------------------------------------------------------------
# Sort and rank (plain torch: XLA in the reference)
# ---------------------------------------------------------------------------

def sort_and_rank_payload(seg_ids: torch.Tensor, valid: torch.Tensor, n_segments: int,
                          payloads: tuple):
    """Stable sort of the table by segment id, invalid rows last, carrying
    payload columns; ranks are the sorted ids compacted to 0, 1, 2, ...
    and invalid rows get rank 2^30.

    Returns (payloads_sorted, seg_sorted, ranks, rank_to_seg, rank_valid);
    seg_sorted is the sorted id column (junk where invalid), rank_to_seg
    (n_segments,) the id of each rank (0 where not rank_valid)."""
    dev = seg_ids.device
    seg = seg_ids.to(torch.int32)
    key = torch.where(valid, seg, torch.full_like(seg, INVALID_RANK))
    key_s, order = torch.sort(key, stable=True)
    seg_sorted = seg[order]
    payloads_s = tuple(p[order] for p in payloads)
    valid_s = key_s < INVALID_RANK
    newflag = torch.ones_like(key_s)
    newflag[1:] = (key_s[1:] != key_s[:-1]).to(torch.int32)
    ranks = (torch.cumsum(newflag, 0, dtype=torch.int32) - 1)
    ranks = torch.where(valid_s, ranks, torch.full_like(ranks, INVALID_RANK))
    ranks_c = torch.clamp(ranks, max=n_segments).long()
    rank_to_seg = torch.zeros(n_segments + 1, dtype=torch.int32, device=dev).scatter_(
        0, ranks_c, seg_sorted)[:n_segments]
    rank_valid = torch.zeros(n_segments + 1, dtype=torch.bool, device=dev).scatter_(
        0, ranks_c, valid_s)[:n_segments]
    return payloads_s, seg_sorted, ranks, rank_to_seg, rank_valid


# ---------------------------------------------------------------------------
# Row layouts the kernels index through
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ObsLayout:
    """rank_start (p + 1,) int32: rows [rank_start[r], rank_start[r + 1])
    hold rank r (the table is rank-sorted).  seg_perm (O,) int32 and
    seg_start (n + 1,) int32: seg_perm[seg_start[c]:seg_start[c + 1]] are
    the rows of segment c in increasing row order; rows with an id outside
    [0, n) sort past seg_start[n]."""
    rank_start: torch.Tensor | None
    seg_perm: torch.Tensor
    seg_start: torch.Tensor


def obs_layout(seg_ids: torch.Tensor, n: int, ranks: torch.Tensor | None = None,
               p: int | None = None) -> ObsLayout:
    """The layout of a table: the rows of each of the n segments of
    `seg_ids` (a stable sort keeps each segment's rows in increasing order)
    and, when `ranks` (rank-sorted) is given, the row range of each of p
    ranks."""
    i = seg_ids.to(torch.int32)
    key = torch.where((i >= 0) & (i < n), i, torch.full_like(i, n))
    key_s, perm = torch.sort(key, stable=True)
    q = torch.arange(n + 1, dtype=torch.int32, device=i.device)
    rank_start = None
    if ranks is not None:
        qr = torch.arange(p + 1, dtype=torch.int32, device=i.device)
        rank_start = torch.searchsorted(ranks.to(torch.int32).contiguous(), qr).to(torch.int32)
    return ObsLayout(rank_start=rank_start, seg_perm=perm.to(torch.int32),
                     seg_start=torch.searchsorted(key_s, q).to(torch.int32))


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _w_torch_dtype(w_dtype: str) -> torch.dtype:
    if w_dtype not in ("bf16", "f32"):
        raise ValueError(f"w_dtype must be 'bf16' or 'f32', got {w_dtype!r}")
    return torch.bfloat16 if w_dtype == "bf16" else torch.float32


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with a zero row wherever idx is outside [0, len(table))."""
    n = table.shape[0]
    idx = idx.long()
    ok = (idx >= 0) & (idx < n)
    rows = table[torch.where(ok, idx, torch.zeros_like(idx))]
    return torch.where(ok.reshape(-1, *([1] * (table.dim() - 1))), rows, torch.zeros_like(rows))


def _segsum_drop(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Sum rows of vals by id into (n, ...); ids outside [0, n) are dropped."""
    ids = ids.long()
    ok = (ids >= 0) & (ids < n)
    out = torch.zeros((n + 1,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, torch.where(ok, ids, torch.full_like(ids, n)), vals)[:n]


def linearize_math(camg, intg, X, uv, w_in, huber_delta: float):
    """Per-observation RADIAL3 linearization (reference ``_linearize_math``
    with refine=False): gathered camg (O, 21), intg (O, 7), X (O, 3),
    uv (O, 2), w_in (O,) -> camvals (O, 28) [Hcc packed 21 | gc 6 | cost],
    ptvals (O, 9) [Hpp packed 6 | gp 3], wc (O, 18) with wc[:, d*3+k] =
    (Jc^T Jp)[d, k].  Jacobians and residuals carry the Huber IRLS weight
    times w_in; rows with w_in <= 0 give exact zeros."""
    Rm = camg[:, 3:12].reshape(-1, 3, 3)
    Jr = camg[:, 12:21].reshape(-1, 3, 3)
    Xc = torch.einsum("oij,oj->oi", Rm, X) + camg[:, 0:3]
    z = Xc[:, 2]
    zs = torch.where(torch.abs(z) < Z_EPS, torch.where(z < 0, -Z_EPS, Z_EPS).to(z.dtype), z)
    iz = 1.0 / zs
    valid = w_in > 0
    x = torch.where(valid, Xc[:, 0] * iz, torch.zeros_like(z))
    y = torch.where(valid, Xc[:, 1] * iz, torch.zeros_like(z))
    r2 = x * x + y * y
    fx, fy, cx, cy, k1, k2, k3 = intg.unbind(-1)
    dist = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    de = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)
    ru = fx * x * dist + cx - uv[:, 0]
    rv = fy * y * dist + cy - uv[:, 1]
    nrm = torch.sqrt(ru * ru + rv * rv)
    w = torch.sqrt(torch.clamp(huber_delta / torch.clamp(nrm, min=1e-12), max=1.0)) * w_in
    au = fx * (dist + 2.0 * x * x * de)
    bu = 2.0 * fx * x * y * de
    cv = 2.0 * fy * x * y * de
    dv = fy * (dist + 2.0 * y * y * de)
    L = torch.stack([torch.stack([au * iz, bu * iz, -(au * x + bu * y) * iz], -1),
                     torch.stack([cv * iz, dv * iz, -(cv * x + dv * y) * iz], -1)], 1)
    # dXc/daa = -(R [X]x) Jr; dXc/dX = R.
    RX = torch.einsum("oij,ojk->oik", Rm, _hat(X))
    N = -torch.einsum("oij,ojk->oik", RX, Jr)
    Jc = torch.cat([L @ N, L], -1) * w[:, None, None]          # (O, 2, 6)
    Jp = (L @ Rm) * w[:, None, None]                           # (O, 2, 3)
    r = torch.stack([ru, rv], -1) * w[:, None]
    iu6, ju6 = torch.triu_indices(6, 6)
    iu3, ju3 = torch.triu_indices(3, 3)
    Hcc = torch.einsum("oki,okj->oij", Jc, Jc)[:, iu6, ju6]
    gc = torch.einsum("oki,ok->oi", Jc, r)
    hcost = torch.where(nrm <= huber_delta, 0.5 * nrm * nrm, huber_delta * (nrm - 0.5 * huber_delta))
    cost = torch.where(valid, hcost * w_in, torch.zeros_like(hcost))
    Hpp = torch.einsum("oki,okj->oij", Jp, Jp)[:, iu3, ju3]
    gp = torch.einsum("oki,ok->oi", Jp, r)
    wc = torch.einsum("oki,okj->oij", Jc, Jp).reshape(-1, 18)
    return torch.cat([Hcc, gc, cost[:, None]], 1), torch.cat([Hpp, gp], 1), wc


def _hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _check_refine(refine: bool):
    if refine:
        raise NotImplementedError(
            "linearize_reduce_radial3_t: the refine mode (intrinsic-group outputs) is not "
            "ported yet; it comes with kernel K5 (schur_fwd_t)")


def linearize_reduce_radial3_t_reference(camtab, grptab, pts_rank, obs_cam, obs_grp, ranks,
                                         obs_uvT, obs_w, refine: bool = False,
                                         refine_mask: tuple = (0.0,) * 7,
                                         huber_delta: float = 4.0, w_dtype: str = "f32"):
    """Plain twin of K2 in the dtype of `camtab` (float32, or float64 as an
    oracle).  Returns camred (C, 28) [Hcc packed 21 | gc 6 | cost],
    ptred (P, 9) [Hpp packed 6 | gp 3] by rank, wcT (18, O) in w_dtype."""
    _check_refine(refine)
    dt = camtab.dtype
    C, P = camtab.shape[0], pts_rank.shape[0]
    cam_ok = (obs_cam >= 0) & (obs_cam < C) & (obs_grp >= 0) & (obs_grp < grptab.shape[0])
    w_in = torch.where(cam_ok, obs_w.to(dt), torch.zeros((), dtype=dt, device=camtab.device))
    camvals, ptvals, wc = linearize_math(
        _gather_rows(camtab, obs_cam), _gather_rows(grptab.to(dt), obs_grp),
        _gather_rows(pts_rank.to(dt), ranks), obs_uvT.to(dt).T, w_in, huber_delta)
    camred = _segsum_drop(camvals, obs_cam, C)
    ptred = _segsum_drop(ptvals, ranks, P)
    return camred, ptred, wc.T.to(_w_torch_dtype(w_dtype))


def _wmat(wT: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(3D, O) coupling table -> (O, D, 3) in dtype dt."""
    dd3, o = wT.shape
    return wT.to(dt).T.reshape(o, dd3 // 3, 3)


def schur_bwd_t_reference(wT, obs_cam, idx_sorted, ztab, n: int):
    """Plain twin of K4: out (n, D) = sum_o [obs_cam_o = n] W_o z[rank_o],
    in the dtype of `ztab`."""
    W = _wmat(wT, ztab.dtype)
    zg = _gather_rows(ztab, idx_sorted)
    return _segsum_drop(torch.einsum("odk,ok->od", W, zg), obs_cam, n)


def schur_mv_t_reference(wT, obs_cam, idx_sorted, vtab, hinv_rank, p: int, hcc_d=None):
    """Plain twin of K3, in the dtype of `vtab`: y = W^T v per rank (p, 3),
    z = Hpp^-1 y, bc = W z per camera; returns (bc, y), or (hcc_d v - bc,
    y) when hcc_d (C, 6, 6) is given."""
    dt = vtab.dtype
    W = _wmat(wT, dt)
    vg = _gather_rows(vtab, obs_cam)
    y = _segsum_drop(torch.einsum("odk,od->ok", W, vg), idx_sorted, p)
    z = torch.einsum("pij,pj->pi", hinv_rank.to(dt), y)
    bc = schur_bwd_t_reference(wT, obs_cam, idx_sorted, z, vtab.shape[0])
    if hcc_d is not None:
        bc = torch.einsum("cij,cj->ci", hcc_d.to(dt), vtab) - bc
    return bc, y


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _dispatch(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch), False for CPU tensors (twin)."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _check_shape(name: str, t: torch.Tensor, shape: tuple):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def _layout_for(layout, seg_ids, n, ranks, p, need_ranks: bool) -> ObsLayout:
    if layout is None:
        return obs_layout(seg_ids, n, ranks if need_ranks else None, p)
    _check_shape("layout.seg_perm", layout.seg_perm, (seg_ids.shape[0],))
    _check_shape("layout.seg_start", layout.seg_start, (n + 1,))
    if need_ranks:
        if layout.rank_start is None:
            raise ValueError("layout has no rank_start; build it with ranks and p")
        _check_shape("layout.rank_start", layout.rank_start, (p + 1,))
    for t in (layout.seg_perm, layout.seg_start) + ((layout.rank_start,) if need_ranks else ()):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != seg_ids.device:
            raise ValueError("layout tensors must be contiguous int32 on the table's device")
    return layout


def _check_w(name: str, wT: torch.Tensor, o: int, dd3: int | None = None):
    if wT.dim() != 2 or wT.shape[1] != o or wT.shape[0] % 3 or (dd3 and wT.shape[0] != dd3):
        raise ValueError(f"{name}: wT must be (3D, {o}), got {tuple(wT.shape)}")
    if wT.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: wT must be bfloat16 or float32, got {wT.dtype}")
    if not wT.is_contiguous():
        raise ValueError(f"{name}: wT must be contiguous")


def linearize_reduce_radial3_t(camtab, grptab, pts_rank, obs_cam, obs_grp, ranks, obs_uvT,
                               obs_w, refine: bool = False, refine_mask: tuple = (0.0,) * 7,
                               huber_delta: float = 4.0, w_dtype: str = "f32", *,
                               layout: ObsLayout | None = None):
    """K2: fused linearize + reduce over a rank-sorted observation table.

    camtab (C, 21) [t | R | Jr], grptab (G, 7) RADIAL3 intrinsics,
    pts_rank (P, 3) points by rank, obs_cam / obs_grp / ranks (O,),
    obs_uvT (2, O), obs_w (O,) -> (camred (C, 28), ptred (P, 9),
    wcT (18, O) in w_dtype); see the twin.  `layout` (camera segments of
    obs_cam, rank ranges for P) saves rebuilding it per call."""
    _check_refine(refine)
    if not _dispatch("linearize_reduce_radial3_t", camtab, grptab, pts_rank, obs_cam, obs_grp,
                     ranks, obs_uvT, obs_w):
        return linearize_reduce_radial3_t_reference(
            camtab, grptab, pts_rank, obs_cam, obs_grp, ranks, obs_uvT, obs_w, refine,
            refine_mask, huber_delta, w_dtype)
    wdt = _w_torch_dtype(w_dtype)
    C, G, P, O = camtab.shape[0], grptab.shape[0], pts_rank.shape[0], ranks.shape[0]
    _check_shape("camtab", camtab, (C, LIN_CAM_DIM))
    _check_shape("grptab", grptab, (G, 7))
    _check_shape("pts_rank", pts_rank, (P, 3))
    for nm, t in (("obs_cam", obs_cam), ("obs_grp", obs_grp), ("obs_w", obs_w)):
        _check_shape(nm, t, (O,))
    _check_shape("obs_uvT", obs_uvT, (2, O))
    if min(C, G, P, O) < 1:
        raise ValueError("linearize_reduce_radial3_t needs at least one camera, group, "
                         "point and observation")
    lay = _layout_for(layout, obs_cam, C, ranks, P, need_ranks=True)
    camtab, grptab, pts = _f32(camtab), _f32(grptab), _f32(pts_rank)
    cam, grp, rk = _i32(obs_cam), _i32(obs_grp), _i32(ranks)
    uvT, w = _f32(obs_uvT), _f32(obs_w)
    dev = camtab.device
    camred = torch.empty((C, 28), dtype=torch.float32, device=dev)
    ptred = torch.empty((P, 9), dtype=torch.float32, device=dev)
    wcT = torch.empty((18, O), dtype=wdt, device=dev)
    lib = cuda_build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpusfm_ba_linearize(
            camtab.data_ptr(), grptab.data_ptr(), pts.data_ptr(), cam.data_ptr(), grp.data_ptr(),
            rk.data_ptr(), uvT.data_ptr(), w.data_ptr(), lay.rank_start.data_ptr(),
            lay.seg_perm.data_ptr(), lay.seg_start.data_ptr(), C, G, P, O, float(huber_delta),
            int(wdt == torch.bfloat16), camred.data_ptr(), ptred.data_ptr(), wcT.data_ptr(),
            stream)
    cuda_build.check(lib, err, "linearize_reduce_radial3_t launch")
    LAUNCHES["linearize_reduce_radial3_t"] += 1
    return camred, ptred, wcT


def schur_mv_t(wT, obs_cam, idx_sorted, vtab, hinv_rank, p: int, hcc_d=None, *,
               layout: ObsLayout | None = None):
    """K3: one Schur matvec over the coupling table.  wT (18, O) bf16/f32,
    obs_cam (O,), idx_sorted (O,) sorted ranks, vtab (C, 6), hinv_rank
    (p, 3, 3) damped point-block inverses by rank -> (bc (C, 6), y (p, 3))
    with bc = W Hpp^-1 W^T v per camera, or S v = hcc_d v - bc when hcc_d
    (C, 6, 6) is given, and y = W^T v per rank."""
    if not _dispatch("schur_mv_t", wT, obs_cam, idx_sorted, vtab, hinv_rank,
                     *(() if hcc_d is None else (hcc_d,))):
        return schur_mv_t_reference(wT, obs_cam, idx_sorted, vtab, hinv_rank, p, hcc_d)
    C, O = vtab.shape[0], idx_sorted.shape[0]
    _check_w("schur_mv_t", wT, O, 18)
    _check_shape("vtab", vtab, (C, 6))
    _check_shape("obs_cam", obs_cam, (O,))
    _check_shape("hinv_rank", hinv_rank, (p, 3, 3))
    if hcc_d is not None:
        _check_shape("hcc_d", hcc_d, (C, 6, 6))
    if min(C, O, p) < 1:
        raise ValueError("schur_mv_t needs at least one camera, observation and rank")
    lay = _layout_for(layout, obs_cam, C, idx_sorted, p, need_ranks=True)
    cam, rk = _i32(obs_cam), _i32(idx_sorted)
    v, hinv = _f32(vtab), _f32(hinv_rank)
    hcc = _f32(hcc_d) if hcc_d is not None else None
    dev = v.device
    out = torch.empty((C, 6), dtype=torch.float32, device=dev)
    y = torch.empty((p, 3), dtype=torch.float32, device=dev)
    z = torch.empty((p, 3), dtype=torch.float32, device=dev)
    lib = cuda_build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tpusfm_ba_schur_mv(
            wT.data_ptr(), int(wT.dtype == torch.bfloat16), cam.data_ptr(), rk.data_ptr(),
            v.data_ptr(), hinv.data_ptr(), None if hcc is None else hcc.data_ptr(),
            lay.rank_start.data_ptr(), lay.seg_perm.data_ptr(), lay.seg_start.data_ptr(),
            C, p, O, y.data_ptr(), z.data_ptr(), out.data_ptr(), stream)
    cuda_build.check(lib, err, "schur_mv_t launch")
    LAUNCHES["schur_mv_t"] += 1
    return out, y


def schur_bwd_t(wT, obs_cam, idx_sorted, ztab, n: int, *, layout: ObsLayout | None = None):
    """K4: out (n, D) = sum over observations o with obs_cam_o = n of
    W_o z[rank_o]; wT (3D, O) bf16/f32 for any D, idx_sorted (O,) ranks into
    ztab (Pz, 3).  obs_cam may be any id column (camera or group) whose
    segment layout `layout` describes."""
    if not _dispatch("schur_bwd_t", wT, obs_cam, idx_sorted, ztab):
        return schur_bwd_t_reference(wT, obs_cam, idx_sorted, ztab, n)
    O = idx_sorted.shape[0]
    _check_w("schur_bwd_t", wT, O)
    D = wT.shape[0] // 3
    if D > 8:
        raise ValueError(f"schur_bwd_t: at most 8 rows per block (3D <= 24), got D = {D}")
    Pz = ztab.shape[0]
    _check_shape("ztab", ztab, (Pz, 3))
    _check_shape("obs_cam", obs_cam, (O,))
    if min(n, O) < 1:
        raise ValueError("schur_bwd_t needs at least one segment and one observation")
    lay = _layout_for(layout, obs_cam, n, None, None, need_ranks=False)
    rk, z = _i32(idx_sorted), _f32(ztab)
    out = torch.empty((n, D), dtype=torch.float32, device=z.device)
    lib = cuda_build.kernels()
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.tpusfm_ba_schur_bwd(
            wT.data_ptr(), int(wT.dtype == torch.bfloat16), D, rk.data_ptr(), z.data_ptr(), Pz,
            lay.seg_perm.data_ptr(), lay.seg_start.data_ptr(), n, O, out.data_ptr(), stream)
    cuda_build.check(lib, err, "schur_bwd_t launch")
    LAUNCHES["schur_bwd_t"] += 1
    return out
