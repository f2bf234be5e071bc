"""Observation-table primitives of the bundle-adjustment kernel path:
wrappers of the CUDA kernels K2-K9 and their plain PyTorch twins.

Port of the part of ``tpusfm/ops/obs_table.py`` that ``_lm_pallas`` runs
for a single-device solve, and of its ops-layer entry points:

- ``sort_and_rank`` and ``sort_and_rank_payload`` (XLA in the reference,
  plain torch here): the per-solve point sort and rank compaction of the
  observation table;
- ``linearize_reduce_radial3_t`` (K2): RADIAL3 residuals, closed-form pose,
  point (and, with ``refine``, intrinsic) Jacobians, Huber IRLS weights
  and cost for every observation, reduced to packed per-camera, per-rank
  (and per-group) normal-equation rows, with the Schur coupling blocks W
  written per observation;
- ``schur_mv_t`` (K3): the Schur matvec of one CG iteration,
  S v = Hcc_d v - W Hpp^-1 W^T v, returning W^T v per rank as well;
- ``schur_bwd_t`` (K4): out[n] = sum over the observations of id n of
  W_o z[rank_o];
- ``schur_fwd_t`` (K5): y[r] = sum over the observations of rank r of
  W_o^T v[id_o];
- ``segsum_table_t`` (K6) and ``segsum_sorted_t`` (K7): segment sums of a
  (k, O) value table by unsorted id and by sorted rank;
- ``gather_table`` (K8) and ``gather_sorted`` (K9): table[idx] by unsorted
  id and by sorted rank, a zero row for ids outside the table;
- ``linearize_radial3_t`` (K2's unreduced mode) and its sublane-layout twin
  ``linearize_radial3``: K2's per-observation values, not reduced;
- ``segsum_table``, ``segsum_sorted``, ``schur_fwd`` and ``schur_bwd``: the
  reference's sublane-layout entry points of K6, K7, K5 and K4, on
  row-major (O, k) tables;
- ``seg_layout``: the segment layout of an id column (a stable counting
  sort, ``csrc/ba_layout.cu``), which ``obs_layout`` builds on the card with
  no host read.  It replaces no TPU kernel (the reference's kernels need no
  sort).

Each wrapper keeps the reference's name, argument order and return
contract.  For CPU tensors it returns its twin ``<name>_reference``; for
CUDA tensors it launches the kernel of ``csrc/ba_*.cu`` or raises.  The
kernels reach rows through index layouts (``ObsLayout``): the rows of each
rank (the table is rank-sorted, so a range) and the rows of each segment
(a stable permutation, cut into fixed chunks for the two-level sums).  A
solve builds its layouts once and passes them to every call; a call
without one builds its own.

Conventions shared with the reference: the table is sorted by rank; a row
whose rank is >= the rank-table size (invalid rows carry 2^30) reads a
zero point and adds nothing to any per-rank sum; a row whose camera (or
segment) id is outside [0, n) adds nothing to any per-camera sum.  Ranks
need not be dense.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import cuda_build

INVALID_RANK = 2 ** 30
LIN_CAM_DIM = 21  # per-camera row: [t (3) | R row-major (9) | Jr row-major (9)]
Z_EPS = 1e-8      # |z| floor of the projection (obs_table.py:1377)
CHUNK_ROWS = 2048  # rows of a segment one block sums in the two-level segment sums
MAX_W_ROWS = 9     # K4/K5 take blocks of D <= 9 rows (Brown-T2 intrinsics)
LAYOUT_MAX_N = 32768  # the largest segment count seg_layout's kernel takes

# Kernel launches (one per wrapper call) since the last reset.
LAUNCHES = {"linearize_reduce_radial3_t": 0, "schur_mv_t": 0, "schur_bwd_t": 0,
            "schur_fwd_t": 0, "segsum_table_t": 0, "segsum_sorted_t": 0,
            "gather_table": 0, "gather_sorted": 0, "linearize_radial3_t": 0, "seg_layout": 0}


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

def _sort_and_rank(seg_ids: torch.Tensor, valid: torch.Tensor, n_segments: int):
    """``sort_and_rank`` that also returns the sorted id column."""
    dev = seg_ids.device
    seg = seg_ids.to(torch.int32)
    key = torch.where(valid, seg, torch.full_like(seg, INVALID_RANK))
    key_s, order = torch.sort(key, stable=True)
    seg_sorted = seg[order]
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
    return order, seg_sorted, ranks, rank_to_seg, rank_valid


def sort_and_rank(seg_ids: torch.Tensor, valid: torch.Tensor, n_segments: int):
    """Stable sort of the table by segment id, invalid rows last; ranks are
    the sorted ids compacted to 0, 1, 2, ... and invalid rows get rank 2^30.

    Returns (order (O,), ranks (O,), rank_to_seg (n_segments,), rank_valid
    (n_segments,)): the sorting permutation, the rank of each sorted row,
    the id of each rank (0 where not rank_valid) and which ranks are real."""
    order, _, ranks, rank_to_seg, rank_valid = _sort_and_rank(seg_ids, valid, n_segments)
    return order, ranks, rank_to_seg, rank_valid


def sort_and_rank_payload(seg_ids: torch.Tensor, valid: torch.Tensor, n_segments: int,
                          payloads: tuple):
    """``sort_and_rank`` carrying payload columns through the sort.

    Returns (payloads_sorted, seg_sorted, ranks, rank_to_seg, rank_valid);
    seg_sorted is the sorted id column (junk where invalid)."""
    order, seg_sorted, ranks, rank_to_seg, rank_valid = _sort_and_rank(seg_ids, valid,
                                                                       n_segments)
    return tuple(p[order] for p in payloads), seg_sorted, ranks, rank_to_seg, rank_valid


# ---------------------------------------------------------------------------
# Row layouts the kernels index through
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ObsLayout:
    """rank_start (p + 1,) int32: rows [rank_start[r], rank_start[r + 1])
    hold rank r (the table is rank-sorted).  seg_perm (O,) int32 and
    seg_start (n + 1,) int32: seg_perm[seg_start[c]:seg_start[c + 1]] are
    the rows of segment c in increasing row order; rows with an id outside
    [0, n) sort past seg_start[n].  chunk_start (n + 1,) int32: segment c
    is cut into chunks of CHUNK_ROWS of its rows, numbered
    [chunk_start[c], chunk_start[c + 1]) over all segments; one block sums
    one chunk and the chunks of a segment are then added in order.
    seg_ranks (O,) int32: the ranks in segment order, ranks[seg_perm] (when
    built with ranks).  in_seg_order (1,) int32 on the table's device: 1
    when seg_perm is the identity (one segment holds every row, as one
    intrinsic group does), so the table's own columns are already in
    segment order; K4 reads it on the device.  arrivals (n,)
    int32: the per-segment counters of the one-launch chunk finish
    (csrc/ba_common.cuh), zero, and left zero by every call; two calls on
    one layout must not run on two streams at once."""
    rank_start: torch.Tensor | None
    seg_perm: torch.Tensor
    seg_start: torch.Tensor
    chunk_start: torch.Tensor
    seg_ranks: torch.Tensor | None
    in_seg_order: torch.Tensor
    arrivals: torch.Tensor

    @property
    def chunk_bound(self) -> int:
        """At least the number of chunks, known without reading the device:
        sum_c ceil(rows_c / CHUNK_ROWS) <= ceil(O / CHUNK_ROWS) + n."""
        return -(-self.seg_perm.shape[0] // CHUNK_ROWS) + self.seg_start.shape[0] - 1


def _rank_ranges(ranks: torch.Tensor, p: int) -> torch.Tensor:
    """rank_start (p + 1,) int32 of a rank-sorted column: rows
    [rank_start[r], rank_start[r + 1]) hold rank r."""
    ranks = ranks.to(torch.int32).contiguous()
    q = torch.arange(p + 1, dtype=torch.int32, device=ranks.device)
    return torch.searchsorted(ranks, q, out_int32=True)


def seg_layout_reference(ids: torch.Tensor, n: int):
    """Plain twin of the layout kernel: ids (O,) -> (seg_perm (O,),
    seg_start (n + 1,), chunk_start (n + 1,), arrivals (n,) zero,
    in_order (1,)), int32 on the ids' device (see ObsLayout; every id
    outside [0, n) counts as n).  A stable sort of the ids; it reads
    nothing to the host."""
    i = ids.to(torch.int32)
    dev = i.device
    key = torch.where((i >= 0) & (i < n), i, torch.full_like(i, n))
    key_s, perm = torch.sort(key, stable=True)
    q = torch.arange(n + 1, dtype=torch.int32, device=dev)
    seg_start = torch.searchsorted(key_s, q).to(torch.int32)
    n_chunks = (seg_start[1:] - seg_start[:-1] + CHUNK_ROWS - 1) // CHUNK_ROWS
    chunk_start = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                             torch.cumsum(n_chunks, 0, dtype=torch.int32)])
    return (perm.to(torch.int32), seg_start, chunk_start,
            torch.zeros(n, dtype=torch.int32, device=dev),
            (key_s == key).all().to(torch.int32).reshape(1))


# The layout kernel's blocks (csrc/ba_layout.cu): W warps a block, so that
# W x (n + 1) shared ints stay within _LAYOUT_SMEM bytes (one warp may take
# more), each over a multiple of _LAYOUT_WARP_ROWS rows, at least (n + 1)
# rows a block so that the per-block counts are no more than the rows; the
# block's tile is staged in shared memory where it fits in _LAYOUT_STAGED.
_LAYOUT_SMEM = 48 * 1024
_LAYOUT_WARP_ROWS = 512
_LAYOUT_STAGED = 160 * 1024


def _layout_plan(n: int, O: int) -> tuple[int, int, int, bool]:
    """(warps a block, rows a warp, blocks, tile staged) of the layout
    kernel."""
    m = n + 1
    warps = max(1, min(8, _LAYOUT_SMEM // (4 * m)))
    warp_rows = _LAYOUT_WARP_ROWS * max(1, -(-m // (warps * _LAYOUT_WARP_ROWS)))
    tile_rows = warps * warp_rows
    staged = 4 * ((warps + 1) * m + 2 * tile_rows) <= _LAYOUT_STAGED
    return warps, warp_rows, -(-O // tile_rows), staged


def seg_layout(ids: torch.Tensor, n: int):
    """The segment layout of an id column: ids (O,) -> (seg_perm (O,),
    seg_start (n + 1,), chunk_start (n + 1,), arrivals (n,) zero,
    in_order (1,)) int32 (see ObsLayout), by the kernel of
    csrc/ba_layout.cu (three launches, no host read) for n <= LAYOUT_MAX_N;
    bit-equal to the twin, a stable sort."""
    if not _dispatch("seg_layout", ids):
        return seg_layout_reference(ids, n)
    if ids.dim() != 1:
        raise ValueError(f"seg_layout: ids must be (O,), got {tuple(ids.shape)}")
    if not 0 <= n <= LAYOUT_MAX_N:
        raise ValueError(f"seg_layout: 0 to {LAYOUT_MAX_N} segments, got {n}")
    ids = _i32(ids)
    dev, O, m = ids.device, ids.shape[0], n + 1
    warps, warp_rows, tiles, staged = _layout_plan(n, O)
    buf = torch.empty(O + 3 * m + m * (tiles + 1), dtype=torch.int32, device=dev)
    seg_perm, seg_start, chunk_start, arrivals, in_order, scratch = buf.split(
        [O, m, m, n, 1, m * (tiles + 1)])
    lib = cuda_build.kernels()
    err = lib.tpusfm_ba_seg_layout(dev.index, ids.data_ptr(), O, n, warps, warp_rows, int(staged),
                                   CHUNK_ROWS, scratch.data_ptr(), seg_perm.data_ptr(),
                                   seg_start.data_ptr(), chunk_start.data_ptr(),
                                   arrivals.data_ptr(), in_order.data_ptr(), _raw_stream(dev))
    cuda_build.check(lib, err, "seg_layout launch")
    LAUNCHES["seg_layout"] += 1
    return seg_perm, seg_start, chunk_start, arrivals, in_order


def layout_plan_args(seg_ids: torch.Tensor, n: int) -> str:
    """The plan obs_layout takes for `seg_ids` and n, as a span's args: the
    kernel's warps a block, rows a warp, tiles and whether a tile is staged
    in shared memory, or the twin's sort (off the card, or past
    LAYOUT_MAX_N segments)."""
    O = seg_ids.shape[0]
    if seg_ids.device.type != "cuda" or n > LAYOUT_MAX_N:
        return f"n={n} O={O} route=sort"
    warps, warp_rows, tiles, staged = _layout_plan(n, O)
    return (f"n={n} O={O} route=kernel warps={warps} warp_rows={warp_rows} tiles={tiles} "
            f"staged={int(staged)}")


def obs_layout(seg_ids: torch.Tensor, n: int, ranks: torch.Tensor | None = None,
               p: int | None = None) -> ObsLayout:
    """The layout of a table: the rows of each of the n segments of
    `seg_ids` (each segment's rows in increasing order: seg_layout) and,
    when `ranks` (rank-sorted) is given, the ranks in segment order and,
    with p, the row range of each of p ranks.  On the card nothing is read
    to the host; above LAYOUT_MAX_N segments the segments come from the
    twin's stable sort on the card."""
    cuda = seg_ids.device.type == "cuda"
    seg_perm, seg_start, chunk_start, arrivals, in_order = (
        seg_layout_reference(seg_ids, n) if cuda and n > LAYOUT_MAX_N else seg_layout(seg_ids, n))
    rank_start = seg_ranks = None
    if ranks is not None:
        ranks = _i32(ranks)
        seg_ranks = ranks.index_select(0, seg_perm)
        if p is not None:
            rank_start = _rank_ranges(ranks, p)
    return ObsLayout(rank_start=rank_start, seg_perm=seg_perm, seg_start=seg_start,
                     chunk_start=chunk_start, seg_ranks=seg_ranks, in_seg_order=in_order,
                     arrivals=arrivals)


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


def linearize_math(camg, intg, X, uv, w_in, huber_delta: float, refine_mask=None,
                   packed: bool = True):
    """Per-observation RADIAL3 linearization (reference
    ``_linearize_math_t``, obs_table.py:1129-1259): gathered camg (O, 21),
    intg (O, 7), X (O, 3), uv (O, 2), w_in (O,) -> camvals (O, 28) [Hcc
    packed 21 | gc 6 | cost], ptvals (O, 9) [Hpp packed 6 | gp 3], wc
    (O, 18) with wc[:, d*3+k] = (Jc^T Jp)[d, k].  Jacobians and residuals
    carry the Huber IRLS weight times w_in; rows with w_in <= 0 give exact
    zeros.

    With refine_mask (7 floats) the intrinsic Jacobian Jg (each lane times
    its mask entry, :1192-1207) joins: camvals becomes (O, 70) [Hcc 21 |
    gc 6 | Hcg row-major 42 | cost], and grpvals (O, 35) [Hgg packed 28 |
    gg 7] and wg (O, 21) with wg[:, e*3+k] = (Jg^T Jp)[e, k] are returned
    as well.

    packed=False gives the full row-major blocks instead of their upper
    triangles (the reference's unreduced layout): Hcc 36, Hpp 9, Hgg 49,
    so camvals (O, 43) or (O, 85), ptvals (O, 12), grpvals (O, 56)."""
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

    def block(J):  # (O, 2, n) -> J^T J per row, upper triangle or full row-major
        n = J.shape[-1]
        H = torch.einsum("oki,okj->oij", J, J)
        if not packed:
            return H.reshape(-1, n * n)
        iu, ju = torch.triu_indices(n, n)
        return H[:, iu, ju]

    Hcc = block(Jc)
    gc = torch.einsum("oki,ok->oi", Jc, r)
    hcost = torch.where(nrm <= huber_delta, 0.5 * nrm * nrm, huber_delta * (nrm - 0.5 * huber_delta))
    cost = torch.where(valid, hcost * w_in, torch.zeros_like(hcost))
    Hpp = block(Jp)
    gp = torch.einsum("oki,ok->oi", Jp, r)
    wc = torch.einsum("oki,okj->oij", Jc, Jp).reshape(-1, 18)
    ptvals = torch.cat([Hpp, gp], 1)
    if refine_mask is None:
        return torch.cat([Hcc, gc, cost[:, None]], 1), ptvals, wc
    m = [float(v) for v in refine_mask]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r4 = r2 * r2
    r6 = r4 * r2
    Jg = torch.stack([
        torch.stack([x * dist * m[0], zero, one * m[2], zero,
                     fx * x * r2 * m[4], fx * x * r4 * m[5], fx * x * r6 * m[6]], -1),
        torch.stack([zero, y * dist * m[1], zero, one * m[3],
                     fy * y * r2 * m[4], fy * y * r4 * m[5], fy * y * r6 * m[6]], -1)],
        1) * w[:, None, None]                                   # (O, 2, 7)
    Hcg = torch.einsum("oki,oke->oie", Jc, Jg).reshape(-1, 42)
    Hgg = block(Jg)
    gg = torch.einsum("oke,ok->oe", Jg, r)
    wg = torch.einsum("oke,okj->oej", Jg, Jp).reshape(-1, 21)
    return (torch.cat([Hcc, gc, Hcg, cost[:, None]], 1), ptvals, wc,
            torch.cat([Hgg, gg], 1), wg)


def _hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _linearize_rows(camtab, grptab, pts_rank, obs_cam, obs_grp, ranks, obs_uvT, obs_w,
                    refine: bool, refine_mask: tuple, huber_delta: float, packed: bool):
    """linearize_math over the table's rows, in the dtype of `camtab`: the
    camera, group and point of each row gathered (a zero point at ranks
    outside [0, P)), and every row whose camera or group id is outside
    [0, C) or [0, G) weighted 0, so it gives exact zeros."""
    dt = camtab.dtype
    C, G = camtab.shape[0], grptab.shape[0]
    cam_ok = (obs_cam >= 0) & (obs_cam < C) & (obs_grp >= 0) & (obs_grp < G)
    w_in = torch.where(cam_ok, obs_w.to(dt), torch.zeros((), dtype=dt, device=camtab.device))
    return linearize_math(
        _gather_rows(camtab, obs_cam), _gather_rows(grptab.to(dt), obs_grp),
        _gather_rows(pts_rank.to(dt), ranks), obs_uvT.to(dt).T, w_in, huber_delta,
        refine_mask if refine else None, packed=packed)


def linearize_radial3_t_reference(camtab, grptab, pts_rank, obs_cam, obs_grp, ranks, obs_uvT,
                                  obs_w, refine: bool = False, refine_mask: tuple = (0.0,) * 7,
                                  huber_delta: float = 4.0, w_dtype: str = "f32"):
    """Plain twin of K2's unreduced mode, in the dtype of `camtab`: the
    per-observation value tables, transposed (reference :1325-1333, widths
    :575).  Returns camvalsT (43, O) [Hcc 36 | gc 6 | cost], ptvalsT
    (12, O) [Hpp 9 | gp 3], wcT (18, O) in w_dtype; with `refine`, camvalsT
    (85, O) [Hcc 36 | gc 6 | Hcg row-major 42 | cost], and also grpvalsT
    (56, O) [Hgg 49 | gg 7] and wgT (21, O) in w_dtype.  Every block is
    full and row-major.  A row whose camera or group id is outside the
    tables gives zeros in every table (the reference gathers a zero camera
    or group row there and linearizes it; no caller passes such ids)."""
    outs = _linearize_rows(camtab, grptab, pts_rank, obs_cam, obs_grp, ranks, obs_uvT, obs_w,
                           refine, refine_mask, huber_delta, packed=False)
    wdt = _w_torch_dtype(w_dtype)
    return tuple(o.T.to(wdt) if i in (2, 4) else o.T for i, o in enumerate(outs))


def linearize_reduce_radial3_t_reference(camtab, grptab, pts_rank, obs_cam, obs_grp, ranks,
                                         obs_uvT, obs_w, refine: bool = False,
                                         refine_mask: tuple = (0.0,) * 7,
                                         huber_delta: float = 4.0, w_dtype: str = "f32",
                                         seg_ordered_w: bool = False):
    """Plain twin of K2 in the dtype of `camtab` (float32, or float64 as an
    oracle).  Returns camred (C, 28) [Hcc packed 21 | gc 6 | cost],
    ptred (P, 9) [Hpp packed 6 | gp 3] by rank, wcT (18, O) in w_dtype;
    with `refine`, camred (C, 70) [Hcc 21 | gc 6 | Hcg row-major 42 |
    cost], and also grpred (G, 35) [Hgg packed 28 | gg 7] and wgT (21, O)
    in w_dtype (reference :1540-1547).  With `seg_ordered_w` one more
    output follows: wcT in camera order, wcT[:, seg_perm] with seg_perm
    that of obs_layout(obs_cam, C)."""
    C, G, P = camtab.shape[0], grptab.shape[0], pts_rank.shape[0]
    outs = _linearize_rows(camtab, grptab, pts_rank, obs_cam, obs_grp, ranks, obs_uvT, obs_w,
                           refine, refine_mask, huber_delta, packed=True)
    wdt = _w_torch_dtype(w_dtype)
    wcT = outs[2].T.to(wdt)
    res = (_segsum_drop(outs[0], obs_cam, C), _segsum_drop(outs[1], ranks, P), wcT)
    if refine:
        res += (_segsum_drop(outs[3], obs_grp, G), outs[4].T.to(wdt))
    if seg_ordered_w:
        res += (wcT[:, obs_layout(obs_cam, C).seg_perm.long()],)
    return res


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


def schur_fwd_t_reference(wT, obs_cam, idx_sorted, vtab, p: int):
    """Plain twin of K5, in the dtype of `vtab` (n, D): y (p, 3) =
    sum_o [rank_o = r] W_o^T v[obs_cam_o] over all D rows of W_o.  Rows
    with rank >= p or an id outside [0, n) add nothing."""
    W = _wmat(wT, vtab.dtype)
    vg = _gather_rows(vtab, obs_cam)
    return _segsum_drop(torch.einsum("odk,od->ok", W, vg), idx_sorted, p)


def schur_mv_t_reference(wT, obs_cam, idx_sorted, vtab, hinv_rank, p: int, hcc_d=None):
    """Plain twin of K3, in the dtype of `vtab`: y = W^T v per rank (p, 3),
    z = Hpp^-1 y, bc = W z per camera; returns (bc, y), or (hcc_d v - bc,
    y) when hcc_d (C, 6, 6) is given."""
    dt = vtab.dtype
    y = schur_fwd_t_reference(wT, obs_cam, idx_sorted, vtab, p)
    z = torch.einsum("pij,pj->pi", hinv_rank.to(dt), y)
    bc = schur_bwd_t_reference(wT, obs_cam, idx_sorted, z, vtab.shape[0])
    if hcc_d is not None:
        bc = torch.einsum("cij,cj->ci", hcc_d.to(dt), vtab) - bc
    return bc, y


def segsum_table_t_reference(valsT, idx, n: int):
    """Plain twin of K6: valsT (k, O), idx (O,) -> (n, k) sums by id in the
    dtype of valsT; ids outside [0, n) are dropped."""
    return _segsum_drop(valsT.T, idx, n)


def segsum_sorted_t_reference(valsT, idx_sorted, p: int):
    """Plain twin of K7: valsT (k, O), ranks (O,) -> (p, k) sums by rank;
    rows with rank >= p are dropped."""
    return _segsum_drop(valsT.T, idx_sorted, p)


def segsum_table_reference(vals, idx, n: int):
    """Plain twin of segsum_table: vals (O, D) -> (n, D) sums by id."""
    return segsum_table_t_reference(vals.T, idx, n)


def segsum_sorted_reference(vals, idx_sorted, p: int):
    """Plain twin of segsum_sorted: vals (O, D) -> (p, D) sums by rank."""
    return segsum_sorted_t_reference(vals.T, idx_sorted, p)


def schur_fwd_reference(w_flat, obs_cam, idx_sorted, vtab, p: int):
    """Plain twin of schur_fwd: w_flat (O, 3D) -> (p, 3)."""
    return schur_fwd_t_reference(w_flat.T, obs_cam, idx_sorted, vtab, p)


def schur_bwd_reference(w_flat, obs_cam, idx_sorted, ztab, n: int):
    """Plain twin of schur_bwd: w_flat (O, 3D) -> (n, D)."""
    return schur_bwd_t_reference(w_flat.T, obs_cam, idx_sorted, ztab, n)


def gather_table_reference(table, idx):
    """Plain twin of K8: table (N, D), idx (O,) -> (O, D) = table[idx] in
    the dtype of `table`, a zero row for every id outside [0, N)."""
    return _gather_rows(table, idx)


def gather_sorted_reference(table, idx_sorted):
    """Plain twin of K9: table (P, D), non-decreasing ranks (O,) -> (O, D) =
    table[idx_sorted], a zero row for every rank outside [0, P).  Ranks
    need not be dense (the reference's windowed kernel zeroes a row whose
    rank jumps past its two-block window)."""
    return _gather_rows(table, idx_sorted)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _dispatch(name: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch), False for CPU tensors (twin)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


# The conversions return their argument when it already has the kernel's
# dtype and is contiguous, without a call into torch.
def _i32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def _raw_stream(dev: torch.device) -> int:
    """The cudaStream_t of `dev`'s current stream, for the launchers, which
    take their device and set it themselves: no Stream object and no Python
    device guard around the call."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _check_shape(name: str, t: torch.Tensor, shape: tuple):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def _layout_for(layout, seg_ids, n, ranks, p, need_ranks: bool,
                need_segs: bool = True) -> ObsLayout:
    """`layout` checked against the table (the parts the kernel reads), or
    a new one when None."""
    if layout is None:
        return obs_layout(seg_ids, n, ranks if need_ranks else None, p)
    parts = ()
    if need_segs:
        _check_shape("layout.seg_perm", layout.seg_perm, (seg_ids.shape[0],))
        _check_shape("layout.seg_start", layout.seg_start, (n + 1,))
        _check_shape("layout.chunk_start", layout.chunk_start, (n + 1,))
        _check_shape("layout.arrivals", layout.arrivals, (n,))
        _check_shape("layout.in_seg_order", layout.in_seg_order, (1,))
        parts += (layout.seg_perm, layout.seg_start, layout.chunk_start, layout.arrivals,
                  layout.in_seg_order)
    if need_ranks:
        if layout.rank_start is None:
            raise ValueError("layout has no rank_start; build it with ranks and p")
        _check_shape("layout.rank_start", layout.rank_start, (p + 1,))
        parts += (layout.rank_start,)
    for t in parts:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != seg_ids.device:
            raise ValueError("layout tensors must be contiguous int32 on the table's device")
    return layout


def _rank_start_for(layout, ranks, p: int) -> torch.Tensor:
    """The rank ranges a rank-only kernel (K5, K7) reads: `layout`'s,
    checked, or, with none, computed alone (no segment sort)."""
    if layout is None:
        return _rank_ranges(ranks, p)
    return _layout_for(layout, ranks, 0, ranks, p, need_ranks=True, need_segs=False).rank_start


def _check_w(name: str, wT: torch.Tensor, o: int, dd3: int | None = None,
             row_major_ok: bool = False):
    """wT (3D, O) checked; contiguous, or with `row_major_ok` also the
    (3D, O) view of a contiguous (O, 3D) table (segsum_lane_major)."""
    if wT.dim() != 2 or wT.shape[1] != o or wT.shape[0] % 3 or (dd3 and wT.shape[0] != dd3):
        raise ValueError(f"{name}: wT must be (3D, {o}), got {tuple(wT.shape)}")
    if wT.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: wT must be bfloat16 or float32, got {wT.dtype}")
    if row_major_ok:
        segsum_lane_major(wT, name)
    elif not wT.is_contiguous():
        raise ValueError(f"{name}: wT must be contiguous")


def _check_lin_inputs(name, camtab, grptab, pts_rank, obs_cam, obs_grp, ranks, obs_uvT, obs_w,
                      refine, refine_mask) -> tuple[int, int, int, int]:
    """K2's input shapes checked; returns (C, G, P, O)."""
    C, G, P, O = camtab.shape[0], grptab.shape[0], pts_rank.shape[0], ranks.shape[0]
    _check_shape("camtab", camtab, (C, LIN_CAM_DIM))
    _check_shape("grptab", grptab, (G, 7))
    _check_shape("pts_rank", pts_rank, (P, 3))
    for nm, t in (("obs_cam", obs_cam), ("obs_grp", obs_grp), ("obs_w", obs_w)):
        _check_shape(nm, t, (O,))
    _check_shape("obs_uvT", obs_uvT, (2, O))
    if min(C, G, P, O) < 1:
        raise ValueError(f"{name} needs at least one camera, group, point and observation")
    if refine and len(refine_mask) != 7:
        raise ValueError(f"refine_mask must have 7 entries, got {len(refine_mask)}")
    return C, G, P, O


def linearize_reduce_radial3_t(camtab, grptab, pts_rank, obs_cam, obs_grp, ranks, obs_uvT,
                               obs_w, refine: bool = False, refine_mask: tuple = (0.0,) * 7,
                               huber_delta: float = 4.0, w_dtype: str = "f32", *,
                               layout: ObsLayout | None = None,
                               grp_layout: ObsLayout | None = None,
                               seg_ordered_w: bool = False):
    """K2: fused linearize + reduce over a rank-sorted observation table.

    camtab (C, 21) [t | R | Jr], grptab (G, 7) RADIAL3 intrinsics,
    pts_rank (P, 3) points by rank, obs_cam / obs_grp / ranks (O,),
    obs_uvT (2, O), obs_w (O,) -> (camred (C, 28), ptred (P, 9),
    wcT (18, O) in w_dtype), or with `refine` (camred (C, 70), ptred,
    wcT, grpred (G, 35), wgT (21, O)); see the twin.  With `seg_ordered_w`
    one more output follows: wcT in the camera order of `layout`
    (wcT[:, layout.seg_perm]), which schur_bwd_t reads as `w_seg`.
    `layout` (camera segments of obs_cam, rank ranges for P) and, with
    `refine`, `grp_layout` (group segments of obs_grp) save rebuilding them
    per call."""
    if not _dispatch("linearize_reduce_radial3_t", camtab, grptab, pts_rank, obs_cam, obs_grp,
                     ranks, obs_uvT, obs_w):
        return linearize_reduce_radial3_t_reference(
            camtab, grptab, pts_rank, obs_cam, obs_grp, ranks, obs_uvT, obs_w, refine,
            refine_mask, huber_delta, w_dtype, seg_ordered_w)
    wdt = _w_torch_dtype(w_dtype)
    C, G, P, O = _check_lin_inputs("linearize_reduce_radial3_t", camtab, grptab, pts_rank,
                                   obs_cam, obs_grp, ranks, obs_uvT, obs_w, refine, refine_mask)
    lay = _layout_for(layout, obs_cam, C, ranks, P, need_ranks=True)
    camtab, grptab, pts = _f32(camtab), _f32(grptab), _f32(pts_rank)
    cam, grp, rk = _i32(obs_cam), _i32(obs_grp), _i32(ranks)
    uvT, w = _f32(obs_uvT), _f32(obs_w)
    dev = camtab.device
    K = 70 if refine else 28
    camred = torch.empty((C, K), dtype=torch.float32, device=dev)
    ptred = torch.empty((P, 9), dtype=torch.float32, device=dev)
    wcT = torch.empty((18, O), dtype=wdt, device=dev)
    wseg = torch.empty((18, O), dtype=wdt, device=dev) if seg_ordered_w else None
    outs = (camred, ptred, wcT)
    grp_ptrs, grp_outs, grp_chunks, mask = (None,) * 4, (None, None), 0, None
    if refine:
        glay = _layout_for(grp_layout, obs_grp, G, None, None, need_ranks=False)
        outs += (torch.empty((G, 35), dtype=torch.float32, device=dev),
                 torch.empty((21, O), dtype=wdt, device=dev))
        mask = (ctypes.c_float * 7)(*(float(m) for m in refine_mask))
        grp_ptrs = (glay.seg_perm.data_ptr(), glay.seg_start.data_ptr(),
                    glay.chunk_start.data_ptr(), glay.arrivals.data_ptr())
        grp_outs = (outs[3].data_ptr(), outs[4].data_ptr())
        grp_chunks = glay.chunk_bound
    # The camera pass's chunk partials, then the group pass's.
    part = torch.empty((lay.chunk_bound * K + grp_chunks * 35,), dtype=torch.float32, device=dev)
    lib = cuda_build.kernels()
    err = lib.tpusfm_ba_linearize(
        dev.index, camtab.data_ptr(), grptab.data_ptr(), pts.data_ptr(), cam.data_ptr(),
        grp.data_ptr(), rk.data_ptr(), uvT.data_ptr(), w.data_ptr(), lay.rank_start.data_ptr(),
        lay.seg_perm.data_ptr(), lay.seg_start.data_ptr(), lay.chunk_start.data_ptr(),
        lay.arrivals.data_ptr(), *grp_ptrs, None if mask is None else ctypes.addressof(mask), C,
        G, P, O, lay.chunk_bound, grp_chunks, CHUNK_ROWS, float(huber_delta),
        int(wdt == torch.bfloat16), camred.data_ptr(), ptred.data_ptr(), wcT.data_ptr(),
        None if wseg is None else wseg.data_ptr(), grp_outs[0], grp_outs[1], part.data_ptr(),
        _raw_stream(dev))
    cuda_build.check(lib, err, "linearize_reduce_radial3_t launch")
    LAUNCHES["linearize_reduce_radial3_t"] += 1
    return outs if wseg is None else outs + (wseg,)


def linearize_radial3_t(camtab, grptab, pts_rank, obs_cam, obs_grp, ranks, obs_uvT, obs_w,
                        refine: bool = False, refine_mask: tuple = (0.0,) * 7,
                        huber_delta: float = 4.0, w_dtype: str = "f32"):
    """K2's unreduced mode: the per-observation value tables of K2's math,
    transposed, one column per row of the table (inputs as
    linearize_reduce_radial3_t; the rows need not be sorted).  Returns
    camvalsT (43, O) [Hcc 36 | gc 6 | cost], ptvalsT (12, O) [Hpp 9 | gp
    3] float32 and wcT (18, O) in w_dtype; with `refine`, camvalsT (85, O)
    [Hcc 36 | gc 6 | Hcg 42 | cost], grpvalsT (56, O) [Hgg 49 | gg 7] and
    wgT (21, O) as well.  Blocks are full and row-major; see the twin."""
    if not _dispatch("linearize_radial3_t", camtab, grptab, pts_rank, obs_cam, obs_grp, ranks,
                     obs_uvT, obs_w):
        return linearize_radial3_t_reference(camtab, grptab, pts_rank, obs_cam, obs_grp, ranks,
                                             obs_uvT, obs_w, refine, refine_mask, huber_delta,
                                             w_dtype)
    wdt = _w_torch_dtype(w_dtype)
    C, G, P, O = _check_lin_inputs("linearize_radial3_t", camtab, grptab, pts_rank, obs_cam,
                                   obs_grp, ranks, obs_uvT, obs_w, refine, refine_mask)
    camtab, grptab, pts = _f32(camtab), _f32(grptab), _f32(pts_rank)
    cam, grp, rk = _i32(obs_cam), _i32(obs_grp), _i32(ranks)
    uvT, w = _f32(obs_uvT), _f32(obs_w)
    dev = camtab.device
    outs = [torch.empty((85 if refine else 43, O), dtype=torch.float32, device=dev),
            torch.empty((12, O), dtype=torch.float32, device=dev),
            torch.empty((18, O), dtype=wdt, device=dev)]
    mask = None
    if refine:
        outs += [torch.empty((56, O), dtype=torch.float32, device=dev),
                 torch.empty((21, O), dtype=wdt, device=dev)]
        mask = (ctypes.c_float * 7)(*(float(m) for m in refine_mask))
    ptrs = [t.data_ptr() for t in outs] + [None] * (5 - len(outs))
    lib = cuda_build.kernels()
    err = lib.tpusfm_ba_linearize_unreduced(
        dev.index, camtab.data_ptr(), grptab.data_ptr(), pts.data_ptr(), cam.data_ptr(),
        grp.data_ptr(), rk.data_ptr(), uvT.data_ptr(), w.data_ptr(),
        None if mask is None else ctypes.addressof(mask), C, G, P, O, float(huber_delta),
        int(wdt == torch.bfloat16), *ptrs, _raw_stream(dev))
    cuda_build.check(lib, err, "linearize_radial3_t launch")
    LAUNCHES["linearize_radial3_t"] += 1
    return tuple(outs)


def linearize_radial3(camtab, grptab, pts_rank, obs_cam, obs_grp, ranks, obs_uv, obs_w,
                      refine: bool = False, refine_mask: tuple = (0.0,) * 7,
                      huber_delta: float = 4.0, w_dtype: str = "f32"):
    """The sublane-layout twin of linearize_radial3_t (reference :540): obs_uv
    (O, 2), and each value table (O, k), the transpose of
    linearize_radial3_t's (views, not copies)."""
    outs = linearize_radial3_t(camtab, grptab, pts_rank, obs_cam, obs_grp, ranks, obs_uv.T,
                               obs_w, refine, refine_mask, huber_delta, w_dtype)
    return tuple(o.T for o in outs)


def schur_mv_t(wT, obs_cam, idx_sorted, vtab, hinv_rank, p: int, hcc_d=None, *,
               layout: ObsLayout | None = None):
    """K3: one Schur matvec over the coupling table.  wT (18, O) bf16/f32,
    obs_cam (O,), idx_sorted (O,) sorted ranks, vtab (C, 6), hinv_rank
    (p, 3, 3) damped point-block inverses by rank -> (bc (C, 6), y (p, 3))
    with bc = W Hpp^-1 W^T v per camera, or S v = hcc_d v - bc when hcc_d
    (C, 6, 6) is given, and y = W^T v per rank.  On the card the kernel
    reads the rows through `layout` (rank ranges for p, camera segments and
    chunks)."""
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
    cam, v, hinv = _i32(obs_cam), _f32(vtab), _f32(hinv_rank)
    hcc = None if hcc_d is None else _f32(hcc_d)
    dev = v.device
    n_chunks = lay.chunk_bound
    out = torch.empty((C, 6), dtype=torch.float32, device=dev)
    y = torch.empty((p, 3), dtype=torch.float32, device=dev)
    # The kernel's scratch: W z per observation (O, 6), then the camera
    # pass's chunk partials (n_chunks, 6).
    scratch = torch.empty(((O + n_chunks) * 6,), dtype=torch.float32, device=dev)
    wz = scratch.data_ptr()
    lib = cuda_build.kernels()
    err = lib.tpusfm_ba_schur_mv(
        dev.index, wT.data_ptr(), int(wT.dtype == torch.bfloat16), cam.data_ptr(), v.data_ptr(),
        hinv.data_ptr(), None if hcc is None else hcc.data_ptr(), lay.rank_start.data_ptr(),
        lay.seg_perm.data_ptr(), lay.seg_start.data_ptr(), lay.chunk_start.data_ptr(), C, p, O,
        n_chunks, CHUNK_ROWS, y.data_ptr(), wz, wz + O * 6 * 4, out.data_ptr(), _raw_stream(dev))
    cuda_build.check(lib, err, "schur_mv_t launch")
    LAUNCHES["schur_mv_t"] += 1
    return out, y


# How K4 reads W and the ranks (csrc/ba_schur.cu WRead).
_K4_PERMUTED, _K4_ORDERED_LANE, _K4_ORDERED_ROW, _K4_PERMUTED_ROW = 0, 1, 2, 3


def schur_bwd_t(wT, obs_cam, idx_sorted, ztab, n: int, *, layout: ObsLayout | None = None,
                w_seg: torch.Tensor | None = None):
    """K4: out (n, D) = sum over observations o with obs_cam_o = n of
    W_o z[rank_o]; wT (3D, O) bf16/f32 with D <= 9, idx_sorted (O,) ranks
    into ztab (Pz, 3).  obs_cam may be any id column (camera or group) whose
    segment layout `layout` describes.  wT is lane-major or the (3D, O)
    view of a row-major (O, 3D) table (segsum_lane_major), read in place.

    `w_seg` (3D, O), optional: the same W in the segment order of `layout`
    (column i is column layout.seg_perm[i] of wT), lane-major or the (3D, O)
    view of a row-major (O, 3D) table (segsum_lane_major), bf16 or f32; the
    layout must carry seg_ranks.  With it, or when the layout's rows are in
    segment order already (in_seg_order, which the kernel reads on the
    device), the kernel reads W and the ranks in order instead of through
    the permutation; both reads give the same bits.  Nothing is read to the
    host, with a layout or without one (the call then builds it)."""
    if w_seg is not None and (layout is None or layout.seg_ranks is None):
        raise ValueError("schur_bwd_t: w_seg needs the layout it is ordered by, built with ranks")
    if not _dispatch("schur_bwd_t", wT, obs_cam, idx_sorted, ztab,
                     *(() if w_seg is None else (w_seg,))):
        if w_seg is None:
            return schur_bwd_t_reference(wT, obs_cam, idx_sorted, ztab, n)
        return schur_bwd_t_reference(w_seg, obs_cam[layout.seg_perm.long()], layout.seg_ranks,
                                     ztab, n)
    O = idx_sorted.shape[0]
    _check_w("schur_bwd_t", wT, O, row_major_ok=True)
    D = wT.shape[0] // 3
    if not 1 <= D <= MAX_W_ROWS:
        raise ValueError(f"schur_bwd_t: 1 to {MAX_W_ROWS} rows per block (3D <= "
                         f"{3 * MAX_W_ROWS}), got D = {D}")
    Pz = ztab.shape[0]
    _check_shape("ztab", ztab, (Pz, 3))
    _check_shape("obs_cam", obs_cam, (O,))
    if min(n, O) < 1:
        raise ValueError("schur_bwd_t needs at least one segment and one observation")
    lay = _layout_for(layout, obs_cam, n, None, None, need_ranks=False)
    z = _f32(ztab)
    if w_seg is not None:
        _check_shape("w_seg", w_seg, tuple(wT.shape))
        _check_shape("layout.seg_ranks", lay.seg_ranks, (O,))
        if w_seg.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"schur_bwd_t: w_seg must be bfloat16 or float32, got {w_seg.dtype}")
        read = _K4_ORDERED_LANE if segsum_lane_major(w_seg, "schur_bwd_t") else _K4_ORDERED_ROW
        w, rk, in_order = w_seg, _i32(lay.seg_ranks), None
    else:
        # The permuted reads take the ordered one where in_seg_order is set.
        read = _K4_PERMUTED if segsum_lane_major(wT, "schur_bwd_t") else _K4_PERMUTED_ROW
        w, rk, in_order = wT, _i32(idx_sorted), lay.in_seg_order.data_ptr()
    out = torch.empty((n, D), dtype=torch.float32, device=z.device)
    part = torch.empty((lay.chunk_bound, D), dtype=torch.float32, device=z.device)
    lib = cuda_build.kernels()
    err = lib.tpusfm_ba_schur_bwd(
        z.device.index, w.data_ptr(), int(w.dtype == torch.bfloat16), read, D, rk.data_ptr(),
        z.data_ptr(), Pz, lay.seg_perm.data_ptr(), lay.seg_start.data_ptr(),
        lay.chunk_start.data_ptr(), in_order, lay.arrivals.data_ptr(), n, O, lay.chunk_bound,
        CHUNK_ROWS, part.data_ptr(), out.data_ptr(), _raw_stream(z.device))
    cuda_build.check(lib, err, "schur_bwd_t launch")
    LAUNCHES["schur_bwd_t"] += 1
    return out


def schur_fwd_t(wT, obs_cam, idx_sorted, vtab, p: int, *, layout: ObsLayout | None = None):
    """K5: y (p, 3) = sum over the observations o of rank r of
    W_o^T v[obs_cam_o], W_o the (D, 3) block in column o of wT (3D, O)
    bf16/f32, D <= 9, vtab (n, D) with obs_cam any id column into it
    (camera or group).  Every one of the D rows counts (the reference's
    kernel sums only the first six; see csrc/ba_schur.cu).  `layout`
    needs only its rank ranges for p.  On the card K5 reads in place a
    contiguous lane-major wT or the (3D, O) view `w.T` of a contiguous
    (O, 3D) table w (segsum_lane_major); the two give the same bits."""
    if not _dispatch("schur_fwd_t", wT, obs_cam, idx_sorted, vtab):
        return schur_fwd_t_reference(wT, obs_cam, idx_sorted, vtab, p)
    O = idx_sorted.shape[0]
    _check_w("schur_fwd_t", wT, O, row_major_ok=True)
    D = wT.shape[0] // 3
    if not 1 <= D <= MAX_W_ROWS:
        raise ValueError(f"schur_fwd_t: 1 to {MAX_W_ROWS} rows per block, got D = {D}")
    n = vtab.shape[0]
    _check_shape("vtab", vtab, (n, D))
    _check_shape("obs_cam", obs_cam, (O,))
    if min(n, O, p) < 1:
        raise ValueError("schur_fwd_t needs at least one id, observation and rank")
    rank_start = _rank_start_for(layout, idx_sorted, p)
    ids, v = _i32(obs_cam), _f32(vtab)
    y = torch.empty((p, 3), dtype=torch.float32, device=v.device)
    lib = cuda_build.kernels()
    err = lib.tpusfm_ba_schur_fwd(
        v.device.index, wT.data_ptr(), int(wT.dtype == torch.bfloat16),
        int(not segsum_lane_major(wT, "schur_fwd_t")), D, ids.data_ptr(), v.data_ptr(), n,
        rank_start.data_ptr(), p, O, y.data_ptr(), _raw_stream(v.device))
    cuda_build.check(lib, err, "schur_fwd_t launch")
    LAUNCHES["schur_fwd_t"] += 1
    return y


def _check_vals(name: str, valsT: torch.Tensor, o: int):
    if valsT.dim() != 2 or valsT.shape[1] != o or valsT.shape[0] < 1:
        raise ValueError(f"{name}: valsT must be (k, {o}) with k >= 1, got {tuple(valsT.shape)}")


def segsum_lane_major(valsT: torch.Tensor, name: str = "segsum_table_t") -> bool:
    """How K6 (and K4, its segment-ordered W) reads a (k, O) table: False
    for row-major storage, the (k, O) view with strides (1, k) of an (O, k)
    table (`x.T` of a contiguous x), which it reads in place; True for a
    contiguous lane-major table (which K6 first transposes into a row-major
    scratch).  Other strides raise."""
    k, o = valsT.shape
    if (k == 1 or valsT.stride(0) == 1) and (o == 1 or valsT.stride(1) == k):
        return False
    if valsT.is_contiguous():
        return True
    raise ValueError(f"{name}: the table must be a contiguous (k, O) table or the (k, O) "
                     f"view of a contiguous (O, k) one, got strides {valsT.stride()}")


def segsum_table_t(valsT, idx, n: int, *, layout: ObsLayout | None = None):
    """K6: valsT (k, O), idx (O,) in any order -> (n, k) float32 sums by
    id; ids outside [0, n) are dropped.  `layout` holds idx's segments.
    On the card valsT is either row-major, the (k, O) view `x.T` of a
    contiguous (O, k) table x, read without a copy, or a contiguous
    lane-major (k, O) table (segsum_lane_major); the two give the same
    bits."""
    if not _dispatch("segsum_table_t", valsT, idx):
        return segsum_table_t_reference(valsT, idx, n)
    O = idx.shape[0]
    _check_vals("segsum_table_t", valsT, O)
    if min(n, O) < 1:
        raise ValueError("segsum_table_t needs at least one segment and one observation")
    k = valsT.shape[0]
    vals = valsT.to(torch.float32)  # keeps the strides of a dense table
    lane_major = segsum_lane_major(vals)
    lay = _layout_for(layout, idx, n, None, None, need_ranks=False)
    dev = vals.device
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    part = torch.empty((lay.chunk_bound, k), dtype=torch.float32, device=dev)
    scratch = torch.empty((O, k), dtype=torch.float32, device=dev) if lane_major else None
    lib = cuda_build.kernels()
    err = lib.tpusfm_ba_segsum_table(
        dev.index, vals.data_ptr(), int(lane_major), k, O, lay.seg_perm.data_ptr(),
        lay.seg_start.data_ptr(), lay.chunk_start.data_ptr(), n, lay.chunk_bound, CHUNK_ROWS,
        None if scratch is None else scratch.data_ptr(), part.data_ptr(), out.data_ptr(),
        _raw_stream(dev))
    cuda_build.check(lib, err, "segsum_table_t launch")
    LAUNCHES["segsum_table_t"] += 1
    return out


def segsum_sorted_t(valsT, idx_sorted, p: int, *, layout: ObsLayout | None = None):
    """K7: valsT (k, O), non-decreasing ranks (O,) -> (p, k) float32 sums
    by rank; rows with rank >= p are dropped and ranks need not be dense.
    `layout` needs only its rank ranges for p.  On the card K7 reads in
    place a contiguous lane-major valsT or the (k, O) view `x.T` of a
    contiguous (O, k) table x; the two give the same bits."""
    if not _dispatch("segsum_sorted_t", valsT, idx_sorted):
        return segsum_sorted_t_reference(valsT, idx_sorted, p)
    O = idx_sorted.shape[0]
    _check_vals("segsum_sorted_t", valsT, O)
    if min(p, O) < 1:
        raise ValueError("segsum_sorted_t needs at least one rank and one observation")
    k = valsT.shape[0]
    rank_start = _rank_start_for(layout, idx_sorted, p)
    vals = valsT.to(torch.float32)  # keeps the strides of a dense table
    row_major = not vals.is_contiguous() and vals.stride() == (1, k)
    if not row_major:
        vals = vals.contiguous()
    dev = vals.device
    out = torch.empty((p, k), dtype=torch.float32, device=dev)
    lib = cuda_build.kernels()
    err = lib.tpusfm_ba_segsum_sorted(dev.index, vals.data_ptr(), int(row_major), k, O,
                                      rank_start.data_ptr(), p, out.data_ptr(), _raw_stream(dev))
    cuda_build.check(lib, err, "segsum_sorted_t launch")
    LAUNCHES["segsum_sorted_t"] += 1
    return out


# ---------------------------------------------------------------------------
# The reference's sublane-layout entry points: row-major (O, k) tables, each
# launched as its kernel on the (k, O) view (obs_table.py:146, 245, 882, 992)
# ---------------------------------------------------------------------------

def segsum_table(vals, idx, n: int):
    """K6 on a row-major table: vals (O, D), idx (O,) in any order -> (n, D)
    float32 sums by id; ids outside [0, n) are dropped.  K6 reads the (D, O)
    view of the table in place, through the layout the call builds
    (seg_layout); nothing is read to the host."""
    if not _dispatch("segsum_table", vals, idx):
        return segsum_table_reference(vals, idx, n)
    return segsum_table_t(_f32(vals).T, idx, n)


def segsum_sorted(vals, idx_sorted, p: int):
    """K7 on a row-major table: vals (O, D), non-decreasing ranks (O,) ->
    (p, D) float32 sums by rank; rows with rank >= p are dropped.  K7 reads
    the (D, O) view of the table in place."""
    if not _dispatch("segsum_sorted", vals, idx_sorted):
        return segsum_sorted_reference(vals, idx_sorted, p)
    return segsum_sorted_t(_f32(vals).T, idx_sorted, p)


def schur_fwd(w_flat, obs_cam, idx_sorted, vtab, p: int):
    """K5 on a row-major coupling table: w_flat (O, 3D) bf16/f32 (row o is
    W_o, (D, 3) row-major), obs_cam (O,) ids into vtab (n, D), idx_sorted
    (O,) sorted ranks -> (p, 3) = sum over the rows of rank r of
    W_o^T v[obs_cam_o], every one of the D rows counted, as the
    reference's sublane kernel does.  K5 reads the (3D, O) view of the
    table in place."""
    if not _dispatch("schur_fwd", w_flat, obs_cam, idx_sorted, vtab):
        return schur_fwd_reference(w_flat, obs_cam, idx_sorted, vtab, p)
    return schur_fwd_t(w_flat.contiguous().T, obs_cam, idx_sorted, vtab, p)


def schur_bwd(w_flat, obs_cam, idx_sorted, ztab, n: int):
    """K4 on a row-major coupling table: w_flat (O, 3D) bf16/f32,
    idx_sorted (O,) ranks into ztab (Pz, 3), obs_cam (O,) ids -> (n, D) =
    sum over the rows of id c of W_o z[rank_o]; ids outside [0, n) are
    dropped.  K4 reads the table in place through the layout the call
    builds (seg_layout), a warp's 32 rows at a time; nothing is read to the
    host."""
    if not _dispatch("schur_bwd", w_flat, obs_cam, idx_sorted, ztab):
        return schur_bwd_reference(w_flat, obs_cam, idx_sorted, ztab, n)
    return schur_bwd_t(w_flat.contiguous().T, obs_cam, idx_sorted, ztab, n)


def _launch_gather(name: str, table, idx) -> torch.Tensor:
    """K8 and K9 share one kernel: out (O, D) float32 = table[idx], a zero
    row for every id outside [0, N)."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{name}: table must be (N, D) and idx (O,), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    (n, d), o = table.shape, idx.shape[0]
    tab, ids = _f32(table), _i32(idx)
    dev = tab.device
    out = torch.empty((o, d), dtype=torch.float32, device=dev)
    if o * d == 0:
        return out
    lib = cuda_build.kernels()
    err = lib.tpusfm_ba_gather(dev.index, tab.data_ptr(), n, d, ids.data_ptr(), o, out.data_ptr(),
                               _raw_stream(dev))
    cuda_build.check(lib, err, f"{name} launch")
    LAUNCHES[name] += 1
    return out


def gather_table(table, idx):
    """K8: table (N, D), idx (O,) ids in any order -> (O, D) float32 =
    table[idx], a zero row for every id outside [0, N)."""
    if not _dispatch("gather_table", table, idx):
        return gather_table_reference(table, idx)
    return _launch_gather("gather_table", table, idx)


def gather_sorted(table, idx_sorted):
    """K9: table (P, D) by rank, idx_sorted (O,) non-decreasing ranks ->
    (O, D) float32 = table[idx_sorted], a zero row for every rank outside
    [0, P) (invalid rows carry 2^30).  Ranks need not be dense; sorted, they
    make neighbouring threads read neighbouring rows."""
    if not _dispatch("gather_sorted", table, idx_sorted):
        return gather_sorted_reference(table, idx_sorted)
    return _launch_gather("gather_sorted", table, idx_sorted)
