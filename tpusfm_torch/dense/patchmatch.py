"""PatchMatch multi-view stereo refinement: slanted-plane hypotheses with
red-black checkerboard propagation.

Port of ``tpusfm/dense/patchmatch.py``.  The plane sweep
(``dense.depth``) gives a fronto-parallel depth; this module refines it with
a plane per pixel (inverse depth and unit normal).  Each half-sweep updates
every pixel of one checkerboard parity at once from its neighbours of the
other parity, so a half-sweep is one regular array program:

  - parity compaction: the active cells are gathered into dense (H, W/2)
    fields by two strided slices and a select, evaluated there, and written
    back the same way;
  - the reference window's statistics (mean, variance, the value at each
    window offset) depend on no candidate and are computed once per call;
  - the NCC window is a dilated diamond plus the four far corners and a
    one-pixel cross (21 samples at radius 6, dilation 3);
  - candidates: two neighbour planes re-intersected with the pixel's ray, a
    joint depth and normal perturbation of shrinking scale, and (unless
    ``fine``) a full-range random restart and a normal-only perturbation;
    with ``presel`` every candidate is ranked on a nine-sample window and
    the best two are scored on the full window against the incumbent;
  - sampling ("upN", the default "up8") reads one texel of a source
    pyramid upsampled N times by bilinear interpolation and stored in
    bfloat16, instead of four bilinear taps.

The reference loops over window offsets and candidates with ``lax.scan`` and
``lax.map``; here the offsets of a window and the candidates of a
half-sweep are one batched expression (a chunk of offsets at a time where
the batch would exceed ``_BATCH_ELEMS`` values), which sums the same terms
in another order.  Random draws come from a ``torch.Generator`` (made on
its own device, then moved to the image's), or are given as arrays through
``draws=``: the parity tests pass the reference's own jax draws in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

# Upper bound on the values of one batched window evaluation
# (sources x offsets x candidates x pixels); larger batches run in chunks of
# offsets.
_BATCH_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class PatchMatchConfig:
    n_iters: int = 4            # full iterations (each = 2 parity sweeps)
    window_radius: int = 6      # window half-extent in px
    dilation: int = 3           # sample spacing inside the window
    window_pattern: str = "diamond"  # "diamond"+corners (sparse) or "square"
    best_k: int = 2             # best-k source aggregation (as plane sweep)
    perturb_depth: float = 0.20     # initial relative inv-depth perturbation
    perturb_normal_deg: float = 25.0
    cost_invalid: float = 2.0
    min_ndotr: float = 0.05     # reject grazing plane/ray intersections
    min_sigma: float = 1e-3     # reject textureless NCC windows
    # Fine level of the coarse-to-fine schedule: 5 candidates (the
    # neighbours and a joint perturbation), no random restart and no
    # normal-only perturbation.
    fine: bool = False
    # Rank every candidate on the inner window subset, then score the best
    # two on the full window against the incumbent.
    presel: bool = True
    # Neighbour candidates per half-sweep: 2 alternates direction pairs
    # between sweeps, 4 takes all four.
    neighbors: int = 2
    # Source sampling: "bilinear" (4 taps), "nearest" (1 tap, 1/2 px) or
    # "upN" (1 tap from an N-times bilinearly upsampled bf16 copy).
    sampling: str = "up8"


def _window_offsets(cfg: PatchMatchConfig) -> list[tuple[int, int]]:
    """The window's (dy, dx) offsets: a dilated diamond, the 4 far corners
    and a 1-px inner cross, or the full dilated square."""
    r, d = cfg.window_radius, cfg.dilation
    steps = list(range(-r, r + 1, d))
    offs = [(dy, dx) for dy in steps for dx in steps]
    if cfg.window_pattern == "diamond":
        offs = [(dy, dx) for dy, dx in offs if abs(dy) + abs(dx) <= r]
        offs += [(-r, -r), (-r, r), (r, -r), (r, r)]
        if d > 1:
            offs += [(-1, 0), (1, 0), (0, -1), (0, 1)]
    return offs


def _presel_offsets(cfg: PatchMatchConfig) -> list[tuple[int, int]]:
    """Pre-selection subset: the 1-px cross and the 4 far corners."""
    r = cfg.window_radius
    offs = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1),
            (-r, -r), (-r, r), (r, -r), (r, r)]
    seen = []
    for o in offs:
        if o not in seen:
            seen.append(o)
    return seen


def _shift_edge(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Static shift with edge clamp over the first two dims:
    out[y, x] = img[clip(y+dy), clip(x+dx)]."""
    if dy == 0 and dx == 0:
        return img
    H, W = img.shape[:2]
    iy = (torch.arange(H, device=img.device) + dy).clamp(0, H - 1)
    ix = (torch.arange(W, device=img.device) + dx).clamp(0, W - 1)
    return img.index_select(0, iy).index_select(1, ix)


def _index(vv: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Clamp float coordinates to [lo, hi] and make them indices (a NaN
    becomes lo; the caller masks such samples)."""
    return torch.nan_to_num(vv.clamp(lo, hi), nan=float(lo)).long()


def bilinear_flat(flat, src_off, vv, uu, H: int, W: int):
    """Bilinear sample from a flattened image stack flat (S*H*W,) at float
    coords (vv, uu) of any shape; src_off = s*H*W (broadcastable to vv)."""
    v0f = torch.floor(vv).clamp(0, H - 2)
    u0f = torch.floor(uu).clamp(0, W - 2)
    fv = torch.clamp(vv - v0f, 0.0, 1.0)
    fu = torch.clamp(uu - u0f, 0.0, 1.0)
    base = src_off + _index(v0f, 0, H - 2) * W + _index(u0f, 0, W - 2)
    flat = flat.reshape(-1)
    g0, g1, g2, g3 = flat[base], flat[base + 1], flat[base + W], flat[base + W + 1]
    return (g0 * (1 - fv) * (1 - fu) + g1 * (1 - fv) * fu
            + g2 * fv * (1 - fu) + g3 * fv * fu)


def nearest_flat(flat, src_off, vv, uu, H: int, W: int):
    """Nearest-neighbour sample (round half to even) from a flattened image
    stack: one gather per sample."""
    v0 = _index(torch.round(vv), 0, H - 1)
    u0 = _index(torch.round(uu), 0, W - 1)
    return flat.reshape(-1)[src_off + v0 * W + u0]


def upsample_pyramid(src_imgs: torch.Tensor, k: int) -> torch.Tensor:
    """(S, H, W) -> (S, H*k, W*k) bilinear upsample with half-pixel centres
    and edge clamp (``jax.image.resize(..., "bilinear")`` when enlarging),
    stored in bfloat16."""
    S, H, W = src_imgs.shape
    up = F.interpolate(src_imgs[:, None], size=(H * k, W * k), mode="bilinear",
                       align_corners=False, antialias=False)
    return up[:, 0].to(torch.bfloat16)


def make_sampler(src_imgs: torch.Tensor, mode: str):
    """Per-source sampler `sample(vv, uu, src_axis=0) -> values` over a
    stack (S, H, W); vv/uu are float pixel coords in the original
    resolution whose axis `src_axis` runs over the S sources.  Modes as
    PatchMatchConfig.sampling."""
    S, H, W = src_imgs.shape

    def off(shape, axis, hw):
        return (torch.arange(S, device=src_imgs.device) * hw).reshape(
            (1,) * axis + (S,) + (1,) * (len(shape) - axis - 1))

    if mode.startswith("up"):
        k = int(mode[2:])
        Hs, Ws = H * k, W * k
        flat = upsample_pyramid(src_imgs, k).reshape(-1)
        half = (k - 1) * 0.5  # pixel-centre alignment of the upsampled grid

        def sample(vv, uu, src_axis=0):
            out = nearest_flat(flat, off(vv.shape, src_axis, Hs * Ws), vv * k + half,
                               uu * k + half, Hs, Ws)
            return out.to(torch.float32)
    elif mode == "nearest":
        flat = src_imgs.reshape(-1)

        def sample(vv, uu, src_axis=0):
            return nearest_flat(flat, off(vv.shape, src_axis, H * W), vv, uu, H, W)
    elif mode == "bilinear":
        flat = src_imgs.reshape(-1)

        def sample(vv, uu, src_axis=0):
            return bilinear_flat(flat, off(vv.shape, src_axis, H * W), vv, uu, H, W)
    else:
        raise ValueError(f"unknown sampling mode {mode!r}")
    return sample


def _parity_cond(x: torch.Tensor, phase: int, hdim: int) -> torch.Tensor:
    """Rows whose active column offset is 0, shaped to broadcast against
    the column-halved x."""
    H = x.shape[hdim]
    even = (torch.arange(H, device=x.device) + phase) % 2 == 0
    return even.reshape((H,) + (1,) * (x.dim() - hdim - 1))


def _gather_parity(x: torch.Tensor, phase: int, hdim: int = 0) -> torch.Tensor:
    """Active cells of checkerboard parity `phase`: row y keeps columns x
    with (x + y + phase) % 2 == 0.  x (..., H, W[, k]) with H at `hdim`
    -> (..., H, W/2[, k])."""
    idx = (slice(None),) * (hdim + 1)
    a = x[idx + (slice(0, None, 2),)]
    b = x[idx + (slice(1, None, 2),)]
    return torch.where(_parity_cond(x, phase, hdim), a, b)


def _scatter_parity(x: torch.Tensor, val: torch.Tensor, phase: int) -> torch.Tensor:
    """Inverse of _gather_parity: write val (H, W/2[, k]) into the active
    cells of x (H, W[, k]), leaving the other parity as it is."""
    a = x[:, 0::2]
    b = x[:, 1::2]
    cond = _parity_cond(x, phase, 0)
    a2 = torch.where(cond, val, a)
    b2 = torch.where(cond, b, val)
    return torch.stack([a2, b2], dim=2).reshape(x.shape)


def _plane_from_state(inv_d, n, rpx, rpy):
    """Plane constant c = n . X_p with X_p = r_p / inv_d (ray z-component 1)."""
    ndotr = n[..., 0] * rpx + n[..., 1] * rpy + n[..., 2]
    return ndotr / torch.clamp(inv_d, min=1e-9)


def _state_from_plane(n, c, rpx, rpy, min_ndotr):
    """Inverse depth of pixel p's ray intersected with plane (n, c)."""
    ndotr = n[..., 0] * rpx + n[..., 1] * rpy + n[..., 2]
    safe = torch.abs(ndotr) > min_ndotr
    c_safe = torch.where(torch.abs(c) < 1e-9, torch.full_like(c, 1e-9), c)
    inv_d = torch.where(safe, ndotr / c_safe, torch.zeros_like(c))
    return inv_d, safe


def _random_unit_normal(u_x, u_y):
    """Camera-facing (n_z < 0) unit normals within ~60 deg of -z from two
    uniform draws."""
    nx = 0.7 * (u_x * 2.0 - 1.0)
    ny = 0.7 * (u_y * 2.0 - 1.0)
    n = torch.stack([nx, ny, -torch.ones_like(nx)], dim=-1)
    return n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)


def _perturb_normal(z, n, max_deg: float):
    """Small rotation of each normal by a normal draw z (n's shape), kept
    camera-facing."""
    rad = float(np.float32(max_deg) * np.float32(np.pi / 180.0))
    out = n + z * rad * 0.5
    out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-9)
    return torch.where(out[..., 2:3] < -0.05, out, n)


def _cost_active(n_a, c_a, xs_a, ys_a, rv_stack, mr_a, varr_a, sample, S,
                 fx, fy, cx, cy, fxs, fys, cxs, cys, R_rel, t_rel,
                 offsets, cfg: PatchMatchConfig, HW):
    """NCC cost of candidate planes (n_a (*B, H, Wh, 3), c_a (*B, H, Wh))
    on the active pixel field with coordinates (ys_a, xs_a) (H, Wh); B is
    an optional leading candidate axis.

    rv_stack (No, H, Wh): reference intensities at each window offset;
    mr_a/varr_a: the reference window's mean and variance (H, Wh).
    Returns the best-k mean cost over sources (*B, H, Wh), in [0, 2]."""
    H, W = HW
    No = len(offsets)
    dev = c_a.device
    nb = c_a.dim()
    # Axes: offsets, sources, then candidates and pixels; offsets lead so
    # that each offset's terms are contiguous for the running sums.
    col = (1, S) + (1,) * nb
    R = [[R_rel[:, i, j].reshape(col) for j in range(3)] for i in range(3)]
    t = [t_rel[:, i].reshape(col) for i in range(3)]
    fxs_, fys_ = fxs.reshape(col), fys.reshape(col)
    cxs_, cys_ = cxs.reshape(col), cys.reshape(col)
    per_off = S * c_a.numel()
    chunk = max(1, min(No, _BATCH_ELEMS // max(per_off, 1)))
    sums = None
    for o0 in range(0, No, chunk):
        offs = torch.as_tensor(offsets[o0:o0 + chunk], dtype=torch.float32, device=dev)
        shp = (len(offs), 1) + (1,) * nb
        dy, dx = offs[:, 0].reshape(shp), offs[:, 1].reshape(shp)
        rv = rv_stack[o0:o0 + chunk].reshape((len(offs), 1) + (1,) * (nb - 2)
                                             + rv_stack.shape[1:])
        # Window ray at q = p + (dx, dy), intersected with p's plane.
        rqx = (xs_a + dx - cx) / fx
        rqy = (ys_a + dy - cy) / fy
        ndotr = n_a[..., 0] * rqx + n_a[..., 1] * rqy + n_a[..., 2]
        safe = torch.abs(ndotr) > cfg.min_ndotr
        s = c_a / torch.where(safe, ndotr,
                              torch.where(ndotr >= 0, torch.full_like(ndotr, cfg.min_ndotr),
                                          torch.full_like(ndotr, -cfg.min_ndotr)))
        a, b = s * rqx, s * rqy
        X0 = R[0][0] * a + R[0][1] * b + R[0][2] * s + t[0]
        X1 = R[1][0] * a + R[1][1] * b + R[1][2] * s + t[1]
        z = R[2][0] * a + R[2][1] * b + R[2][2] * s + t[2]
        zsafe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        us = X0 / zsafe * fxs_ + cxs_
        vs = X1 / zsafe * fys_ + cys_
        inb = (us >= 0) & (us <= W - 1) & (vs >= 0) & (vs <= H - 1) & (z > 0) & safe
        sv = torch.where(inb, sample(vs, us, src_axis=1), torch.zeros_like(us))
        terms = (sv, sv * sv, sv * rv, (~inb).to(torch.float32))
        for j in range(len(offs)):  # the reference's order: offset by offset
            part = tuple(x[j] for x in terms)
            sums = part if sums is None else tuple(p + q for p, q in zip(sums, part))
    s_s, s_ss, s_rs, oob = sums

    N = float(No)
    ms = s_s / N
    var_s = torch.clamp(s_ss / N - ms * ms, min=0.0)
    cov = s_rs / N - mr_a * ms
    sig = torch.sqrt(varr_a * var_s)
    ncc = torch.clamp(cov / torch.clamp(sig, min=cfg.min_sigma ** 2), -1.0, 1.0)
    ok = (oob < 0.3 * N) & (varr_a > cfg.min_sigma ** 2)
    cost_s = torch.where(ok, 1.0 - ncc, torch.full_like(ncc, cfg.cost_invalid))
    return _best_k_mean(cost_s, min(cfg.best_k, S))


def _best_k_mean(cost_s: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of the k smallest values along axis 0 (source aggregation)."""
    S = cost_s.shape[0]
    if k >= S:
        return torch.mean(cost_s, dim=0)
    if k == 1:
        return torch.amin(cost_s, dim=0)
    if k == S - 1:
        return (torch.sum(cost_s, dim=0) - torch.amax(cost_s, dim=0)) / k
    return torch.mean(torch.sort(cost_s, dim=0).values[:k], dim=0)


def draw_half_sweep(generator: torch.Generator | None, H: int, Wh: int, fine: bool,
                    device) -> dict:
    """The random draws of one half-sweep, in the reference's order of
    use: "depth" (H, Wh) and "normal" (H, Wh, 3) normals for the joint
    perturbation; unless `fine`, "restart" (H, Wh) uniform inverse depth,
    "restart_nx"/"restart_ny" (H, Wh) uniforms for the restart normal, and
    "normal_only" (H, Wh, 3) normals for the normal-only perturbation."""
    gdev = generator.device if generator is not None else torch.device("cpu")

    def normal(shape):
        return torch.randn(shape, generator=generator, device=gdev).to(device)

    def uniform(shape):
        return torch.rand(shape, generator=generator, device=gdev).to(device)

    d = {"depth": normal((H, Wh)), "normal": normal((H, Wh, 3))}
    if not fine:
        d["restart"] = uniform((H, Wh))
        d["restart_nx"] = uniform((H, Wh))
        d["restart_ny"] = uniform((H, Wh))
        d["normal_only"] = normal((H, Wh, 3))
    return d


def patchmatch_refine(ref_img, src_imgs, K, K_src, R_rel, t_rel, inv_d_init, inv_lo, inv_hi,
                      generator: torch.Generator | None = None,
                      cfg: PatchMatchConfig = PatchMatchConfig(), n_init=None, draws=None):
    """Refine a fronto-parallel depth init into slanted-plane depth.

    ref_img (H, W) raw intensities; src_imgs (S, H, W); K (3, 3) and K_src
    (S, 3, 3) intrinsics; R_rel (S, 3, 3), t_rel (S, 3) ref-cam -> src-cam;
    inv_d_init (H, W) inverse-depth init; inv_lo/inv_hi the search range;
    n_init optional (H, W, 3) normal init (None = fronto-parallel).  Random
    draws come from `generator`, or from `draws`, a list of 2 * n_iters
    dicts as `draw_half_sweep` makes them (at the even width the call pads
    to).  All tensors on one device.  Returns (depth, cost, normal)."""
    H, W = ref_img.shape
    if W % 2:  # parity compaction needs an even width: edge-pad one column
        ref_p = torch.cat([ref_img, ref_img[:, -1:]], dim=1)
        src_p = torch.cat([src_imgs, src_imgs[:, :, -1:]], dim=2)
        inv_p = torch.cat([inv_d_init, inv_d_init[:, -1:]], dim=1)
        n_p = None if n_init is None else torch.cat([n_init, n_init[:, -1:]], dim=1)
        d, c, n = patchmatch_refine(ref_p, src_p, K, K_src, R_rel, t_rel, inv_p, inv_lo, inv_hi,
                                    generator, cfg, n_p, draws)
        return d[:, :W], c[:, :W], n[:, :W]

    dev = ref_img.device
    f32 = dict(dtype=torch.float32, device=dev)
    inv_lo = torch.as_tensor(inv_lo, **f32)
    inv_hi = torch.as_tensor(inv_hi, **f32)
    Wh = W // 2
    S = src_imgs.shape[0]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    fxs, fys = K_src[:, 0, 0], K_src[:, 1, 1]
    cxs, cys = K_src[:, 0, 2], K_src[:, 1, 2]
    ys = torch.arange(H, **f32)[:, None] * torch.ones((1, W), **f32)
    xs = torch.arange(W, **f32)[None, :] * torch.ones((H, 1), **f32)
    rpx = (xs - cx) / fx
    rpy = (ys - cy) / fy
    offsets = _window_offsets(cfg)
    No = len(offsets)

    # Candidate-independent reference window statistics.
    shifted = torch.stack([_shift_edge(ref_img, dy, dx) for dy, dx in offsets])
    s_r = torch.zeros((H, W), **f32)
    s_rr = torch.zeros((H, W), **f32)
    for i in range(No):
        s_r = s_r + shifted[i]
        s_rr = s_rr + shifted[i] * shifted[i]
    mr = s_r / No
    var_r = torch.clamp(s_rr / No - mr * mr, min=0.0)

    sample = make_sampler(src_imgs, cfg.sampling)
    cost_kw = dict(sample=sample, S=S, fx=fx, fy=fy, cx=cx, cy=cy, fxs=fxs, fys=fys,
                   cxs=cxs, cys=cys, R_rel=R_rel, t_rel=t_rel, cfg=cfg, HW=(H, W))
    p_offs = _presel_offsets(cfg)
    shifted_p = torch.stack([_shift_edge(ref_img, dy, dx) for dy, dx in p_offs])
    ys_a = ys[:, :Wh]

    # What depends only on the parity, for phase 0 and 1.
    par = []
    for phase in (0, 1):
        odd = ((torch.arange(H, device=dev) + phase) % 2).to(torch.float32)
        xs_a = 2.0 * torch.arange(Wh, **f32)[None, :] + odd[:, None]
        rvp = _gather_parity(shifted_p, phase, hdim=1)
        s_rp = sum(rvp[i] for i in range(len(p_offs)))
        s_rrp = sum(rvp[i] * rvp[i] for i in range(len(p_offs)))
        mr_p = s_rp / len(p_offs)
        par.append(dict(
            xs_a=xs_a, rpx_a=(xs_a - cx) / fx, rpy_a=(ys_a - cy) / fy,
            rv=_gather_parity(shifted, phase, hdim=1),
            mr=_gather_parity(mr, phase), var=_gather_parity(var_r, phase),
            rvp=rvp, mr_p=mr_p, var_p=torch.clamp(s_rrp / len(p_offs) - mr_p * mr_p, min=0.0)))

    def full_cost(phase, nn, cc):
        p = par[phase]
        return _cost_active(nn, cc, p["xs_a"], ys_a, p["rv"], p["mr"], p["var"],
                            offsets=offsets, **cost_kw)

    if n_init is None:
        n0 = torch.zeros((H, W, 3), **f32)
        n0[..., 2] = -1.0  # fronto-parallel
    else:
        nl = torch.linalg.vector_norm(n_init, dim=-1, keepdim=True)
        n0 = n_init / torch.clamp(nl, min=1e-9)
    inv0 = torch.minimum(torch.maximum(inv_d_init, inv_lo), inv_hi)
    c0_full = _plane_from_state(inv0, n0, rpx, rpy)
    cost0 = torch.zeros((H, W), **f32)
    for ph in (0, 1):
        ca = full_cost(ph, _gather_parity(n0, ph), _gather_parity(c0_full, ph))
        cost0 = _scatter_parity(cost0, ca, ph)

    inv_d, n, cost = inv0, n0, cost0
    n_sweeps = 2 * cfg.n_iters
    for sweep in range(n_sweeps):
        phase = sweep % 2
        scale = 0.5 ** (sweep // 2)
        p = par[phase]
        dr = draws[sweep] if draws is not None else draw_half_sweep(generator, H, Wh, cfg.fine,
                                                                     dev)
        rpx_a, rpy_a = p["rpx_a"], p["rpy_a"]
        c_cur = _plane_from_state(inv_d, n, rpx, rpy)
        inv_a = _gather_parity(inv_d, phase)
        n_a = _gather_parity(n, phase)
        cost_a = _gather_parity(cost, phase)

        # Neighbour propagation (the other parity): (down, up) on even
        # sweeps and (right, left) on odd ones, or all four.
        dirs = ((1, 0), (-1, 0), (0, 1), (0, -1))
        if cfg.neighbors < 4:
            dirs = dirs[:2] if sweep % 2 == 0 else dirs[2:]
        cand_n = [_gather_parity(_shift_edge(n, dy, dx), phase) for dy, dx in dirs]
        cand_c = [_gather_parity(_shift_edge(c_cur, dy, dx), phase) for dy, dx in dirs]
        # Joint depth + normal perturbation (shrinking scale).
        inv_p = inv_a * torch.exp(dr["depth"] * cfg.perturb_depth * scale)
        inv_p = torch.minimum(torch.maximum(inv_p, inv_lo), inv_hi)
        n_p = _perturb_normal(dr["normal"], n_a, cfg.perturb_normal_deg * scale)
        cand_n.append(n_p)
        cand_c.append(_plane_from_state(inv_p, n_p, rpx_a, rpy_a))
        if not cfg.fine:
            # Random restart (full range), then a normal-only perturbation.
            inv_r = inv_lo + (inv_hi - inv_lo) * dr["restart"]
            n_r = _random_unit_normal(dr["restart_nx"], dr["restart_ny"])
            cand_n.append(n_r)
            cand_c.append(_plane_from_state(inv_r, n_r, rpx_a, rpy_a))
            n_o = _perturb_normal(dr["normal_only"], n_a, cfg.perturb_normal_deg * scale)
            cand_n.append(n_o)
            cand_c.append(_plane_from_state(inv_a, n_o, rpx_a, rpy_a))
        cand_n_st = torch.stack(cand_n)
        cand_c_st = torch.stack(cand_c)

        if cfg.presel and len(cand_n) > 2:
            # Rank every candidate on the inner window, then take the
            # best two (the second with the first masked out).
            costs_p = _cost_active(cand_n_st, cand_c_st, p["xs_a"], ys_a, p["rvp"], p["mr_p"],
                                   p["var_p"], offsets=p_offs, **cost_kw)
            nc = costs_p.shape[0]
            sel1 = torch.argmin(costs_p, dim=0)
            masked = costs_p + (torch.arange(nc, device=dev)[:, None, None]
                                == sel1[None]).to(torch.float32) * 1e9
            sel2 = torch.argmin(masked, dim=0)
            sel = torch.stack([sel1, sel2])
            ev_n = torch.take_along_dim(cand_n_st, sel[..., None], dim=0)
            ev_c = torch.take_along_dim(cand_c_st, sel, dim=0)
        else:
            ev_n, ev_c = cand_n_st, cand_c_st
        ev_cost = full_cost(phase, ev_n, ev_c)
        for j in range(ev_c.shape[0]):
            inv_c, ok = _state_from_plane(ev_n[j], ev_c[j], rpx_a, rpy_a, cfg.min_ndotr)
            ok = ok & (inv_c > inv_lo * 0.5) & (inv_c < inv_hi * 2.0)
            better = ok & (ev_cost[j] < cost_a)
            inv_a = torch.where(better, inv_c, inv_a)
            n_a = torch.where(better[..., None], ev_n[j], n_a)
            cost_a = torch.where(better, ev_cost[j], cost_a)
        inv_d = _scatter_parity(inv_d, inv_a, phase)
        n = _scatter_parity(n, n_a, phase)
        cost = _scatter_parity(cost, cost_a, phase)
    depth = 1.0 / torch.clamp(inv_d, min=1e-9)
    return depth, cost, n
