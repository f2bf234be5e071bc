"""SIFT-class feature detection + description, batched on the device.

Port of ``tpusfm/features/sift.py`` (vlfeat scale space and DoG detector,
orientation assignment, 4x4x8 descriptor, RootSIFT u8 quantization).  The
reference's per-keypoint ``vmap``s are a (B, K) batch written out here:
refinement gathers each keypoint's 3x3x3 DoG cube, and orientation and
descriptor sample a fixed grid from one padded gradient stack of all
octaves, soft-binned with batched matrix products instead of scatter.

Top-k selections use a stable descending sort, so equal scores keep index
order (lowest index first) on every backend; the feature order feeds the
matcher's tie-breaks.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import image as imops


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    n_octaves: int = 4
    n_scales: int = 3          # detectable scales per octave
    sigma0: float = 1.6        # base blur at s=0
    sigma_n: float = 0.5       # assumed input blur
    first_octave: int = 0      # -1 upsamples the input 2x
    peak_thresh: float = 0.04  # contrast threshold, applied as peak_thresh/n_scales
    edge_thresh: float = 10.0  # curvature ratio threshold
    max_per_octave: int = 1024
    max_features: int = 2048
    root_sift: bool = True
    orient_bins: int = 36
    orient_grid: int = 12      # sample grid side for the orientation window
    desc_grid: int = 12        # sample grid side for the descriptor window
    magnif: float = 3.0        # descriptor bin width in units of sigma
    refine_iters: int = 4
    n_orientations: int = 1    # orientation peaks emitted per keypoint


@dataclasses.dataclass
class Features:
    """Fixed-capacity per-image feature set.

    kp (..., N, 4) = (x, y, sigma, angle); desc (..., N, 128) float32 on the
    u8 grid; score (..., N) |DoG|; mask (..., N) validity."""

    kp: torch.Tensor
    desc: torch.Tensor
    score: torch.Tensor
    mask: torch.Tensor

    def replace(self, **kw) -> "Features":
        return dataclasses.replace(self, **kw)


def _stable_topk(x: torch.Tensor, k: int):
    """Largest k along the last axis, ties in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# Scale space
# ---------------------------------------------------------------------------

def _level_sigmas(cfg: SiftConfig) -> np.ndarray:
    S = cfg.n_scales
    return np.array([cfg.sigma0 * 2.0 ** ((l - 1) / S) for l in range(S + 3)])


def build_scale_space(images: torch.Tensor, cfg: SiftConfig):
    """images (B, H, W) in [0,1] -> list of per-octave dicts with 'levels'
    (B, S+3, Ho, Wo) and 'dogs' (B, S+2, Ho, Wo)."""
    S = cfg.n_scales
    sig = _level_sigmas(cfg)
    base = images
    if cfg.first_octave < 0:
        base = imops.upsample2(base)
        sigma_in = cfg.sigma_n * 2.0
    else:
        sigma_in = cfg.sigma_n
    current = imops.blur(base, math.sqrt(max(sig[0] ** 2 - sigma_in ** 2, 1e-10)))
    octaves = []
    for _ in range(cfg.n_octaves):
        levels = [current]
        for l in range(1, S + 3):
            inc = math.sqrt(max(sig[l] ** 2 - sig[l - 1] ** 2, 1e-10))
            levels.append(imops.blur(levels[-1], inc))
        lv = torch.stack(levels, dim=-3)
        octaves.append({"levels": lv, "dogs": lv[..., 1:, :, :] - lv[..., :-1, :, :]})
        current = imops.downsample2(levels[S])
        if min(current.shape[-2:]) < 8:
            break
    return octaves


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

def _extrema_score(dogs: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """26-neighbour extremum scan: dogs (B, S+2, H, W) -> score (B, S, H, W),
    zero where not an extremum or on the one-pixel border."""
    S = dogs.shape[-3] - 2
    mx = dogs
    mn = dogs
    for ax in (-3, -2, -1):
        mx = torch.maximum(torch.maximum(torch.roll(mx, 1, dims=ax), mx), torch.roll(mx, -1, dims=ax))
        mn = torch.minimum(torch.minimum(torch.roll(mn, 1, dims=ax), mn), torch.roll(mn, -1, dims=ax))
    center = dogs[..., 1: S + 1, :, :]
    th = 0.8 * cfg.peak_thresh / cfg.n_scales
    is_max = (center >= mx[..., 1: S + 1, :, :]) & (center > th)
    is_min = (center <= mn[..., 1: S + 1, :, :]) & (center < -th)
    score = torch.abs(center) * (is_max | is_min)
    h, w = dogs.shape[-2:]
    ar_h = torch.arange(h, device=dogs.device)
    ar_w = torch.arange(w, device=dogs.device)
    ym = ((ar_h >= 1) & (ar_h <= h - 2)).to(score.dtype)
    xm = ((ar_w >= 1) & (ar_w <= w - 2)).to(score.dtype)
    return score * ym[:, None] * xm[None, :]


def _topk_keypoints(score: torch.Tensor, k: int):
    """score (B, S, H, W) -> (vals, si, yi, xi) each (B, k)."""
    b = score.shape[0]
    S, h, w = score.shape[-3:]
    flat = score.reshape(b, -1)
    vals, idx = _stable_topk(flat, min(k, flat.shape[-1]))
    si = idx // (h * w)
    rem = idx % (h * w)
    return vals, si + 1, rem // w, rem % w


def _gather_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Reference gather semantics: a negative index wraps once, an index
    past the end clamps to the last element."""
    return torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)


_CUBE_OFF = np.stack(np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), np.arange(-1, 2),
                                 indexing="ij"), axis=-1).reshape(27, 3)


def _refine(dogs: torch.Tensor, si, yi, xi, cfg: SiftConfig):
    """Subpixel refinement of (B, K) keypoints against dogs (B, S+2, H, W):
    fixed-iteration re-centering + quadratic fit.  Returns (x, y, s_cont,
    value, valid, s_idx), each (B, K)."""
    B, n_dog, h, w = dogs.shape
    S = n_dog - 2
    off = torch.as_tensor(_CUBE_OFF, device=dogs.device)
    bidx = torch.arange(B, device=dogs.device)[:, None, None]

    def load_cube(s, y, x):
        ss = _gather_index(s[..., None] + off[:, 0], n_dog)
        yy = _gather_index(y[..., None] + off[:, 1], h)
        xx = _gather_index(x[..., None] + off[:, 2], w)
        return dogs[bidx, ss, yy, xx].reshape(*s.shape, 3, 3, 3)

    def grad_hess(c):
        g = 0.5 * torch.stack(
            [c[..., 2, 1, 1] - c[..., 0, 1, 1], c[..., 1, 2, 1] - c[..., 1, 0, 1],
             c[..., 1, 1, 2] - c[..., 1, 1, 0]], dim=-1)
        ctr = c[..., 1, 1, 1]
        Hss = c[..., 2, 1, 1] + c[..., 0, 1, 1] - 2 * ctr
        Hyy = c[..., 1, 2, 1] + c[..., 1, 0, 1] - 2 * ctr
        Hxx = c[..., 1, 1, 2] + c[..., 1, 1, 0] - 2 * ctr
        Hsy = 0.25 * (c[..., 2, 2, 1] - c[..., 2, 0, 1] - c[..., 0, 2, 1] + c[..., 0, 0, 1])
        Hsx = 0.25 * (c[..., 2, 1, 2] - c[..., 2, 1, 0] - c[..., 0, 1, 2] + c[..., 0, 1, 0])
        Hyx = 0.25 * (c[..., 1, 2, 2] - c[..., 1, 2, 0] - c[..., 1, 0, 2] + c[..., 1, 0, 0])
        return g, (Hss, Hsy, Hsx, Hyy, Hyx, Hxx)

    def solve(g, H):
        # Closed-form symmetric 3x3 solve (adjugate).
        Hss, Hsy, Hsx, Hyy, Hyx, Hxx = H
        a, b_, c_ = Hss + 1e-10, Hsy, Hsx
        e, f_ = Hyy + 1e-10, Hyx
        i_ = Hxx + 1e-10
        A = e * i_ - f_ * f_
        Bc = c_ * f_ - b_ * i_
        Cc = b_ * f_ - c_ * e
        E = a * i_ - c_ * c_
        Fc = b_ * c_ - a * f_
        I = a * e - b_ * b_
        det = a * A + b_ * Bc + c_ * Cc
        inv_det = torch.where(torch.abs(det) > 1e-20, 1.0 / det, torch.zeros_like(det))
        g0, g1, g2 = g[..., 0], g[..., 1], g[..., 2]
        d = -inv_det[..., None] * torch.stack([
            A * g0 + Bc * g1 + Cc * g2,
            Bc * g0 + E * g1 + Fc * g2,
            Cc * g0 + Fc * g1 + I * g2,
        ], dim=-1)
        finite = torch.isfinite(d).all(dim=-1, keepdim=True)
        return torch.where(finite, d, torch.zeros_like(d))

    def step(v, dv, lo, hi):
        return torch.clamp(v + (dv > 0.6).long() - (dv < -0.6).long(), lo, hi)

    s, y, x = si, yi, xi
    for _ in range(cfg.refine_iters):
        g, H = grad_hess(load_cube(s, y, x))
        d = solve(g, H)
        s = step(s, d[..., 0], 1, S)
        y = step(y, d[..., 1], 1, h - 2)
        x = step(x, d[..., 2], 1, w - 2)
    c = load_cube(s, y, x)
    g, H = grad_hess(c)
    d = solve(g, H)
    val = c[..., 1, 1, 1] + 0.5 * torch.sum(g * d, dim=-1)
    _, _, _, Hyy, Hyx, Hxx = H
    det = Hxx * Hyy - Hyx * Hyx
    tr = Hxx + Hyy
    r = cfg.edge_thresh
    edge_ok = (det > 0) & (tr * tr / torch.where(det > 0, det, torch.ones_like(det))
                           < (r + 1.0) ** 2 / r)
    in_cell = torch.all(torch.abs(d) < 1.5, dim=-1)
    peak_ok = torch.abs(val) >= cfg.peak_thresh / cfg.n_scales
    valid = edge_ok & in_cell & peak_ok
    return (x + d[..., 2], y + d[..., 1], (s - 1).to(d.dtype) + d[..., 0], val, valid, s)


# ---------------------------------------------------------------------------
# Orientation + descriptor (gather + soft-bin products, no scatter)
# ---------------------------------------------------------------------------

def _soft_bin_circular(fbin: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Fractional circular bin (...,) -> tent weights (..., n_bins)."""
    centers = torch.arange(n_bins, dtype=fbin.dtype, device=fbin.device)
    d = torch.abs(fbin[..., None] - centers)
    d = torch.minimum(d, n_bins - d)
    return torch.clamp(1.0 - d, min=0.0)


def _soft_bin_linear(fbin: torch.Tensor, n_bins: int) -> torch.Tensor:
    centers = torch.arange(n_bins, dtype=fbin.dtype, device=fbin.device)
    return torch.clamp(1.0 - torch.abs(fbin[..., None] - centers), min=0.0)


def _orientations(grad, bidx, lvl, x, y, sigma, hl, wl, cfg: SiftConfig):
    """Orientation peaks for (B, K) keypoints: the dominant histogram peak
    plus secondary local maxima >= 80% of it.  Returns (thetas (B, K, O),
    ori_mask (B, K, O)) with O = cfg.n_orientations."""
    G = cfg.orient_grid
    nb = cfg.orient_bins
    dev = x.device
    win_r = (3.0 * 1.5 * sigma)[..., None, None]  # (B, K, 1, 1)
    lin = torch.linspace(-1.0, 1.0, G, device=dev)
    du = lin[None, :] * win_r
    dv = lin[:, None] * win_r
    ma = imops.bilinear_sample_level_ch(
        grad, bidx[..., None, None], lvl[..., None, None], y[..., None, None] + dv,
        x[..., None, None] + du, hl[..., None, None], wl[..., None, None])
    m, a = ma[..., 0], ma[..., 1]
    wr = torch.clamp(win_r, min=1e-6)
    r2 = (du / wr) ** 2 + (dv / wr) ** 2
    sig15 = (1.5 * sigma)[..., None, None]
    wgt = torch.exp(-r2 * (win_r ** 2) / (2.0 * sig15 ** 2)) * (r2 <= 1.0)
    wb = _soft_bin_circular(a / (2.0 * np.pi) * nb, nb)
    hist = torch.einsum("bkgh,bkghn->bkn", m * wgt, wb)
    for _ in range(6):
        hist = (torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1)) / 3.0

    def interp_peak(peak):
        hp = torch.gather(hist, -1, ((peak + 1) % nb)[..., None])[..., 0]
        hm = torch.gather(hist, -1, ((peak - 1) % nb)[..., None])[..., 0]
        h0 = torch.gather(hist, -1, peak[..., None])[..., 0]
        denom = hm - 2.0 * h0 + hp
        dp = torch.where(torch.abs(denom) > 1e-12, 0.5 * (hm - hp) / denom, torch.zeros_like(denom))
        dp = torch.clamp(dp, -0.5, 0.5)
        return torch.remainder((peak + dp) / nb * 2.0 * np.pi, 2.0 * np.pi)

    bins = torch.arange(nb, device=dev)
    is_local_max = (hist >= torch.roll(hist, 1, dims=-1)) & (hist >= torch.roll(hist, -1, dims=-1))
    peak0 = torch.argmax(hist, dim=-1)
    thetas = [interp_peak(peak0)]
    masks = [torch.ones_like(peak0, dtype=torch.bool)]
    h_max = torch.gather(hist, -1, peak0[..., None])[..., 0]
    dist = torch.abs(bins - peak0[..., None])
    excluded = torch.minimum(dist, nb - dist) <= 1
    for _ in range(cfg.n_orientations - 1):
        cand = torch.where(is_local_max & ~excluded, hist, torch.full_like(hist, -1.0))
        pk = torch.argmax(cand, dim=-1)
        masks.append(torch.gather(cand, -1, pk[..., None])[..., 0] >= 0.8 * h_max)
        thetas.append(interp_peak(pk))
        dist = torch.abs(bins - pk[..., None])
        excluded = excluded | (torch.minimum(dist, nb - dist) <= 1)
    return torch.stack(thetas, dim=-1), torch.stack(masks, dim=-1)


def _descriptors(grad, bidx, lvl, x, y, sigma, theta, hl, wl, cfg: SiftConfig):
    """128-D descriptors for (B, K) keypoints at orientation theta, sampled on
    a fixed GxG grid in the rotated keypoint frame and soft-binned into
    4 x 4 x 8.  Returns (B, K, 128) on the u8 grid (stored as float)."""
    NBP, NBO = 4, 8
    G = cfg.desc_grid
    dev = x.device
    half = (NBP + 1) / 2.0
    lin = torch.linspace(-half, half, G, device=dev)
    nx = lin[None, :].expand(G, G)
    ny = lin[:, None].expand(G, G)
    sbp = (cfg.magnif * sigma)[..., None, None]
    ct = torch.cos(theta)[..., None, None]
    st = torch.sin(theta)[..., None, None]
    xs = x[..., None, None] + (ct * nx - st * ny) * sbp
    ys = y[..., None, None] + (st * nx + ct * ny) * sbp
    ma = imops.bilinear_sample_level_ch(
        grad, bidx[..., None, None], lvl[..., None, None], ys, xs,
        hl[..., None, None], wl[..., None, None])
    m, a = ma[..., 0], ma[..., 1]
    wgt = torch.exp(-(nx ** 2 + ny ** 2) / (2.0 * (NBP / 2.0) ** 2))
    rel = torch.remainder(a - theta[..., None, None], 2.0 * np.pi)
    wo = _soft_bin_circular(rel / (2.0 * np.pi) * NBO, NBO)  # (B, K, G, G, 8)
    wx = _soft_bin_linear(nx + (NBP - 1) / 2.0, NBP)         # (G, G, 4)
    wy = _soft_bin_linear(ny + (NBP - 1) / 2.0, NBP)
    S = G * G
    wxy = (wy[..., :, None] * wx[..., None, :]).reshape(S, NBP * NBP)
    weighted = wxy * (m * wgt).reshape(*m.shape[:-2], S, 1)   # (B, K, S, 16)
    desc = weighted.transpose(-1, -2) @ wo.reshape(*wo.shape[:-3], S, NBO)
    d = desc.reshape(*desc.shape[:-2], NBP * NBP * NBO)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    d = torch.clamp(d, max=0.2)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    if cfg.root_sift:
        d = torch.sqrt(d / torch.clamp(torch.sum(d, dim=-1, keepdim=True), min=1e-12))
    return torch.clamp(torch.floor(512.0 * d), max=255.0)


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def _detect_octave_candidates(oct_data, cfg: SiftConfig):
    """One octave: DoG extrema -> top-K -> subpixel refine.  (B, K) arrays
    in octave coordinates."""
    dogs = oct_data["dogs"]
    k = min(cfg.max_per_octave, dogs.shape[-1] * dogs.shape[-2] * cfg.n_scales)
    vals, si, yi, xi = _topk_keypoints(_extrema_score(dogs, cfg), k)
    x, y, s_cont, val, valid, s_idx = _refine(dogs, si, yi, xi, cfg)
    return dict(x=x, y=y, s_cont=s_cont, val=val, valid=valid & (vals > 0), s_idx=s_idx)


def sift_features(images: torch.Tensor, cfg: SiftConfig = SiftConfig(),
                  masks: torch.Tensor | None = None) -> Features:
    """Detector + describer over a batch: images (B, H, W) float32 in [0, 1]
    -> Features with capacity cfg.max_features per image.  masks (B, H, W),
    optional: keypoints on zero-mask pixels are discarded before the
    capacity top-k."""
    octaves = build_scale_space(images, cfg)
    S = cfg.n_scales
    L = S + 3
    B = images.shape[0]
    dev = images.device
    H0, W0 = octaves[0]["levels"].shape[-2:]
    cands = [_detect_octave_candidates(o, cfg) for o in octaves]

    def cat(field):
        return torch.cat([c[field] for c in cands], dim=-1)

    x, y, s_cont, val, valid, s_idx = (cat(f) for f in ("x", "y", "s_cont", "val", "valid", "s_idx"))
    oct_idx = torch.cat([torch.full(c["x"].shape, i, dtype=torch.long, device=dev)
                         for i, c in enumerate(cands)], dim=-1)
    oh = torch.as_tensor([o["levels"].shape[-2] for o in octaves], device=dev)
    ow = torch.as_tensor([o["levels"].shape[-1] for o in octaves], device=dev)
    scale = 2.0 ** (oct_idx.to(torch.float32) + cfg.first_octave)

    if masks is not None:
        H, W = images.shape[-2:]
        xi = torch.clamp(torch.round(x * scale).long(), 0, W - 1)
        yi = torch.clamp(torch.round(y * scale).long(), 0, H - 1)
        inside = masks[torch.arange(B, device=dev)[:, None], yi, xi]
        valid = valid & (inside > 0)

    n = cfg.max_features
    masked_score = torch.where(valid, torch.abs(val), torch.full_like(val, -1.0))
    if masked_score.shape[-1] > n:
        score, sel = _stable_topk(masked_score, n)
        x, y, s_cont, s_idx, oct_idx, valid, scale = (
            torch.gather(v, -1, sel) for v in (x, y, s_cont, s_idx, oct_idx, valid, scale))
    else:
        score = masked_score

    grads = []
    for o in octaves:
        m, a = imops.gradients(o["levels"])
        ph, pw = H0 - m.shape[-2], W0 - m.shape[-1]
        g = torch.stack([m, a], dim=-1)
        grads.append(torch.nn.functional.pad(g, (0, 0, 0, pw, 0, ph)))
    grad = torch.cat(grads, dim=1)  # (B, n_oct * L, H0, W0, 2)

    lvl = oct_idx * L + s_idx
    hl = oh[oct_idx]
    wl = ow[oct_idx]
    bidx = torch.arange(B, device=dev)[:, None].expand(lvl.shape)
    sigma_oct = cfg.sigma0 * 2.0 ** (s_cont / S)
    theta, ori_mask = _orientations(grad, bidx, lvl, x, y, sigma_oct, hl, wl, cfg)
    n_ori = cfg.n_orientations
    K = x.shape[-1]

    def tile(v):  # (B, K) -> (B, K * n_ori)
        return v[..., None].expand(B, K, n_ori).reshape(B, K * n_ori)

    desc = _descriptors(grad, tile(bidx), tile(lvl), tile(x), tile(y), tile(sigma_oct),
                        theta.reshape(B, K * n_ori), tile(hl), tile(wl), cfg)
    kp = torch.stack([tile(x * scale), tile(y * scale), tile(sigma_oct * scale),
                      theta.reshape(B, K * n_ori)], dim=-1)
    score = tile(score)
    mask = tile(valid) & ori_mask.reshape(B, K * n_ori)

    if n_ori > 1 and kp.shape[-2] > n:
        score, sel = _stable_topk(torch.where(mask, score, torch.full_like(score, -1.0)), n)
        kp = torch.gather(kp, -2, sel[..., None].expand(B, n, 4))
        desc = torch.gather(desc, -2, sel[..., None].expand(B, n, desc.shape[-1]))
        mask = torch.gather(mask, -1, sel)
    return Features(kp=kp, desc=desc, score=score, mask=mask & (score > 0))


def detect_and_describe(images: torch.Tensor, cfg: SiftConfig = SiftConfig(),
                        masks: torch.Tensor | None = None) -> Features:
    """Entry point: (B, H, W[, 3]) uint8 or float images, plus an optional
    (B, H, W) feature mask (nonzero = keep)."""
    return sift_features(imops.to_grayscale(images), cfg, masks=masks)
