"""Image array ops: separable Gaussian blur, decimation, bilinear resize and
sampling, gradients, and the full-image undistortion remap of the dense
stage.

Port of ``tpusfm/ops/image.py``.  The blur keeps the reference's layout and
edge semantics: NCHW, edge-replicate padding (``F.pad(mode="replicate")``),
then the same (1, 1, k, 1) and (1, 1, 1, k) taps through ``F.conv2d``.  A
float32 convolution on the card runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off; ``pipeline.sparse.run_sparse``
turns it off so SIFT extrema do not move.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    """1-D Gaussian taps truncated at 4 sigma (vlfeat's truncation)."""
    if radius is None:
        radius = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / max(sigma, 1e-8)) ** 2)
    return (k / k.sum()).astype(np.float32)


def blur(images: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur over (..., H, W), SAME size, edge-replicate."""
    if sigma <= 0:
        return images
    k = torch.as_tensor(gaussian_kernel1d(sigma), device=images.device)
    r = (k.shape[0] - 1) // 2
    batch_shape = images.shape[:-2]
    h, w = images.shape[-2:]
    x = images.reshape(-1, 1, h, w)
    x = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), k.reshape(1, 1, -1, 1))
    x = F.conv2d(F.pad(x, (r, r, 0, 0), mode="replicate"), k.reshape(1, 1, 1, -1))
    return x.reshape(*batch_shape, h, w)


def downsample2(images: torch.Tensor) -> torch.Tensor:
    """Decimate by 2 (every other pixel)."""
    return images[..., ::2, ::2]


def resize_bilinear(images: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W) with half-pixel centers (the
    ``jax.image.resize`` convention for upsampling)."""
    batch_shape = images.shape[:-2]
    h, w = images.shape[-2:]
    x = F.interpolate(images.reshape(-1, 1, h, w), size=shape, mode="bilinear",
                      align_corners=False)
    return x.reshape(*batch_shape, *shape)


def upsample2(images: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample (first_octave = -1)."""
    h, w = images.shape[-2:]
    return resize_bilinear(images, (2 * h, 2 * w))


def bilinear_sample(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bilinear gather from img (H, W) at float coords y, x (any shape),
    clamped to the image (edge padding semantics)."""
    h, w = img.shape[-2:]
    y = torch.clamp(y, 0.0, h - 1.0)
    x = torch.clamp(x, 0.0, w - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = y - y0
    fx = x - x0
    return (
        img[y0, x0] * (1 - fy) * (1 - fx)
        + img[y0, x1] * (1 - fy) * fx
        + img[y1, x0] * fy * (1 - fx)
        + img[y1, x1] * fy * fx
    )


def bilinear_sample_level(vol: torch.Tensor, lvl, y: torch.Tensor, x: torch.Tensor,
                          h_lim=None, w_lim=None) -> torch.Tensor:
    """Bilinear gather from level lvl of a stack vol (L, H, W) at float
    coords y, x.  h_lim/w_lim (optional int scalars or tensors) clamp the
    coordinates to the level's true extent [0, h_lim) x [0, w_lim), as for
    levels of different sizes zero-padded into one stack."""
    h, w = vol.shape[-2:]
    hi = torch.as_tensor(h if h_lim is None else h_lim, device=y.device) - 1
    wi = torch.as_tensor(w if w_lim is None else w_lim, device=x.device) - 1
    y = torch.minimum(torch.clamp(y, min=0.0), hi.to(y.dtype))
    x = torch.minimum(torch.clamp(x, min=0.0), wi.to(x.dtype))
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.minimum(y0 + 1, hi)
    x1 = torch.minimum(x0 + 1, wi)
    fy = y - y0
    fx = x - x0
    return (
        vol[lvl, y0, x0] * (1 - fy) * (1 - fx)
        + vol[lvl, y0, x1] * (1 - fy) * fx
        + vol[lvl, y1, x0] * fy * (1 - fx)
        + vol[lvl, y1, x1] * fy * fx
    )


def undistort_image(image: torch.Tensor, intr: torch.Tensor, fill: float = 0.0,
                    model: str = "auto") -> torch.Tensor:
    """Resample a captured (distorted) image onto the ideal pinhole grid:
    output pixel p takes the bilinear value at K distort(K^-1 p), the
    forward distortion of p's ideal ray, so the remap needs no inversion.

    image (H, W) or (H, W, C) float; intr (7,) fx fy cx cy k1 k2 k3, or
    (9,) Brown [.. t1 t2] / fisheye [.. k1..k4 0] by `model`.  Samples
    more than half a pixel outside the frame get `fill`."""
    from ..core import camera as _cam
    from ..core import distortion as _dist

    h, w = image.shape[:2]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=image.device),
                            torch.arange(w, dtype=torch.float32, device=image.device),
                            indexing="ij")
    f = torch.stack([intr[0], intr[1]])
    c = torch.stack([intr[2], intr[3]])
    xn = (torch.stack([xs, ys], dim=-1) - c) / f
    m = _cam._resolve_model(intr, model)
    if m == "fisheye":
        xd = _dist.distort_fisheye(intr[4:8], xn)
    elif m == "brown":
        xd = _dist.distort_brown(intr[4:9], xn)
    else:
        xd = _cam.distort_radial(intr, xn)
    src = xd * f + c
    sx, sy = src[..., 0], src[..., 1]
    inb = (sx > -0.5) & (sx < w - 0.5) & (sy > -0.5) & (sy < h - 0.5)
    if image.dim() == 2:
        return torch.where(inb, bilinear_sample(image, sy, sx), torch.full_like(sx, fill))
    out = torch.stack([bilinear_sample(image[..., ch], sy, sx) for ch in range(image.shape[-1])],
                      dim=-1)
    return torch.where(inb[..., None], out, torch.full_like(out, fill))


def bilinear_sample_level_ch(vol: torch.Tensor, lvl, y: torch.Tensor, x: torch.Tensor,
                             h_lim=None, w_lim=None) -> torch.Tensor:
    """``bilinear_sample_level`` over a channel-packed stack vol (L, H, W, C):
    one gather fetches all C channels.  h_lim/w_lim (optional ints or
    tensors) clamp the coordinates to the level's true extent.  Returns
    (..., C)."""
    h, w = vol.shape[-3:-1]
    bidx = torch.zeros((), dtype=torch.long, device=vol.device)
    h_lim = torch.as_tensor(h if h_lim is None else h_lim, device=vol.device)
    w_lim = torch.as_tensor(w if w_lim is None else w_lim, device=vol.device)
    return bilinear_sample_batch_level_ch(vol[None], bidx, lvl, y, x, h_lim, w_lim)


def bilinear_sample_batch_level_ch(vol: torch.Tensor, bidx: torch.Tensor, lvl: torch.Tensor,
                                   y: torch.Tensor, x: torch.Tensor,
                                   h_lim: torch.Tensor, w_lim: torch.Tensor) -> torch.Tensor:
    """``bilinear_sample_level_ch`` over a batch of stacks vol (B, L, H, W,
    C) at image bidx (SIFT samples every image's pyramid in one gather).
    The coordinates are clamped to [0, h_lim) x [0, w_lim), all arguments
    broadcast.  Returns (..., C)."""
    hm = (h_lim - 1).to(y.dtype)
    wm = (w_lim - 1).to(x.dtype)
    y = torch.minimum(torch.clamp(y, min=0.0), hm)
    x = torch.minimum(torch.clamp(x, min=0.0), wm)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = torch.minimum(y0 + 1, h_lim - 1)
    x1 = torch.minimum(x0 + 1, w_lim - 1)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    v00 = vol[bidx, lvl, y0, x0]
    v01 = vol[bidx, lvl, y0, x1]
    v10 = vol[bidx, lvl, y1, x0]
    v11 = vol[bidx, lvl, y1, x1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def gradients(images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradient magnitude and angle over (..., H, W);
    angle in [0, 2 pi).  The one-pixel border is zeroed."""
    gx = 0.5 * (torch.roll(images, -1, dims=-1) - torch.roll(images, 1, dims=-1))
    gy = 0.5 * (torch.roll(images, -1, dims=-2) - torch.roll(images, 1, dims=-2))
    h, w = images.shape[-2:]
    xs = torch.arange(w, device=images.device)
    ys = torch.arange(h, device=images.device)
    interior = (((xs > 0) & (xs < w - 1))[None, :] & ((ys > 0) & (ys < h - 1))[:, None])
    interior = interior.to(images.dtype)
    gx = gx * interior
    gy = gy * interior
    mag = torch.sqrt(gx * gx + gy * gy + 1e-20)
    ang = torch.remainder(torch.atan2(gy, gx), 2.0 * np.pi)
    return mag, ang


def to_grayscale(images: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8/float or (..., H, W) -> (..., H, W) float32."""
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    if images.dim() >= 3 and images.shape[-1] == 3:
        images = 0.299 * images[..., 0] + 0.587 * images[..., 1] + 0.114 * images[..., 2]
    return images.to(torch.float32)
