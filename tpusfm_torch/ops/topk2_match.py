"""Fused top-2 descriptor matcher: wrapper of the CUDA kernel K1 and its
plain PyTorch twin.

Port of ``tpusfm/ops/pallas_match.py``, with its ``quantized`` contract:
``quantized=True`` (the main path's, for descriptors on SIFT's u8 grid)
runs the product in bf16 on the tensor cores, ``quantized=False`` keeps
f32 accuracy on them: each value is split into two TF32 parts and the
product taken as three TF32 products (hi.lo + lo.hi + hi.hi), within
float32 rounding of the twin off the u8 grid and bit-equal to it on the
grid.  The kernels are ``csrc/topk2_match.cu``; this module
checks what it is given, allocates the outputs, launches the variant asked
for on the current stream and counts the launches per variant.  A CPU
tensor takes the plain twin ``match_topk2_reference`` (a full distance
matrix plus ``torch.min``/``argmin``); a CUDA tensor launches the kernel or
raises.  On the card the twin runs only as the kernel's oracle.
"""

from __future__ import annotations

import torch

from . import cuda_build

INF = 3.4e38  # the reference's sentinel for masked B rows (pallas_match.py:51)
D = 128

# Kernel launches per variant since the last reset (a run sets both to 0).
LAUNCHES = {"quantized": 0, "f32": 0}


def match_topk2_reference(da: torch.Tensor, db: torch.Tensor, mask_b: torch.Tensor,
                          quantized: bool = False):
    """Plain twin of the kernel.  da (P, Na, D), db (P, Nb, D) float32,
    mask_b (P, Nb) bool.  Returns d1, d2 (P, Na) float32 — the smallest and
    second smallest squared L2 distance to an unmasked B row, duplicates
    counting — and i1 (P, Na) int32, the argmin (lowest index on ties).
    Masked rows count with the 3.4e38 sentinel, so a fully masked B gives
    d1 >= 1e38.  quantized=True is the reference's bf16 path: the product
    of A and B rounded to bf16, |a|^2 of the rounded A, |b|^2 of the
    unrounded B (pallas_match.py:75, :146-150); on the u8 grid it equals
    quantized=False bit for bit."""
    a, b = da, db
    if quantized:
        a, b = da.to(torch.bfloat16).float(), db.to(torch.bfloat16).float()
    a2 = torch.sum(a * a, dim=-1)
    b2m = torch.where(mask_b, torch.sum(db * db, dim=-1), torch.full_like(mask_b, INF, dtype=da.dtype))
    dts = b2m[..., None, :] - 2.0 * (a @ b.transpose(-1, -2))
    m1 = torch.amin(dts, dim=-1)
    i1 = torch.argmin(dts, dim=-1)
    m2 = torch.amin(dts.scatter(-1, i1[..., None], INF), dim=-1)
    return m1 + a2, m2 + a2, i1.to(torch.int32)


def _check_inputs(da: torch.Tensor, db: torch.Tensor, mask_b: torch.Tensor) -> None:
    if da.dim() != 3 or db.dim() != 3 or mask_b.dim() != 2:
        raise ValueError(f"expected da (P, Na, {D}), db (P, Nb, {D}), mask_b (P, Nb); "
                         f"got {tuple(da.shape)}, {tuple(db.shape)}, {tuple(mask_b.shape)}")
    P, na, d = da.shape
    if d != D or db.shape[0] != P or db.shape[2] != D or mask_b.shape != (P, db.shape[1]):
        raise ValueError(f"shape mismatch: da {tuple(da.shape)}, db {tuple(db.shape)}, "
                         f"mask_b {tuple(mask_b.shape)} (descriptor width must be {D})")
    if na == 0 or db.shape[1] == 0:
        raise ValueError("match_topk2 needs at least one A row and one B row")
    if da.dtype != torch.float32 or db.dtype != torch.float32 or mask_b.dtype != torch.bool:
        raise TypeError(f"expected float32/float32/bool, got {da.dtype}/{db.dtype}/{mask_b.dtype}")
    if not (da.device == db.device == mask_b.device):
        raise ValueError("da, db and mask_b must be on one device")
    for name, t in (("da", da), ("db", db), ("mask_b", mask_b)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if da.data_ptr() % 16 or db.data_ptr() % 16:
        raise ValueError("da and db must be 16-byte aligned")


def match_topk2(da: torch.Tensor, db: torch.Tensor, mask_b: torch.Tensor,
                quantized: bool = False):
    """Fused top-2 matcher over a batch of pairs; same contract as
    ``match_topk2_reference``.  CPU tensors take the twin; CUDA tensors
    launch kernel K1's variant (bf16 products for quantized=True, three
    TF32 products otherwise, both on the tensor cores), one launch for the
    whole batch."""
    if da.device.type == "cpu":
        return match_topk2_reference(da, db, mask_b, quantized)
    if da.device.type != "cuda":
        raise ValueError(f"match_topk2: unsupported device {da.device}")
    _check_inputs(da, db, mask_b)
    P, na, _ = da.shape
    nb = db.shape[1]
    lib = cuda_build.kernels()
    d1 = torch.empty((P, na), dtype=torch.float32, device=da.device)
    d2 = torch.empty_like(d1)
    i1 = torch.empty((P, na), dtype=torch.int32, device=da.device)
    # The launcher sets the device itself: no device guard, no Stream object.
    index = da.device.index
    err = lib.tpusfm_topk2_match(index, da.data_ptr(), db.data_ptr(), mask_b.data_ptr(),
                                 d1.data_ptr(), d2.data_ptr(), i1.data_ptr(), P, na, nb,
                                 int(quantized), torch._C._cuda_getCurrentRawStream(index))
    cuda_build.check(lib, err, "topk2_match launch")
    LAUNCHES["quantized" if quantized else "f32"] += 1
    return d1, d2, i1


def match_descriptors_topk2(da: torch.Tensor, db: torch.Tensor, mask_a: torch.Tensor,
                            mask_b: torch.Tensor, ratio: float = 0.8, cross_check: bool = True,
                            quantized: bool = False):
    """Counterpart of ``match_descriptors_pallas`` over a batch of pairs:
    ratio test d1 < ratio^2 d2 & d1 < 3.4e38, and cross-check by a second
    call B -> A, both of the `quantized` variant.  Returns (i1 (P, Na)
    int32, ok (P, Na) bool)."""
    d1, d2, i1 = match_topk2(da, db, mask_b, quantized)
    ok = mask_a & (d1 < (ratio * ratio) * d2) & (d1 < INF)
    if cross_check:
        _, _, j1 = match_topk2(db, da, mask_a, quantized)
        arange = torch.arange(da.shape[-2], device=da.device)
        ok = ok & (torch.gather(j1, -1, i1.long()) == arange)
    return i1, ok
