"""The least bytes and operations of one call of a bundle-adjustment
kernel, from the call's shapes and the configuration's precision.

Each count takes every input that the computation needs and every output
that it makes, each element once: per-observation ids as int32 (camera or
group, and point), per-observation tables in the configuration's storage
type (the coupling table W in ``w_dtype``), everything else float32, and
symmetric blocks by their unique entries.  Scratch, second reads, padding,
copies in another order and the layout tables of any one implementation
are not counted, so the count stays the same whatever implements the
kernel.  Operations count each multiply and each add once; a
multiply-add into an accumulator is two.

The least time of a call is the larger of its bytes over the memory rate
and its operations over float32's rate outside the tensor cores (H100
SXM, NVIDIA's data sheet, 700 W).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
F32 = 4
I32 = 4
STORAGE_BYTES = {"bf16": 2, "f32": 4}

POSE = 6
INTR = 7
HCC_UNIQUE = POSE * (POSE + 1) // 2  # a camera's Hcc block by its unique entries
# Per-observation operations of the linearization with intrinsics held:
# the camera transform (18), perspective and distortion to the residual (20),
# the Huber cost and weight (11), d pixel / d X_cam (41), d r / d X (36),
# d r / d [aa] through [X]x and the right Jacobian (54), the weights (20),
# and the products summed or written per observation: Hcc's 21 and Hpp's 6
# unique entries (4 each), gc's 6 and gp's 3 (4 each), W's 18 (3 each) and
# the cost (1), 199 in all.
LIN_FLOPS_HELD = 18 + 20 + 11 + 41 + 36 + 54 + 20 + 199
# Refining intrinsics adds d r / d intrinsics (12), its weights (14), Hcg's
# 42 and Hgg's 28 unique entries (4 each), gg's 7 (4 each) and Wg's 21 (3 each).
LIN_FLOPS_REFINE = LIN_FLOPS_HELD + 12 + 14 + 42 * 4 + 28 * 4 + 7 * 4 + 21 * 3


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of a call, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def linearize(O: int, C: int, P: int, G: int, refine: bool, w_dtype: str):
    """K2, the fused linearization and reduction: poses (C, 6), intrinsics
    (G, 7), points (P, 3), per observation its pixel, camera id and point
    id -> Hcc (21 unique) and gc per camera, Hpp (6 unique) and gp per
    point, W (O, 18) and the cost; refining also Hcg (C, 42), Hgg (28
    unique) and gg per group and Wg (O, 21).  Returns (bytes, operations)."""
    wb = STORAGE_BYTES[w_dtype]
    nbytes = (C * POSE * F32 + G * INTR * F32 + P * 3 * F32 + O * (2 * F32 + 2 * I32)
              + C * (HCC_UNIQUE + POSE) * F32 + P * (6 + 3) * F32 + O * POSE * 3 * wb + F32)
    flops = O * LIN_FLOPS_HELD
    if refine:
        nbytes += C * POSE * INTR * F32 + G * (28 + INTR) * F32 + O * INTR * 3 * wb
        flops = O * LIN_FLOPS_REFINE
    return nbytes, flops


def schur_mv(O: int, C: int, P: int, w_dtype: str):
    """K3, the reduced camera system's product S v = Hcc v - W Hpp^-1 W^T v:
    W (O, 18), camera and point ids, v (C, 6), Hpp^-1 (6 unique a point),
    damped Hcc (21 unique a camera) -> S v (C, 6).  y = W^T v per point is
    a step inside the product, not an output that CG needs, so it is not
    counted as bytes.  A multiply-add per W entry in each direction,
    Hpp^-1 y per point, Hcc v and the difference per camera."""
    wb = STORAGE_BYTES[w_dtype]
    nbytes = (O * (POSE * 3 * wb + 2 * I32) + C * POSE * F32 + P * 6 * F32
              + C * HCC_UNIQUE * F32 + C * POSE * F32)
    flops = O * 2 * (2 * POSE * 3) + P * 2 * 9 + C * (2 * 36 + POSE)
    return nbytes, flops


def schur_fwd(O: int, n: int, P: int, D: int, w_dtype: str):
    """K5, y = W^T v summed per point: W (O, 3 D), per observation its
    camera or group id and point id, v (n, D) -> y (P, 3).  A multiply-add
    per W entry."""
    wb = STORAGE_BYTES[w_dtype]
    nbytes = O * (3 * D * wb + 2 * I32) + n * D * F32 + P * 3 * F32
    return nbytes, O * 2 * 3 * D


def segsum_table(O: int, n: int, k: int):
    """K6, sums of k float32 columns by id: values (O, k), ids (O,) ->
    (n, k).  One add per value."""
    return O * (k * F32 + I32) + n * k * F32, O * k
