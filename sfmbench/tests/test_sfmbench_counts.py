"""The roofline counts against hand counts at a small shape."""

import pytest

from sfmbench.counts import kernels as kc

O, C, P, G = 10, 2, 3, 2


def test_schur_mv_hand_count():
    # W 10 x 18 bf16 + two int32 ids a row; v, Hpp^-1 (6 unique), damped
    # Hcc (21 unique) and S v in float32; y = W^T v is no output.
    nbytes = 10 * (36 + 8) + 2 * 24 + 3 * 24 + 2 * 84 + 2 * 24
    flops = 10 * 72 + 3 * 18 + 2 * 78
    assert kc.schur_mv(O, C, P, "bf16") == (nbytes, flops) == (776, 930)
    assert kc.schur_mv(O, C, P, "f32")[0] == 776 + 10 * 36


def test_linearize_hand_count():
    held = 2 * 24 + 2 * 28 + 3 * 12 + 10 * 16 + 2 * 27 * 4 + 3 * 9 * 4 + 10 * 36 + 4
    assert kc.linearize(O, C, P, G, False, "bf16") == (held, 10 * 399) == (988, 3990)
    refine = held + 2 * 42 * 4 + 2 * 35 * 4 + 10 * 42
    assert kc.linearize(O, C, P, G, True, "bf16") == (refine, 10 * 796) == (2024, 7960)


def test_schur_fwd_and_segsum_hand_count():
    assert kc.schur_fwd(O, 2, P, 7, "bf16") == (10 * 50 + 56 + 36, 420) == (592, 420)
    assert kc.segsum_table(O, 2, 42) == (10 * 172 + 336, 420) == (2056, 420)


def test_k6_counts_the_camera_reduction_by_unique_entries():
    # Hcc's 21 unique entries and gc's 6 a camera: 27 float32 columns, each
    # a value read and a sum written, and one int32 camera id a row.
    assert kc.HCC_UNIQUE + kc.POSE == 27
    assert kc.segsum_table(O, C, 27) == (10 * (27 * 4 + 4) + 2 * 27 * 4, 270) == (1336, 270)


@pytest.mark.parametrize("nbytes,flops,want", [(3.35e12, 0, 1.0), (0, 67e12, 1.0),
                                               (3.35e12, 134e12, 2.0)])
def test_bound_is_the_larger(nbytes, flops, want):
    assert kc.bound_s(nbytes, flops) == pytest.approx(want)
