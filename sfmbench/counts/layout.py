"""The least bytes of the segment layouts of a bundle-adjustment solve
(``tpusfm_torch.ops.obs_table.obs_layout``, each under the span
``tpusfm.ba.prep.layout``), from the call's shapes.

The convention is ``kernels.py``'s: each input read once and each output
written once, as int32, with no scratch, no per-tile counts and no second
read, so that the count is the same whichever implementation builds the
layout (the counting sort of csrc/ba_layout.cu, or the twin's stable sort
past its segment limit).  A layout moves ints and does no floating-point
arithmetic, so its least time is its bytes over the memory rate.
"""

from __future__ import annotations

from sfmbench.counts.kernels import I32

# The span each layout runs under (the string a trace carries, so that a
# checkout whose program lacks the span reads nothing).
SPAN = "tpusfm.ba.prep.layout"


def layout(O: int, n: int, ranks: bool, p: int | None = None):
    """One layout of O segment ids over n segments: ids (O,) and, with
    `ranks`, the rank-sorted ranks (O,) -> seg_perm (O,), seg_start and
    chunk_start (n + 1,) each, and with ranks seg_ranks (O,) and, given p
    ranks, rank_start (p + 1,).  Returns (bytes, operations)."""
    ints = 2 * O + 2 * (n + 1)
    if ranks:
        ints += 2 * O + (p + 1 if p is not None else 0)
    return ints * I32, 0


def ba_prep(O: int, C: int, P: int, G: int, refine: bool) -> list:
    """The layouts of one solve's preparation on the kernel path: the
    cameras' with the point ranks and their row ranges and, refining, the
    groups' with the ranks.  Returns [(bytes, operations)], one a layout."""
    out = [layout(O, C, True, P)]
    if refine:
        out.append(layout(O, G, True))
    return out
