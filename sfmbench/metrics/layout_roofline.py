"""layout_roofline: the segment layouts (the ``tpusfm.ba.prep.layout``
span) as a share of their least time, counted from the cell's shapes
(counts/layout.py: each input read once, each output written once), over
the device time of all the work launched while that span was the innermost
one open.  A solve lays out its cameras and, refining, its groups; the
span's instances are counted in those pairs.  The count is the same
whichever implementation builds the layout."""

from sfmbench.counts import kernels as kc
from sfmbench.counts import layout as cl


def read(run):
    if run.trace is None:
        return None
    lay = run.trace.spans.get(cl.SPAN)
    if lay is None or lay.n == 0 or lay.device_s <= 0:
        return None
    C, P, O, G = run.shape
    per_solve = cl.ba_prep(O, C, P, G, bool(run.settings["refine_intrinsics"]))
    least = sum(kc.bound_s(*b) for b in per_solve)
    return 100.0 * lay.n / len(per_solve) * least / lay.device_s
