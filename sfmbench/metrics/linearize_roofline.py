"""linearize_roofline: the linearization (the ``tpusfm.ba.linearize``
span) as a share of its least time, counted from the cell's shapes
(counts/kernels.py: each input read once, each output written once), over
the device time of all the work launched while that span was the innermost
one open.  The count is the same whatever implements the linearization:
the fused K2, K2's unreduced mode reduced by K6 and K7, or jacfwd with its
plain-torch glue."""

from sfmbench import spansum
from sfmbench.counts import kernels as kc


def read(run):
    if run.trace is None:
        return None
    lin = run.trace.spans.get(spansum.LINEARIZE)
    if lin is None or lin.n == 0 or lin.device_s <= 0:
        return None
    C, P, O, G = run.shape
    st = run.settings
    b = kc.linearize(O, C, P, G, bool(st["refine_intrinsics"]), st["w_dtype"])
    return 100.0 * lin.n * kc.bound_s(*b) / lin.device_s
