"""k5_roofline: K5 (schur_fwd_kernel, one launch a call, D in its template
arguments) as a share of its least time, counted from the cell's shapes
(counts/kernels.py) with D = 6 on the camera table and D = 7 on the
group table, over its device time in the trace."""

import re

from sfmbench.counts import kernels as kc

NAME = re.compile(r"schur_fwd_kernel<[^,]*,\s*(\d+)\s*,")


def read(run):
    if run.trace is None:
        return None
    C, P, O, G = run.shape
    bound, sec = 0.0, 0.0
    for name, (calls, s) in run.trace.kernels.items():
        m = NAME.search(name)
        if not m:
            continue
        D = int(m.group(1))
        n = C if D == 6 else G
        bound += calls * kc.bound_s(*kc.schur_fwd(O, n, P, D, run.settings["w_dtype"]))
        sec += s
    return 100.0 * bound / sec if sec > 0 else None
