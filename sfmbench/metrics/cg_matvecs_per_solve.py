"""cg_matvecs_per_solve: CG products of the reduced system per traced
solve, counted by the matvec kernel's launches in the trace: K3
(schur_mv, whose first pass is schur_rank_wz_kernel) with intrinsics held,
else K5 on the camera table (schur_fwd_kernel with D = 6), one per product."""

import re

from sfmbench.tracesum import kernel_calls

K5_CAMERAS = re.compile(r"schur_fwd_kernel<[^,]*,\s*6\s*,")


def read(run):
    if run.trace is None or run.traced_solves == 0:
        return None
    n, _ = kernel_calls(run.trace, "schur_rank_wz_kernel")
    if n == 0:
        n = sum(c for name, (c, _) in run.trace.kernels.items() if K5_CAMERAS.search(name))
    return n / run.traced_solves if n else None
