"""k2_roofline: the fused K2 (linearize_reduce_radial3_t: lin_rank_kernel,
lin_camera_kernel and, refining, lin_group_kernel) as a share of its least
time, counted from the cell's shapes (counts/kernels.py), over its device
time in the trace."""

from sfmbench.counts import kernels as kc
from sfmbench.tracesum import kernel_calls

PIECES = ("lin_rank_kernel", "lin_camera_kernel", "lin_group_kernel")


def read(run):
    if run.trace is None:
        return None
    calls, _ = kernel_calls(run.trace, "lin_camera_kernel")
    sec = sum(kernel_calls(run.trace, p)[1] for p in PIECES)
    if calls == 0 or sec <= 0:
        return None
    C, P, O, G = run.shape
    st = run.settings
    b = kc.linearize(O, C, P, G, bool(st["refine_intrinsics"]), st["w_dtype"])
    return 100.0 * calls * kc.bound_s(*b) / sec
