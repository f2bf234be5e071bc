"""k3_roofline: K3 (schur_mv: three launches, schur_rank_wz_kernel,
schur_wz_chunk_kernel, schur_camera_finish_kernel) as a share of its
least time, counted from the cell's shapes (counts/kernels.py), over its
device time in the trace."""

from sfmbench.counts import kernels as kc
from sfmbench.tracesum import kernel_calls

PIECES = ("schur_rank_wz_kernel", "schur_wz_chunk_kernel", "schur_camera_finish_kernel")


def read(run):
    if run.trace is None:
        return None
    calls, _ = kernel_calls(run.trace, PIECES[0])
    sec = sum(kernel_calls(run.trace, p)[1] for p in PIECES)
    if calls == 0 or sec <= 0:
        return None
    C, P, O, _ = run.shape
    return 100.0 * calls * kc.bound_s(*kc.schur_mv(O, C, P, run.settings["w_dtype"])) / sec
