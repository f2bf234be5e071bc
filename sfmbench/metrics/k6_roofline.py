"""k6_roofline: K6 (segsum_table_t: segsum_rows_chunk_kernel and
chunk_finish_kernel) on the unfused linearization's camera reduction, as a
share of its least time, counted from the cell's shapes (counts/kernels.py:
k = 21 + 6 columns a camera with intrinsics held: Hcc by its unique
entries and gc, whatever columns an implementation hands the kernel), over
its device time in the trace."""

from sfmbench.counts import kernels as kc
from sfmbench.tracesum import kernel_calls

PIECES = ("segsum_rows_chunk_kernel", "chunk_finish_kernel", "transpose_tile_kernel")


def read(run):
    if run.trace is None or run.settings["refine_intrinsics"]:
        return None
    calls, _ = kernel_calls(run.trace, PIECES[0])
    sec = sum(kernel_calls(run.trace, p)[1] for p in PIECES)
    if calls == 0 or sec <= 0:
        return None
    C, P, O, _ = run.shape
    return 100.0 * calls * kc.bound_s(*kc.segsum_table(O, C, kc.HCC_UNIQUE + kc.POSE)) / sec
