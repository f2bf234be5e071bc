"""lm_iter_ms: the traced solves' wall time over their LM iterations
(``info["iterations"]``), in milliseconds."""


def read(run):
    if run.trace is None or run.traced_iterations == 0:
        return None
    return run.traced_wall_s / run.traced_iterations * 1e3
