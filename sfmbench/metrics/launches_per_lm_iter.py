"""launches_per_lm_iter: every device kernel launched in the traced solves
over their LM iterations."""


def read(run):
    if run.trace is None or run.traced_iterations == 0 or run.trace.launches == 0:
        return None
    return run.trace.launches / run.traced_iterations
