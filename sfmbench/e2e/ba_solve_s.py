"""ba_solve_s: the window's wall time over the solves completed in it
(time to solution at the configuration's stopping rule)."""


def read(run):
    return run.window_s / len(run.latencies)
