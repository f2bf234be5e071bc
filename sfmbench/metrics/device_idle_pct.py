"""device_idle_pct: the share of the traced window in which no kernel,
copy or fill runs on the device (the union of their intervals)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.launches == 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
