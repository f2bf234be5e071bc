"""ba_solve_p90_s: the 90th percentile of the window's solve times (nearest
rank: the ceil(0.9 n)-th smallest), each from the call of bundle_adjust to
its return with the device synchronised."""

import math


def read(run):
    lat = sorted(run.latencies)
    return lat[math.ceil(0.9 * len(lat)) - 1]
