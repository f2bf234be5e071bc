"""start_cost_gap: each solve's reported initial cost against the float64
reference's cost of the same start, as a share of the latter."""

from sfmbench.compare import gap


def read(j):
    return {s.k: gap(float(s.info["initial_cost"]), j.costs(s.k)[0]) for s in j.solves}
