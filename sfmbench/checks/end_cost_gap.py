"""end_cost_gap: each solve's reported final cost against the float64
reference's cost of the state that it returned, as a share of the latter."""

from sfmbench.compare import gap


def read(j):
    return {s.k: gap(float(s.info["final_cost"]), j.costs(s.k)[1]) for s in j.solves}
