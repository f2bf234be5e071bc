"""solve_excess: for the solves sampled from the seed, how far the
program's answer lies above the float64 reference's own solve from the same
start, as a share of the cost that the reference removed:
(cost(program) - cost(reference)) / (cost(start) - cost(reference))."""

from sfmbench.compare import finite


def read(j):
    out = {}
    for k in j.sampled():
        c0, c1 = j.costs(k)
        c_ref = j.reference_cost(k)
        out[k] = finite((c1 - c_ref) / (c0 - c_ref))
    return out
