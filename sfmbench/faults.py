"""Faults planted in the program's linear algebra, inside the timed path,
to show that the comparison catches them (``python3 -m sfmbench.readings
--fault <kind>``, and the tests):

- ``matvec_half``: the reduced system's product (K3 ``schur_mv_t``, or K5
  ``schur_fwd_t`` where intrinsics are refined) reads every other
  observation's W row as zero, as a kernel that covers half its rows would;
- ``point_gradient``: the point gradient gp comes out of the linearization
  (fused K2, or K7 on the unfused path) doubled.

Neither touches a cost, so only a solve that lands elsewhere shows them.
At the cells' sizes neither does: LM keeps a step only where the cost
falls, so each still ends within the float64 reference's answer, and the
comparison reads both as correct (readings in PERF.md).
"""

from __future__ import annotations

import contextlib

FAULTS = ("matvec_half", "point_gradient")


def _half(wT):
    w = wT.clone()
    w[:, 1::2] = 0
    return w


@contextlib.contextmanager
def planted(kind: str):
    """Patch ``tpusfm_torch.ops.obs_table`` for the duration."""
    from tpusfm_torch.ops import obs_table as ot

    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}; one of {FAULTS}")
    saved = {}

    def patch(name, wrap):
        saved[name] = getattr(ot, name)
        setattr(ot, name, wrap(saved[name]))

    if kind == "matvec_half":
        patch("schur_mv_t", lambda f: lambda wT, *a, **k: f(_half(wT), *a, **k))
        patch("schur_fwd_t", lambda f: lambda wT, *a, **k: f(_half(wT), *a, **k))
    else:
        def fused(f):
            def lin(*a, **k):
                outs = list(f(*a, **k))
                outs[1] = outs[1].clone()
                outs[1][:, 6:9] *= 2  # ptred (P, 9): Hpp's 6 unique entries, then gp
                return tuple(outs)
            return lin

        def ranks(f):
            def seg(valsT, *a, **k):
                out = f(valsT, *a, **k)
                if out.shape[1] == 12:  # the point table: Hpp (9), then gp
                    out = out.clone()
                    out[:, 9:] *= 2
                return out
            return seg

        patch("linearize_reduce_radial3_t", fused)
        patch("segsum_sorted_t", ranks)
    try:
        yield
    finally:
        for name, f in saved.items():
            setattr(ot, name, f)


def solver(kind: str, base):
    """A solver factory like ``base`` whose every solve runs under the fault."""
    def make(cell, scene):
        solve = base(cell, scene)

        def faulty(start):
            with planted(kind):
                return solve(start)
        return faulty
    return make
