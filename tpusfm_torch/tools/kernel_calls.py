"""Kernel launch counts and a recorder of kernel-wrapper calls, for runs
that must show which kernels a path went through (``chip_smoke.py`` and
the multi-rank phases of ``tools/parallel_rung.py``, in every rank).

    reset_counts()
    with recording(captured := {}) as (solves, calls):
        run_sparse(...)
    counts()   # launches since the reset, by kernel
"""

from __future__ import annotations

import contextlib
from collections import Counter

# The wrappers recorded: K1 in ops.topk2_match, K2-K9 in ops.obs_table.
K1 = "match_topk2"
OBS_TABLE = ("linearize_reduce_radial3_t", "schur_mv_t", "schur_bwd_t", "schur_fwd_t",
             "segsum_table_t", "segsum_sorted_t", "gather_table", "gather_sorted",
             "linearize_radial3_t")


def reset_counts() -> None:
    from ..ops import obs_table as ot
    from ..ops import topk2_match as k1

    for launches in (k1.LAUNCHES, ot.LAUNCHES):
        for name in launches:
            launches[name] = 0


def counts() -> dict:
    """Launches since the last reset: K1's bf16 variant as "topk2_match",
    its f32 variant as "topk2_match f32", and K2-K9."""
    from ..ops import obs_table as ot
    from ..ops import topk2_match as k1

    return {"topk2_match": k1.LAUNCHES["quantized"], "topk2_match f32": k1.LAUNCHES["f32"],
            **ot.LAUNCHES}


def variant(name: str, a: tuple, k: dict) -> str:
    """The launch variant a path is held to: K1's and K2's mode, K4/K5's
    and K8/K9's block height D, K6/K7's value count k."""
    if name == K1:
        return "quantized" if k.get("quantized", len(a) > 3 and a[3]) else "f32"
    if name in ("linearize_reduce_radial3_t", "linearize_radial3_t"):
        return "refine" if k.get("refine", len(a) > 8 and a[8]) else "held"
    if name in ("schur_bwd_t", "schur_fwd_t"):
        return f"D={a[0].shape[0] // 3}"
    if name in ("segsum_table_t", "segsum_sorted_t"):
        return f"k={a[0].shape[0]}"
    if name in ("gather_table", "gather_sorted"):
        return f"D={a[0].shape[1]}"
    return ""


def named(calls: Counter) -> dict:
    """`calls` keyed "name variant"."""
    return {f"{n} {v}".strip(): c for (n, v), c in sorted(calls.items())}


@contextlib.contextmanager
def recording(capture: dict | None = None):
    """Yields (solves, calls): this run's kernel-path BA solves
    (``_lm_kernels``) as (C, P, O), and a Counter of kernel-wrapper calls
    by (name, variant).  When `capture` is given, also keeps there the
    arguments (args, kwargs) of the last call of each wrapper, under its
    name and under (name, variant), and the last match table that
    ``pipeline.sparse.match_pairs`` returned, under "matches".  Restores
    every wrapper on exit."""
    from ..ba import bundle_adjust as tba
    from ..ops import obs_table as ot
    from ..ops import topk2_match as k1
    from ..pipeline import sparse as sp

    solves, calls = [], Counter()
    saved = {(tba, "_lm_kernels"): tba._lm_kernels, (sp, "match_pairs"): sp.match_pairs}

    def lm_kernels(*a, **k):
        solves.append((a[0].shape[0], a[2].shape[0], a[8].shape[0]))
        return saved[(tba, "_lm_kernels")](*a, **k)

    def match_pairs(*a, **k):
        out = saved[(sp, "match_pairs")](*a, **k)
        if capture is not None:
            capture["matches"] = out
        return out

    tba._lm_kernels, sp.match_pairs = lm_kernels, match_pairs
    for mod, name in [(k1, K1)] + [(ot, n) for n in OBS_TABLE]:
        saved[(mod, name)] = getattr(mod, name)

        def rec(*a, _key=(mod, name), **k):
            key = (_key[1], variant(_key[1], a, k))
            calls[key] += 1
            if capture is not None:
                capture[key[0]] = capture[key] = (a, k)
            return saved[_key](*a, **k)

        setattr(mod, name, rec)
    try:
        yield solves, calls
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
