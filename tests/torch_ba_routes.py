"""The first linearization of a kernel-path bundle adjustment, as the LM
loop receives it, so that the fused K2 route can be held against the
jacfwd route (K6/K7): tests/test_torch_ba_route.py on the CPU twins and
tests/test_torch_cuda.py on the card.  Imports neither jax nor the
reference package."""

import numpy as np
import torch

from tpusfm_torch.ba import bundle_adjust as tba

FIELDS = ("Hcc", "gc", "Hpp", "gp", "cost")


def ba_args(prob: dict, dev, dtype: torch.dtype = torch.float32) -> dict:
    """bundle_adjust's arguments from a numpy problem, its float arrays in
    `dtype`, on device `dev`."""
    return {k: torch.as_tensor(v, device=dev).to(dtype) if np.asarray(v).dtype.kind == "f"
            else torch.as_tensor(v, device=dev) for k, v in prob.items()}


def first_linearization(args: dict, cfg: tba.BAConfig, monkeypatch) -> dict:
    """{Hcc, gc, Hpp, gp, cost} of the solve's first linearization (the
    point side by rank), read where the LM loop receives it; no LM
    iteration runs."""
    seen = []
    loop = tba._lm_loop

    def recording_loop(linearize, *rest):
        def lin(*a):
            out = linearize(*a)
            seen.append(out)
            return out
        return loop(lin, *rest)

    with monkeypatch.context() as m:
        m.setattr(tba, "_lm_loop", recording_loop)
        tba.bundle_adjust(cfg=cfg, max_iters=0, **args)
    sys, cost = seen[0]
    return {k: sys[k] for k in FIELDS[:-1]} | {"cost": cost}
