"""Fixed-size batched hypothesize-and-verify RANSAC.

Port of ``tpusfm/sfm/ransac.py``.  The reference ``vmap``s one RANSAC per
pair; here every function takes a leading batch axis B (pairs, candidate
seed pairs or views) and runs all hypotheses of all rows as one array
program:

  1. draw (B, I, S) correspondence indices at once (Gumbel top-k, without
     replacement, from a ``torch.Generator`` on the device),
  2. run the minimal solver over (B, I) samples,
  3. score every hypothesis against every correspondence,
  4. argmax, then one weighted least-squares refit on the winner's inliers.

The reference's random draws come from jax keys and cannot be reproduced
in torch, so ``ransac`` and ``ransac_ac`` also accept the sample indices
(and the scoring subset) from outside: the parity tests pass the
reference's own draws in.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def _tree_map(fn, *trees):
    if isinstance(trees[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*trees))
    return fn(*trees)


def _take(m: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """m (B, H, ...) indexed by best (B,) -> (B, ...)."""
    return m[torch.arange(m.shape[0], device=m.device), best]


def _where_rows(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim())), a, b)


def gumbel(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel noise drawn from `generator` on `device`."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, 1e-20, 1.0 - 1e-7)))


def sample_indices(generator, valid: torch.Tensor, n_iters: int, sample_size: int) -> torch.Tensor:
    """Indices ~ uniform over valid slots, without replacement per
    hypothesis: valid (B, N) -> (B, I, S) int64."""
    B, n = valid.shape
    g = gumbel((B, n_iters, n), generator, valid.device)
    logits = torch.where(valid[:, None, :], g, torch.full_like(g, -math.inf))
    return torch.topk(logits, sample_size, dim=-1).indices


def _gather_samples(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, d), idx (B, I, S) -> (B, I, S, d)."""
    B, I, S = idx.shape
    flat = torch.gather(x, 1, idx.reshape(B, I * S, 1).expand(B, I * S, x.shape[-1]))
    return flat.reshape(B, I, S, x.shape[-1])


def _hypotheses(solver, x0, x1, idx, n_candidates):
    """Minimal-solver models over (B, I) samples, flattened to (B, H, ...)
    with H = I * n_candidates, plus validity (B, H) or None."""
    B, I, _ = idx.shape
    s0, s1 = _gather_samples(x0, idx), _gather_samples(x1, idx)
    if n_candidates > 1:
        models, ok = solver(s0, s1)
        models = _tree_map(lambda m: m.reshape((B, I * n_candidates) + m.shape[3:]), models)
        return models, ok.reshape(B, I * n_candidates)
    return solver(s0, s1), None


def ransac(
    generator: torch.Generator | None,
    x0: torch.Tensor,
    x1: torch.Tensor,
    valid: torch.Tensor,
    solver: Callable,
    scorer: Callable,
    sample_size: int,
    n_iters: int = 512,
    inlier_thresh=4.0,
    refit: bool = True,
    n_candidates: int = 1,
    refit_solver: Callable | None = None,
    score_subset: int = 0,
    idx: torch.Tensor | None = None,
    sub: torch.Tensor | None = None,
):
    """Generic two-array RANSAC over a batch: x0, x1 (B, N, d), valid (B, N).

    solver(x0s, x1s, w=None) -> model batched over leading dims (or
    (models with a candidate axis, ok) when n_candidates > 1);
    scorer(model, x0, x1) -> squared errors (..., N).  inlier_thresh is a
    float or a (B,) tensor, in sqrt(scorer) units.  idx (B, I, S) and sub
    (B, score_subset) replace the random draws when given.

    Returns (model (B, ...), inliers (B, N) bool, n_inliers (B,))."""
    B, n_pts = valid.shape
    if idx is None:
        idx = sample_indices(generator, valid, n_iters, sample_size)
    models, ok = _hypotheses(solver, x0, x1, idx, n_candidates)
    if torch.is_tensor(inlier_thresh):
        t2 = (inlier_thresh * inlier_thresh).to(x0.dtype).expand(B)
    else:  # squared in double like the reference's Python-float threshold
        t2 = torch.full((B,), inlier_thresh * inlier_thresh, dtype=x0.dtype, device=x0.device)
    bidx = torch.arange(B, device=x0.device)
    if score_subset and score_subset < n_pts:
        # Hypothesis selection on a random subset of the valid matches; the
        # winner's inliers are classified on all matches below.
        if sub is None:
            r = torch.rand((B, n_pts), generator=generator, device=x0.device)
            r = torch.where(valid, r, torch.full_like(r, 2.0))
            sub = torch.sort(r, dim=-1, stable=True).indices[:, :score_subset]
        xs0 = torch.gather(x0, 1, sub[..., None].expand(B, sub.shape[1], x0.shape[-1]))
        xs1 = torch.gather(x1, 1, sub[..., None].expand(B, sub.shape[1], x1.shape[-1]))
        errs_s = scorer(models, xs0[:, None], xs1[:, None])  # (B, H, M)
        counts = torch.sum((errs_s < t2[:, None, None]) & torch.gather(valid, 1, sub)[:, None], dim=-1)
        if ok is not None:
            counts = torch.where(ok, counts, torch.full_like(counts, -1))
        best = torch.argmax(counts, dim=-1)
        best_model = _tree_map(lambda m: _take(m, best), models)
        best_inl = (scorer(best_model, x0, x1) < t2[:, None]) & valid
    else:
        errs = scorer(models, x0[:, None], x1[:, None])  # (B, H, N)
        inl = (errs < t2[:, None, None]) & valid[:, None]
        counts = torch.sum(inl, dim=-1)
        if ok is not None:
            counts = torch.where(ok, counts, torch.full_like(counts, -1))
        best = torch.argmax(counts, dim=-1)
        best_model = _tree_map(lambda m: _take(m, best), models)
        best_inl = inl[bidx, best]
    if refit:
        fit = refit_solver if refit_solver is not None else solver
        refit_model = fit(x0, x1, best_inl.to(x0.dtype))
        errs_r = scorer(refit_model, x0, x1)
        inl_r = (errs_r < t2[:, None]) & valid
        # Keep the refit only if it did not lose support.
        better = torch.sum(inl_r, -1) >= torch.sum(best_inl, -1)
        best_model = _tree_map(lambda a, b: _where_rows(better, a, b), refit_model, best_model)
        best_inl = _where_rows(better, inl_r, best_inl)
    return best_model, best_inl, torch.sum(best_inl, -1)


def ransac_ac(
    generator: torch.Generator | None,
    x0: torch.Tensor,
    x1: torch.Tensor,
    valid: torch.Tensor,
    solver: Callable,
    scorer: Callable,
    sample_size: int,
    n_iters: int = 512,
    error_dim: int = 1,
    alpha0=1.0,
    max_thresh=16.0,
    min_thresh=0.0,
    refit: bool = True,
    n_candidates: int = 1,
    refit_solver: Callable | None = None,
    idx: torch.Tensor | None = None,
):
    """A-contrario RANSAC (ORSA / AC-RANSAC) over a batch: each hypothesis
    is scored by its smallest log number of false alarms over the candidate
    inlier count k, and eps_k* becomes the pair's inlier threshold.  alpha0,
    max_thresh and min_thresh are floats or (B,) tensors.

    Returns (model, inliers (B, N), n_inliers (B,), log10_nfa (B,),
    eps_star (B,))."""
    B, n = valid.shape
    dev, dt = x0.device, x0.dtype
    if idx is None:
        idx = sample_indices(generator, valid, n_iters, sample_size)
    models, ok = _hypotheses(solver, x0, x1, idx, n_candidates)
    s = sample_size

    def col(v):  # scalar or (B,) -> broadcastable against (B, ..., N)
        return torch.as_tensor(v, dtype=dt, device=dev).reshape(-1)

    nv = torch.sum(valid, -1).to(dt)  # (B,)
    kk = torch.arange(1, n + 1, dtype=dt, device=dev)
    log_alpha0 = torch.log(col(alpha0))
    max_t = col(max_thresh)
    min_t = col(min_thresh)

    def lognfa_surface(errs, extra_dims):
        """errs (B, *extra, N) squared -> (log-NFA, eps*) minimized over k."""
        shape = (B,) + (1,) * extra_dims
        e = torch.sqrt(torch.clamp(errs, min=0.0))
        vmask = valid.reshape(B, *(1,) * extra_dims, n)
        e = torch.where(vmask, e, torch.full_like(e, math.inf))
        e_sorted = torch.sort(e, dim=-1).values
        nvb = nv.reshape(*shape, 1)
        logC_nk = (torch.lgamma(nvb + 1) - torch.lgamma(kk + 1)
                   - torch.lgamma(torch.clamp(nvb - kk, min=0.0) + 1))
        logC_ks = (torch.lgamma(kk + 1) - math.lgamma(s + 1)
                   - torch.lgamma(torch.clamp(kk - s, min=0.0) + 1))
        log_eps = torch.log(torch.clamp(e_sorted, min=1e-12))
        la0 = (log_alpha0.reshape(-1, *(1,) * (extra_dims + 1))
               if log_alpha0.numel() > 1 else log_alpha0)
        log_nfa = (torch.log(torch.clamp(nvb - s, min=1.0)) + logC_nk + logC_ks
                   + (kk - s) * (error_dim * log_eps + la0))
        mt = max_t.reshape(-1, *(1,) * (extra_dims + 1)) if max_t.numel() > 1 else max_t
        bad = (kk <= s) | (kk > nvb) | (e_sorted > mt) | ~torch.isfinite(e_sorted)
        log_nfa = torch.where(bad, torch.full_like(log_nfa, math.inf), log_nfa)
        k_star = torch.argmin(log_nfa, dim=-1, keepdim=True)
        return (torch.gather(log_nfa, -1, k_star)[..., 0],
                torch.gather(e_sorted, -1, k_star)[..., 0])

    errs = scorer(models, x0[:, None], x1[:, None])  # (B, H, N)
    nfa, eps = lognfa_surface(errs, 1)
    if ok is not None:
        nfa = torch.where(ok, nfa, torch.full_like(nfa, math.inf))
    best = torch.argmin(nfa, dim=-1)
    bidx = torch.arange(B, device=dev)
    best_model = _tree_map(lambda m: _take(m, best), models)
    best_eps = eps[bidx, best]
    best_nfa = nfa[bidx, best]
    best_errs = errs[bidx, best]
    collect = torch.maximum(best_eps, min_t)
    best_inl = (best_errs <= (collect * collect)[:, None]) & valid

    if refit:
        fit = refit_solver if refit_solver is not None else solver
        refit_model = fit(x0, x1, best_inl.to(dt))
        errs_r = scorer(refit_model, x0, x1)
        nfa_r, eps_r = lognfa_surface(errs_r, 0)
        better = nfa_r <= best_nfa
        best_model = _tree_map(lambda a, b: _where_rows(better, a, b), refit_model, best_model)
        best_eps = torch.where(better, eps_r, best_eps)
        best_nfa = torch.where(better, nfa_r, best_nfa)
        errs_f = _where_rows(better, errs_r, best_errs)
        collect = torch.maximum(best_eps, min_t)
        best_inl = (errs_f <= (collect * collect)[:, None]) & valid

    # NFA > 1 (log > 0): not meaningful, empty support.
    best_inl = best_inl & (best_nfa <= 0.0)[:, None]
    return best_model, best_inl, torch.sum(best_inl, -1), best_nfa / math.log(10.0), best_eps
