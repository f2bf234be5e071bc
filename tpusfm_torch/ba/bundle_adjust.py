"""Huber-robust bundle adjustment: Levenberg-Marquardt over a Schur
complement, with shared self-calibrating intrinsics and GPS priors.

Port of the plain (non-Pallas) path of ``tpusfm/ba/bundle_adjust.py``:
residual = reproject(angle-axis, t, intrinsics, X) - uv, Huber loss, points
eliminated exactly with 3x3 block inverses, and the reduced
[pose | intrinsic-group] system solved either densely by Cholesky (when it
is at most ``dense_schur_max_dim`` scalars wide — every solve of a 20-view
reconstruction) or by block-Jacobi preconditioned CG over segment sums of
the observation table.  Jacobians come from ``torch.func.jacfwd`` as the
reference's from ``jax.jacfwd``; nothing needs autograd.

The reference's Pallas path ``_lm_pallas`` becomes ``_lm_kernels``: the
observation table is point-sorted once per solve, and linearization, the
reduced right-hand side and every CG matvec run through the hand-written
CUDA kernels K2-K4 (``ops/obs_table.py``; on CPU tensors, their plain
twins).  It runs for ``impl="pallas"`` on any device, and for
``impl="auto"`` on a CUDA device when the dense solve is not eligible (more
than 64 cameras), where the reference runs those kernels on its chip.  Of
that path this port covers the single-device mode with intrinsics held and
RADIAL3 cameras; refining intrinsics there needs kernel K5, and more than
2048 cameras or groups or another camera model the unfused kernels K6/K7,
which are not ported and raise.  On the CPU, ``impl="auto"`` takes the
plain PCG path, as the reference's ``impl="xla"`` does.  The LM and CG
loops are Python loops that read one convergence flag from the device per
iteration.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch
from torch.func import jacfwd, vmap

from ..core import camera as cam
from ..core import lie
from ..ops import obs_table as ot

POSE_DIM = 6
INTR_DIM = 7


@dataclasses.dataclass(frozen=True)
class BAConfig:
    max_iters: int = 20            # LM outer iterations
    huber_delta: float = 4.0       # px
    refine_intrinsics: bool = False
    refine_params: str = "all"     # "focal" | "focal_pp" | "all"
    cg_iters: int = 50
    cg_tol: float = 1e-2           # inexact Newton: CG only needs a descent direction
    lambda_init: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    lambda_min: float = 1e-10
    lambda_max: float = 1e8
    converge_rtol: float = 3e-6    # accepted-step relative improvement = converged
    fix_first_cam: bool = True     # gauge: camera 0's pose is held
    impl: str = "auto"             # "auto" | "xla" (the plain path) | "pallas" (kernels K2-K4)
    precond: str = "hcc"           # kernel path's PCG preconditioner: "hcc" (damped Hcc
                                   # blocks) | "schur_diag" (exact S diagonal blocks)
    w_dtype: str = "bf16"          # kernel path: storage of the coupling table W ("bf16" | "f32")
    assume_sorted: bool = False    # kernel path: obs_pt is already non-decreasing and dense
                                   # (every id up to max(obs_pt) has a row; unobserved points
                                   # only trail), so the per-solve sort is skipped and
                                   # fractional obs weights are honoured
    dense_schur_max_dim: int = 384  # dense Cholesky of the reduced system up to this width
    dense_schur_max_bytes: int = 256 * 1024 * 1024  # cap on the coupling tables
    camera_model: str = "auto"     # "auto" (7 lanes RADIAL3, 9 Brown-T2) | "fisheye" | "spherical"

    def refine_mask(self, e: int = INTR_DIM) -> tuple[float, ...]:
        if not self.refine_intrinsics:
            return (0.0,) * e
        if self.refine_params in ("focal", "focal_pp"):
            n = 2 if self.refine_params == "focal" else 4
            return tuple(1.0 if i < n else 0.0 for i in range(e))
        if self.camera_model == "fisheye":
            return tuple(1.0 if i < 8 else 0.0 for i in range(e))
        if self.camera_model == "spherical":
            return tuple(1.0 if i < 4 else 0.0 for i in range(e))
        return (1.0,) * e


# ---------------------------------------------------------------------------
# Residuals and Jacobians
# ---------------------------------------------------------------------------

def _residual_one(pose, intr, X, uv, model: str = "auto"):
    Xc = lie.rotate_aa(pose[..., :3], X) + pose[..., 3:6]
    return cam.camera_to_pixel(intr, Xc, model=model) - uv


def _obs_jacobians(pose_o, intr_o, X_o, uv_o, refine: bool, model: str = "auto"):
    """Per-observation residual + Jacobians.  Returns r (O, 2), Jc (O, 2, 6),
    Jg (O, 2, E) | None, Jp (O, 2, 3)."""
    f = partial(_residual_one, model=model)
    r = f(pose_o, intr_o, X_o, uv_o)
    if refine:
        Jc, Jg, Jp = vmap(jacfwd(f, argnums=(0, 1, 2)))(pose_o, intr_o, X_o, uv_o)
        return r, Jc, Jg, Jp
    Jc, Jp = vmap(jacfwd(f, argnums=(0, 2)))(pose_o, intr_o, X_o, uv_o)
    return r, Jc, None, Jp


def _prior_terms(ps, prior_pos, prior_w):
    """Soft camera-center prior: additive (dHcc (C,6,6), dgc (C,6), dcost)."""
    aa = ps[:, :3]
    t = ps[:, 3:6]
    R = lie.so3_exp(aa)
    Jr = lie.so3_right_jacobian(aa)
    Cc = -torch.einsum("cji,cj->ci", R, t)
    r = Cc - prior_pos
    J = torch.cat([torch.einsum("cij,cjk->cik", lie.hat(Cc), Jr), -R.transpose(1, 2)], dim=2)
    dH = prior_w[:, None, None] * torch.einsum("cki,ckj->cij", J, J)
    dg = prior_w[:, None] * torch.einsum("cki,ck->ci", J, r)
    dcost = 0.5 * torch.sum(prior_w * torch.sum(r * r, dim=-1))
    return dH, dg, dcost


def _huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight sqrt(rho'(s)): 1 inside delta, delta/||r|| outside."""
    nrm = torch.linalg.norm(r, dim=-1)
    return torch.sqrt(torch.clamp(delta / torch.clamp(nrm, min=1e-12), max=1.0))


def robust_cost(r: torch.Tensor, mask: torch.Tensor, delta: float) -> torch.Tensor:
    """Total Huber cost over masked observations."""
    s = torch.sum(r * r, dim=-1)
    nrm = torch.sqrt(s + 1e-20)
    return torch.sum(torch.where(nrm <= delta, 0.5 * s, delta * (nrm - 0.5 * delta)) * mask)


# ---------------------------------------------------------------------------
# Small linear-algebra helpers
# ---------------------------------------------------------------------------

def segment_sum(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Sum rows of vals (O, ...) by id (O,) into (n, ...)."""
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, ids, vals)


def _damp_blocks(H, lam):
    """Marquardt-scaled damping H + lam * diag(H), diagonal floored at 1e-6."""
    d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-6)
    return H + torch.diag_embed(lam * d)


def _inv3(M):
    """Batched closed-form (adjugate) 3x3 inverse with a ridge."""
    M = M + 1e-12 * torch.eye(3, dtype=M.dtype, device=M.device)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    adj = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return adj / det[..., None, None]


def _invD(M):
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.linalg.inv_ex(M + 1e-12 * eye)[0]


def _tree_vdot(a: dict, b: dict) -> torch.Tensor:
    return sum(torch.sum(a[k] * b[k]) for k in a)


def _pcg(matvec, b: dict, apply_M, iters: int, tol: float, aux0=None):
    """Block-Jacobi preconditioned conjugate gradients over a dict of
    per-block unknowns.

    aux0: optional zero accumulator.  Then `matvec(p)` returns (Ap, aux_p)
    with aux_p linear in p, and the solver returns (x, sum_i alpha_i
    aux_{p_i}), i.e. aux at the solution without another pass (the kernel
    path gets W^T dc for the point back-substitution this way)."""
    with_aux = aux0 is not None
    aux = aux0
    x = {k: torch.zeros_like(v) for k, v in b.items()}
    r = dict(b)
    z = apply_M(r)
    p = z
    rz = _tree_vdot(r, z)
    b2 = torch.clamp(_tree_vdot(b, b), min=1e-30)
    for _ in range(iters):
        if not bool(_tree_vdot(r, r) > tol * tol * b2):
            break
        Ap = matvec(p)
        if with_aux:
            Ap, aux_p = Ap
        pAp = _tree_vdot(p, Ap)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-30, torch.full_like(pAp, 1e-30), pAp)
        x = {k: x[k] + alpha * p[k] for k in x}
        if with_aux:
            aux = aux + alpha * aux_p
        r = {k: r[k] - alpha * Ap[k] for k in r}
        z = apply_M(r)
        rz_new = _tree_vdot(r, z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-30, torch.full_like(rz, 1e-30), rz)
        p = {k: z[k] + beta * p[k] for k in p}
        rz = rz_new
    return (x, aux) if with_aux else x


# ---------------------------------------------------------------------------
# Normal-equation assembly
# ---------------------------------------------------------------------------

def _build_system(pose, gintr, points, refine_m, obs_cam, obs_grp, obs_pt, obs_uv, obs_w,
                  C, G, cfg: BAConfig):
    """Segment-summed normal-equation pieces plus the per-observation
    coupling blocks Wc (O, 18) [and Wg (O, 3E)], in one pass over the obs
    table."""
    P = points.shape[0]
    D, E = POSE_DIM, gintr.shape[-1]
    refine = cfg.refine_intrinsics
    r, Jc, Jg, Jp = _obs_jacobians(pose[obs_cam], gintr[obs_grp], points[obs_pt], obs_uv,
                                   refine, cfg.camera_model)
    w = (_huber_weight(r, cfg.huber_delta) * obs_w)[:, None]
    acc = {"cost": robust_cost(r, obs_w, cfg.huber_delta)}
    r = r * w
    Jc = Jc * w[..., None]
    Jp = Jp * w[..., None]
    acc["Hcc"] = segment_sum(torch.einsum("oki,okj->oij", Jc, Jc), obs_cam, C)
    acc["Hpp"] = segment_sum(torch.einsum("oki,okj->oij", Jp, Jp), obs_pt, P)
    acc["gc"] = segment_sum(torch.einsum("oki,ok->oi", Jc, r), obs_cam, C)
    acc["gp"] = segment_sum(torch.einsum("oki,ok->oi", Jp, r), obs_pt, P)
    acc["Wc"] = torch.einsum("oki,okj->oij", Jc, Jp).reshape(-1, D * 3)
    if refine:
        Jg = Jg * (w[..., None] * refine_m[None, None, :])
        acc["Hgg"] = segment_sum(torch.einsum("oki,okj->oij", Jg, Jg), obs_grp, G)
        acc["Hcg"] = segment_sum(torch.einsum("oki,okj->oij", Jc, Jg), obs_cam, C)
        acc["gg"] = segment_sum(torch.einsum("oki,ok->oi", Jg, r), obs_grp, G)
        acc["Wg"] = torch.einsum("oki,okj->oij", Jg, Jp).reshape(-1, E * 3)
    return acc


# ---------------------------------------------------------------------------
# Reduced-system solves
# ---------------------------------------------------------------------------

def _dense_schur_solve(Hcc_d, Hgg_d, Hcg, Hpp_inv, Wc3, Wg3, obs_cam, obs_grp, obs_pt, rhs,
                       upd_c, upd_g, cam_group, C, G, refine: bool):
    """Assemble the reduced [pose | intrinsic-group] system densely from
    per-point coupling tables (P, C, 6, 3) [+ (P, G, E, 3)] and solve it by
    Cholesky.  A failed factorization gives the zero step (LM rejects it)."""
    D = POSE_DIM
    E = Hgg_d.shape[-1] if refine else INTR_DIM
    P = Hpp_inv.shape[0]
    dev, dt = Hcc_d.device, Hcc_d.dtype
    Wcp = segment_sum(Wc3.reshape(-1, D * 3), obs_pt * C + obs_cam, P * C).reshape(P, C, D, 3)
    Acp = torch.einsum("pcdk,pkl->pcdl", Wcp, Hpp_inv)
    idxC = torch.arange(C, device=dev)
    Scc = -torch.einsum("pcdl,pejl->cdej", Acp, Wcp)
    Scc[idxC, :, idxC, :] += Hcc_d
    if refine:
        Wgp = segment_sum(Wg3.reshape(-1, E * 3), obs_pt * G + obs_grp, P * G).reshape(P, G, E, 3)
        Scg = -torch.einsum("pcdl,pgel->cdge", Acp, Wgp)
        Scg[idxC, :, cam_group, :] += Hcg
        Agp = torch.einsum("pgek,pkl->pgel", Wgp, Hpp_inv)
        idxG = torch.arange(G, device=dev)
        Sgg = -torch.einsum("pgel,phfl->gehf", Agp, Wgp)
        Sgg[idxG, :, idxG, :] += Hgg_d
        cg = Scg.reshape(C * D, G * E)
        S = torch.cat([torch.cat([Scc.reshape(C * D, C * D), cg], 1),
                       torch.cat([cg.T, Sgg.reshape(G * E, G * E)], 1)], 0)
        u = torch.cat([upd_c.expand(C, D).reshape(-1), upd_g.expand(G, E).reshape(-1)])
    else:
        S = Scc.reshape(C * D, C * D)
        u = upd_c.expand(C, D).reshape(-1)
    # Freeze fixed rows: zero rows/cols, identity diagonal (S stays SPD).
    S = S * (u[:, None] * u[None, :]) + torch.diag(1.0 - u)
    L, info = torch.linalg.cholesky_ex(S)
    y = torch.linalg.solve_triangular(L, (rhs * u)[:, None], upper=False)
    d = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    good = torch.isfinite(d).all() & (info == 0)
    d = torch.where(good, d, torch.zeros((), dtype=dt, device=dev)) * u
    dc = d[: C * D].reshape(C, D)
    dg = d[C * D:].reshape(G, E) if refine else None
    return dc, dg


def _dense_eligible(C, G, P, cfg: BAConfig) -> bool:
    dim = C * POSE_DIM + (G * INTR_DIM if cfg.refine_intrinsics else 0)
    tables = P * C * POSE_DIM * 3
    if cfg.refine_intrinsics:
        tables += P * G * INTR_DIM * 3
    return dim <= cfg.dense_schur_max_dim and 2 * tables * 4 <= cfg.dense_schur_max_bytes


def _schur_diag_pose(Hcc_d, Hpp_inv, Wc, obs_cam, obs_pt, C):
    """Exact pose-diagonal blocks of S (block-Jacobi preconditioner)."""
    D = Hcc_d.shape[-1]
    W3 = Wc.reshape(-1, D, 3)
    contrib = torch.einsum("oij,ojk,olk->oil", W3, Hpp_inv[obs_pt], W3)
    return Hcc_d - segment_sum(contrib, obs_cam, C)


# ---------------------------------------------------------------------------
# LM loop (both paths)
# ---------------------------------------------------------------------------

def _lm_loop(linearize, solve, ps, gi, pts, refine: bool, cfg: BAConfig, max_iters: int):
    """Two-pass-accept Levenberg-Marquardt: solve the carried linearization
    at the current damping, linearize the candidate (its cost rides along),
    keep the winner's linearization.  Returns (ps, gi, pts, lambda,
    initial cost, final cost, iterations)."""
    sys, cost = linearize(ps, gi, pts)
    init_cost = cost
    lam = torch.tensor(cfg.lambda_init, dtype=torch.float32, device=ps.device)
    done = torch.zeros((), dtype=torch.bool, device=ps.device)
    n_it = 0
    while n_it < max_iters:
        dc, dg, dp = solve(sys, lam)
        ps_new = ps + dc
        gi_new = gi + dg if refine else gi
        pts_new = pts + dp
        sys_new, new_cost = linearize(ps_new, gi_new, pts_new)
        accept = (new_cost < cost) & ~done
        ps = torch.where(accept, ps_new, ps)
        gi = torch.where(accept, gi_new, gi)
        pts = torch.where(accept, pts_new, pts)
        sys = {k: torch.where(accept, sys_new[k], sys[k]) for k in sys}
        cost_out = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * cfg.lambda_down, min=cfg.lambda_min),
                          torch.clamp(lam * cfg.lambda_up, max=cfg.lambda_max))
        rel = torch.abs(cost - cost_out) / torch.clamp(cost, min=1e-12)
        done = done | (accept & (rel < cfg.converge_rtol))
        cost = cost_out
        n_it += 1
        if bool(done):
            break
    return ps, gi, pts, lam, init_cost, cost, n_it


# ---------------------------------------------------------------------------
# Kernel path: every observation-table pass through K2-K4
# ---------------------------------------------------------------------------

def camera_table(ps: torch.Tensor) -> torch.Tensor:
    """K2's per-camera rows (C, 21) [t | R row-major | Jr row-major] of
    poses ps (C, 6) = [axis-angle | t]."""
    C = ps.shape[0]
    R = lie.so3_exp(ps[:, :3])
    Jr = lie.so3_right_jacobian(ps[:, :3])
    return torch.cat([ps[:, 3:6], R.reshape(C, 9), Jr.reshape(C, 9)], 1)


def _lm_kernels(pose0, gintr0, points, upd_c, pt_upd, obs_cam, obs_grp, obs_pt, obs_uv, obs_w,
                C, G, cfg: BAConfig, max_iters: int, prior_pos=None, prior_w=None):
    """Counterpart of the reference's ``_lm_pallas`` in its single-device,
    rank-space mode with intrinsics held: the table is point-sorted and
    rank-compacted once per solve (or taken as sorted under
    ``assume_sorted``), the whole point side of the state lives in rank
    space, and each linearization (K2), right-hand side (K4) and CG matvec
    (K3) is one kernel call.  Returns (ps, gi, pts, lambda, initial cost,
    final cost, iterations)."""
    if cfg.refine_intrinsics:
        raise NotImplementedError(
            "the BA kernel path with refine_intrinsics=True needs K2's refine mode and "
            "kernel K5 (schur_fwd_t), which are not ported yet")
    E = gintr0.shape[-1]
    if C > 2048 or G > 2048 or E != INTR_DIM or cfg.camera_model not in ("auto", "radial3"):
        raise NotImplementedError(
            f"the BA kernel path with C={C}, G={G} and a {E}-lane {cfg.camera_model!r} camera "
            "model runs the unfused kernels K6 (segsum_table_t) and K7 (segsum_sorted_t), "
            "which are not ported yet; the fused K2 takes RADIAL3 and up to 2048 cameras "
            "and groups")
    if cfg.precond not in ("hcc", "schur_diag"):
        raise ValueError(f"precond must be 'hcc' or 'schur_diag', got {cfg.precond!r}")
    dev = pose0.device
    if cfg.precond == "schur_diag" and dev.type != "cpu":
        raise NotImplementedError(
            "precond='schur_diag' reduces per camera through kernel K6 (segsum_table_t), "
            "which is not ported yet; use precond='hcc'")
    P = points.shape[0]
    D = POSE_DIM
    if cfg.assume_sorted:
        # Rank IS the point id: no sort, and fractional weights stand.
        obs_pt = obs_pt.to(torch.int32)
        ranks = obs_pt
        rank_to_pt = torch.arange(P, dtype=torch.int32, device=dev)
        rank_valid = torch.arange(P, device=dev) <= obs_pt[-1]
        obs_cam = obs_cam.to(torch.int32)
        obs_grp = obs_grp.to(torch.int32)
        obs_w = obs_w.to(torch.float32)
    else:
        # One stable sort carries the columns; the weight is rebuilt as
        # binary from the sort key (the reference's contract, :616-621).
        cam32, grp32 = obs_cam.to(torch.int32), obs_grp.to(torch.int32)
        if C < 2 ** 15 and G < 2 ** 16:
            (packed, uv0, uv1), obs_pt, ranks, rank_to_pt, rank_valid = ot.sort_and_rank_payload(
                obs_pt, obs_w > 0, P, (cam32 * 65536 + grp32, obs_uv[:, 0], obs_uv[:, 1]))
            obs_cam = packed // 65536
            obs_grp = packed - obs_cam * 65536
        else:
            (obs_cam, obs_grp, uv0, uv1), obs_pt, ranks, rank_to_pt, rank_valid = \
                ot.sort_and_rank_payload(obs_pt, obs_w > 0, P, (cam32, grp32, obs_uv[:, 0],
                                                                  obs_uv[:, 1]))
        obs_w = (ranks < ot.INVALID_RANK).to(torch.float32)
        obs_uv = torch.stack([uv0, uv1], 1)
    obs_uvT = obs_uv.T.contiguous()
    safe_r2p = torch.clamp(rank_to_pt, max=P - 1).long()
    layout = ot.obs_layout(obs_cam, C, ranks, P)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    full66 = torch.tensor(ot._FULL66, device=dev)
    full33 = torch.tensor(ot._FULL33, device=dev)

    def linearize(ps, gi, pts):
        camred, ptred, Wc = ot.linearize_reduce_radial3_t(
            camera_table(ps), gi, pts, obs_cam, obs_grp, ranks, obs_uvT, obs_w, refine=False,
            refine_mask=cfg.refine_mask(), huber_delta=cfg.huber_delta, w_dtype=cfg.w_dtype,
            layout=layout)
        sys = {"Hcc": camred[:, full66].reshape(C, D, D), "gc": camred[:, 21:27], "Wc": Wc,
               "Hpp": ptred[:, full33].reshape(P, 3, 3), "gp": ptred[:, 6:9]}
        cost = torch.sum(camred[:, -1])
        if prior_pos is not None:
            dH, dg, dcost = _prior_terms(ps, prior_pos, prior_w)
            sys["Hcc"] = sys["Hcc"] + dH
            sys["gc"] = sys["gc"] + dg
            cost = cost + dcost
        return sys, cost

    def solve(sys, lam):
        Hcc_d = _damp_blocks(sys["Hcc"], lam)
        Hinv = torch.where(rank_valid[:, None, None], _inv3(_damp_blocks(sys["Hpp"], lam)), zero)
        gp, Wc = sys["gp"], sys["Wc"]
        z = torch.einsum("pij,pj->pi", Hinv, gp)
        rhs = {"c": (-sys["gc"] + ot.schur_bwd_t(Wc, obs_cam, ranks, z, C, layout=layout))
               * upd_c}
        if cfg.precond == "schur_diag":  # exact S diagonal blocks (CPU only, see above)
            W3 = Wc.to(torch.float32).T.reshape(-1, D, 3)
            Hinv_o = ot._gather_rows(Hinv, ranks)
            contrib = torch.einsum("oij,ojk,olk->oil", W3, Hinv_o, W3)
            M_inv_c = _invD(Hcc_d - ot._segsum_drop(contrib, obs_cam, C))
        else:  # damped Hcc blocks: one obs-table pass fewer
            M_inv_c = _invD(Hcc_d)

        def apply_M(v):
            return {"c": torch.einsum("cij,cj->ci", M_inv_c, v["c"])}

        def mv(v):
            sv, y = ot.schur_mv_t(Wc, obs_cam, ranks, v["c"] * upd_c, Hinv, P, hcc_d=Hcc_d,
                                  layout=layout)
            return {"c": sv * upd_c}, y

        d, Wtd = _pcg(mv, rhs, apply_M, cfg.cg_iters, cfg.cg_tol,
                      aux0=torch.zeros((P, 3), dtype=torch.float32, device=dev))
        dp = -torch.einsum("pij,pj->pi", Hinv, gp + Wtd) * pt_upd_state
        return d["c"] * upd_c, None, dp

    # Points enter rank space once and leave it once.
    pts_state0 = torch.where(rank_valid[:, None], points[safe_r2p], zero)
    pt_upd_state = torch.where(rank_valid[:, None], pt_upd[safe_r2p], zero)
    ps, gi, pts, lam, init_cost, cost, n_it = _lm_loop(linearize, solve, pose0, gintr0,
                                                       pts_state0, False, cfg, max_iters)
    # Rows of valid ranks go back to their points; the rest keep their input.
    scatter_ids = torch.where(rank_valid, rank_to_pt, torch.full_like(rank_to_pt, P)).long()
    out = torch.cat([points, points[:1]], 0).index_copy_(0, scatter_ids, pts)[:P]
    return ps, gi, out, lam, init_cost, cost, n_it


# ---------------------------------------------------------------------------
# LM driver
# ---------------------------------------------------------------------------

def bundle_adjust(
    intr: torch.Tensor,        # (C, 7) per-camera intrinsics, consistent within a group
    cam_rot: torch.Tensor,     # (C, 3) axis-angle
    cam_t: torch.Tensor,       # (C, 3)
    cam_mask: torch.Tensor,    # (C,)
    points: torch.Tensor,      # (P, 3)
    point_mask: torch.Tensor,  # (P,)
    obs_cam: torch.Tensor,     # (O,)
    obs_pt: torch.Tensor,      # (O,)
    obs_uv: torch.Tensor,      # (O, 2)
    obs_mask: torch.Tensor,    # (O,)
    cfg: BAConfig = BAConfig(),
    cam_free_mask: torch.Tensor | None = None,  # (C,) False freezes a camera pose
    cam_group: torch.Tensor | None = None,      # (C,) intrinsic-group id per camera
    n_groups: int | None = None,                # group count; None = C
    prior_pos: torch.Tensor | None = None,      # (C, 3) soft camera-center priors
    prior_weight: torch.Tensor | None = None,   # (C,) prior weights (1/sigma^2)
    max_iters: int | None = None,               # overrides cfg.max_iters
):
    """Run LM bundle adjustment.  Returns (intr, cam_rot, cam_t, points,
    info) with info = {'initial_cost', 'final_cost', 'lambda', 'iterations',
    'n_obs'}; the returned intr is per camera, gathered from the group
    table."""
    dev = intr.device
    C = intr.shape[0]
    P = points.shape[0]
    refine = cfg.refine_intrinsics
    if cam_group is None:
        cam_group = torch.arange(C, device=dev)
        G = C
    else:
        cam_group = cam_group.long()
        G = int(n_groups) if n_groups is not None else C
    dense_ok = _dense_eligible(C, G, P, cfg)
    E = intr.shape[-1]
    D = POSE_DIM
    gintr = torch.zeros((G, E), dtype=intr.dtype, device=dev)
    gintr[cam_group] = intr
    refine_m = torch.as_tensor(cfg.refine_mask(E), dtype=intr.dtype, device=dev)

    obs_cam = obs_cam.long()
    obs_pt = obs_pt.long()
    obs_w = obs_mask.to(torch.float32)
    obs_grp = cam_group[obs_cam]

    free = cam_mask if cam_free_mask is None else (cam_mask & cam_free_mask)
    upd_c = free.to(torch.float32)[:, None]
    if cfg.fix_first_cam:
        upd_c = upd_c.clone()
        upd_c[0] = 0.0
    pt_upd = point_mask.to(torch.float32)[:, None]
    grp_w = segment_sum(obs_w, obs_grp, G)
    upd_g = (grp_w > 0).to(torch.float32)[:, None] * refine_m[None, :]

    prior_w = None
    if prior_pos is not None:
        pw = torch.ones(C, device=dev) if prior_weight is None else prior_weight
        prior_w = pw * cam_mask.to(torch.float32)

    pose0 = torch.cat([cam_rot, cam_t], dim=-1)

    def linearize(ps, gi, pts):
        sys = _build_system(ps, gi, pts, refine_m, obs_cam, obs_grp, obs_pt, obs_uv, obs_w,
                            C, G, cfg)
        cost = sys.pop("cost")
        if prior_pos is not None:
            dH, dg, dcost = _prior_terms(ps, prior_pos, prior_w)
            sys["Hcc"] = sys["Hcc"] + dH
            sys["gc"] = sys["gc"] + dg
            cost = cost + dcost
        return sys, cost

    def solve(sys, lam):
        Wc3 = sys["Wc"].reshape(-1, D, 3)
        Wg3 = sys["Wg"].reshape(-1, E, 3) if refine else None
        Hcc_d = _damp_blocks(sys["Hcc"], lam)
        Hpp_inv = _inv3(_damp_blocks(sys["Hpp"], lam))
        Hgg_d = _damp_blocks(sys["Hgg"], lam) if refine else None
        Hcg = sys["Hcg"] if refine else None

        # Reduced rhs: -g + W Hpp^-1 gp.
        z_o = torch.einsum("pij,pj->pi", Hpp_inv, sys["gp"])[obs_pt]
        rhs_c = (-sys["gc"] + segment_sum(torch.einsum("oij,oj->oi", Wc3, z_o), obs_cam, C)) * upd_c
        if refine:
            rhs_g = (-sys["gg"] + segment_sum(torch.einsum("oij,oj->oi", Wg3, z_o), obs_grp, G)) * upd_g

        if dense_ok:
            rhs_flat = torch.cat([rhs_c.reshape(-1), rhs_g.reshape(-1)]) if refine else rhs_c.reshape(-1)
            dc, dg = _dense_schur_solve(Hcc_d, Hgg_d, Hcg, Hpp_inv, Wc3, Wg3, obs_cam, obs_grp,
                                        obs_pt, rhs_flat, upd_c, upd_g, cam_group, C, G, refine)
        else:
            M_inv_c = _invD(_schur_diag_pose(Hcc_d, Hpp_inv, sys["Wc"], obs_cam, obs_pt, C))
            M_inv_g = _invD(Hgg_d) if refine else None

            def apply_M(v):
                out = {"c": torch.einsum("cij,cj->ci", M_inv_c, v["c"])}
                if refine:
                    out["g"] = torch.einsum("gij,gj->gi", M_inv_g, v["g"])
                return out

            def mv(v):
                vc = v["c"] * upd_c
                u = torch.einsum("oij,oi->oj", Wc3, vc[obs_cam])
                if refine:
                    vg = v["g"] * upd_g
                    u = u + torch.einsum("oij,oi->oj", Wg3, vg[obs_grp])
                zz_o = torch.einsum("pij,pj->pi", Hpp_inv, segment_sum(u, obs_pt, P))[obs_pt]
                bc = segment_sum(torch.einsum("oij,oj->oi", Wc3, zz_o), obs_cam, C)
                Hvc = torch.einsum("cij,cj->ci", Hcc_d, vc)
                if refine:
                    Hvc = Hvc + torch.einsum("cde,ce->cd", Hcg, vg[cam_group])
                    bg = segment_sum(torch.einsum("oij,oj->oi", Wg3, zz_o), obs_grp, G)
                    Hvg = (torch.einsum("gef,gf->ge", Hgg_d, vg)
                           + segment_sum(torch.einsum("cde,cd->ce", Hcg, vc), cam_group, G))
                    return {"c": (Hvc - bc) * upd_c, "g": (Hvg - bg) * upd_g}
                return {"c": (Hvc - bc) * upd_c}

            rhs = {"c": rhs_c, "g": rhs_g} if refine else {"c": rhs_c}
            d = _pcg(mv, rhs, apply_M, cfg.cg_iters, cfg.cg_tol)
            dc = d["c"] * upd_c
            dg = d["g"] * upd_g if refine else None

        # Back-substitute points: dp = -Hpp^-1 (gp + W^T d).
        u = torch.einsum("oij,oi->oj", Wc3, dc[obs_cam])
        if refine:
            u = u + torch.einsum("oij,oi->oj", Wg3, dg[obs_grp])
        Wtd = segment_sum(u, obs_pt, P)
        dp = -torch.einsum("pij,pj->pi", Hpp_inv, sys["gp"] + Wtd) * pt_upd
        return dc, dg, dp

    mi = cfg.max_iters if max_iters is None else int(max_iters)
    if cfg.impl == "pallas" or (cfg.impl == "auto" and dev.type == "cuda" and not dense_ok):
        ps, gi, pts, lam, init_cost, cost, n_it = _lm_kernels(
            pose0, gintr, points, upd_c, pt_upd, obs_cam, obs_grp, obs_pt, obs_uv, obs_w, C, G,
            cfg, mi, prior_pos=prior_pos, prior_w=prior_w)
    else:
        ps, gi, pts, lam, init_cost, cost, n_it = _lm_loop(linearize, solve, pose0, gintr, points,
                                                           refine, cfg, mi)
    info = {
        "initial_cost": init_cost,
        "final_cost": cost,
        "lambda": lam,
        "iterations": n_it,
        "n_obs": torch.sum(obs_mask),
    }
    return gi[cam_group], ps[:, :3], ps[:, 3:6], pts, info
