"""The benchmark's plain reference: Huber-robust Levenberg-Marquardt bundle
adjustment over the Schur complement, solved by block-Jacobi
preconditioned conjugate gradients, in plain PyTorch.

It implements the algorithm that the configuration's solver settings
state, from the problem alone: residuals and closed-form Jacobians of the
RADIAL3 camera (x_cam = R(aa) X + t, pixel = f * distort(x / z) + c),
Huber weights (IRLS), the normal equations summed per camera, group and
point, Marquardt-scaled damping, the points eliminated by their 3x3 blocks,
the reduced camera [and intrinsic-group] system solved by PCG from zero
with the damped diagonal blocks as preconditioner, the points
back-substituted, and the two-pass accept of LM (solve at the carried
linearization, linearize the candidate, keep the better).  Observations
are taken in the order given; nothing is sorted or compacted.

``dtype`` is the working precision of every table and sum: float64 is the
reference, float32 the CPU test, and bfloat16 the control that computes
the same solve one precision below the configuration's.  torch.linalg has
no bfloat16, so the 6x6 and 7x7 preconditioner inverses of a bfloat16 run
are taken in float32 and rounded back.  TF32 is switched off.

Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses

import torch

POSE = 6
INTR = 7
CHUNK = 1 << 20  # observations per block of the linearization and of the cost


@dataclasses.dataclass(frozen=True)
class Settings:
    """The solver settings that the reference reads (a configuration's
    ``ba`` block holds them, with others that only the program reads)."""
    max_iters: int
    huber_delta: float
    refine_intrinsics: bool
    refine_params: str
    cg_iters: int
    cg_tol: float
    lambda_init: float
    lambda_up: float
    lambda_down: float
    lambda_min: float
    lambda_max: float
    converge_rtol: float
    fix_first_cam: bool

    @classmethod
    def from_ba(cls, ba: dict) -> "Settings":
        return cls(**{f.name: ba[f.name] for f in dataclasses.fields(cls)})

    def refine_mask(self) -> list[float]:
        if not self.refine_intrinsics:
            return [0.0] * INTR
        n = {"focal": 2, "focal_pp": 4, "all": INTR}[self.refine_params]
        return [1.0] * n + [0.0] * (INTR - n)


@dataclasses.dataclass
class Table:
    """The observation table as the reference uses it."""
    cam: torch.Tensor    # (O,) int64
    pt: torch.Tensor     # (O,) int64
    uv: torch.Tensor     # (O, 2) working dtype
    grp: torch.Tensor    # (O,) int64 intrinsic group of each observation
    C: int
    P: int
    G: int
    cam_group: torch.Tensor  # (C,) int64


def make_table(obs_cam, obs_pt, obs_uv, n_points: int, cam_group, n_groups: int,
               dtype) -> Table:
    cam_group = cam_group.long()
    cam = obs_cam.long()
    return Table(cam=cam, pt=obs_pt.long(), uv=obs_uv.to(dtype), grp=cam_group[cam],
                 C=int(cam_group.shape[0]), P=int(n_points), G=int(n_groups),
                 cam_group=cam_group)


def _no_tf32() -> None:
    """float32 products in full float32 (PyTorch's default for matmul)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Rotations
# ---------------------------------------------------------------------------

def hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _angle_terms(w: torch.Tensor):
    """theta^2 and the three series sin(t)/t, (1 - cos t)/t^2 and
    (t - sin t)/t^3, with their Taylor forms near zero."""
    th2 = (w * w).sum(-1)
    small = th2 < 1e-6
    safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(safe)
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / safe)
    c = torch.where(small, 1.0 / 6 - th2 / 120, (th - torch.sin(th)) / (safe * th))
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: R = I + a [w]x + b [w]x^2."""
    a, b, _ = _angle_terms(w)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Jr(w) = I - b [w]x + c [w]x^2: R(w + d) = R(w) Exp(Jr(w) d) to first order."""
    _, b, c = _angle_terms(w)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - b[..., None, None] * W + c[..., None, None] * (W @ W)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Row-wise matrix-vector products by elementwise sums (no matmul)."""
    return (M * v[..., None, :]).sum(-1)


# ---------------------------------------------------------------------------
# Residuals, cost and linearization
# ---------------------------------------------------------------------------

def _residual_rows(R, t, intr, X, uv):
    """Per-row residual and the intermediate terms of its Jacobians."""
    Xc = _mv(R, X) + t
    iz = 1 / Xc[:, 2]
    xn = Xc[:, :2] * iz[:, None]
    r2 = (xn * xn).sum(-1)
    k1, k2, k3 = intr[:, 4], intr[:, 5], intr[:, 6]
    s = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * s[:, None]
    f = intr[:, 0:2]
    r = xd * f + intr[:, 2:4] - uv
    return r, dict(iz=iz, xn=xn, r2=r2, s=s, xd=xd, f=f, k1=k1, k2=k2, k3=k3)


def _huber(r: torch.Tensor, delta: float):
    """Per-row Huber cost and IRLS weight sqrt(rho')."""
    s = (r * r).sum(-1)
    nrm = torch.sqrt(s)
    cost = torch.where(nrm <= delta, 0.5 * s, delta * (nrm - 0.5 * delta))
    w = torch.sqrt(torch.clamp(delta / torch.clamp(nrm, min=1e-12), max=1.0))
    return cost, w


def robust_cost(intr_cam, rot, t, pts, tab: Table, delta: float, dtype=torch.float64):
    """The total Huber cost of a state with per-camera intrinsics (C, 7),
    in `dtype`, in blocks of observations."""
    _no_tf32()
    intr_cam, rot, t, pts = (x.to(dtype) for x in (intr_cam, rot, t, pts))
    R = so3_exp(rot)
    total = torch.zeros((), dtype=dtype, device=pts.device)
    for s in range(0, tab.cam.shape[0], CHUNK):
        c, p = tab.cam[s:s + CHUNK], tab.pt[s:s + CHUNK]
        r, _ = _residual_rows(R[c], t[c], intr_cam[c], pts[p], tab.uv[s:s + CHUNK].to(dtype))
        total = total + _huber(r, delta)[0].sum()
    return total


def _jacobians(R, Jr, intr, X, terms, refine: bool):
    """Closed-form Jacobians of one block of rows: d r / d [aa | t] (n, 2, 6),
    d r / d X (n, 2, 3) and, refining, d r / d intrinsics (n, 2, 7)."""
    iz, xn, r2, s, f = terms["iz"], terms["xn"], terms["r2"], terms["s"], terms["f"]
    ds = terms["k1"] + r2 * (2 * terms["k2"] + 3 * r2 * terms["k3"])
    x, y = xn[:, 0], xn[:, 1]
    # d xd / d xn = s I + 2 ds xn xn^T, then the focal, then d xn / d Xc.
    a00 = s + 2 * ds * x * x
    a01 = 2 * ds * x * y
    a11 = s + 2 * ds * y * y
    fx, fy = f[:, 0], f[:, 1]
    z = torch.zeros_like(x)
    JX = torch.stack([
        torch.stack([fx * a00 * iz, fx * a01 * iz, -fx * (a00 * x + a01 * y) * iz], -1),
        torch.stack([fy * a01 * iz, fy * a11 * iz, -fy * (a01 * x + a11 * y) * iz], -1),
    ], 1)                                               # (n, 2, 3) d r / d Xc
    Jp = (JX[:, :, :, None] * R[:, None, :, :]).sum(2)  # d r / d X = JX R
    # d (R X) / d aa = -R [X]x Jr: row k of Jp [X]x is cross(Jp_k, X).
    M = _cross(Jp, X[:, None, :])
    Jrot = -(M[:, :, :, None] * Jr[:, None, :, :]).sum(2)
    Jc = torch.cat([Jrot, JX], 2)
    if not refine:
        return Jc, Jp, None
    xd = terms["xd"]
    one = torch.ones_like(x)
    p1, p2, p3 = r2, r2 * r2, r2 * r2 * r2
    Jg = torch.stack([
        torch.stack([xd[:, 0], z, one, z, fx * x * p1, fx * x * p2, fx * x * p3], -1),
        torch.stack([z, xd[:, 1], z, one, fy * y * p1, fy * y * p2, fy * y * p3], -1),
    ], 1)
    return Jc, Jp, Jg


def _tt(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Row-wise A^T B of (n, 2, a) and (n, 2, b) -> (n, a, b)."""
    return (A[:, :, :, None] * B[:, :, None, :]).sum(1)


def _tv(A: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Row-wise A^T r of (n, 2, a) and (n, 2) -> (n, a)."""
    return (A * r[:, :, None]).sum(1)


def linearize(pose, gi, pts, tab: Table, st: Settings, refine_m: torch.Tensor):
    """Cost and normal-equation pieces at (pose (C, 6), gi (G, 7), pts (P, 3)):
    Hcc, gc per camera, Hpp, gp per point, W (O, 6, 3) per observation and,
    refining, Hgg, gg per group, Hcg per camera and Wg (O, 7, 3)."""
    dt, dev = pose.dtype, pose.device
    refine = st.refine_intrinsics
    R = so3_exp(pose[:, :3])
    Jr = right_jacobian(pose[:, :3])
    intr_cam = gi[tab.cam_group]
    z = dict(dtype=dt, device=dev)
    C, P, G, O = tab.C, tab.P, tab.G, tab.cam.shape[0]
    out = {"cost": torch.zeros((), **z), "Hcc": torch.zeros(C, POSE, POSE, **z),
           "gc": torch.zeros(C, POSE, **z), "Hpp": torch.zeros(P, 3, 3, **z),
           "gp": torch.zeros(P, 3, **z), "W": torch.empty(O, POSE, 3, **z)}
    if refine:
        out.update(Hgg=torch.zeros(G, INTR, INTR, **z), gg=torch.zeros(G, INTR, **z),
                   Hcg=torch.zeros(C, POSE, INTR, **z), Wg=torch.empty(O, INTR, 3, **z))
    for s in range(0, O, CHUNK):
        c, p, g = tab.cam[s:s + CHUNK], tab.pt[s:s + CHUNK], tab.grp[s:s + CHUNK]
        X = pts[p]
        r, terms = _residual_rows(R[c], pose[c, 3:], intr_cam[c], X, tab.uv[s:s + CHUNK])
        cost, w = _huber(r, st.huber_delta)
        out["cost"] = out["cost"] + cost.sum()
        Jc, Jp, Jg = _jacobians(R[c], Jr[c], intr_cam[c], X, terms, refine)
        r = r * w[:, None]
        Jc = Jc * w[:, None, None]
        Jp = Jp * w[:, None, None]
        out["Hcc"].index_add_(0, c, _tt(Jc, Jc))
        out["gc"].index_add_(0, c, _tv(Jc, r))
        out["Hpp"].index_add_(0, p, _tt(Jp, Jp))
        out["gp"].index_add_(0, p, _tv(Jp, r))
        out["W"][s:s + CHUNK] = _tt(Jc, Jp)
        if refine:
            Jg = Jg * (w[:, None, None] * refine_m)
            out["Hgg"].index_add_(0, g, _tt(Jg, Jg))
            out["gg"].index_add_(0, g, _tv(Jg, r))
            out["Hcg"].index_add_(0, c, _tt(Jc, Jg))
            out["Wg"][s:s + CHUNK] = _tt(Jg, Jp)
    return out


# ---------------------------------------------------------------------------
# One damped step
# ---------------------------------------------------------------------------

def damp(H: torch.Tensor, lam: float) -> torch.Tensor:
    """H + lam * diag(H), the diagonal floored at 1e-6 (Marquardt)."""
    d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-6)
    return H + torch.diag_embed(lam * d)


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 inverse by the adjugate (any dtype)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, Cc = e * i - f * h, c * h - b * i, b * f - c * e
    D, E, F = f * g - d * i, a * i - c * g, c * d - a * f
    G, H, I = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack([torch.stack([A, B, Cc], -1), torch.stack([D, E, F], -1),
                       torch.stack([G, H, I], -1)], -2)
    return adj / det[..., None, None]


def _inv(M: torch.Tensor) -> torch.Tensor:
    if M.dtype == torch.bfloat16:
        return torch.linalg.inv(M.float()).to(M.dtype)
    return torch.linalg.inv(M)


def _sum_rows(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                       device=vals.device).index_add_(0, ids, vals)


def _dot(a: dict, b: dict) -> torch.Tensor:
    return sum((a[k] * b[k]).sum() for k in a)


def pcg(matvec, b: dict, precond, iters: int, tol: float) -> dict:
    """Preconditioned conjugate gradients from zero, stopped once
    |r| <= tol |b| or after `iters` products."""
    x = {k: torch.zeros_like(v) for k, v in b.items()}
    r = dict(b)
    zv = precond(r)
    p = zv
    rz = _dot(r, zv)
    b2 = max(float(_dot(b, b)), 1e-30)
    for _ in range(iters):
        if not float(_dot(r, r)) > tol * tol * b2:
            break
        Ap = matvec(p)
        pAp = _dot(p, Ap)
        alpha = rz / (pAp if abs(float(pAp)) >= 1e-30 else 1e-30)
        x = {k: x[k] + alpha * p[k] for k in x}
        r = {k: r[k] - alpha * Ap[k] for k in r}
        zv = precond(r)
        rz_new = _dot(r, zv)
        beta = rz_new / (rz if abs(float(rz)) >= 1e-30 else 1e-30)
        p = {k: zv[k] + beta * p[k] for k in p}
        rz = rz_new
    return x


def step(lin: dict, lam: float, tab: Table, st: Settings, upd_c, upd_g, upd_p):
    """The damped Gauss-Newton step (dc, dg, dp) of one linearization."""
    refine = st.refine_intrinsics
    W = lin["W"]
    Hcc = damp(lin["Hcc"], lam)
    Hpp_inv = inv3(damp(lin["Hpp"], lam))

    def w_sum(z_pt):  # per camera [and group] sums of W z over observations
        z_o = z_pt[tab.pt]
        out = {"c": _sum_rows(_mv(W, z_o), tab.cam, tab.C)}
        if refine:
            out["g"] = _sum_rows(_mv(lin["Wg"], z_o), tab.grp, tab.G)
        return out

    def wt_sum(v):  # per point sums of W^T v over observations
        u = _mv(W.transpose(1, 2), v["c"][tab.cam])
        if refine:
            u = u + _mv(lin["Wg"].transpose(1, 2), v["g"][tab.grp])
        return _sum_rows(u, tab.pt, tab.P)

    wz = w_sum(_mv(Hpp_inv, lin["gp"]))
    rhs = {"c": (-lin["gc"] + wz["c"]) * upd_c}
    Minv = {"c": _inv(Hcc)}
    if refine:
        Hgg = damp(lin["Hgg"], lam)
        rhs["g"] = (-lin["gg"] + wz["g"]) * upd_g
        Minv["g"] = _inv(Hgg)
        Hcg = lin["Hcg"]

    def matvec(v):
        v = {"c": v["c"] * upd_c, **({"g": v["g"] * upd_g} if refine else {})}
        b = w_sum(_mv(Hpp_inv, wt_sum(v)))
        out = {"c": _mv(Hcc, v["c"]) - b["c"]}
        if refine:
            out["c"] = out["c"] + _mv(Hcg, v["g"][tab.cam_group])
            hg = _sum_rows(_mv(Hcg.transpose(1, 2), v["c"]), tab.cam_group, tab.G)
            out["g"] = (_mv(Hgg, v["g"]) + hg - b["g"]) * upd_g
        out["c"] = out["c"] * upd_c
        return out

    d = pcg(matvec, rhs, lambda v: {k: _mv(Minv[k], v[k]) for k in v}, st.cg_iters, st.cg_tol)
    d = {"c": d["c"] * upd_c, **({"g": d["g"] * upd_g} if refine else {})}
    dp = -_mv(Hpp_inv, lin["gp"] + wt_sum(d)) * upd_p
    return d["c"], d.get("g"), dp


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def solve(intr, cam_rot, cam_t, points, obs_cam, obs_pt, obs_uv, ba: dict,
          cam_group=None, n_groups: int | None = None, dtype=torch.float64):
    """LM bundle adjustment of the start (intr (C, 7) per camera, consistent
    within a group; cam_rot, cam_t (C, 3); points (P, 3)) against the table,
    every camera and point free (but camera 0's pose under
    ``fix_first_cam``).  Returns (intr per camera, cam_rot, cam_t, points,
    info) in `dtype`, info = {initial_cost, final_cost, iterations}."""
    _no_tf32()
    st = Settings.from_ba(ba)
    dev = points.device
    C = intr.shape[0]
    if cam_group is None:
        cam_group, n_groups = torch.arange(C, device=dev), C
    tab = make_table(obs_cam, obs_pt, obs_uv, points.shape[0], cam_group, n_groups, dtype)
    z = dict(dtype=dtype, device=dev)
    gi = torch.zeros(tab.G, INTR, **z)
    gi[tab.cam_group] = intr.to(dtype)
    pose = torch.cat([cam_rot, cam_t], 1).to(dtype)
    pts = points.to(dtype)
    refine_m = torch.tensor(st.refine_mask(), **z)
    upd_c = torch.ones(C, 1, **z)
    if st.fix_first_cam:
        upd_c[0] = 0
    seen = torch.zeros(tab.G, **z).index_add_(0, tab.grp, torch.ones(tab.grp.shape[0], **z))
    upd_g = (seen > 0).to(dtype)[:, None] * refine_m
    upd_p = torch.ones(tab.P, 1, **z)

    lin = linearize(pose, gi, pts, tab, st, refine_m)
    cost = lin["cost"]
    init_cost = cost
    lam = st.lambda_init
    it = 0
    while it < st.max_iters:
        dc, dg, dp = step(lin, lam, tab, st, upd_c, upd_g, upd_p)
        pose_n, pts_n = pose + dc, pts + dp
        gi_n = gi + dg if st.refine_intrinsics else gi
        lin_n = linearize(pose_n, gi_n, pts_n, tab, st, refine_m)
        it += 1
        if bool(lin_n["cost"] < cost):
            rel = float(torch.abs(cost - lin_n["cost"]) / torch.clamp(cost, min=1e-12))
            pose, gi, pts, lin, cost = pose_n, gi_n, pts_n, lin_n, lin_n["cost"]
            lam = max(lam * st.lambda_down, st.lambda_min)
            if rel < st.converge_rtol:
                break
        else:
            lam = min(lam * st.lambda_up, st.lambda_max)
    info = {"initial_cost": init_cost, "final_cost": cost, "iterations": it}
    return gi[tab.cam_group], pose[:, :3], pose[:, 3:], pts, info
