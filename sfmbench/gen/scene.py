"""Bundle-adjustment problems at a BAL problem's published size, made on
the device from a seed.

No BAL file is read: the benchmark runs without a network, so a problem
with BAL's exact counts of cameras, points and observations is generated
instead.  Cameras stand on a ring around a ball of points, each turned
towards it with its own elevation, distance, roll and a small jitter of the
look direction; consecutive cameras stand a fixed azimuth step apart, so the
ring winds round several times.  Each point's track is a run of consecutive
cameras (a camera shares points with its neighbours, as in BAL's
collections), of a length drawn from a power law on [2, max] whose
exponent gives BAL's mean track length, observations / points; the lengths
are then trimmed so that they add up to the published count exactly.  The
observations are the projections through one RADIAL3 camera (fx = fy, a
centred principal point, k3 = 0) plus Gaussian pixel noise, and a share of
gross outliers spread uniformly over the frame.  The table is camera-major.

The whole scene (cameras, points, tracks, noise and outliers) is drawn
from the configuration's ``problem_seed``, so that every run of a
configuration solves the same problem, as a BAL file would be; a run's
seed draws every solve's start (``start_state``).  A scene drawn from the
run's seed moved the mean work of a solve by up to 12% from seed to seed
(the conditioning that sets the CG iterations), far more than two runs of
one seed differ.

Every value that BAL does not publish comes from the configuration's
``assumed`` block.  Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..common import STREAM_SCENE, STREAM_START, sub_seed


@dataclasses.dataclass
class Scene:
    """The true state and the observation table of one problem."""
    intr: torch.Tensor      # (C, 7) float32 [fx, fy, cx, cy, k1, k2, k3]
    aa: torch.Tensor        # (C, 3) float32 axis-angle, world to camera
    t: torch.Tensor         # (C, 3) float32
    points: torch.Tensor    # (P, 3) float32
    obs_cam: torch.Tensor   # (O,) int32, camera-major
    obs_pt: torch.Tensor    # (O,) int32, ascending within a camera
    obs_uv: torch.Tensor    # (O, 2) float32
    outlier: torch.Tensor   # (O,) bool: replaced by a uniform draw over the frame
    img_w: float
    img_h: float

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.intr.shape[0], self.points.shape[0], self.obs_cam.shape[0]


def track_law_exponent(mean: float, lmin: int, lmax: int) -> float:
    """The exponent s of P(L = l) ~ l**-s on [lmin, lmax] whose mean is
    `mean` (bisection in float64 on the host; the mean falls as s rises)."""
    ls = np.arange(lmin, lmax + 1, dtype=np.float64)
    if not lmin < mean < lmax:
        raise ValueError(f"no power law on [{lmin}, {lmax}] has mean {mean}")

    def m(s):
        w = ls ** -s
        return float((ls * w).sum() / w.sum())

    lo, hi = -10.0, 20.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if m(mid) > mean else (lo, mid)
    return 0.5 * (lo + hi)


def _track_lengths(P: int, O: int, lmin: int, lmax: int, g: torch.Generator,
                   dev: torch.device) -> torch.Tensor:
    """P track lengths in [lmin, lmax] drawn from the power law with mean
    O / P, then trimmed by one observation at a time, on tracks picked by a
    random permutation, until they add up to O."""
    if not lmin * P <= O <= lmax * P:
        raise ValueError(f"{O} observations cannot make {P} tracks of {lmin}..{lmax}")
    s = track_law_exponent(O / P, lmin, lmax)
    ls = np.arange(lmin, lmax + 1, dtype=np.float64)
    cdf = np.cumsum(ls ** -s)
    cdf = torch.tensor(cdf / cdf[-1], dtype=torch.float64, device=dev)
    u = torch.rand(P, generator=g, device=dev, dtype=torch.float64)
    L = lmin + torch.searchsorted(cdf, u).clamp_(max=lmax - lmin)
    diff = O - int(L.sum())
    while diff != 0:
        step = 1 if diff > 0 else -1
        perm = torch.randperm(P, generator=g, device=dev)
        Lp = L[perm]
        elig = Lp < lmax if step > 0 else Lp > lmin
        take = elig & (torch.cumsum(elig.to(torch.int64), 0) <= abs(diff))
        L[perm[take]] += step
        diff = O - int(L.sum())
    return L


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def rotation_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3), through the
    unit quaternion (Shepperd's choice of the largest diagonal term), valid
    at every angle up to pi."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cand = torch.stack([tr, m00, m11, m22], -1)
    k = torch.argmax(cand, -1)
    q = torch.zeros(R.shape[:-2] + (4,), dtype=R.dtype, device=R.device)
    # Each branch's quaternion (w, x, y, z) up to a positive factor.
    qs = [
        torch.stack([1 + tr, R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1),
        torch.stack([R[..., 2, 1] - R[..., 1, 2], 1 + m00 - m11 - m22,
                     R[..., 0, 1] + R[..., 1, 0], R[..., 0, 2] + R[..., 2, 0]], -1),
        torch.stack([R[..., 0, 2] - R[..., 2, 0], R[..., 0, 1] + R[..., 1, 0],
                     1 - m00 + m11 - m22, R[..., 1, 2] + R[..., 2, 1]], -1),
        torch.stack([R[..., 1, 0] - R[..., 0, 1], R[..., 0, 2] + R[..., 2, 0],
                     R[..., 1, 2] + R[..., 2, 1], 1 - m00 - m11 + m22], -1),
    ]
    for i, qi in enumerate(qs):
        q = torch.where((k == i)[..., None], qi, q)
    q = _unit(q)
    q = torch.where(q[..., :1] < 0, -q, q)
    vn = torch.linalg.norm(q[..., 1:], dim=-1)
    angle = 2 * torch.atan2(vn, q[..., 0])
    scale = torch.where(vn > 1e-12, angle / torch.clamp(vn, min=1e-300),
                        torch.full_like(vn, 2.0))
    return q[..., 1:] * scale[..., None]


def project(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor, intr: torch.Tensor):
    """Camera-frame points and pixels of X through (R, t) and RADIAL3
    intrinsics, all gathered per row already: (z, uv)."""
    Xc = (R * X[:, None, :]).sum(-1) + t
    z = Xc[:, 2]
    xn = Xc[:, :2] / z[:, None]
    r2 = (xn * xn).sum(-1, keepdim=True)
    k1, k2, k3 = intr[:, 4:5], intr[:, 5:6], intr[:, 6:7]
    xd = xn * (1 + r2 * (k1 + r2 * (k2 + r2 * k3)))
    return z, xd * intr[:, 0:2] + intr[:, 2:4]


def generate(config: dict, device) -> Scene:
    """The problem of `config` (its ``problem`` counts, ``assumed`` geometry
    and ``problem_seed``), made on `device`: the same configuration and
    device give the same bits."""
    dev = torch.device(device)
    pb, a = config["problem"], config["assumed"]
    C, P, O = int(pb["cameras"]), int(pb["points"]), int(pb["observations"])
    g = torch.Generator(device=dev).manual_seed(sub_seed(a["problem_seed"], STREAM_SCENE))
    f64 = dict(dtype=torch.float64, device=dev)

    # Track lengths and starts; a track is a run of consecutive cameras.
    lmax = min(int(a["track_max"]), C)
    L = _track_lengths(P, O, int(a["track_min"]), lmax, g, dev)
    first = torch.randint(0, C, (P,), generator=g, device=dev)
    pt = torch.repeat_interleave(torch.arange(P, device=dev), L)
    offs = torch.cumsum(L, 0) - L
    cam = (first[pt] + torch.arange(O, device=dev) - offs[pt]) % C

    # Cameras on the ring, each facing the ball of points.
    i = torch.arange(C, **f64)
    az = torch.deg2rad(i * a["azimuth_step_deg"])
    el = torch.deg2rad(a["elevation_mean_deg"] + a["elevation_amp_deg"]
                       * torch.sin(2 * math.pi * i / a["elevation_period_cams"]))
    dist = a["ring_radius"] * (1 + a["radius_jitter"]
                               * (2 * torch.rand(C, generator=g, **f64) - 1))
    centers = dist[:, None] * torch.stack([torch.cos(el) * torch.sin(az), -torch.sin(el),
                                           -torch.cos(el) * torch.cos(az)], 1)
    look = torch.randn(C, 3, generator=g, **f64) * math.radians(a["look_jitter_deg"])
    z = _unit(-centers / dist[:, None] + look)
    up = torch.tensor([0.0, 1.0, 0.0], **f64).expand(C, 3)
    x = _unit(torch.linalg.cross(up, z))
    y = torch.linalg.cross(z, x)
    roll = torch.deg2rad((2 * torch.rand(C, generator=g, **f64) - 1) * a["roll_max_deg"])
    cr, sr = torch.cos(roll)[:, None], torch.sin(roll)[:, None]
    x, y = cr * x + sr * y, cr * y - sr * x
    R = torch.stack([x, y, z], 1)
    t = -(R * centers[:, None, :]).sum(-1)

    # Points uniform in a ball.
    r = a["cloud_radius"] * torch.rand(P, generator=g, **f64) ** (1.0 / 3.0)
    X = _unit(torch.randn(P, 3, generator=g, **f64)) * r[:, None]

    w, h = float(a["image_width"]), float(a["image_height"])
    f = float(a["focal_px"])
    intr1 = torch.tensor([f, f, w / 2, h / 2, a["k1"], a["k2"], 0.0], **f64)
    intr = intr1.expand(C, 7)

    # Camera-major table: one stable sort of (camera, point).
    order = torch.sort(cam * P + pt, stable=True).indices
    cam, pt = cam[order], pt[order]
    zc, uv = project(R[cam], t[cam], X[pt], intr[cam])
    inside = ((zc > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0)
              & (uv[:, 1] < h))
    if not bool(inside.all()):
        raise ValueError(f"{int((~inside).sum())} observations fall behind a camera or out of "
                         "frame: the assumed geometry does not fit the image")
    uv = uv + a["noise_px"] * torch.randn(O, 2, generator=g, **f64)
    outlier = torch.rand(O, generator=g, **f64) < a["outlier_share"]
    wild = torch.rand(O, 2, generator=g, **f64) * torch.tensor([w, h], **f64)
    uv = torch.where(outlier[:, None], wild, uv)
    return Scene(intr=intr.to(torch.float32).contiguous(),
                 aa=rotation_to_axis_angle(R).to(torch.float32),
                 t=t.to(torch.float32), points=X.to(torch.float32),
                 obs_cam=cam.to(torch.int32), obs_pt=pt.to(torch.int32),
                 obs_uv=uv.to(torch.float32), outlier=outlier, img_w=w, img_h=h)


def start_state(scene: Scene, traffic: dict, seed: int, k: int) -> dict:
    """Solve k's start, drawn from (seed, k): poses and points of the true
    state perturbed by the traffic's scales and, where the traffic refines
    intrinsics, the focal scaled by a factor drawn from its range and the
    distortion set to its start.  Returns the float32 (C, 7) intrinsics,
    (C, 3) rotations and translations and (P, 3) points."""
    st = traffic["start"]
    dev = scene.points.device
    g = torch.Generator(device=dev).manual_seed(sub_seed(seed, STREAM_START, k))
    C, P, _ = scene.shape
    f32 = dict(dtype=torch.float32, device=dev)
    rot = scene.aa + st["pose_sigma"] * torch.randn(C, 3, generator=g, **f32)
    t = scene.t + st["pose_sigma"] * torch.randn(C, 3, generator=g, **f32)
    pts = scene.points + st["point_sigma"] * torch.randn(P, 3, generator=g, **f32)
    intr = scene.intr.clone()
    if "focal_factor" in st:
        lo, hi = st["focal_factor"]
        phi = lo + (hi - lo) * torch.rand((), generator=g, **f32)
        intr[:, 0:2] = intr[:, 0:2] * phi
    if "distortion" in st:
        intr[:, 4:7] = torch.tensor(st["distortion"], **f32)
    return {"intr": intr, "cam_rot": rot, "cam_t": t, "points": pts}
