"""The generator: exact counts, determinism (the problem from the
configuration, the starts from the seed), the track law, visibility."""

import json

import pytest
import torch

from sfmbench.gen import scene as gen
from sfmbench.tests.cells import REPO


def _config(name="bal-venice-1778", **problem):
    cfg = json.loads((REPO / f"sfmbench/configs/{name}.json").read_text())
    if problem:
        cfg["problem"] = problem
    return cfg


def _check(sc, cfg):
    C, P, O = (cfg["problem"][k] for k in ("cameras", "points", "observations"))
    assert sc.shape == (C, P, O)
    counts = torch.bincount(sc.obs_pt.long(), minlength=P)
    assert int(counts.min()) >= cfg["assumed"]["track_min"]
    assert int(counts.sum()) == O  # the mean track length is O / P exactly
    # Camera-major, points ascending within a camera.
    key = sc.obs_cam.long() * P + sc.obs_pt.long()
    assert bool((key[1:] > key[:-1]).all())
    # Every observation's true projection is in front of its camera and in frame.
    from sfmbench.reference import ba as ref
    R = ref.so3_exp(sc.aa.double())
    c, p = sc.obs_cam.long(), sc.obs_pt.long()
    z, uv = gen.project(R[c], sc.t.double()[c], sc.points.double()[p], sc.intr.double()[c])
    assert bool((z > 0).all())
    frame = torch.tensor([sc.img_w, sc.img_h], dtype=uv.dtype, device=uv.device)
    assert bool(((uv >= 0) & (uv < frame)).all())
    # The noisy pixels sit near it, but for the outliers.
    err = (uv - sc.obs_uv.double()).norm(dim=1)
    assert float(err[~sc.outlier].max()) < 10 * cfg["assumed"]["noise_px"]
    share = float(sc.outlier.double().mean())
    assert abs(share - cfg["assumed"]["outlier_share"]) < 0.01


@pytest.mark.parametrize("C,P,O", [(24, 400, 2012), (40, 900, 6201)])
def test_counts_and_visibility_cpu(C, P, O):
    cfg = _config(cameras=C, points=P, observations=O)
    _check(gen.generate(cfg, "cpu"), cfg)


FIELDS = ("intr", "aa", "t", "points", "obs_cam", "obs_pt", "obs_uv", "outlier")


def test_same_problem_seed_same_bits_other_seed_other_table():
    cfg = _config(cameras=30, points=500, observations=3000)
    a, b = gen.generate(cfg, "cpu"), gen.generate(cfg, "cpu")
    assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)
    cfg["assumed"]["problem_seed"] += 1
    c = gen.generate(cfg, "cpu")
    for f in ("points", "obs_pt", "obs_uv", "outlier"):
        assert not torch.equal(getattr(a, f), getattr(c, f)), f


def test_track_law_mean():
    import numpy as np
    for mean in (5.03, 6.89):
        s = gen.track_law_exponent(mean, 2, 128)
        ls = np.arange(2, 129, dtype=np.float64)
        w = ls ** -s
        assert abs((ls * w).sum() / w.sum() - mean) < 1e-9


def test_start_state_is_drawn_from_the_seed_and_index():
    cfg = _config(cameras=30, points=500, observations=3000)
    sc = gen.generate(cfg, "cpu")
    traffic = json.loads((REPO / "sfmbench/traffic/selfcal.json").read_text())
    a, b = gen.start_state(sc, traffic, 3, 5), gen.start_state(sc, traffic, 3, 5)
    c, d = gen.start_state(sc, traffic, 3, 6), gen.start_state(sc, traffic, 2**31 + 3, 5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["points"], c["points"])
    assert not torch.equal(a["points"], d["points"])
    phi = a["intr"][:, 0] / sc.intr[:, 0]
    assert bool((phi >= 0.98).all() and (phi <= 1.02).all())
    assert bool((a["intr"][:, 4:] == 0).all())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bal-venice-1778", "bal-final-4585"])
def test_full_size_on_the_card(cuda, name):
    cfg = _config(name)
    a = gen.generate(cfg, cuda)
    _check(a, cfg)
    b = gen.generate(cfg, cuda)
    assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)
