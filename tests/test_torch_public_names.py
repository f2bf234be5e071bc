"""Public names of ported modules against the JAX reference on the CPU:
the Scene capacities and counts, Features.n_valid, obs_table.sort_and_rank,
metrics.rotation_error_deg and the reference form of
ops.image.bilinear_sample_level_ch, on inputs made from a seed."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpusfm.features import sift as jsift
from tpusfm.ops import image as jimage
from tpusfm.ops import obs_table as jot
from tpusfm.sfm import scene as jscene
from tpusfm.utils import metrics as jmetrics
from tpusfm_torch.core import lie as tlie
from tpusfm_torch.features import sift as tsift
from tpusfm_torch.ops import image as timage
from tpusfm_torch.ops import obs_table as tot
from tpusfm_torch.sfm import scene as tscene
from tpusfm_torch.utils import metrics as tmetrics

torch.set_num_threads(2)


def _scene_arrays(seed, C=7, P=40, O=90):
    rng = np.random.default_rng(seed)
    return {
        "intr": rng.normal(size=(C, 7)).astype(np.float32),
        "cam_rot": rng.normal(scale=0.3, size=(C, 3)).astype(np.float32),
        "cam_t": rng.normal(size=(C, 3)).astype(np.float32),
        "cam_mask": rng.random(C) > 0.3,
        "points": rng.normal(size=(P, 3)).astype(np.float32),
        "colors": rng.integers(0, 256, (P, 3), dtype=np.uint8),
        "point_mask": rng.random(P) > 0.4,
        "obs_cam": rng.integers(0, C, O).astype(np.int32),
        "obs_pt": rng.integers(0, P, O).astype(np.int32),
        "obs_uv": rng.normal(size=(O, 2)).astype(np.float32),
        "obs_mask": rng.random(O) > 0.5,
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_scene_capacities_and_counts(seed):
    arrays = _scene_arrays(seed)
    ref = jscene.Scene(**{k: jnp.asarray(v) for k, v in arrays.items()})
    port = tscene.scene_from_numpy(arrays, "cpu")
    for name in ("max_cams", "max_points", "max_obs"):
        got = getattr(port, name)
        assert isinstance(got, int) and got == getattr(ref, name), name
    for name in ("n_cams", "n_points", "n_obs"):
        got = getattr(port, name)
        assert isinstance(got, torch.Tensor) and got.dim() == 0, name
        assert int(got) == int(getattr(ref, name)), name


def test_features_n_valid():
    rng = np.random.default_rng(2)
    V, N = 5, 64
    f = dict(kp=rng.normal(size=(V, N, 4)).astype(np.float32),
             desc=rng.normal(size=(V, N, 128)).astype(np.float32),
             score=rng.random((V, N)).astype(np.float32), mask=rng.random((V, N)) > 0.35)
    ref = jsift.Features(**{k: jnp.asarray(v) for k, v in f.items()})
    port = tsift.Features(**{k: torch.as_tensor(v) for k, v in f.items()})
    np.testing.assert_array_equal(port.n_valid.numpy(), np.asarray(ref.n_valid))
    assert port.n_valid.shape == (V,)


@pytest.mark.parametrize("O,S,seed,p_valid", [(500, 64, 5, 0.8), (1000, 37, 6, 0.9),
                                              (64, 200, 7, 0.5)])
def test_sort_and_rank_matches_reference(O, S, seed, p_valid):
    """Exact order and ranks; the first case is tests/test_obs_table.py's."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, S, O).astype(np.int32)
    valid = rng.random(O) < p_valid
    want = jot.sort_and_rank(jnp.asarray(seg), jnp.asarray(valid), S)
    got = tot.sort_and_rank(torch.as_tensor(seg), torch.as_tensor(valid), S)
    for name, w, g in zip(("order", "ranks", "rank_to_seg", "rank_valid"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # The payload form sorts and ranks the same way.
    (pay,), seg_s, ranks, r2s, rv = tot.sort_and_rank_payload(
        torch.as_tensor(seg), torch.as_tensor(valid), S, (torch.arange(O),))
    np.testing.assert_array_equal(pay.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(seg_s.numpy(), seg[np.asarray(want[0])])
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(want[1]))


def test_rotation_error_deg_matches_reference():
    rng = np.random.default_rng(3)
    aa = rng.normal(scale=0.8, size=(12, 3)).astype(np.float32)
    R_gt = tlie.so3_exp(torch.as_tensor(aa)).double().numpy()
    noise = rng.normal(scale=0.02, size=(12, 3)).astype(np.float32)
    R_est = tlie.so3_exp(torch.as_tensor(aa + noise)).double().numpy()
    G = tlie.so3_exp(torch.as_tensor([0.3, -0.2, 0.5])).double().numpy()
    R_est = R_est @ G  # a global gauge rotation changes nothing
    got = tmetrics.rotation_error_deg(R_est, R_gt)
    np.testing.assert_array_equal(got, jmetrics.rotation_error_deg(R_est, R_gt))
    assert got[0] == 0.0 and 0.1 < got.max() < 10.0


@pytest.mark.parametrize("lims", [None, (9, 13), "tensor"])
def test_bilinear_sample_level_ch_reference_form(lims):
    rng = np.random.default_rng(4)
    L, H, W, C = 3, 12, 17, 2
    vol = rng.normal(size=(L, H, W, C)).astype(np.float32)
    lvl = rng.integers(0, L, (5, 6))
    y = rng.uniform(-2, H + 2, (5, 6)).astype(np.float32)
    x = rng.uniform(-2, W + 2, (5, 6)).astype(np.float32)
    if lims is None:
        kw_j = kw_t = {}
    elif lims == "tensor":
        hl = rng.integers(5, H + 1, (5, 6))
        wl = rng.integers(5, W + 1, (5, 6))
        kw_j = dict(h_lim=jnp.asarray(hl), w_lim=jnp.asarray(wl))
        kw_t = dict(h_lim=torch.as_tensor(hl), w_lim=torch.as_tensor(wl))
    else:
        kw_j = kw_t = dict(h_lim=lims[0], w_lim=lims[1])
    want = jimage.bilinear_sample_level_ch(jnp.asarray(vol), jnp.asarray(lvl), jnp.asarray(y),
                                           jnp.asarray(x), **kw_j)
    got = timage.bilinear_sample_level_ch(torch.as_tensor(vol), torch.as_tensor(lvl),
                                          torch.as_tensor(y), torch.as_tensor(x), **kw_t)
    assert got.shape == (5, 6, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_core_package_imports_its_submodules():
    """`import tpusfm_torch.core` binds the submodules the reference's core
    package imports (tpusfm/core/__init__.py), in a fresh process where
    nothing else imported them."""
    import ast
    import subprocess
    import sys
    from pathlib import Path

    import tpusfm.core as jcore

    # The names the reference's __init__ imports (its module's attributes
    # also hold whatever submodules other tests imported in this process).
    tree = ast.parse(Path(jcore.__file__).read_text())
    names = sorted(a.name for node in tree.body if isinstance(node, ast.ImportFrom)
                   and node.level == 1 and not node.module for a in node.names)
    assert names == ["camera", "epipolar", "homography", "lie", "triangulate"]
    code = ("import sys, types, tpusfm_torch.core as c; "
            f"print(all(isinstance(getattr(c, n, None), types.ModuleType) for n in {names!r}), "
            "'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], timeout=120)
    assert out.stdout.split() == ["True", "False"], out.stderr[-2000:]


@pytest.mark.parametrize("module,name,home", [
    ("pipeline.config", "BAConfig", "ba.bundle_adjust"),
    ("sfm.stellar", "GlobalConfig", "sfm.global_sfm"),
    ("sfm.stellar", "rotation_averaging", "sfm.global_sfm"),
])
def test_reexported_names_match_reference(module, name, home):
    """The names the reference's modules import from a sibling are there
    in the port too, as the same objects; configs have the reference's
    fields and defaults."""
    import dataclasses
    import importlib

    j, t = (importlib.import_module(f"{pkg}.{module}") for pkg in ("tpusfm", "tpusfm_torch"))
    assert getattr(j, name) is getattr(importlib.import_module(f"tpusfm.{home}"), name)
    assert getattr(t, name) is getattr(importlib.import_module(f"tpusfm_torch.{home}"), name)
    if dataclasses.is_dataclass(getattr(j, name)):
        assert dataclasses.asdict(getattr(t, name)()) == dataclasses.asdict(getattr(j, name)())
