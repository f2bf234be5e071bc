"""Tests of the port that need an NVIDIA card (marker `cuda`); they skip
where torch sees no CUDA device.  This file imports neither jax nor the
reference package, so it also runs on a machine that has only the port:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from tpusfm_torch.ba import bundle_adjust as tba
from tpusfm_torch.ops import topk2_match
from tpusfm_torch.pipeline.config import config_from_overrides
from tpusfm_torch.pipeline.sparse import run_sparse
from tpusfm_torch.utils import metrics
from tpusfm_torch.utils.synth_render import render_orbit_images

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; none is visible to torch")
    return torch.device("cuda")


def _u8(shape, gen, dev):
    return torch.floor(torch.rand(shape, generator=gen, device=dev) * 256.0).clamp(max=255.0)


@pytest.mark.parametrize("P,na,nb,mask_frac", [(4, 1024, 1024, 0.1), (3, 130, 200, 0.1),
                                               (2, 65, 1, 0.0), (2, 130, 200, 1.1)])
def test_kernel_bit_equal_to_twin(dev, P, na, nb, mask_frac):
    gen = torch.Generator(device=dev).manual_seed(P * 1000 + na)
    da, db = _u8((P, na, 128), gen, dev), _u8((P, nb, 128), gen, dev)
    mb = torch.rand((P, nb), generator=gen, device=dev) >= mask_frac
    before = topk2_match.LAUNCHES
    got = topk2_match.match_topk2(da, db, mb)
    torch.cuda.synchronize()
    assert topk2_match.LAUNCHES == before + 1
    for g, w in zip(got, topk2_match.match_topk2_reference(da, db, mb)):
        assert torch.equal(g, w)


def test_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    da = torch.zeros((2, 8, 64), device=dev)
    with pytest.raises(ValueError):
        topk2_match.match_topk2(da, da, torch.ones((2, 8), dtype=torch.bool, device=dev))
    nc = torch.zeros((8, 2, 128), device=dev).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        topk2_match.match_topk2(nc, nc, torch.ones((2, 8), dtype=torch.bool, device=dev))


def test_run_sparse_on_card(dev):
    images, gt = render_orbit_images(n_views=6, img_h=240, img_w=320, focal=0.9 * 320,
                                     arc_deg=60.0, seed=1)
    cfg = config_from_overrides(**{"sift.n_octaves": 3, "sift.max_per_octave": 512,
                                   "sift.max_features": 768, "matching.pair_chunk": 16,
                                   "filter.max_iterations": 128, "feature_batch": 3})
    topk2_match.LAUNCHES = 0
    scene, report = run_sparse(images, gt["intr"], cfg, device=dev)
    assert topk2_match.LAUNCHES >= 2
    reg = scene.cam_mask.cpu().numpy()
    assert reg.sum() >= 5
    ate = metrics.ate_rmse(scene.camera_centers().cpu().numpy()[reg], gt["centers"][reg])
    assert ate < 0.08 and report["n_points"] > 50


def test_ba_beyond_dense_raises_on_card(dev):
    C, P, O = 70, 64, 256  # 70 cameras: 420 scalars > dense_schur_max_dim
    rng = np.random.default_rng(0)
    t = lambda a, **kw: torch.as_tensor(a, device=dev, **kw)  # noqa: E731
    args = dict(intr=t(np.tile([500, 500, 320, 240, 0, 0, 0], (C, 1)), dtype=torch.float32),
                cam_rot=t(np.zeros((C, 3), np.float32)), cam_t=t(np.zeros((C, 3), np.float32)),
                cam_mask=t(np.ones(C, bool)), points=t(rng.normal(size=(P, 3)).astype(np.float32)),
                point_mask=t(np.ones(P, bool)), obs_cam=t(rng.integers(0, C, O).astype(np.int32)),
                obs_pt=t(rng.integers(0, P, O).astype(np.int32)),
                obs_uv=t(rng.uniform(0, 480, (O, 2)).astype(np.float32)), obs_mask=t(np.ones(O, bool)))
    with pytest.raises(NotImplementedError, match="K2"):
        tba.bundle_adjust(cfg=tba.BAConfig(), **args)
