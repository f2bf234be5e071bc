"""Loop-closure retrieval and the preemptive prefilter: the port against the
JAX reference on the CPU.

- ``retrieval_pairs`` must give the reference's pair list exactly: on the
  synthetic revisit features of tests/test_loop_closure.py, on the SIFT
  features of rendered views and on descriptors built so that whole groups
  of views tie exactly (jax.lax.top_k keeps the lower index on ties; the
  port's stable sort must too).
- ``generate_pairs`` with loop closure on and off equals the reference's.
- ``preemptive_filter_pairs`` keeps the same pairs as the reference on the
  8-view scene of tests/test_preemptive.py, and ``match_pairs`` with the
  prefilter gives the same rows (exact: descriptors on the u8 grid make
  every distance an exact integer in both packages).
- ``run_sparse(device="cpu")`` on the 6-view scene of test_torch_pipeline.py
  with loop closure (window 1) and with the prefilter: the same pair list
  as the reference's run, pair_ok agreeing on at least 90% of the pairs
  (RANSAC draws differ), the same number of registered views and ATE
  under 0.08 on both.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusfm.features import sift as jsift
from tpusfm.matching import pairs as jpairs
from tpusfm.pipeline import config as jconfig
from tpusfm.pipeline import sparse as jsparse
from tpusfm.utils import metrics as jmetrics
from tpusfm.utils import synth_render as jrender
from tpusfm_torch import convert
from tpusfm_torch.matching import pairs as tpairs
from tpusfm_torch.pipeline import config as tconfig
from tpusfm_torch.pipeline import sparse as tsparse
from tpusfm_torch.utils import metrics as tmetrics

torch.set_num_threads(2)


def _revisit_features(V=24, N=64, D=128, period=8, seed=0):
    """tests/test_loop_closure.py:18-31: view i and i + period share a
    cluster centre."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(period, D)).astype(np.float32)
    desc = np.zeros((V, N, D), np.float32)
    for v in range(V):
        desc[v] = centers[v % period] + 0.05 * rng.normal(size=(N, D))
    return desc, np.ones((V, N), bool)


def _both(desc, mask, **kw):
    want = jpairs.retrieval_pairs(jnp.asarray(desc), jnp.asarray(mask), **kw)
    got = tpairs.retrieval_pairs(torch.as_tensor(desc), torch.as_tensor(mask), **kw)
    assert got.dtype == np.int32 and got.shape[1] == 2
    return want, got


@pytest.mark.parametrize("exclude,top_k,min_sim", [(4, 2, 0.5), (4, 2, 1.01), (2, 3, 0.0),
                                                   (8, 5, 0.5), (1, 23, -2.0)])
def test_retrieval_pairs_equal_reference_on_revisits(exclude, top_k, min_sim):
    desc, mask = _revisit_features()
    mask[3, 40:] = False  # a partly masked view
    want, got = _both(desc, mask, exclude=exclude, top_k=top_k, min_sim=min_sim)
    np.testing.assert_array_equal(got, want)
    if min_sim > 1.0:
        assert len(got) == 0  # the min-sim gate
    else:
        assert len(got) > 0


def test_retrieval_pairs_exact_ties_keep_the_lower_index():
    """Views 0, 2, 4, ... carry one descriptor set and 1, 3, 5, ... another,
    bit for bit, so each query's candidates tie exactly; both packages must
    keep the lowest view indices among the tied."""
    rng = np.random.default_rng(3)
    sets = rng.normal(size=(2, 16, 128)).astype(np.float32)
    desc = np.stack([sets[v % 2] for v in range(12)])
    mask = np.ones((12, 16), bool)
    for top_k in (1, 2, 3):
        want, got = _both(desc, mask, exclude=1, top_k=top_k, min_sim=0.5)
        np.testing.assert_array_equal(got, want)
    # Each query's top 3 are the three lowest views of its tied set.
    _, jidx = jpairs._retrieval_topk(jnp.asarray(desc), jnp.asarray(mask), top_k=3, exclude=1,
                                     pool_k=16)
    _, tidx = tpairs._retrieval_topk(torch.as_tensor(desc), torch.as_tensor(mask), 3, 1, 16)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tidx[0].tolist() == [2, 4, 6] and tidx[6].tolist() == [0, 2, 4]


@pytest.fixture(scope="module")
def sift_views():
    """SIFT features of 16 rendered views of a 240-degree orbit (the
    reference's, fed to both packages)."""
    images, _ = jrender.render_orbit_images(n_views=16, img_h=120, img_w=160, focal=0.9 * 160,
                                            arc_deg=240.0, seed=5)
    cfg = jsift.SiftConfig(n_octaves=2, max_per_octave=256, max_features=256)
    f = jsift.detect_and_describe(jnp.asarray(images), cfg)
    return np.asarray(f.desc), np.asarray(f.mask)


@pytest.mark.parametrize("top_k,min_sim", [(3, 0.5), (5, 0.9)])
def test_retrieval_pairs_equal_reference_on_sift(sift_views, top_k, min_sim):
    desc, mask = sift_views
    want, got = _both(desc, mask, exclude=2, top_k=top_k, min_sim=min_sim)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("loop", [True, False])
def test_generate_pairs_equal_reference(loop):
    desc, mask = _revisit_features()
    ov = {"matching.pair_mode": "contiguous", "matching.contiguous_window": 2,
          "matching.loop_closure": loop, "matching.loop_top_k": 2, "matching.loop_min_sim": 0.5}
    want = jsparse.generate_pairs(24, jconfig.config_from_overrides(**ov),
                                  feats=types.SimpleNamespace(desc=jnp.asarray(desc),
                                                              mask=jnp.asarray(mask)))
    got = tsparse.generate_pairs(24, tconfig.config_from_overrides(**ov),
                                 feats=types.SimpleNamespace(desc=torch.as_tensor(desc),
                                                             mask=torch.as_tensor(mask)))
    np.testing.assert_array_equal(got, want)
    gaps = got[:, 1] - got[:, 0]
    assert (gaps <= 2).sum() == 23 + 22
    assert ((gaps >= 8).sum() > 0) == loop


PRE_BASE = {"sift.n_octaves": 3, "sift.max_features": 512, "sift.max_per_octave": 256,
            "matching.pair_chunk": 8}


@pytest.fixture(scope="module")
def preemptive_scene():
    """tests/test_preemptive.py:19-41's 8-view scene and the reference's
    features, as the reference's and as the port's objects."""
    images, _ = jrender.render_orbit_images(n_views=8, img_h=240, img_w=320, arc_deg=200.0)
    jcfg = jconfig.config_from_overrides(**PRE_BASE)
    jfeats = jsparse.detect_features(images, jcfg)
    tfeats = convert.features_from_numpy(*(np.asarray(getattr(jfeats, k))
                                           for k in ("kp", "desc", "score", "mask")), "cpu")
    return jfeats, tfeats, jsparse.generate_pairs(8, jcfg)


def test_preemptive_keep_mask_equals_reference(preemptive_scene):
    jfeats, tfeats, pl = preemptive_scene
    ov = {**PRE_BASE, "matching.preemptive": True}
    want = jsparse.preemptive_filter_pairs(jfeats, pl, jconfig.config_from_overrides(**ov))
    got = tsparse.preemptive_filter_pairs(tfeats, pl, tconfig.config_from_overrides(**ov))
    np.testing.assert_array_equal(got, want)
    assert (~got).sum() > 0 and got.sum() > 0


def test_match_pairs_with_preemptive_equals_reference(preemptive_scene):
    jfeats, tfeats, pl = preemptive_scene
    ov = {**PRE_BASE, "matching.preemptive": True}
    jmi, jmv = jsparse.match_pairs(jfeats, pl, jconfig.config_from_overrides(**ov))
    tmi, tmv = tsparse.match_pairs(tfeats, pl, tconfig.config_from_overrides(**ov))
    np.testing.assert_array_equal(tmv, jmv)
    np.testing.assert_array_equal(tmi[tmv], jmi[jmv])
    # Kept rows equal full matching's; dropped rows are all invalid.
    keep = tsparse.preemptive_filter_pairs(tfeats, pl, tconfig.config_from_overrides(**ov))
    fmi, fmv = tsparse.match_pairs(tfeats, pl, tconfig.config_from_overrides(**PRE_BASE))
    np.testing.assert_array_equal(tmv[keep], fmv[keep])
    np.testing.assert_array_equal(tmi[keep], fmi[keep])
    assert not tmv[~keep].any()


SMALL = {"sift.n_octaves": 3, "sift.max_per_octave": 512, "sift.max_features": 768,
         "matching.pair_chunk": 16, "filter.max_iterations": 128, "feature_batch": 3}
RUNS = {"loop_closure": {"matching.pair_mode": "contiguous", "matching.contiguous_window": 1,
                         "matching.loop_closure": True},
        "preemptive": {"matching.preemptive": True}}


@pytest.fixture(scope="module")
def scene6():
    return jrender.render_orbit_images(n_views=6, img_h=240, img_w=320, focal=0.9 * 320,
                                       arc_deg=60.0, seed=1)


@pytest.mark.parametrize("what", list(RUNS))
def test_run_sparse_option_agrees_with_reference(scene6, what):
    images, gt = scene6
    ov = {**SMALL, **RUNS[what]}
    jscene, jrep = jsparse.run_sparse(images, gt["intr"], jconfig.config_from_overrides(**ov),
                                      key=jax.random.PRNGKey(0))
    tscene, trep = tsparse.run_sparse(images, gt["intr"], tconfig.config_from_overrides(**ov),
                                      device="cpu")
    # The reference's report has no pair list or pair_ok: its own stages on
    # its features give them (pair_ok statistically: RANSAC draws differ).
    jcfg = jconfig.config_from_overrides(**ov)
    jfeats = jsparse.detect_features(images, jcfg)
    jpl = jsparse.generate_pairs(6, jcfg, feats=jfeats)
    np.testing.assert_array_equal(trep["pair_list"], jpl)
    if what == "loop_closure":
        assert ((jpl[:, 1] - jpl[:, 0]) > 2).any()  # retrieval proposed loop pairs
    mi, mv = jsparse.match_pairs(jfeats, jpl, jcfg)
    _, _, jok = jsparse.filter_pairs(jfeats, jpl, mi, mv, jcfg, intr=np.tile(gt["intr"], (6, 1)),
                                     img_hw=images.shape[1:3])
    assert np.mean(jok == trep["pair_ok"]) >= 0.9, (jok, trep["pair_ok"])
    jreg = np.asarray(jscene.cam_mask)
    treg = tscene.cam_mask.numpy()
    assert jreg.sum() == treg.sum() >= 5
    jate = jmetrics.ate_rmse(np.asarray(jscene.camera_centers())[jreg], gt["centers"][jreg])
    tate = tmetrics.ate_rmse(tscene.camera_centers().numpy()[treg], gt["centers"][treg])
    assert jate < 0.08 and tate < 0.08, (jate, tate)
