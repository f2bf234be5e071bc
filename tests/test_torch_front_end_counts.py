"""`tpusfm_torch.tools.front_end_counts` on the medium rung cut to 8 views,
against the same stages of the JAX reference on the same images: features,
putative and geometric matches, pairs kept and tracks (the reference's own
track builder).  Up to one feature or match may fall on the other side of a
float32 threshold between the two backends, so counts agree to 0.5%."""

import jax
import numpy as np
import pytest
import torch

from tpusfm.pipeline import config as jconfig
from tpusfm.pipeline import sparse as jsparse
from tpusfm.sfm import tracks as jtracks
from tpusfm_torch.tools import front_end_counts as fe

torch.set_num_threads(2)

N_VIEWS = 8


@pytest.fixture(scope="module")
def counts():
    images, gt, cfg = fe.rung_inputs(N_VIEWS)
    port = fe.front_end_counts(images, gt["intr"], cfg, device="cpu")
    rcfg = jconfig.config_from_overrides(**{
        "sift.n_octaves": 3, "sift.max_per_octave": 512, "sift.max_features": 512,
        "matching.pair_mode": "contiguous", "matching.contiguous_window": 6,
        "matching.pair_chunk": 32, "filter.max_iterations": 128,
        "feature_batch": 10, "engine_type": "incremental"})
    intr = np.tile(np.asarray(gt["intr"], np.float32), (N_VIEWS, 1))
    feats = jsparse.detect_features(images, rcfg)
    pairs = jsparse.generate_pairs(N_VIEWS, rcfg, feats=feats)
    mi, mv = jsparse.match_pairs(feats, pairs, rcfg)
    putative = int(np.asarray(mv).sum())
    mi, mv, ok = jsparse.filter_pairs(feats, pairs, mi, mv, rcfg, jax.random.PRNGKey(0),
                                      intr=intr, img_hw=images.shape[1:3])
    ok = np.asarray(ok)
    _, n_tracks = jtracks.build_tracks(N_VIEWS, np.asarray(feats.mask).shape[1], pairs[ok],
                                       np.asarray(mi)[ok], np.asarray(mv)[ok])
    ref = {"features": int(np.asarray(feats.mask).sum()), "pairs": len(pairs),
           "putative": putative, "geometric": int(np.asarray(mv).sum()),
           "pairs_kept": int(ok.sum()), "tracks": int(n_tracks)}
    return port, ref


def test_report_is_consistent(counts):
    port, _ = counts
    assert port["views"] == N_VIEWS
    assert port["features"] > 0 and port["geometric"] <= port["putative"]
    assert port["pairs_kept"] <= port["pairs"]
    assert sum(port["track_len"].values()) == port["tracks"]


@pytest.mark.parametrize("stage", ["features", "pairs", "putative", "geometric",
                                   "pairs_kept", "tracks"])
def test_stage_counts_match_reference(counts, stage):
    port, ref = counts
    assert port[stage] == pytest.approx(ref[stage], rel=5e-3), (stage, port, ref)
