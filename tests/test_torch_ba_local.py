"""The engine's windowed local step-BA on the kernel path (CPU twins of
K2-K4).  `_run_ba_local` hands `bundle_adjust` a compacted table with
`assume_sorted=True`, which skips the per-solve sort: the table must then
be point-sorted and densely relabelled, or K2-K4 would leave rows out of
the per-point sums.  The engine runs with `ba_local_from_obs` lowered to 0,
so every step-BA past the window is a local one."""

import dataclasses

import numpy as np
import pytest
import torch

from tpusfm_torch.pipeline import config as tconfig
from tpusfm_torch.pipeline import sparse as tsparse
from tpusfm_torch.sfm import incremental as tinc
from tpusfm_torch.utils import synth_render as trender

torch.set_num_threads(2)

OVERRIDES = {
    "sift.n_octaves": 3,
    "sift.max_per_octave": 512,
    "sift.max_features": 768,
    "matching.pair_chunk": 16,
    "filter.max_iterations": 128,
    "feature_batch": 4,
}


@pytest.fixture(scope="module")
def local_calls():
    """run_sparse on 8 rendered views; returns the local BA calls (their
    keyword arguments and results) and the report."""
    images, gt = trender.render_orbit_images(n_views=8, img_h=240, img_w=320, focal=0.9 * 320,
                                             arc_deg=80.0, seed=1)
    cfg = tconfig.config_from_overrides(**OVERRIDES)
    eng = dataclasses.replace(cfg.engine, ba_local_from_obs=0, ba_local_window=2,
                              register_batch=1, ba_every=1,
                              ba=dataclasses.replace(cfg.engine.ba, impl="pallas"))
    cfg = dataclasses.replace(cfg, engine=eng)
    calls = []
    solve = tinc.ba.bundle_adjust

    def record(**kw):
        out = solve(**kw)
        if kw["cfg"].assume_sorted:
            calls.append((kw, out))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(tinc.ba, "bundle_adjust", record)
    try:
        _, report = tsparse.run_sparse(images, gt["intr"], cfg, device="cpu")
    finally:
        mp.undo()
    return calls, report


def test_local_ba_runs_on_the_kernel_path(local_calls):
    calls, report = local_calls
    assert report["n_registered"] >= 7, report["engine_log"]
    assert len(calls) >= 2, f"{len(calls)} local BA calls; log: {report['engine_log']}"


def test_local_table_is_point_sorted_and_dense(local_calls):
    for kw, _ in local_calls[0]:
        opt = kw["obs_pt"].numpy()
        live = opt[kw["obs_mask"].numpy()]
        assert live.size > 0
        # Padding rows included: the whole table is non-decreasing.
        assert (np.diff(opt) >= 0).all()
        # Every local point id from 0 to the largest is observed.
        np.testing.assert_array_equal(np.unique(live), np.arange(live.max() + 1))
        np.testing.assert_array_equal(np.flatnonzero(kw["point_mask"].numpy()),
                                      np.arange(live.max() + 1))


def test_local_solve_equals_the_sorted_solve(local_calls):
    """The same local problem with the per-solve sort: the sort finds the
    table already in order, so both solves sum the same rows in the same
    order.  The weights are the binary obs mask, which the sorted path
    rebuilds exactly.  1e-5 leaves room for float32 rounding only."""
    for kw, (_, rot, t, pts, info) in local_calls[0]:
        cfg = dataclasses.replace(kw["cfg"], assume_sorted=False)
        _, rot2, t2, pts2, info2 = tinc.ba.bundle_adjust(**dict(kw, cfg=cfg))
        live = kw["point_mask"].numpy()
        np.testing.assert_allclose(rot2.numpy(), rot.numpy(), atol=1e-5)
        np.testing.assert_allclose(t2.numpy(), t.numpy(), atol=1e-5)
        np.testing.assert_allclose(pts2.numpy()[live], pts.numpy()[live], atol=1e-5)
        np.testing.assert_allclose(float(info2["final_cost"]), float(info["final_cost"]),
                                   rtol=1e-5)
