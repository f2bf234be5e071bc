"""Observation weights on the BA kernel path, against the reference's
Pallas path in interpret mode.  Without assume_sorted the path rebuilds
each weight as binary from its sort key (the reference's contract), so a
fractional obs_mask solves exactly as its support (obs_mask > 0) does.
With assume_sorted (point-sorted, densely relabelled table) nothing is
rebuilt and fractional weights are honoured.  Final cost within 1e-3
relative, poses and points within 1e-3."""

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_ba import _FIELDS, _compare, _problem
from tpusfm.ba import bundle_adjust as jba
from tpusfm_torch import convert
from tpusfm_torch.ba import bundle_adjust as tba
from tpusfm_torch.utils.synth_scene import point_sorted

torch.set_num_threads(2)


def _fractional(prob, seed=4):
    r = np.random.default_rng(seed)
    w = np.where(prob["obs_mask"], 1.0, 0.0).astype(np.float32)
    w[(r.random(len(w)) < 0.3) & prob["obs_mask"]] = 0.25
    return dict(prob, obs_mask=w)


def _port(prob, cfg):
    scene = convert.scene_from_numpy(prob, "cpu")
    args = {k: getattr(scene, k) for k in _FIELDS}
    args["obs_mask"] = torch.as_tensor(prob["obs_mask"])  # float weights, not a bool mask
    return tba.bundle_adjust(cfg=cfg, **args)


def _run_both(prob, jcfg, tcfg):
    jout = jba.bundle_adjust(cfg=jcfg, **{k: jnp.asarray(prob[k]) for k in _FIELDS})
    return jout, _port(prob, tcfg)


def test_unsorted_path_makes_weights_binary():
    prob = _fractional(_problem())
    jcfg = jba.BAConfig(max_iters=10, impl="pallas", pallas_interpret=True)
    tcfg = tba.BAConfig(max_iters=10, impl="pallas")
    jout, tout = _run_both(prob, jcfg, tcfg)
    _compare(jout, tout)
    binary = _port(dict(prob, obs_mask=(prob["obs_mask"] > 0).astype(np.float32)), tcfg)
    for a, b in zip(tout[:4], binary[:4]):
        assert torch.equal(a, b)
    assert float(tout[4]["final_cost"]) == float(binary[4]["final_cost"])


def test_assume_sorted_path_honours_fractional_weights():
    prob = _fractional(point_sorted(_problem()))
    jcfg = jba.BAConfig(max_iters=10, impl="pallas", pallas_interpret=True, assume_sorted=True)
    tcfg = tba.BAConfig(max_iters=10, impl="pallas", assume_sorted=True)
    jout, tout = _run_both(prob, jcfg, tcfg)
    _compare(jout, tout)
    binary = _port(dict(prob, obs_mask=(prob["obs_mask"] > 0).astype(np.float32)), tcfg)
    assert abs(float(binary[4]["final_cost"]) - float(tout[4]["final_cost"])) > \
        1e-2 * float(tout[4]["final_cost"])
