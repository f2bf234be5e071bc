"""The reference's K5 (`schur_fwd_t`) sums only the first six rows of W
(tpusfm/ops/obs_table.py:1811-1815), and what that does to its
self-calibrating solve, on the CPU.

1. Lanes: schur_fwd_t(..., interpret=True) on a 300-row table with dense
   ranks against numpy, for D = 6, 7, 9: the max abs error against the sum
   over all D rows and against the sum over the first six only.
2. Solves: tests/test_camera_models.py's 12-camera Brown-T2 problem (2,400
   observations), one group, started from zero distortion: the
   reference's kernel path (pallas_interpret=True) against its plain path
   (impl="xla"), refining all nine lanes, and with intrinsics held; and the
   PyTorch port's kernel path (its K5 sums every row; CPU twins).  Prints
   final costs, iterations and the recovered lens.

Usage: JAX_PLATFORMS=cpu python scripts/k5_lane_fault.py   (a few minutes)
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))


def lanes():
    import jax.numpy as jnp
    import numpy as np

    from tpusfm.ops import obs_table as ot

    r = np.random.default_rng(0)
    O, C = 300, 12
    ranks = np.sort(r.integers(0, 80, O))
    ranks = np.unique(ranks, return_inverse=True)[1].astype(np.int32)
    p = int(ranks.max()) + 1
    cam = r.integers(0, C, O).astype(np.int32)
    for d in (6, 7, 9):
        wT = r.normal(size=(3 * d, O)).astype(np.float32)
        v = r.normal(size=(C, d)).astype(np.float32)
        got = np.asarray(ot.schur_fwd_t(jnp.asarray(wT), jnp.asarray(cam), jnp.asarray(ranks),
                                        jnp.asarray(v), p, interpret=True), np.float64)
        W = wT.astype(np.float64).reshape(d, 3, O)
        per = np.einsum("dko,od->dok", W, v[cam].astype(np.float64))  # (d, O, 3)
        full, six = np.zeros((p, 3)), np.zeros((p, 3))
        np.add.at(full, ranks, per.sum(0))
        np.add.at(six, ranks, per[:6].sum(0))
        print(f"D={d}: max abs err vs all {d} rows {np.abs(got - full).max():.3g}, "
              f"vs the first 6 rows {np.abs(got - six).max():.3g}", flush=True)


def solves():
    import jax.numpy as jnp
    import numpy as np
    import torch

    from test_camera_models import _brown_ba_problem
    from tpusfm.ba import bundle_adjust as jba
    from tpusfm_torch.ba import bundle_adjust as tba

    d = _brown_ba_problem()
    C, P, rng = d["C"], d["P"], d["rng"]
    intr0 = d["intr_gt"].copy()
    intr0[4:9] = 0.0
    args = dict(intr=np.tile(intr0, (C, 1)),
                cam_rot=(d["aa"] + rng.normal(scale=0.005, size=(C, 3))).astype(np.float32),
                cam_t=d["t"], cam_mask=np.ones(C, bool),
                points=(d["pts"] + rng.normal(scale=0.02, size=(P, 3))).astype(np.float32),
                point_mask=np.ones(P, bool), obs_cam=d["ocam"].astype(np.int32),
                obs_pt=d["opt"].astype(np.int32), obs_uv=d["uv"],
                obs_mask=np.ones(len(d["ocam"]), bool), cam_group=np.zeros(C, np.int32))
    print(f"problem: {C} cameras, {P} points, {len(d['ocam'])} observations; lens "
          f"{d['intr_gt'][4:].tolist()}", flush=True)
    for refine in (True, False):
        common = dict(max_iters=30, cg_iters=60, refine_intrinsics=refine, camera_model="brown")
        for label, cfg in (("reference kernel path (interpret)",
                            jba.BAConfig(impl="pallas", pallas_interpret=True, **common)),
                           ("reference plain path", jba.BAConfig(impl="xla", **common))):
            out = jba.bundle_adjust(cfg=cfg, n_groups=1, **{k: jnp.asarray(v)
                                                            for k, v in args.items()})
            g = np.asarray(out[0])[0]
            print(f"refine={refine} {label}: cost {float(out[4]['initial_cost']):.6g} -> "
                  f"{float(out[4]['final_cost']):.6g} in {int(out[4]['iterations'])} "
                  f"iterations; lens {np.round(g[4:], 4).tolist()}", flush=True)
        out = tba.bundle_adjust(cfg=tba.BAConfig(impl="pallas", **common), n_groups=1,
                                **{k: torch.as_tensor(v) for k, v in args.items()})
        g = out[0].numpy()[0]
        print(f"refine={refine} port kernel path (CPU twins): cost "
              f"{float(out[4]['initial_cost']):.6g} -> {float(out[4]['final_cost']):.6g} in "
              f"{out[4]['iterations']} iterations; lens {np.round(g[4:], 4).tolist()}",
              flush=True)


if __name__ == "__main__":
    lanes()
    solves()
