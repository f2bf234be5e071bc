"""Device-time breakdown of a warm run of the medium rung on one card.

    python -m tpusfm_torch.tools.profile_rung --views 200 [--self-calibrate]
        [--repeats N] [--no-profile]

Runs ``run_sparse`` on the medium rung (bench.py:352-421, cut to
``--views``) once to warm up, ``--repeats`` times plain for the wall time,
and once under ``torch.profiler``.  ``--self-calibrate`` refines one
intrinsic group shared by every view from the true focal
(``chip_smoke.py``'s path A).  Prints the plain and profiled wall seconds,
the device kernel time and launch count of the profiled run, the busy
share (device time over the fastest plain wall time) and the kernels with
the most device time.  With ``--out`` the full table is also written to
that file.  ``--no-profile`` prints the plain wall times only: the
profiler's bookkeeping of a self-calibrating run's million launches takes
minutes.
"""

from __future__ import annotations

import argparse
import json
import time


def _device_kernels(prof):
    """(name, launches, device microseconds) of every device kernel."""
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, int(e.count), float(us)))
    return sorted(rows, key=lambda r: -r[2])


def main(argv=None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..pipeline.sparse import run_sparse
    from .front_end_counts import rung_inputs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=200)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=None)
    ap.add_argument("--self-calibrate", action="store_true")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_rung: no CUDA device visible to torch")
    images, gt, cfg = rung_inputs(args.views)
    intr, kw = gt["intr"], {}
    if args.self_calibrate:
        intr = np.tile(np.asarray(gt["intr"], np.float32), (images.shape[0], 1))
        kw["cam_group"] = np.zeros(images.shape[0], np.int32)

    def run(seed):
        torch.cuda.synchronize()
        t0 = time.time()
        run_sparse(images, intr, cfg, device="cuda", seed=seed, **kw)
        torch.cuda.synchronize()
        return time.time() - t0

    run(0)
    walls = [run(1) for _ in range(args.repeats)]
    wall = min(walls)
    if args.no_profile:
        print(json.dumps({"views": args.views, "self_calibrate": args.self_calibrate,
                          "wall_s": walls}))
        return 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = run(1)
    rows = _device_kernels(prof)
    dev_ms = sum(r[2] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    print(json.dumps({"views": args.views, "self_calibrate": args.self_calibrate,
                      "wall_s": round(wall, 3), "wall_profiled_s": round(wall_prof, 3), "device_ms": round(dev_ms, 1),
                      "launches": launches, "busy_share": round(dev_ms / 1e3 / wall, 4)}))
    table = [f"{us / 1e3:10.2f} ms {n:8d} x {us / max(n, 1):9.1f} us  {name}"
             for name, n, us in rows]
    print("\n".join(table[: args.top]))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(table) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
