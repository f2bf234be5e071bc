"""Run one cell of the benchmark of ``tpusfm_torch`` on this machine's GPUs.

    python3 sfmbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints progress and the numbers compared
on standard error and, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number compared
with its limit.  Exits non-zero, printing no result, without enough CUDA
devices, and if JAX or the JAX package was loaded.  The port builds its
kernel library (SASS for sm_90a) into ``tpusfm_torch/_build`` inside the
checkout on the checkout's first run; no other build or kernel cache is
written.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
FORBIDDEN = ("jax", "jaxlib", "flax", "tpusfm")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one cell of the tpusfm_torch benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)  # the harness's modules are imported as the package sfmbench
    sys.path.insert(0, str(ROOT))

    import torch

    from sfmbench.common import read_json
    from sfmbench.harness import run_cell

    torch.set_num_threads(2)
    chips = next((int(w["chips"]) for w in read_json(ROOT / "BENCHMARK.json")["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result, diag = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    emit(result, diag)
    return 0


def emit(result: dict, diag: dict) -> None:
    """Diagnostics, then each number compared beside its limit, on standard
    error; the result as the last line of standard output."""
    lat = diag["latencies"]
    print(f"window: {len(lat)} solves, latency s min {min(lat):.4f} median "
          f"{sorted(lat)[len(lat) // 2]:.4f} max {max(lat):.4f}; iterations "
          f"{sorted(set(diag['iterations']))}", file=sys.stderr)
    print("setup s: " + ", ".join(f"{k} {v:.3f}" for k, v in diag["setup_parts"].items()),
          file=sys.stderr)
    for name, top in diag["tails"].items():
        print(f"largest {name}: {top}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
