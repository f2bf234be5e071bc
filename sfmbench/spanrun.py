"""One traced run of a cell, as ``run.py --trace 1`` makes it, with the
spans that the harness read from its trace (``spansum``) laid out whole.

    python3 -m sfmbench.spanrun --workload <name> --seed <n> --seconds <s> [--out f.json]

Run from the root of a checkout, on a machine with the cell's CUDA devices
(``--device cpu`` runs a CPU cell of the harness's tests).  Prints one JSON
object as the last line: ``result`` (the line ``run.py`` prints), ``spans``
(``spansum.SpanSum`` by span name), ``per_layer`` (``spansum.per_layer``),
``idle_gaps`` (the ten largest idle gaps by span and host op),
``idle_outside_s``, and ``agree``, the two readings that the spans and the
harness's own trace sums must share: CG products per traced solve, and the
window's idle seconds.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def run(root: Path, workload: str, seed: int, seconds: float, device: str,
        t_start: float) -> dict:
    from sfmbench import spansum, tracesum
    from sfmbench.harness import run_cell

    # The harness hands back only the result; keep the summary it read it from.
    got = {}
    plain = tracesum.summarize

    def keep(prof):
        got["trace"] = plain(prof)
        return got["trace"]

    tracesum.summarize = keep
    try:
        result, _ = run_cell(root, workload, seed, seconds, True, device, t_start)
    finally:
        tracesum.summarize = plain
    ts = got["trace"]
    solves = ts.spans.get(spansum.SOLVE)
    mv = ts.spans.get(spansum.PCG_MATVEC)
    dev = result["device"]
    return {
        "result": result,
        "spans": {k: dataclasses.asdict(v) for k, v in ts.spans.items()},
        "per_layer": spansum.per_layer(ts.spans),
        "idle_gaps": sorted(ts.gaps.items(), key=lambda kv: -kv[1])[:10],
        "idle_outside_s": ts.idle_outside_s,
        "agree": {
            "matvecs_per_solve": [mv.n / solves.n if mv and solves else None,
                                  result["metrics"].get("cg_matvecs_per_solve", {}).get("value")],
            "idle_s": [sum(v.idle_s for v in ts.spans.values()) + ts.idle_outside_s,
                       dev["window_s"] - dev["busy_s"] if "busy_s" in dev else None],
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one traced run of a cell, reduced by spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(2)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("spanrun: no CUDA device", file=sys.stderr)
        return 3
    out = run(Path.cwd(), args.workload, args.seed, args.seconds, args.device, T_START)
    line = json.dumps(out)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
