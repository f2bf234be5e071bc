"""The harness's view of a torch.profiler trace of the traced solves: the
sums that ``spansum`` reduces it to (kernels by name, launches, the
device's busy time in the window, idle gaps by span and host op, and the
program's spans), the breakdown the result line carries, and kernel time
by a piece of a kernel's name for the per-layer readers.
"""

from __future__ import annotations

from sfmbench import spansum
from sfmbench.spansum import SOLVE_SPAN

TraceSummary = spansum.SpanSummary


def summarize(prof) -> TraceSummary:
    ts = spansum.summarize(prof)
    if not ts.solves:
        raise RuntimeError(f"the trace holds no {SOLVE_SPAN!r} span")
    return ts


def breakdown(ts: TraceSummary, top: int = 10, width: int = 120) -> dict:
    """The ten kernels with the most device time and the ten labels (span
    and host operation) under which the device sat idle longest (names cut
    to `width` characters)."""
    ops = sorted(ts.kernels.items(), key=lambda kv: -kv[1][1])[:top]
    gaps = sorted(ts.gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:width], v[1]] for n, v in ops],
            "idle_gaps": [[n[:width], s] for n, s in gaps]}


def kernel_calls(ts: TraceSummary, piece: str) -> tuple[int, float]:
    """Launches and device seconds of every kernel whose name holds `piece`."""
    n, sec = 0, 0.0
    for name, (c, s) in ts.kernels.items():
        if piece in name:
            n += c
            sec += s
    return n, sec
