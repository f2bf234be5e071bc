"""The harness's trace reader as it was before it read the program's
spans, kept as the witness that the reader built on ``spansum`` reads
kernels, launches and the device's busy time and window as this one did.
It drops the projection of the ``sfmbench.solve`` record alone, by name,
and labels each idle gap by the innermost host operation at its middle.

A window of a few solves launches some tens of thousands of kernels; its
full timeline would be hundreds of megabytes, so only sums leave this
module: device time and launches by kernel name, the union of the device's
busy intervals, and the idle gaps summed by what the host was doing
(the innermost host operation open at the gap's middle).  The window is the
span from the first traced solve's start to the last one's end, both in the
profiler's own clock; each solve ends with a device synchronisation.
"""

from __future__ import annotations

import dataclasses
import re

SOLVE_SPAN = "sfmbench.solve"
COPIES = ("Memcpy", "Memset")
NO_OP = "python between host operations"


@dataclasses.dataclass
class TraceSummary:
    kernels: dict           # short name -> [launches, device seconds]
    launches: int           # kernel launches (copies and fills not counted)
    busy_s: float           # union of device activity inside the window
    window_s: float
    gaps: dict              # host operation -> idle seconds


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list (its
    template arguments stay)."""
    name = name.replace("(anonymous namespace)", "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return re.sub(r"^(void|__global__)\s+", "", name.strip()) or "(unnamed)"


def _events(prof):
    """(on the device, name, start_ns, end_ns, thread) of every event, from
    the kineto results where this torch exposes them."""
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is not None:
        for e in res.events():
            yield ("CUDA" in str(e.device_type()), e.name(), e.start_ns(), e.end_ns(),
                   e.start_thread_id())
        return
    for e in prof.events():  # FunctionEvents, microseconds
        yield ("CUDA" in str(e.device_type), e.name, int(e.time_range.start * 1e3),
               int(e.time_range.end * 1e3), e.thread)


def summarize(prof) -> TraceSummary:
    device, host, spans = [], [], []
    for dev, name, s, e, th in _events(prof):
        if dev:
            if name != SOLVE_SPAN:  # the span's own projection on the device timeline
                device.append((s, e, not name.startswith(COPIES), name))
        elif name == SOLVE_SPAN:
            spans.append((s, e, th))
        else:
            host.append((s, e, name, th))
    if not spans:
        raise RuntimeError(f"the trace holds no {SOLVE_SPAN!r} span")
    w0, w1 = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
    main = spans[0][2]

    kernels: dict = {}
    launches = 0
    for s, e, is_kernel, name in device:
        if not is_kernel:
            continue
        k = kernels.setdefault(short_name(name), [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
        launches += 1

    # Union of device intervals clipped to the window, and the gaps between.
    busy = 0
    gaps = []
    cur = w0
    for s, e, _, _ in sorted(device):
        s, e = max(s, w0), min(e, w1)
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        busy += e - cur
        cur = e
    if cur < w1:
        gaps.append((cur, w1))

    # Each gap named by the innermost host operation open at its middle.
    ops = sorted((s, e, name) for s, e, name, th in host if th == main)
    named: dict = {}
    stack: list = []
    i = 0
    for a, b in sorted(gaps):
        m = (a + b) // 2
        while i < len(ops) and ops[i][0] <= m:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        label = stack[-1][2] if stack else NO_OP
        named[label] = named.get(label, 0.0) + (b - a) * 1e-9
    return TraceSummary(kernels=kernels, launches=launches, busy_s=busy * 1e-9,
                        window_s=(w1 - w0) * 1e-9, gaps=named)


def breakdown(ts: TraceSummary, top: int = 10, width: int = 120) -> dict:
    """The ten kernels with the most device time and the ten host
    operations under which the device sat idle longest (names cut to
    `width` characters)."""
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
