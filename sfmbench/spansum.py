"""Reduce a torch.profiler trace of the traced solves to sums: the
harness's one reader of a profile (``tracesum`` hands on what it returns).

A window of a few solves launches some tens of thousands of kernels; its
full timeline would be hundreds of megabytes, so only sums leave this
module.  The window is the span from the first ``sfmbench.solve`` record's
start to the last one's end (where the trace has none, of the program's
spans), in the profiler's own clock; each solve ends with a device
synchronisation.  The device timeline is every device operation but the
projections of user annotations (``record_function`` scopes, which kineto
mirrors onto the device as intervals covering what they launched).  From
it come:

- ``kernels``: launches and device seconds by short kernel name, and
  ``launches``, every kernel launched (copies and fills not counted);
- ``busy_s``: the union of device activity inside the window;
- ``gaps``: the idle gaps summed by label, ``"<innermost span> | <innermost
  host op>"`` open on the solves' thread at the gap's middle, or the host op
  alone outside every program span.

The port opens a host record named ``tpusfm.<layer>`` around each layer of
its bundle adjustment (``tpusfm_torch/utils/spans.py``; the names below
are that module's, kept here as the strings a trace carries, so that this
module reads a checkout without them and finds nothing).  Kineto writes
those records, the host's ops and the device's work on one clock, and
links each kernel, copy and fill to the innermost op or record open when
it was launched (its ``linked_correlation_id`` is that event's
``correlation_id``), whose start stands for the launch.  On the thread
that ran the traced solves, each span name is reduced to (``SpanSum``):

- ``n``: instances;
- ``host_s``: host seconds;
- ``self_s``: host seconds outside child spans;
- ``device_s``: device seconds of the work launched while the span was the
  innermost one open;
- ``completion_s``: over its instances, the time from the span's start to
  the later of its end and the end of the last device operation launched
  inside it (children included);
- ``idle_s``: seconds of the window in which the device ran nothing while
  the span was the innermost one open.

A torch that keeps no kineto results hands over its events without those
links: the spans are then left out and the rest is read as above.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

SOLVE_SPAN = "sfmbench.solve"
COPIES = ("Memcpy", "Memset")
NO_OP = "python between host operations"

PREFIX = "tpusfm."
SOLVE = "tpusfm.ba.solve"
PREP = "tpusfm.ba.prep"
LINEARIZE = "tpusfm.ba.linearize"
STEP = "tpusfm.ba.step"
PCG = "tpusfm.ba.pcg"
PCG_MATVEC = "tpusfm.ba.pcg.matvec"
PCG_STOP_READ = "tpusfm.ba.pcg.stop_read"
LM_ACCEPT = "tpusfm.ba.lm.accept"
LM_STOP_READ = "tpusfm.ba.lm.stop_read"


@dataclasses.dataclass
class SpanSum:
    n: int = 0
    host_s: float = 0.0
    self_s: float = 0.0
    device_s: float = 0.0
    completion_s: float = 0.0
    idle_s: float = 0.0


@dataclasses.dataclass
class SpanSummary:
    spans: dict = dataclasses.field(default_factory=dict)    # span name -> SpanSum
    idle_outside_s: float = 0.0  # idle seconds of the window outside every program span
    busy_s: float = 0.0
    window_s: float = 0.0
    gaps: dict = dataclasses.field(default_factory=dict)     # label -> idle seconds
    kernels: dict = dataclasses.field(default_factory=dict)  # short name -> [launches, seconds]
    launches: int = 0
    solves: int = 0              # sfmbench.solve records, which set the window where > 0


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


def _events(prof) -> tuple[list, bool]:
    """(on the device, name, start ns, end ns, thread, correlation id, linked
    correlation id, user annotation) of every event, and whether the links
    are there.  Without kineto results: torch's FunctionEvents (microseconds),
    no links, the solve records' projections known by name."""
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is not None:
        return [("CUDA" in str(e.device_type()), e.name(), e.start_ns(), e.end_ns(),
                 e.start_thread_id(), e.correlation_id(), e.linked_correlation_id(),
                 e.is_user_annotation()) for e in res.events()], True
    out = []
    for e in prof.events():
        dev = "CUDA" in str(e.device_type)
        out.append((dev, e.name, int(e.time_range.start * 1e3), int(e.time_range.end * 1e3),
                    e.thread, 0, 0, dev and e.name == SOLVE_SPAN))
    return out, False


def _innermost(spans: list, w0: int, w1: int) -> list:
    """(start, end, index or None) pieces that cut [w0, w1] by the innermost
    of the nested `spans` (start, end, index) open in each."""
    pieces, stack, t = [], [], w0

    def until(x):
        nonlocal t
        x = min(max(x, w0), w1)
        if x > t:
            pieces.append((t, x, stack[-1][2] if stack else None))
            t = x

    for sp in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= sp[0]:
            until(stack[-1][1])
            stack.pop()
        until(sp[0])
        stack.append(sp)
    while stack:
        until(stack[-1][1])
        stack.pop()
    until(w1)
    return pieces


def summarize(prof) -> SpanSummary:
    events, linked = _events(prof)
    device, host, frontend, solves = [], [], {}, []
    for dev, name, s, t, th, corr, link, annotation in events:
        if dev:
            if not annotation:  # an annotation's image, not device work
                device.append((s, t, link, name))
            continue
        if linked and link == 0:  # an op or a record, which device work links to
            frontend[corr] = (s, th)
        if name == SOLVE_SPAN:
            solves.append((s, t, th))
        else:
            host.append((s, t, name, th))

    kernels: dict = {}
    for s, t, _, name in device:
        if not name.startswith(COPIES):
            k = kernels.setdefault(short_name(name), [0, 0.0])
            k[0] += 1
            k[1] += (t - s) * 1e-9
    launches = sum(k[0] for k in kernels.values())

    prog = [h for h in host if linked and h[2].startswith(PREFIX)]
    if solves:
        w0, w1, main = min(s for s, _, _ in solves), max(t for _, t, _ in solves), solves[0][2]
    elif prog:
        w0, w1, main = min(h[0] for h in prog), max(h[1] for h in prog), prog[0][3]
    else:
        return SpanSummary(kernels=kernels, launches=launches)
    mine = [h for h in prog if h[3] == main]
    spans = [(s, t, i) for i, (s, t, _, _) in enumerate(mine)]
    names = [h[2] for h in mine]
    ops = sorted((s, t, name) for s, t, name, th in host
                 if th == main and not name.startswith(PREFIX))

    # Host seconds, and self seconds: each span less its direct children.
    out = {name: SpanSum() for name in dict.fromkeys(names)}
    child = [0] * len(spans)
    stack: list = []
    for s, t, i in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack:
            child[stack[-1][2]] += t - s
        stack.append((s, t, i))
        k = out[names[i]]
        k.n += 1
        k.host_s += (t - s) * 1e-9
    for s, t, i in spans:
        out[names[i]].self_s += (t - s - child[i]) * 1e-9

    # Device work by the innermost span open at its launch; each span's
    # completion from the last end of the work launched inside it.
    pieces = _innermost(spans, w0, w1)
    starts = [p[0] for p in pieces]

    def at(x):
        j = bisect.bisect_right(starts, x) - 1
        return pieces[j][2] if 0 <= j < len(pieces) and x < pieces[j][1] else None

    launched = []  # (launch time, device end) of work launched on the main thread
    for s, t, corr, _ in device:
        hit = frontend.get(corr)
        if hit is None or hit[1] != main:
            continue
        launched.append((hit[0], t))
        i = at(hit[0])
        if i is not None:
            out[names[i]].device_s += (t - s) * 1e-9
    launched.sort()
    times = [x for x, _ in launched]
    for s, t, i in spans:
        lo, hi = bisect.bisect_left(times, s), bisect.bisect_right(times, t)
        end = max([t] + [d for _, d in launched[lo:hi]])
        out[names[i]].completion_s += (end - s) * 1e-9

    # The union of device intervals clipped to the window, and the idle gaps
    # between, each cut by the innermost span.
    gaps, busy, cur = [], 0, w0
    for s, t, _, _ in sorted(device):
        s, t = max(s, w0), min(t, w1)
        if t <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        busy += t - cur
        cur = t
    if cur < w1:
        gaps.append((cur, w1))
    outside = 0
    for a, b in gaps:
        j = max(bisect.bisect_right(starts, a) - 1, 0)
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
            if hi > lo:
                i = pieces[j][2]
                if i is None:
                    outside += hi - lo
                else:
                    out[names[i]].idle_s += (hi - lo) * 1e-9
            j += 1

    # Labels: the innermost span and the innermost other host op at each gap's middle.
    labels: dict = {}
    stack, k = [], 0
    for a, b in gaps:
        m = (a + b) // 2
        while k < len(ops) and ops[k][0] <= m:
            while stack and stack[-1][1] < ops[k][0]:
                stack.pop()
            stack.append(ops[k])
            k += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        op = stack[-1][2] if stack else NO_OP
        i = at(m)
        label = op if i is None else f"{names[i]} | {op}"
        labels[label] = labels.get(label, 0.0) + (b - a) * 1e-9
    return SpanSummary(spans=out, idle_outside_s=outside * 1e-9, busy_s=busy * 1e-9,
                       window_s=(w1 - w0) * 1e-9, gaps=labels, kernels=kernels,
                       launches=launches, solves=len(solves))


def per_layer(spans: dict) -> dict:
    """The per-layer numbers the spans give, by metric name; a number whose
    spans the trace lacks is left out.

    - prep_ms: mean completion of ``tpusfm.ba.prep``;
    - linearize_ms: mean completion of ``tpusfm.ba.linearize``;
    - cg_iters_per_step: CG products per CG loop;
    - pcg_host_us_per_iter: host time in the CG loop but in its flag reads,
      per CG product;
    - pcg_idle_pct: device idle while the CG loop or a child is innermost,
      over the CG loop's host time."""
    got = {}
    for metric, name in (("prep_ms", PREP), ("linearize_ms", LINEARIZE)):
        if name in spans and spans[name].n:
            got[metric] = spans[name].completion_s / spans[name].n * 1e3
    pcg, mv = spans.get(PCG), spans.get(PCG_MATVEC)
    if pcg and pcg.n and mv and mv.n:
        read = spans.get(PCG_STOP_READ, SpanSum())
        got["cg_iters_per_step"] = mv.n / pcg.n
        got["pcg_host_us_per_iter"] = (pcg.host_s - read.host_s) / mv.n * 1e6
        idle = sum(spans[n].idle_s for n in (PCG, PCG_MATVEC, PCG_STOP_READ) if n in spans)
        got["pcg_idle_pct"] = 100.0 * idle / pcg.host_s
    return got
