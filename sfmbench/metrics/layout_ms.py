"""layout_ms: the mean completion of the ``tpusfm.ba.prep.layout`` span (a
segment layout built in a solve's preparation: the cameras', and the
groups' when refining), from its start to the end of the last device work
launched inside it, in milliseconds; nothing where the trace has no such
span."""

from sfmbench.counts import layout as cl


def read(run):
    if run.trace is None:
        return None
    lay = run.trace.spans.get(cl.SPAN)
    if lay is None or lay.n == 0:
        return None
    return lay.completion_s / lay.n * 1e3
