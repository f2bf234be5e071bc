"""The segment layout's readers, layout_ms and layout_roofline, and its
count (counts/layout.py), on hand-built span sums: a solve lays out its
cameras (with the point ranks and their row ranges) and, refining, its
groups (with the ranks), each under the span ``tpusfm.ba.prep.layout``.
A trace without that span, as a program without it gives, reads nothing."""

import types

import pytest

from sfmbench import spansum
from sfmbench.common import load_module
from sfmbench.counts import kernels as kc
from sfmbench.counts import layout as cl
from sfmbench.tests.cells import REPO

C, P, O, G = 5, 7, 100, 5


def _read(metric, run):
    return load_module(REPO / "sfmbench" / "metrics" / f"{metric}.py").read(run)


def _run(spans, refine=False, shape=(C, P, O, G)):
    trace = spansum.SpanSummary(spans=spans)
    return types.SimpleNamespace(trace=trace, shape=shape,
                                 settings={"refine_intrinsics": refine, "w_dtype": "bf16"})


def test_layout_hand_count():
    # ids and ranks read, seg_perm and seg_ranks written, O ints each;
    # seg_start and chunk_start (n + 1) each; rank_start (p + 1).
    assert cl.layout(O, C, True, P) == (4 * (4 * O + 2 * (C + 1) + (P + 1)), 0) == (1680, 0)
    assert cl.layout(O, G, True) == (4 * (4 * O + 2 * (G + 1)), 0) == (1648, 0)
    assert cl.layout(O, C, False) == (4 * (2 * O + 2 * (C + 1)), 0) == (848, 0)
    assert cl.ba_prep(O, C, P, G, False) == [(1680, 0)]
    assert cl.ba_prep(O, C, P, G, True) == [(1680, 0), (1648, 0)]


def test_layout_count_at_final_13682():
    # 28,987,644 observations, 13,682 cameras, 4,456,117 point ranks: 481.8 MB,
    # 143.8 us at 3.35 TB/s.
    nbytes, ops = cl.ba_prep(28987644, 13682, 4456117, 13682, False)[0]
    assert nbytes == 4 * (4 * 28987644 + 2 * 13683 + 4456118) == 481736240 and ops == 0
    assert kc.bound_s(nbytes, ops) == pytest.approx(143.80e-6, rel=1e-4)


def test_layout_ms_is_the_mean_completion():
    run = _run({cl.SPAN: spansum.SpanSum(n=3, completion_s=0.006, device_s=0.004)})
    assert _read("layout_ms", run) == pytest.approx(2.0)


@pytest.mark.parametrize("refine,n", [(False, 3), (True, 6)])
def test_layout_roofline_counts_solves_of_layouts(refine, n):
    """Three solves: three camera layouts held, and three of each kind
    refining; the share is their least time over the span's device time."""
    dev_s = 1e-3
    run = _run({cl.SPAN: spansum.SpanSum(n=n, completion_s=0.01, device_s=dev_s)}, refine)
    least = sum(kc.bound_s(*b) for b in cl.ba_prep(O, C, P, G, refine))
    assert _read("layout_roofline", run) == pytest.approx(100.0 * 3 * least / dev_s)


@pytest.mark.parametrize("metric", ["layout_ms", "layout_roofline"])
def test_layout_readers_read_nothing_without_the_span(metric):
    assert _read(metric, _run({spansum.PREP: spansum.SpanSum(n=3, completion_s=0.01,
                                                             device_s=0.001)})) is None
    assert _read(metric, _run({cl.SPAN: spansum.SpanSum()})) is None
    assert _read(metric, types.SimpleNamespace(trace=None)) is None


def test_layout_roofline_reads_nothing_without_device_time():
    # A CPU-recorded trace: the span is there, no device work under it.
    run = _run({cl.SPAN: spansum.SpanSum(n=3, completion_s=0.01, device_s=0.0)})
    assert _read("layout_roofline", run) is None
    assert _read("layout_ms", run) == pytest.approx(10.0 / 3)
