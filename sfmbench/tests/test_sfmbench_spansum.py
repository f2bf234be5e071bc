"""The span reader (spansum.py) on hand-made kineto events: sums by span
name, device work put down to the innermost span open at its launch (the
op or record that its linked correlation id names), completion times, idle
seconds cut by the innermost span, the "span | op" gap labels, the five
per-layer numbers, and a trace without program spans read as the
harness's earlier reader (tracesum_by_name.py) read it."""

import pytest

from sfmbench import spansum
from sfmbench.tests import tracesum_by_name
from sfmbench.tests.events import Event, profile_of


def _launch(s, corr, op):
    return Event(False, "cudaLaunchKernel", s, s + 10, corr=corr, linked=op)


def test_span_sums():
    ev = [Event(False, spansum.SOLVE_SPAN, 0, 1100, ua=True),
          Event(True, spansum.SOLVE_SPAN, 0, 1100, ua=True),
          Event(False, spansum.SOLVE, 0, 1000, corr=1),
          Event(False, spansum.PCG, 100, 700, corr=2),
          Event(False, spansum.PCG_MATVEC, 150, 300, corr=3),
          Event(False, spansum.PCG_STOP_READ, 400, 600, corr=4),
          Event(True, spansum.PCG, 160, 650, ua=True),  # a projection: not device work
          Event(False, "aten::_local_scalar_dense", 410, 590, corr=5),
          # k1 from an op in the matvec, k2 straight from the solve's record (a
          # wrapper's own launch), k3 from an op after the CG loop, k4 from another thread.
          Event(False, "aten::mm", 155, 180, corr=6), Event(False, "aten::add", 705, 725, corr=7),
          Event(False, "aten::mul", 760, 780, th=2, corr=8),
          _launch(50, 12, 1), _launch(160, 11, 6), _launch(710, 13, 7),
          Event(True, "k1", 200, 350, corr=11, linked=6),
          Event(True, "k2", 60, 90, corr=12, linked=1),
          Event(True, "k3", 750, 800, corr=13, linked=7),
          Event(True, "k4", 770, 790, corr=14, linked=8)]
    ss = spansum.summarize(profile_of(ev))
    assert ss.window_s == pytest.approx(1100e-9) and ss.busy_s == pytest.approx(230e-9)
    s = ss.spans
    assert {k: v.n for k, v in s.items()} == {spansum.SOLVE: 1, spansum.PCG: 1,
                                               spansum.PCG_MATVEC: 1, spansum.PCG_STOP_READ: 1}
    want = {  # host, self, device, completion, idle (ns)
        spansum.SOLVE: (1000, 400, 80, 1000, 320),
        spansum.PCG: (600, 250, 0, 600, 200),
        spansum.PCG_MATVEC: (150, 150, 150, 200, 50),
        spansum.PCG_STOP_READ: (200, 200, 0, 200, 200),
    }
    for name, (host, own, dev, done, idle) in want.items():
        got = s[name]
        assert (got.host_s, got.self_s, got.device_s, got.completion_s, got.idle_s) == \
            pytest.approx((host * 1e-9, own * 1e-9, dev * 1e-9, done * 1e-9, idle * 1e-9)), name
    assert ss.idle_outside_s == pytest.approx(100e-9)
    assert ss.gaps == pytest.approx({
        f"{spansum.SOLVE} | {spansum.NO_OP}": 360e-9,
        f"{spansum.PCG} | {spansum.NO_OP}": 110e-9,
        f"{spansum.PCG_STOP_READ} | aten::_local_scalar_dense": 400e-9})
    layer = spansum.per_layer(s)
    assert layer == pytest.approx({"cg_iters_per_step": 1.0, "pcg_host_us_per_iter": 0.4,
                                   "pcg_idle_pct": 75.0})


def test_no_program_spans_reads_as_tracesum():
    ev = [Event(False, spansum.SOLVE_SPAN, 0, 1000, ua=True),
          Event(True, spansum.SOLVE_SPAN, 0, 1000, ua=True),
          Event(False, "aten::item", 100, 400), Event(False, "aten::mul", 600, 700),
          Event(True, "void k1<float, 6>(float*)", 0, 100),
          Event(True, "void k1<float, 6>(float*)", 400, 600),
          Event(True, "Memcpy DtoH", 650, 800),
          Event(True, "void (anonymous namespace)::k2()", 780, 900)]
    ss = spansum.summarize(profile_of(ev))
    ts = tracesum_by_name.summarize(profile_of(ev))
    assert ss.spans == {} and spansum.per_layer(ss.spans) == {}
    assert ss.kernels == ts.kernels and ss.launches == ts.launches
    assert ss.gaps == pytest.approx(ts.gaps)
    assert ss.busy_s == pytest.approx(ts.busy_s) and ss.window_s == pytest.approx(ts.window_s)
    assert ss.idle_outside_s == pytest.approx(ts.window_s - ts.busy_s)


def test_function_events_read_without_spans():
    """A profile without kineto results hands over torch's FunctionEvents
    (microseconds, no launch links): read as the earlier reader read it,
    with no span sums."""
    from types import SimpleNamespace as NS

    def fe(dev, name, s, e):
        return NS(device_type="DeviceType.CUDA" if dev else "DeviceType.CPU", name=name,
                  time_range=NS(start=s, end=e), thread=1)

    ev = [fe(False, spansum.SOLVE_SPAN, 0, 10), fe(True, spansum.SOLVE_SPAN, 0, 10),
          fe(False, spansum.PCG, 1, 6), fe(False, "aten::item", 1, 4),
          fe(True, "void k1<float, 6>(float*)", 0, 1), fe(True, "Memcpy DtoH", 4, 6)]
    prof = NS(events=lambda: ev)
    ss, ts = spansum.summarize(prof), tracesum_by_name.summarize(prof)
    assert ss.spans == {} and ss.solves == 1
    assert ss.kernels == ts.kernels and ss.launches == ts.launches == 1
    assert (ss.busy_s, ss.window_s) == pytest.approx((ts.busy_s, ts.window_s))
    assert ss.gaps == pytest.approx({"aten::item": 3e-6, spansum.NO_OP: 4e-6})
