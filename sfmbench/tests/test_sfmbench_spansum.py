"""The span reader (spansum.py) on hand-made kineto events: sums by span
name, device work put down to the innermost span open at its launch (the
op or record that its linked correlation id names), completion times, idle
seconds cut by the innermost span, the "span | op" gap labels, the five
per-layer numbers, and a trace without program spans read as tracesum
reads it."""

import pytest

from sfmbench import spansum, tracesum


class _Event:
    def __init__(self, dev, name, s, e, th=1, corr=0, linked=0, ua=False):
        self._v = (dev, name, s, e, th, corr, ua, linked)

    def device_type(self):
        return "DeviceType.CUDA" if self._v[0] else "DeviceType.CPU"

    def name(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]

    def linked_correlation_id(self):
        return self._v[7]


def _prof(ev):
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: ev})()
    return prof


def _launch(s, corr, op):
    return _Event(False, "cudaLaunchKernel", s, s + 10, corr=corr, linked=op)


def test_span_sums():
    ev = [_Event(False, tracesum.SOLVE_SPAN, 0, 1100, ua=True),
          _Event(True, tracesum.SOLVE_SPAN, 0, 1100, ua=True),
          _Event(False, spansum.SOLVE, 0, 1000, corr=1),
          _Event(False, spansum.PCG, 100, 700, corr=2),
          _Event(False, spansum.PCG_MATVEC, 150, 300, corr=3),
          _Event(False, spansum.PCG_STOP_READ, 400, 600, corr=4),
          _Event(True, spansum.PCG, 160, 650, ua=True),  # a projection: not device work
          _Event(False, "aten::_local_scalar_dense", 410, 590, corr=5),
          # k1 from an op in the matvec, k2 straight from the solve's record (a
          # wrapper's own launch), k3 from an op after the CG loop, k4 from another thread.
          _Event(False, "aten::mm", 155, 180, corr=6), _Event(False, "aten::add", 705, 725, corr=7),
          _Event(False, "aten::mul", 760, 780, th=2, corr=8),
          _launch(50, 12, 1), _launch(160, 11, 6), _launch(710, 13, 7),
          _Event(True, "k1", 200, 350, corr=11, linked=6),
          _Event(True, "k2", 60, 90, corr=12, linked=1),
          _Event(True, "k3", 750, 800, corr=13, linked=7),
          _Event(True, "k4", 770, 790, corr=14, linked=8)]
    ss = spansum.summarize(_prof(ev))
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
        f"{spansum.SOLVE} | {tracesum.NO_OP}": 360e-9,
        f"{spansum.PCG} | {tracesum.NO_OP}": 110e-9,
        f"{spansum.PCG_STOP_READ} | aten::_local_scalar_dense": 400e-9})
    layer = spansum.per_layer(s)
    assert layer == pytest.approx({"cg_iters_per_step": 1.0, "pcg_host_us_per_iter": 0.4,
                                   "pcg_idle_pct": 75.0})


def test_no_program_spans_reads_as_tracesum():
    ev = [_Event(False, tracesum.SOLVE_SPAN, 0, 1000, ua=True),
          _Event(True, tracesum.SOLVE_SPAN, 0, 1000, ua=True),
          _Event(False, "aten::item", 100, 400), _Event(False, "aten::mul", 600, 700),
          _Event(True, "void k1<float, 6>(float*)", 0, 100),
          _Event(True, "void k1<float, 6>(float*)", 400, 600),
          _Event(True, "Memcpy DtoH", 650, 800),
          _Event(True, "void (anonymous namespace)::k2()", 780, 900)]
    ss = spansum.summarize(_prof(ev))
    ts = tracesum.summarize(_prof(ev))
    assert ss.spans == {} and spansum.per_layer(ss.spans) == {}
    assert ss.gaps == pytest.approx(ts.gaps)
    assert ss.busy_s == pytest.approx(ts.busy_s) and ss.window_s == pytest.approx(ts.window_s)
    assert ss.idle_outside_s == pytest.approx(ts.window_s - ts.busy_s)
