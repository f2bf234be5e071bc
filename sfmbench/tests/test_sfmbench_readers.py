"""The per-layer readers of a traced run.  On one CPU-recorded profile of
the tiny cell's solves on the kernel path, with device kernels added where
the card would launch them (linked to the span that launches them), the
reader built on spansum and the harness's earlier reader
(tracesum_by_name.py) read the same kernels, launches, busy time and
window, so every metric both report reads the same value.
linearize_roofline follows its formula, the five span metrics read what
spansum.per_layer gives, and spanrun's two readings agree on the CPU cell."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from sfmbench import harness, spanrun, spansum, tracesum
from sfmbench.common import load_module
from sfmbench.counts import kernels as kc
from sfmbench.gen import scene as gen
from sfmbench.tests import tracesum_by_name
from sfmbench.tests.cells import REPO, tiny_root
from sfmbench.tests.events import Event, profile_of

SEED = 2**31 + 91
# The kernels the card launches in each span, as fractions of the span's time.
KERNELS = {
    spansum.PREP: [("void seg_count_kernel(int const*, int)", 0.1, 0.3),
                   ("Memcpy HtoD (Pageable -> Device)", 0.3, 0.4)],
    spansum.LINEARIZE: [("void lin_rank_kernel<__nv_bfloat16>(float const*)", 0.1, 0.5),
                        ("void lin_camera_kernel<__nv_bfloat16>(float const*)", 0.5, 0.7)],
    spansum.PCG_MATVEC: [("void schur_rank_wz_kernel<__nv_bfloat16>(float const*)", 0.0, 0.4),
                         ("void schur_wz_chunk_kernel<__nv_bfloat16>(float const*)", 0.4, 0.6),
                         ("void schur_camera_finish_kernel(float const*)", 0.6, 0.8),
                         ("void schur_fwd_kernel<__nv_bfloat16, 6, false>(float const*)", 0.8,
                          0.9),
                         ("void schur_fwd_kernel<__nv_bfloat16, 7, false>(float const*)", 0.9,
                          1.5)],
    spansum.LM_STOP_READ: [("Memcpy DtoH (Device -> Pageable)", 0.0, 0.2)],
}
EARLIER = ("lm_iter_ms", "cg_matvecs_per_solve", "launches_per_lm_iter", "k2_roofline",
           "k3_roofline", "k5_roofline", "device_idle_pct")
SPAN_METRICS = ("prep_ms", "linearize_ms", "cg_iters_per_step", "pcg_host_us_per_iter",
                "pcg_idle_pct")


def with_kernels(prof):
    """The profile's own events, with the user annotation of each solve
    record projected onto the device and `KERNELS` added under each span."""
    real = list(prof.profiler.kineto_results.events())
    corr = max(e.correlation_id() for e in real) + 1
    out = []
    for e in real:
        dev, name, s, t = "CUDA" in str(e.device_type()), e.name(), e.start_ns(), e.end_ns()
        out.append(Event(dev, name, s, t, e.start_thread_id(), e.correlation_id(),
                         e.linked_correlation_id(), e.is_user_annotation()))
        if name == spansum.SOLVE_SPAN:
            out.append(Event(True, name, s, t, e.start_thread_id(), ua=True))
        for kernel, a, b in KERNELS.get(name, []):
            d = t - s
            out.append(Event(True, kernel, s + int(a * d), s + int(b * d), 7, corr,
                             e.correlation_id()))
            corr += 1
    return profile_of(out)


def _run_data(cell, scene, trace, iterations):
    drv = harness.driver(cell)
    C, P, O = scene.shape
    return harness.RunData(cell=cell, shape=(C, P, O, drv.groups(cell, scene)[1]),
                           settings=drv.ba_settings(cell), setup_s=0.0, setup_parts={},
                           window_s=1.0, latencies=[], iterations=iterations, device={},
                           trace=trace, traced_solves=len(iterations),
                           traced_iterations=sum(iterations), traced_wall_s=0.5)


def _metric(name):
    return load_module(REPO / "sfmbench" / "metrics" / f"{name}.py").read


@pytest.fixture(scope="module")
def tiny_kernels(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("readers"), name="tinyr", ba={"impl": "pallas"})


@pytest.fixture(scope="module")
def traced(tiny_kernels):
    """(cell, scene, profile with kernels, each solve's LM iterations)."""
    torch.set_num_threads(2)
    root, name = tiny_kernels
    cell = harness.load_cell(root, name)
    drv = harness.driver(cell)
    scene = gen.generate(cell.config, torch.device("cpu"))
    solve = drv.port_solver(cell, scene)
    iterations = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(2):
            with record_function(tracesum.SOLVE_SPAN):
                iterations.append(int(solve(drv.start(cell, scene, SEED, k))[4]["iterations"]))
    return cell, scene, with_kernels(prof), iterations


def test_the_two_readers_read_the_same_sums(traced):
    _, _, prof, _ = traced
    new, old = tracesum.summarize(prof), tracesum_by_name.summarize(prof)
    assert new.kernels == old.kernels and new.launches == old.launches > 0
    assert new.busy_s == old.busy_s > 0 and new.window_s == old.window_s > new.busy_s
    assert sum(new.gaps.values()) == pytest.approx(sum(old.gaps.values()), rel=1e-12)
    assert any(" | " in label for label in new.gaps)


@pytest.mark.parametrize("metric", EARLIER)
def test_metric_reads_as_with_the_earlier_reader(traced, metric):
    cell, scene, prof, iterations = traced
    read = _metric(metric)
    new = read(_run_data(cell, scene, tracesum.summarize(prof), iterations))
    old = read(_run_data(cell, scene, tracesum_by_name.summarize(prof), iterations))
    assert new is not None and new == old


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_metric_reads_spansum(traced, metric):
    cell, scene, prof, iterations = traced
    ts = tracesum.summarize(prof)
    got = _metric(metric)(_run_data(cell, scene, ts, iterations))
    assert got is not None and got == spansum.per_layer(ts.spans)[metric]


def test_linearize_roofline_formula():
    read = _metric("linearize_roofline")
    C, P, O, G = 1778, 993923, 5001946, 1778
    settings = {"refine_intrinsics": False, "w_dtype": "bf16"}

    def run(spans):
        return harness.RunData(cell=None, shape=(C, P, O, G), settings=settings, setup_s=0.0,
                               setup_parts={}, window_s=1.0, latencies=[], iterations=[],
                               device={}, trace=spansum.SpanSummary(spans=spans))

    lin = spansum.SpanSum(n=78, device_s=0.15)
    want = 100.0 * 78 * kc.bound_s(*kc.linearize(O, C, P, G, False, "bf16")) / 0.15
    assert read(run({spansum.LINEARIZE: lin})) == pytest.approx(want, rel=1e-12)
    assert read(run({spansum.SOLVE: lin})) is None
    assert read(run({spansum.LINEARIZE: spansum.SpanSum(n=78)})) is None


def test_linearize_roofline_counts_the_span_whatever_launches_in_it(traced):
    """On the profile, the share is the least time over every kernel and
    copy put down to the linearization span, not K2's kernels alone."""
    cell, scene, prof, iterations = traced
    ts = tracesum.summarize(prof)
    lin = ts.spans[spansum.LINEARIZE]
    assert lin.n == sum(iterations) + len(iterations)
    sec = sum(s for name, (_, s) in ts.kernels.items() if name.startswith("lin_"))
    assert lin.device_s == pytest.approx(sec, rel=1e-12)
    C, P, O = scene.shape
    b = kc.linearize(O, C, P, C, False, "bf16")
    got = _metric("linearize_roofline")(_run_data(cell, scene, ts, iterations))
    assert got == pytest.approx(100.0 * lin.n * kc.bound_s(*b) / sec, rel=1e-12)


def test_spanrun_agrees_on_the_cpu_cell(tiny_kernels, monkeypatch):
    root, name = tiny_kernels
    plain = spansum.summarize
    monkeypatch.setattr(spansum, "summarize", lambda prof: plain(with_kernels(prof)))
    torch.set_num_threads(2)
    out = spanrun.run(root, name, SEED, 0.5, "cpu", time.perf_counter())
    assert out["result"]["correct"], out["result"]["checks"]
    spans_side, harness_side = out["agree"]["matvecs_per_solve"]
    assert spans_side is not None and spans_side == harness_side
    inside, outside = out["agree"]["idle_s"]
    assert 0 < inside == pytest.approx(outside, rel=1e-9)
    assert set(out["per_layer"]) == set(SPAN_METRICS)
    for metric in SPAN_METRICS + ("linearize_roofline",):
        assert metric in out["result"]["metrics"]
