"""The port's bundle-adjustment spans (tpusfm_torch/utils/spans.py) on the
CPU, on the 8-camera orbit problem of test_torch_ba.py: the kernel path's
twins (impl="pallas": fused K2 with intrinsics held, fused K2 refining one
focal group, and the unfused linearization), the plain PCG path and the
dense-Cholesky path.

With no profiler no record is opened and the answer is the traced call's,
bit for bit.  Under a CPU torch.profiler the spans nest as the layers do,
come in the counts that the solve's iterations and CG products give, and
stay host records (no user annotation, which kineto would project onto the
device timeline).  The benchmark's span reader (sfmbench/spansum.py) reads
the same names."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sfmbench import spansum
from sfmbench.counts import layout as layout_counts
from tpusfm_torch.ba import bundle_adjust as tba
from tpusfm_torch.utils import spans
from tpusfm_torch.utils.synth_scene import orbit_scene

torch.set_num_threads(2)

C, P = 8, 200
VARIANTS = {
    "kernel_fused_held": dict(impl="pallas"),
    "kernel_fused_refine": dict(impl="pallas", refine_intrinsics=True, refine_params="focal"),
    "kernel_unfused": dict(impl="pallas", fused_linearize=False),
    "plain_pcg": dict(impl="xla", dense_schur_max_dim=0),
    "dense": dict(impl="xla"),
}
PARENT = {spans.BA_PREP: spans.BA_SOLVE, spans.BA_PREP_LAYOUT: spans.BA_PREP,
          spans.BA_LINEARIZE: spans.BA_SOLVE,
          spans.BA_STEP: spans.BA_SOLVE, spans.BA_PCG: spans.BA_STEP,
          spans.BA_PCG_MATVEC: spans.BA_PCG, spans.BA_PCG_STOP_READ: spans.BA_PCG,
          spans.BA_LM_ACCEPT: spans.BA_SOLVE, spans.BA_LM_STOP_READ: spans.BA_SOLVE}


def _problem(seed=0, noise_px=0.5, perturb=0.01):
    """test_torch_ba.py's perturbed orbit problem, as torch tensors."""
    s = orbit_scene(n_cams=C, n_points=P, noise_px=noise_px, seed=seed)
    r = np.random.default_rng(seed + 1)
    aa = s["aa"] + r.normal(scale=perturb, size=(C, 3))
    t = s["t"] + r.normal(scale=perturb, size=(C, 3))
    pts = s["points"] + r.normal(scale=2 * perturb, size=(P, 3))
    aa[0], t[0] = s["aa"][0], s["t"][0]
    O = len(s["obs_cam"])
    obs_mask = np.ones(O, bool)
    obs_mask[r.random(O) < 0.05] = False
    f32 = dict(dtype=torch.float32)
    return dict(intr=torch.tensor(np.tile(s["intr"], (C, 1)), **f32),
                cam_rot=torch.tensor(aa, **f32), cam_t=torch.tensor(t, **f32),
                cam_mask=torch.ones(C, dtype=torch.bool), points=torch.tensor(pts, **f32),
                point_mask=torch.tensor(s["point_valid"]),
                obs_cam=torch.tensor(s["obs_cam"], dtype=torch.int64),
                obs_pt=torch.tensor(s["obs_pt"], dtype=torch.int64),
                obs_uv=torch.tensor(s["obs_uv"], **f32), obs_mask=torch.tensor(obs_mask))


def _solve(variant):
    kw = VARIANTS[variant]
    cfg = tba.BAConfig(max_iters=10, **kw)
    groups = dict(cam_group=torch.zeros(C, dtype=torch.int64), n_groups=1) \
        if kw.get("refine_intrinsics") else {}
    return tba.bundle_adjust(cfg=cfg, **_problem(), **groups)


def _traced(variant, monkeypatch):
    """(answer, [(start, end, name)] of the spans, CG products counted at the
    matvec closure) of one solve under a CPU profiler."""
    products = [0]
    pcg = tba._pcg

    def counting_pcg(matvec, *args, **kw):
        def mv(p):
            products[0] += 1
            return matvec(p)
        return pcg(mv, *args, **kw)

    monkeypatch.setattr(tba, "_pcg", counting_pcg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _solve(variant)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(spans.PREFIX)]
    assert not any(e.is_user_annotation() for e in events)
    assert len({e.start_thread_id() for e in events}) == 1
    return out, sorted((e.start_ns(), e.end_ns(), e.name()) for e in events), products[0]


def _parents(recs):
    """Each span's innermost enclosing span (None at the top)."""
    out, stack = [], []
    for s, e, name in sorted(recs, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][1] <= s:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((s, e, name))
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_spans_open_nothing_untraced(variant, monkeypatch):
    entered = []

    class Counting:
        def __init__(self, *a):
            entered.append(a)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    real_enter = torch.autograd.profiler.record_function.__enter__

    def counting_enter(self):
        entered.append(self.name)
        return real_enter(self)

    monkeypatch.setattr(spans, "_Record", Counting)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counting_enter)
    assert not spans.recording()
    untraced = _solve(variant)
    assert entered == []
    monkeypatch.undo()
    traced, recs, _ = _traced(variant, monkeypatch)
    assert recs
    for a, b in zip(untraced[:4], traced[:4]):
        assert torch.equal(a, b)
    for k in ("initial_cost", "final_cost", "lambda"):
        assert torch.equal(untraced[4][k], traced[4][k])
    assert untraced[4]["iterations"] == traced[4]["iterations"]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_span_tree_and_counts(variant, monkeypatch):
    out, recs, products = _traced(variant, monkeypatch)
    iters = out[4]["iterations"]
    assert iters >= 2
    n = {name: 0 for name in spans.NAMES}
    for name, parent in _parents(recs):
        n[name] += 1
        assert parent == PARENT.get(name), (name, parent)
    kernel, cg = variant.startswith("kernel"), variant != "dense"
    assert n[spans.BA_SOLVE] == 1
    assert n[spans.BA_PREP] == (1 if kernel else 0)
    # The cameras' layout, and the groups' when refining.
    refine = VARIANTS[variant].get("refine_intrinsics", False)
    assert n[spans.BA_PREP_LAYOUT] == ((2 if refine else 1) if kernel else 0)
    assert n[spans.BA_LINEARIZE] == iters + 1
    assert n[spans.BA_STEP] == n[spans.BA_LM_ACCEPT] == n[spans.BA_LM_STOP_READ] == iters
    assert n[spans.BA_PCG] == (iters if cg else 0)
    assert n[spans.BA_PCG_MATVEC] == products
    assert (products > 0) == cg
    # One read before each product, and one more in each loop that stops short of its cap.
    assert products <= n[spans.BA_PCG_STOP_READ] <= products + n[spans.BA_PCG]


def test_reader_names_and_numbers(monkeypatch):
    """spansum's names and the layout readers' span are the spans module's;
    on a CPU profile of a kernel-path solve it counts what the tree holds."""
    assert {getattr(spansum, k) for k in ("SOLVE", "PREP", "LINEARIZE", "STEP", "PCG",
                                          "PCG_MATVEC", "PCG_STOP_READ", "LM_ACCEPT",
                                          "LM_STOP_READ")} | {layout_counts.SPAN} \
        == set(spans.NAMES)
    assert spansum.PREFIX == spans.PREFIX
    products = [0]
    pcg = tba._pcg

    def counting_pcg(matvec, *args, **kw):
        def mv(p):
            products[0] += 1
            return matvec(p)
        return pcg(mv, *args, **kw)

    monkeypatch.setattr(tba, "_pcg", counting_pcg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _solve("kernel_fused_held")
    ss = spansum.summarize(prof)
    iters = out[4]["iterations"]
    got = {k: v.n for k, v in ss.spans.items()}
    assert got[spans.BA_LINEARIZE] == iters + 1 and got[spans.BA_PCG] == iters
    assert got[spans.BA_PCG_MATVEC] == products[0]
    assert got[layout_counts.SPAN] == got[spans.BA_PREP] == 1
    layer = spansum.per_layer(ss.spans)
    assert layer["cg_iters_per_step"] == products[0] / iters
    assert set(layer) == {"prep_ms", "linearize_ms", "cg_iters_per_step",
                          "pcg_host_us_per_iter", "pcg_idle_pct"}
    # No device: the whole window is idle, and every idle second is some span's.
    root = dataclasses.asdict(ss.spans[spans.BA_SOLVE])
    assert ss.busy_s == 0 and root["n"] == 1
    assert sum(v.idle_s for v in ss.spans.values()) + ss.idle_outside_s == \
        pytest.approx(ss.window_s)
