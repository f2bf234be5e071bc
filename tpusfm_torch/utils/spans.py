"""Named spans over the port's bundle-adjustment layers, on the profiler's
clock.

``span(name, args)`` does nothing unless a ``torch.profiler`` (or any
profiler that PyTorch's record-function machinery serves) is recording.
Then it opens a host record that lands in the profiler's trace: kineto
writes host records and device kernels on one clock and links each kernel
to its launch by a correlation id, so a trace reader can put every kernel,
and every stretch in which the device sat idle, down to the innermost span
open on the launching thread.  Spans nest as the calls do.

The profiler is the only switch: an untraced call pays one read of the
profiler's state a span (well under a microsecond) and enters a shared
no-op context.  The profiler keeps the records until it stops and hands
them over with its results, so this module keeps nothing.

The record is a function-scope one (``torch._C._profiler._RecordFunctionFast``,
the record PyTorch's compiler uses for its own kernels), not
``torch.profiler.record_function``'s user scope: kineto projects a
user-scope record onto the device timeline as an annotation that covers
every kernel launched inside it, and a reader summing that timeline would
take each projection for a kernel spanning its idle gaps.  The
function-scope record stays on the host, and costs about a tenth as much.

The names below are the contract that trace readers match on; each starts
with ``PREFIX``.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "tpusfm."

# Once per bundle_adjust call; args carry the sizes and the path taken.
BA_SOLVE = "tpusfm.ba.solve"
# Kernel path, once per solve: sort and rank compaction, layouts, rank-space state.
BA_PREP = "tpusfm.ba.prep"
# Inside prep, each segment layout (obs_layout): the cameras', and the groups'
# when refining; args name the layout's plan (ops.obs_table.layout_plan_args).
BA_PREP_LAYOUT = "tpusfm.ba.prep.layout"
# Each linearization (LM iterations + 1).
BA_LINEARIZE = "tpusfm.ba.linearize"
# Each LM step: damping, reduced right-hand side, preconditioner, PCG, back-substitution.
BA_STEP = "tpusfm.ba.step"
# The CG loop, once per step on the CG paths.
BA_PCG = "tpusfm.ba.pcg"
# One product with the reduced system, once per CG iteration.
BA_PCG_MATVEC = "tpusfm.ba.pcg.matvec"
# The host read of CG's convergence flag, once per CG iteration and once to stop.
BA_PCG_STOP_READ = "tpusfm.ba.pcg.stop_read"
# LM's accept: the selects over state and linearization, damping, convergence test.
BA_LM_ACCEPT = "tpusfm.ba.lm.accept"
# The host read of LM's stop flag, once per LM iteration.
BA_LM_STOP_READ = "tpusfm.ba.lm.stop_read"

NAMES = (BA_SOLVE, BA_PREP, BA_PREP_LAYOUT, BA_LINEARIZE, BA_STEP, BA_PCG, BA_PCG_MATVEC,
         BA_PCG_STOP_READ, BA_LM_ACCEPT, BA_LM_STOP_READ)

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled
_Record = torch._C._profiler._RecordFunctionFast


def recording() -> bool:
    """Whether a profiler is recording, so that spans are recorded."""
    return _recording()


def span(name: str, args: str = ""):
    """A context manager: a host record named `name` (with `args`, which a
    profiler keeps when it records inputs) while a profiler is recording,
    else a shared no-op."""
    if not _recording():
        return _OFF
    return _Record(name, (), {"args": args}) if args else _Record(name)
