"""tpusfm_torch — the PyTorch/CUDA port of tpusfm.

Mirrors the subpackage layout of the JAX package ``tpusfm`` (the reference):
each ported module keeps its reference module's file name, so the counterpart
of ``tpusfm/core/epipolar.py`` is ``tpusfm_torch/core/epipolar.py``.  The one
exception is the matcher kernel: ``tpusfm/ops/pallas_match.py`` becomes
``ops/topk2_match.py`` (wrapper and plain twin) plus ``csrc/topk2_match.cu``
(the hand-written CUDA kernel for Hopper, ``sm_90a``).

The port imports ``torch`` and never ``jax`` or the ``tpusfm`` package.
Functions take tensors and run on the tensors' device; entry points that
create state (``pipeline.sparse.run_sparse``) take the device explicitly.
The slice ported so far is the sparse main path, ``run_sparse`` with the
incremental engine.
"""

__version__ = "0.1.0"
