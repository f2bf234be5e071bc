"""tpusfm_torch — the PyTorch/CUDA port of tpusfm.

Mirrors the subpackage layout of the JAX package ``tpusfm`` (the reference):
each ported module keeps its reference module's file name, so the counterpart
of ``tpusfm/core/epipolar.py`` is ``tpusfm_torch/core/epipolar.py``.  The one
exception is the matcher kernel: ``tpusfm/ops/pallas_match.py`` becomes
``ops/topk2_match.py`` (wrapper and plain twin) plus ``csrc/topk2_match.cu``
(the hand-written CUDA kernel for Hopper, ``sm_90a``).

The port imports ``torch`` and never ``jax`` or the ``tpusfm`` package.
Functions take tensors and run on the tensors' device; entry points that
create state (``pipeline.sparse.run_sparse``, ``sfm.two_view.two_view_reconstruct``,
``sfm.scene.load_scene_npz``, ``core.camera.make_intrinsics``) take the
device explicitly.
Ported so far: the sparse path (``run_sparse`` with the incremental
engine, loop-closure retrieval and the preemptive prefilter included),
two-view reconstruction, the sparse modules' public helpers, the dense
and mesh stages that follow (``dense.depth.dense_reconstruct``,
``dense.meshing``, ``dense.texturing``, ``io.ply``), and the staged
workspace pipeline with its I/O, the HTTP service and the CLI
(``pipeline.staged``, ``io.{images,native_ingest,colmap,reports,viewer}``,
``utils.{events,result,geo}``, ``pipeline.checkpoint``,
``service.http_server``, ``cli``).  Entry points that run stages take
``device`` and default to ``"cuda"``; with no CUDA device they raise.
"""

__version__ = "0.1.0"
