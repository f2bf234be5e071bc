"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and the objects are linked
into one shared library with a plain C interface, at first use, from the
sources in this package only.  The library lands in
``tpusfm_torch/_build/libtpusfm_kernels-<hash of sources>.so`` and is loaded
with ``ctypes``; a changed source or header gets a new hash and is rebuilt.
A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): "
                       "the port's CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(_sources() + list(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtpusfm_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for the current sources exists.
    verbose=True also asks ptxas for each kernel's registers and shared
    memory and prints the compiler's output.  Returns the library path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / (src.stem + ".o") for src in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                                   "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_sources(), objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(_sources(), procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
            if verbose:
                print(log, end="")
        tmp = Path(tmpdir) / out.name
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tpusfm_topk2_match.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.tpusfm_topk2_match.restype = ci
        lib.tpusfm_ba_linearize.argtypes = [vp] * 11 + [ci] * 4 + [ctypes.c_float, ci] + [vp] * 4
        lib.tpusfm_ba_linearize.restype = ci
        lib.tpusfm_ba_schur_mv.argtypes = [vp, ci] + [vp] * 8 + [ci] * 3 + [vp] * 4
        lib.tpusfm_ba_schur_mv.restype = ci
        lib.tpusfm_ba_schur_bwd.argtypes = [vp, ci, ci, vp, vp, ci, vp, vp, ci, ci, vp, vp]
        lib.tpusfm_ba_schur_bwd.restype = ci
        lib.tpusfm_cuda_error_string.argtypes = [ci]
        lib.tpusfm_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.tpusfm_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
