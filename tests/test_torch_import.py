"""The port stands alone: every module of tpusfm_torch imports with jax
blocked, and importing it pulls in neither jax nor the reference package."""

import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import tpusfm_torch
names = [m.name for m in pkgutil.walk_packages(tpusfm_torch.__path__, "tpusfm_torch.")]
for name in names:
    importlib.import_module(name)
assert sys.modules["jax"] is None, "jax was imported"
leaked = sorted(m for m in sys.modules if m == "tpusfm" or m.startswith("tpusfm."))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every subpackage and module was walked


def test_no_module_mentions_jax_imports():
    for path in (REPO / "tpusfm_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax", "import flax", "from flax",
                                            "from tpusfm.", "import tpusfm.")), (path, line)
