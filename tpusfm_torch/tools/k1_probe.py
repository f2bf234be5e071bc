"""What the parts of K1's kernels cost, on one card.

    python -m tpusfm_torch.tools.k1_probe [--variant bf16|f32]

Builds ``csrc/topk2_match.cu`` as it is and with parts of one variant's
step cut out, each into a library of its own with ``nvcc``: the top-2
fold (a plain running minimum is left), the wgmma products, the
conversion of B tiles (the bulk copies are still awaited), and all three
(the data path alone: bulk copies, the A block's conversion, barriers).
``--variant bf16`` (the default) cuts the bf16 kernel, ``--variant f32``
the f32 one (three TF32 products; its fold is the bf16 kernel's, so that
cut reaches both), and builds it once more rounding to TF32 by
``cvt.rna.tf32.f32`` instead of its two integer operations (the same
values).  Prints ptxas's register count and wgmma diagnostics (C75xx) for
the variant's kernel in each build, checks the full kernel bit for bit
against its twin, and times every build by CUDA events (median of 20
calls after 3) at the 20-view chunk (192 pairs x 1024 x 1024) and the
200-view chunk (256 x 512 x 512), u8-grid descriptors made from a seed.  A
cut build computes wrong results; what it saves against the full one is
what that part costs where nothing else hides it.  The cuts are text edits
of the source and fail loudly when the kernel no longer has the lines they
edit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess

from ..ops import cuda_build

_FOLD = ("""  t.i1 = v < t.m1 ? j : t.i1;
  t.m2 = fminf(t.m2, fmaxf(t.m1, v));
  t.m1 = fminf(t.m1, v);""", "  t.m1 = fminf(t.m1, v);")
_MMA = ("      wgmma_64x64x16_rs(acc, afrag[s], sw128_desc(b_base + offb), s > 0);\n", "")
_CONV = ("    if (t + 1 < nt) convert_b(t + 1, mask);\n",
         "    if (t + 1 < nt) mbar_wait(smem_u32(mbar + (kPiecesA + t + 1) % kRawSlots),\n"
         "                              ((kPiecesA + t + 1) / kRawSlots) & 1);\n")
# The f32 kernel's MMA cut turns its wgmma instruction into a PTX comment.
_MMA_F32 = ('      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "\n', '      "// "\n')
_CONV_F32 = ("    uint8_t* dst = sB + (k % kBufsF) * kBufF;\n",
             "    uint8_t* dst = sB + (k % kBufsF) * kBufF;\n"
             "    if (dst) {\n"
             "      mbar_arrive(full0 + 8 * (k % kBufsF));\n"
             "      return;\n"
             "    }\n")


# Not a cut: the f32 kernel rounding to TF32 by cvt.rna.tf32.f32 (the same
# values) in place of its two integer operations.
_CVT_F32 = ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n",
            "  uint32_t r;\n"
            "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
            "  return r & 0xffffe000u;\n")


def _cuts(mma, conv) -> dict:
    return {"full": (), "no fold": (_FOLD,), "no MMA": (mma,), "no B conversion": (conv,),
            "data path only": (_FOLD, mma, conv)}


# variant: (the kernel's name tag, the launcher's `quantized`, the builds)
VARIANTS = {"bf16": ("bf16", 1, _cuts(_MMA, _CONV)),
            "f32": ("tf32", 0, {**_cuts(_MMA_F32, _CONV_F32), "cvt rounding": (_CVT_F32,)})}
SHAPES = ((192, 1024, 1024), (256, 512, 512))


def _build(name: str, edits, tag: str = "bf16") -> tuple:
    """Compiles the edited source into its own library; returns (path,
    ptxas lines of the kernel whose name holds `tag`)."""
    src = (cuda_build.CSRC / "topk2_match.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"k1_probe: cut {name!r} no longer matches the kernel source")
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "k1_probe"
    out.mkdir(parents=True, exist_ok=True)
    stem = re.sub(r"\W+", "_", f"{tag} {name}")
    (out / f"{stem}.cu").write_text(src)
    lib = out / f"lib{stem}.so"
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
                           "-I", str(cuda_build.CSRC), "-shared", "-o", str(lib),
                           str(out / f"{stem}.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"k1_probe: nvcc failed on {name!r}:\n{proc.stdout}{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    notes = [line.strip() for line in lines if "C75" in line and tag in line]
    for i, line in enumerate(lines):
        if "Compiling entry" in line and tag in line:
            notes += [x.strip() for x in lines[i + 1:i + 4] if "Used" in x]
    return lib, notes


def _launcher(path, quantized: int = 1):
    import torch

    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tpusfm_topk2_match.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]

    def run(da, db, mb):
        P, na, nb = da.shape[0], da.shape[1], db.shape[1]
        d1 = torch.empty((P, na), device=da.device)
        d2 = torch.empty_like(d1)
        i1 = torch.empty((P, na), dtype=torch.int32, device=da.device)
        err = lib.tpusfm_topk2_match(da.device.index, da.data_ptr(), db.data_ptr(),
                                     mb.data_ptr(), d1.data_ptr(), d2.data_ptr(), i1.data_ptr(),
                                     P, na, nb, quantized,
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"k1_probe: launch failed ({err})")
        return d1, d2, i1

    return run


def _median_ms(fn, warmup: int = 3, runs: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[runs // 2]


def main(argv=None) -> int:
    import torch

    from ..ops import topk2_match

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", choices=sorted(VARIANTS), default="bf16")
    tag, quantized, cuts = VARIANTS[ap.parse_args(argv).variant]
    if not torch.cuda.is_available():
        raise SystemExit("k1_probe: needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = []
    for P, na, nb in SHAPES:
        da, db = (torch.floor(torch.rand((P, n, 128), generator=gen, device=dev) * 256.0)
                  .clamp(max=255.0) for n in (na, nb))
        inputs.append((da, db, torch.rand((P, nb), generator=gen, device=dev) >= 0.1))
    print(torch.cuda.get_device_name(0), f"K1 {tag} kernel")
    for name, edits in cuts.items():
        path, notes = _build(name, edits, tag)
        run = _launcher(path, quantized)
        if name in ("full", "cvt rounding"):
            for da, db, mb in inputs:
                want = topk2_match.match_topk2_reference(da, db, mb, quantized=bool(quantized))
                if not all(torch.equal(g, w) for g, w in zip(run(da, db, mb), want)):
                    raise AssertionError("k1_probe: the full build differs from the twin")
        times = ", ".join(f"{da.shape[0]} x {da.shape[1]} x {db.shape[1]}: "
                          f"{_median_ms(lambda: run(da, db, mb)):.4f} ms"
                          for da, db, mb in inputs)
        print(f"{name}: {times}")
        for note in notes:
            print(f"    {note}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
