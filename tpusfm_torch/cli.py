"""Command-line interface (port of ``tpusfm/cli.py``).

  python -m tpusfm_torch.cli reconstruct <image_dir> --workspace ws [--dense --mesh]
  python -m tpusfm_torch.cli serve --workspace ws [--host H --port P]
  python -m tpusfm_torch.cli export-colmap <scene.npz> [--out dir]

Every command runs on the card (``--device cuda``, the default) unless
``--device cpu`` asks for the CPU; with no CUDA device the card default is
an error.  ``reconstruct --devices N`` runs data-parallel over N ranks, one
process per device, started by torchrun::

  torchrun --nproc-per-node N -m tpusfm_torch.cli reconstruct <image_dir> \
      --workspace ws --devices N

Each rank joins the group from torchrun's environment (NCCL on cards,
gloo on the CPU) and takes card LOCAL_RANK; rank 0 prints and writes the
workspace.  ``serve --devices N`` runs the same way: rank 0 binds the
HTTP server, the other ranks follow its stage commands::

  torchrun --nproc-per-node N -m tpusfm_torch.cli serve --workspace ws --devices N

Not ported yet, raising ``NotImplementedError``: ``bench`` (the port's
benchmark is ROADMAP queue 1 item 1).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path


def _add_cfg_args(p: argparse.ArgumentParser):
    p.add_argument("--preset", default="NORMAL", choices=["NORMAL", "HIGH", "ULTRA"],
                   help="SIFT describer preset (SIFT_describer.hpp:99-117 parity)")
    p.add_argument("--max-features", type=int, default=2048)
    p.add_argument("--pair-mode", default="exhaustive", choices=["exhaustive", "contiguous"])
    p.add_argument("--focal", type=float, default=None,
                   help="focal prior in pixels (overrides EXIF)")
    p.add_argument("--force", action="store_true", help="ignore stage artifacts")
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel rank count: run under torchrun --nproc-per-node N")
    p.add_argument("--engine", default="incremental",
                   choices=["incremental", "global", "stellar"],
                   help="reconstruction engine (ESfMEngine parity)")
    p.add_argument("--no-self-calibrate", action="store_true",
                   help="disable RADIAL3 self-calibration (shared-group "
                        "BA intrinsic refinement)")
    p.add_argument("--device", default="cuda",
                   help="torch device the stages run on (default cuda; cpu to ask for the CPU)")


def _make_cfg(args):
    from .features import sift
    from .pipeline.config import MatchingConfig, PipelineConfig

    return PipelineConfig(
        sift=sift.preset(args.preset, max_features=args.max_features,
                         max_per_octave=args.max_features),
        matching=MatchingConfig(pair_mode=args.pair_mode),
        focal_prior_px=args.focal,
        devices=getattr(args, "devices", None),
        engine_type=getattr(args, "engine", "incremental"),
        self_calibrate=not getattr(args, "no_self_calibrate", False),
    )


def _join_ranks(args, cfg):
    """With --devices N > 1: join torchrun's group of N ranks (unless this
    process is in a group already).  Returns (this rank's device, whether
    this rank prints and writes, whether the group is this call's)."""
    if not cfg.devices or cfg.devices <= 1:
        return args.device, True, False
    import torch.distributed as dist

    from .parallel import mesh as mesh_mod

    device = mesh_mod.rank_device(args.device)
    made = mesh_mod.initialize_distributed(device=device)
    if not dist.is_initialized() or dist.get_world_size() != cfg.devices:
        raise RuntimeError(f"--devices {cfg.devices} needs a group of {cfg.devices} ranks: run "
                           f"under torchrun --nproc-per-node {cfg.devices}")
    return device, dist.get_rank() == 0, made


def cmd_reconstruct(args):
    import threading

    from .pipeline.staged import StagedPipeline
    from .utils.events import EventBus

    cfg = _make_cfg(args)
    device, lead, own_group = _join_ranks(args, cfg)
    ws = Path(args.workspace)
    img_dir = ws / "images"
    src = Path(args.image_dir)
    if lead and src.resolve() != img_dir.resolve():
        img_dir.mkdir(parents=True, exist_ok=True)
        for p in sorted(src.iterdir()):
            if p.is_file():
                shutil.copy2(p, img_dir / p.name)

    bus = EventBus()
    last = {}

    def printer():
        q = bus.subscribe()
        while True:
            ev = q.get()
            if ev.progress != last.get(ev.type):
                print(f"[{ev.type}] {ev.progress*100:5.1f}%", file=sys.stderr, flush=True)
                last[ev.type] = ev.progress

    if lead:
        threading.Thread(target=printer, daemon=True).start()
    pipe = StagedPipeline(ws, cfg, bus=bus, force=args.force, device=device)
    if lead:
        print(f"tpusfm_torch: stages on device {pipe.device}"
              + (f", {cfg.devices} ranks" if pipe.device_mesh is not None else ""),
              file=sys.stderr, flush=True)
    pipe.preprocess(focal_prior_px=args.focal)
    scene, report = pipe.sparse()
    if lead:
        print(json.dumps({k: v for k, v in report.items() if k != "engine_log"}, indent=2))
    if args.dense:
        pts, _ = pipe.dense()
        if lead:
            print(f"dense: {len(pts)} points -> {ws/'dense.ply'}")
    if args.mesh:
        verts, faces = pipe.mesh()
        if lead:
            print(f"mesh: {len(verts)} verts / {len(faces)} faces -> {ws/'mesh.ply'}")
    if own_group:
        import torch.distributed as dist

        dist.destroy_process_group()


def cmd_serve(args):
    from .service.http_server import serve

    cfg = _make_cfg(args)
    device, _, own_group = _join_ranks(args, cfg)
    try:
        serve(args.workspace, cfg, host=args.host, port=args.port, device=device)
    finally:
        if own_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def cmd_export_colmap(args):
    from .io.colmap import export_colmap
    from .pipeline.staged import resolve_device
    from .sfm.scene import load_scene_npz

    scene = load_scene_npz(args.scene, device=resolve_device(args.device))
    out = export_colmap(args.out, scene)
    print(out)


def cmd_bench(args):
    del args
    raise NotImplementedError("the port has no benchmark yet (ROADMAP queue 1 item 1); "
                              "bench.py drives the JAX package")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpusfm_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("reconstruct", help="run the sparse (+dense/mesh) pipeline")
    r.add_argument("image_dir")
    r.add_argument("--workspace", default="./tpusfm_ws")
    r.add_argument("--dense", action="store_true")
    r.add_argument("--mesh", action="store_true")
    _add_cfg_args(r)
    r.set_defaults(fn=cmd_reconstruct)

    s = sub.add_parser("serve", help="start the HTTP service")
    s.add_argument("--workspace", default="./tpusfm_ws")
    s.add_argument("--host", default="localhost")
    s.add_argument("--port", type=int, default=8080)
    _add_cfg_args(s)
    s.set_defaults(fn=cmd_serve)

    b = sub.add_parser("bench", help="not ported yet")
    b.set_defaults(fn=cmd_bench)

    e = sub.add_parser("export-colmap",
                       help="export a reconstructed scene.npz as a COLMAP text model")
    e.add_argument("scene", help="path to scene.npz")
    e.add_argument("--out", default="./colmap_model")
    e.add_argument("--device", default="cuda",
                   help="torch device the scene is read onto (default cuda; cpu for the CPU)")
    e.set_defaults(fn=cmd_export_colmap)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
