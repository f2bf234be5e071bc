"""File-staged, resumable pipeline workspace (port of
``tpusfm/pipeline/staged.py``).

Every stage persists its output and later stages reload it, so re-running a
stage resumes from the last artifact.  The workspace holds the reference's
files under the reference's names, in the same formats, so either package
resumes the other's workspace:

  workspace/
    images/                  uploaded/source images
    views.json               image records + focal priors
    config.json              pipeline config dump
    features.npz             keypoints, descriptors, scores, masks
    matches_putative.npz     pair list + ratio-test matches
    matches_geometric.npz    RANSAC-verified matches + kept pairs
    scene.npz                the sparse scene
    colmap/                  COLMAP text model of the scene
    cloud_and_poses.ply      sparse cloud + camera markers
    colorized.ply / .pcd     colorized sparse cloud
    report.json / .html      reconstruction report; viewer.html
    dense.ply, depth_maps.npz, undistorted_images/   dense stage
    mesh.ply, textured_mesh.{obj,mtl,png}            mesh stage

Stages run on the pipeline's device (``"cuda"`` unless the caller asks for
the CPU; no CUDA device is an error, not a CPU run).  Random draws come from
one ``torch.Generator`` on that device, seeded from ``seed``, as in
``run_sparse``.  The images, geo-registration and the report are host work.

With ``cfg.devices = N`` the process is one of N ranks
(``pipeline.sparse.get_mesh``): the sparse and dense stages split their
matching, large BAs and depth maps over the ranks, every rank computes the
same result, and only rank 0 writes the workspace, so no two processes
write one file.  Each stage starts and ends with a barrier, and the next
stage starts after rank 0's files are written.  What a stage finds in the
workspace (features, match tables, a scene to resume from) is what rank 0
saw, broadcast before it writes anything.  Features are detected by rank 0
alone, and the mesh stage (no sharded part) runs on rank 0 alone; the
ranks that wait on such work, and on rank 0's writes, wait up to
``parallel.mesh.WAIT_S``, not a collective's timeout, and learn whether it
raised, so that an error there is raised by every rank alike.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..features import sift
from ..io import images as im_io
from ..io import ply
from ..parallel import mesh as mesh_mod
from ..sfm import scene as scene_mod
from ..utils.events import EventBus
from . import sparse as sp
from .config import PipelineConfig


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device with no CUDA available
    raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA is not available; "
                           f"pass device='cpu' to run on the CPU")
    return device


def _no_tf32() -> None:
    """float32 matrix products and convolutions in full float32 (the SIFT
    blur would otherwise run in TF32 on the card and move extrema)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class StagedPipeline:
    """Workspace-backed pipeline with stage skip-if-done semantics
    (the reference's ``!bForce && is_regular_file`` pattern,
    sparseBuilder.cpp:700)."""

    def __init__(self, workspace: str | Path, cfg: PipelineConfig = PipelineConfig(),
                 bus: EventBus | None = None, force: bool = False, *, device="cuda",
                 seed: int = 0):
        self.device = resolve_device(device)
        self.seed = seed
        self.ws = Path(workspace)
        self.cfg = cfg
        self.device_mesh = sp.get_mesh(cfg, self.device)
        # Rank 0 alone writes the workspace; the others wait on it in the
        # stages' barriers.
        self.writer = self.device_mesh is None or self.device_mesh.rank == 0
        self._waiting = (None if self.device_mesh is None
                         else mesh_mod.waiting_group(self.device_mesh))
        self.bus = bus or EventBus()
        self.force = force
        self.progress = self.bus.progress_fn()
        if self.writer:
            self.ws.mkdir(parents=True, exist_ok=True)
            (self.ws / "images").mkdir(exist_ok=True)
            (self.ws / "config.json").write_text(cfg.to_json())

    # -- helpers -----------------------------------------------------------

    def _done(self, name: str) -> bool:
        return not self.force and (self.ws / name).exists()

    def image_dir(self) -> Path:
        return self.ws / "images"

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _rank0_sees(self, *flags: bool) -> list[bool]:
        """`flags` as rank 0 computed them, on every rank."""
        if self.device_mesh is None:
            return list(flags)
        return mesh_mod.broadcast_flags(self.device_mesh, flags)

    def _rank0_alone(self, fn):
        """fn() on rank 0 alone (work no other rank shares: features, the
        mesh stage, the workspace's files), its result there and None on
        the other ranks, which wait for it on the waiting group and raise
        when it raised: a failure there is then one that every rank raises
        and the ranks stay in step."""
        if self._waiting is None:
            return fn()
        out, err = None, None
        if self.writer:
            try:
                out = fn()
            except Exception as e:
                err = e
        ok = mesh_mod.broadcast_ints(self.device_mesh, [err is None], group=self._waiting)[0]
        if err is not None:
            raise err
        if not ok:
            raise RuntimeError("rank 0 raised in work it does alone (see its error)")
        return out

    @contextlib.contextmanager
    def _stage(self):
        """Brackets a stage with a barrier of the ranks at each end."""
        if self._waiting is not None:
            dist.barrier(group=self._waiting)
        yield
        if self._waiting is not None:
            dist.barrier(group=self._waiting)

    # -- stage 1: preprocessing (ingest + features) ------------------------

    def preprocess(self, focal_prior_px: float | None = None):
        """~ preload(): readImagesCluster + detectFeature (main.cpp:120-129)."""
        with self._stage():
            return self._preprocess(focal_prior_px)

    def _preprocess(self, focal_prior_px):
        _no_tf32()
        self.progress("preprocessing", 0.0)
        paths = im_io.list_images(self.image_dir())
        if not paths:
            raise FileNotFoundError(f"no images in {self.image_dir()}")
        records = [
            im_io.read_image_record(
                p, focal_prior_px=focal_prior_px or self.cfg.focal_prior_px
            )
            for p in paths
        ]
        self._rank0_alone(lambda: self._write_views_and_features(paths, records))
        self.progress("preprocessing", 1.0)
        return records

    def _write_views_and_features(self, paths, records) -> None:
        (self.ws / "views.json").write_text(json.dumps(
            [dataclasses.asdict(r) for r in records], indent=2
        ))
        self.progress("preprocessing", 0.5)
        if self._done("features.npz"):
            return
        images = im_io.load_images_gray(paths)
        # Optional feature masks (parity: sparseBuilder.cpp:706-739):
        # a global mask.png applies to every view; a per-image
        # <stem>_mask.png overrides it.
        masks = None
        global_mask = self.image_dir() / "mask.png"
        per_image = [p.with_name(p.stem + "_mask.png") for p in paths]
        if global_mask.exists() or any(m.exists() for m in per_image):
            H, W = images.shape[1:3]
            gm = None
            if global_mask.exists():
                gm = im_io.load_images_gray([global_mask])[0]
            masks = np.ones((len(paths), H, W), np.float32)
            for k, m in enumerate(per_image):
                if m.exists():
                    masks[k] = im_io.load_images_gray([m])[0]
                elif gm is not None:
                    masks[k] = gm
        feats = sp.detect_features(images, self.cfg, self.progress, masks=masks,
                                   device=self.device)
        np.savez_compressed(
            self.ws / "features.npz",
            **{f: getattr(feats, f).cpu().numpy() for f in ("kp", "desc", "score", "mask")},
        )

    def _load_features(self) -> sift.Features:
        with np.load(self.ws / "features.npz") as d:
            return sift.Features(**{f: torch.as_tensor(d[f], device=self.device)
                                    for f in ("kp", "desc", "score", "mask")})

    def _load_views(self):
        return json.loads((self.ws / "views.json").read_text())

    def _intrinsics(self) -> np.ndarray:
        views = self._load_views()
        intr = []
        for v in views:
            intr.append([v["focal_px"], v["focal_px"], v["width"] / 2, v["height"] / 2, 0, 0, 0])
        return np.asarray(intr, np.float32)

    def _intrinsic_groups(self) -> np.ndarray:
        """Shared-intrinsics group id per view (GroupSharedIntrinsics
        parity, sparseBuilder.cpp:554-556): views from the same physical
        camera (same EXIF make/model, dimensions and focal prior) share one
        self-calibrating BA intrinsic block; distortion starts at zero and
        is refined (RADIAL3 ADJUST_ALL)."""
        views = self._load_views()
        keys = {}
        groups = []
        for v in views:
            key = (v.get("camera_model"), v["width"], v["height"],
                   round(float(v["focal_px"]), 1))
            groups.append(keys.setdefault(key, len(keys)))
        return np.asarray(groups, np.int32)

    # -- stage 2: sparse ---------------------------------------------------

    def sparse(self, generator: torch.Generator | None = None):
        """~ sparseWork(): matchPair + match + filter + reconstruction +
        colorize (main.cpp:131-146).  Random draws come from `generator`
        (a torch.Generator on the pipeline's device), made from the
        pipeline's seed when none is given."""
        with self._stage():
            return self._sparse(generator)

    def _sparse(self, generator):
        t0 = time.time()
        _no_tf32()
        # What the workspace holds, as rank 0 saw it before writing anything.
        have_features, have_putative, have_geometric, have_scene = self._rank0_sees(
            (self.ws / "features.npz").exists(), self._done("matches_putative.npz"),
            self._done("matches_geometric.npz"), self._done("scene.npz"))
        if not have_features:
            self.preprocess()
        feats = self._load_features()
        intr = self._intrinsics()
        V = intr.shape[0]
        views = self._load_views()
        img_hw = (views[0]["height"], views[0]["width"])
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.seed)

        if have_putative:
            d = np.load(self.ws / "matches_putative.npz")
            pair_list, mi, mv = d["pairs"], d["idx"], d["valid"]
        else:
            pair_list = sp.generate_pairs(V, self.cfg, feats=feats)
            mi, mv = sp.match_pairs(feats, pair_list, self.cfg, self.progress,
                                    mesh=self.device_mesh)
        if not have_putative:
            self._rank0_alone(lambda: self._write_putative(V, pair_list, mi, mv))
        if have_geometric:
            d = np.load(self.ws / "matches_geometric.npz")
            pair_list, mi, mv, pair_ok = d["pairs"], d["idx"], d["valid"], d["pair_ok"]
        else:
            mi, mv, pair_ok = sp.filter_pairs(feats, pair_list, mi, mv, self.cfg, generator,
                                              self.progress, intr=intr, img_hw=img_hw)
        if not have_geometric:
            self._rank0_alone(lambda: self._write_geometric(V, pair_list, mi, mv, pair_ok))

        # Reconstruction with EXIF-identity shared-intrinsic groups, so BA
        # self-calibrates when cfg.self_calibrate.  A previous scene.npz
        # seeds the engine (EXISTING_POSES, sparseBuilder.cpp:188-193): only
        # unregistered views are resected on a re-run.
        init_scene = None
        if have_scene:
            try:
                prev = scene_mod.load_scene_npz(str(self.ws / "scene.npz"), device=self.device)
                if int(prev.cam_mask.sum()) >= 2:
                    init_scene = prev
            except Exception:
                init_scene = None
        scene, engine = sp.reconstruct(
            feats, intr, pair_list[pair_ok], mi[pair_ok], mv[pair_ok],
            self.cfg, generator, self.progress, cam_group=self._intrinsic_groups(),
            mesh=self.device_mesh, init_scene=init_scene,
        )
        # colorize (~ colorize(), sparseBuilder.cpp:1601)
        paths = im_io.list_images(self.image_dir())
        rgb = im_io.load_images_rgb(paths)
        scene = engine.colorize(scene, rgb)

        # GPS geo-registration (getGPS pose priors, sparseBuilder.cpp:
        # 112-171): with >= 3 GPS-tagged registered views, similarity-align
        # into the local ENU metric frame, then BA again with soft
        # camera-centre priors at the fixes (ViewPriors, .cpp:506-533).
        geo_info = None
        gps_list = [tuple(v["gps"]) if v.get("gps") else None for v in views]
        if sum(g is not None for g in gps_list) >= 3:
            from ..utils import geo

            try:
                scene, geo_info = geo.georegister_scene(scene, gps_list)
                scene, prior_info = geo.gps_prior_ba(scene, gps_list)
                if prior_info is not None:
                    geo_info = {**geo_info, "prior_ba": prior_info}
                self.progress("sparse", 0.95, geo_rms_m=geo_info["rms_m"])
            except ValueError as e:
                self.progress("sparse", 0.95, warning=f"geo-registration: {e}")

        report = self._sparse_report(scene, engine, V, geo_info, t0)
        self._rank0_alone(lambda: self._write_sparse(scene, rgb, paths, report))
        self.progress("done", 1.0, n_points=report["n_points"])
        return scene, report

    def _write_putative(self, V, pair_list, mi, mv) -> None:
        from ..io import reports

        np.savez_compressed(self.ws / "matches_putative.npz", pairs=pair_list, idx=mi, valid=mv)
        # Diagnostics parity (.cpp:1010-1019): adjacency SVG + stats.
        counts = mv.sum(axis=1)
        reports.write_adjacency_svg(self.ws / "putative_matches.svg", V, pair_list, counts)
        (self.ws / "putative_graph_stats.json").write_text(
            json.dumps(reports.graph_stats(V, pair_list, counts))
        )

    def _write_geometric(self, V, pair_list, mi, mv, pair_ok) -> None:
        from ..io import reports

        np.savez_compressed(self.ws / "matches_geometric.npz",
                            pairs=pair_list, idx=mi, valid=mv, pair_ok=pair_ok)
        # Diagnostics parity (.cpp:1249-1269).
        counts = mv.sum(axis=1)
        reports.write_adjacency_svg(self.ws / "geometric_matches.svg", V, pair_list, counts)
        reports.write_graphviz(self.ws / "geometric_matches.dot", pair_list, counts)
        (self.ws / "geometric_graph_stats.json").write_text(
            json.dumps(reports.graph_stats(V, pair_list, counts))
        )

    def _sparse_report(self, scene, engine, V, geo_info, t0) -> dict:
        reg = scene.cam_mask.cpu().numpy()
        pm = scene.point_mask.cpu().numpy()
        obs_mask = scene.obs_mask.cpu().numpy()
        self.sync()
        return {
            "n_views": int(V),
            "n_registered": int(reg.sum()),
            "n_points": int(pm.sum()),
            "n_obs": int(obs_mask.sum()),
            "mean_reproj_px": float(
                scene.reprojection_errors().cpu().numpy()[obs_mask].mean()
            ) if obs_mask.any() else None,
            "elapsed_s": round(time.time() - t0, 2),
            "engine_log": engine.log,
            "geo": geo_info,
            "device": str(self.device),
            "recon_phase_s": {k: round(v, 3) for k, v in sorted(engine.timings.items())},
            "ba_solves": dict(Counter(f"{kind} {c}x{p}x{o}" for kind, c, p, o in engine.ba_solves)),
        }

    def _write_sparse(self, scene, rgb, paths, report) -> None:
        """The sparse stage's files: scene.npz, the COLMAP model, the PLY and
        PCD clouds, the viewer and the report."""
        from ..io import reports

        scene_mod.save_scene_npz(str(self.ws / "scene.npz"), scene)
        # External-tool interchange (~ DenseBuilder::save -> .mvs,
        # DenseBuilder.h:54-146): the COLMAP text model.
        from ..io import colmap

        try:
            sizes = np.array([[im.shape[1], im.shape[0]] for im in rgb]) \
                if len(rgb) == scene.max_cams else None
            colmap.export_colmap(self.ws / "colmap", scene,
                                 [p.name for p in paths], image_sizes=sizes)
        except Exception as e:  # interchange is auxiliary: never fail sparse
            self.progress("sparse", 1.0, warning=f"colmap export failed: {e}")
        reg = scene.cam_mask.cpu().numpy()
        pm = scene.point_mask.cpu().numpy()
        points = scene.points.cpu().numpy()[pm]
        colors = scene.colors.cpu().numpy()[pm]
        centers = scene.camera_centers().cpu().numpy()[reg]
        ply.write_ply_points(self.ws / "cloud_and_poses.ply", points, camera_centers=centers)
        ply.write_ply_points(self.ws / "colorized.ply", points, colors)
        ply.write_pcd_points(self.ws / "colorized.pcd", points, colors)
        # Interactive inspection artifact (WorldStructure::show,
        # src/world/WorldStructure.h:108-155), served at /files/viewer.html.
        from ..io import viewer as viewer_mod

        try:
            viewer_mod.write_scene_viewer(self.ws / "viewer.html", scene)
        except Exception as e:
            self.progress("sparse", 1.0, warning=f"viewer write failed: {e}")
        (self.ws / "report.json").write_text(json.dumps(report, indent=2))
        reports.write_html_report(
            self.ws / "report.html", report,
            [str(self.ws / "putative_matches.svg"), str(self.ws / "geometric_matches.svg")],
        )

    def load_scene(self):
        return scene_mod.load_scene_npz(str(self.ws / "scene.npz"), device=self.device)

    # -- stage 3/4: dense + mesh -------------------------------------------

    def dense(self):
        """~ denseWork() (main.cpp:148-166): depth maps + fused cloud."""
        with self._stage():
            return self._dense()

    def _dense(self):
        from ..dense import depth as dense_depth

        scene = self.load_scene()
        paths = im_io.list_images(self.image_dir())
        images = im_io.load_images_gray(paths)
        rgb = im_io.load_images_rgb(paths)
        # Undistort to ideal pinhole before MVS, like the reference's
        # `openMVG2openMVS -d undistorted_images` export (main.cpp:157-158).
        intr_np = scene.intr.cpu().numpy()
        if np.abs(intr_np[:, 4:7]).max() > 1e-12:
            from ..ops.image import undistort_image

            und_dir = self.ws / "undistorted_images"
            if self.writer:
                und_dir.mkdir(exist_ok=True)
            g_list, c_list = [], []
            for i in range(len(images)):
                it = torch.as_tensor(intr_np[min(i, len(intr_np) - 1)], device=self.device)
                g = torch.as_tensor(images[i], device=self.device)
                c = torch.as_tensor(rgb[i], dtype=torch.float32, device=self.device)
                g_list.append(undistort_image(g, it).cpu().numpy())
                cu = undistort_image(c, it).cpu().numpy()
                c_list.append(np.clip(cu, 0, 255).astype(np.uint8))
                if not self.writer:
                    continue
                try:
                    from PIL import Image as _PILImage

                    _PILImage.fromarray(c_list[-1]).save(und_dir / paths[i].name)
                except Exception:
                    pass
            images = np.stack(g_list)
            rgb = np.stack(c_list)
            intr_np = intr_np.copy()
            intr_np[:, 4:7] = 0.0
            scene = scene.replace(intr=torch.as_tensor(intr_np, device=self.device))
        pts, cols, maps = dense_depth.dense_reconstruct(
            scene, images, rgb, cfg=self.cfg.dense, progress=self.progress,
            return_maps=True, seed=self.seed, mesh=self.device_mesh,
            device=self.device,
        )
        self._rank0_alone(lambda: self._write_dense(scene, pts, cols, maps))
        self.progress("dense", 1.0, n_points=int(len(pts)))
        return pts, cols

    def _write_dense(self, scene, pts, cols, maps) -> None:
        ply.write_ply_points(self.ws / "dense.ply", pts, cols)
        np.savez_compressed(self.ws / "depth_maps.npz", **maps)
        # Refresh the viewer with the dense cloud.
        from ..io import viewer as viewer_mod

        try:
            reg_m = scene.cam_mask.cpu().numpy()
            viewer_mod.write_viewer_html(
                self.ws / "viewer.html", pts, cols,
                cam_rotations=scene.rotations().cpu().numpy()[reg_m],
                cam_centers=scene.camera_centers().cpu().numpy()[reg_m],
                title="tpusfm dense reconstruction")
        except Exception as e:
            self.progress("dense", 1.0, warning=f"viewer write failed: {e}")

    def mesh(self):
        """~ meshWork() (main.cpp:168-193): TSDF + marching tetrahedra from
        the dense stage's depth maps (falls back to the point cloud).  With a
        mesh of ranks, rank 0 alone runs it; the others return (None, None)
        (and raise when it raised)."""
        with self._stage():
            out = self._rank0_alone(self._mesh)
        return out if self.writer else (None, None)

    def _mesh(self):
        from ..dense import meshing

        paths = im_io.list_images(self.image_dir())
        rgb = im_io.load_images_rgb(paths)
        maps_path = self.ws / "depth_maps.npz"
        if maps_path.exists():
            d = dict(np.load(maps_path))
            verts, faces, vcols = meshing.mesh_from_depths(
                d["depths"], d["valid"], d["K"], d["R"], d["t"],
                rgb_images=rgb, progress=self.progress, device=self.device,
            )
            if len(faces):
                # ~ RefineMesh (main.cpp:184-185): depth-fit + Laplacian,
                # then photometric refinement against the images.
                verts = meshing.refine_mesh(
                    verts, faces, d["depths"], d["valid"], d["K"], d["R"], d["t"]
                )
                gray = np.asarray(rgb, np.float32).mean(axis=-1) / 255.0
                verts = meshing.refine_mesh_photometric(
                    verts, faces, gray, d["K"], d["R"], d["t"],
                    d["depths"], d["valid"], device=self.device,
                )
                # ~ TextureMesh (main.cpp:188-189): OBJ + MTL + atlas PNG.
                from ..dense import texturing

                texturing.texture_mesh(
                    self.ws, verts, faces, d["depths"], d["valid"],
                    d["K"], d["R"], d["t"], rgb, progress=self.progress,
                )
        else:
            xyz, pc_rgb = ply.read_ply_points(self.ws / "dense.ply")
            verts, faces, vcols = meshing.reconstruct_mesh(
                xyz, pc_rgb, progress=self.progress
            )
        ply.write_ply_mesh(self.ws / "mesh.ply", verts, faces, vcols)
        self.progress("mesh", 1.0, n_faces=int(len(faces)))
        return verts, faces
