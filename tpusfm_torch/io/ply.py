"""PLY point-cloud / mesh I/O and an ASCII PCD writer.

Port of ``tpusfm/io/ply.py``, a numpy copy: binary little-endian by default
(dense clouds are large), ASCII for debugging, non-finite points dropped,
camera centres appended in green; a minimal reader handles both formats.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

CAMERA_COLOR = np.array([0, 255, 0], dtype=np.uint8)  # green, SfMPlyHelper.hpp:106


def write_ply_points(
    path: str | Path,
    points: np.ndarray,
    colors: np.ndarray | None = None,
    camera_centers: np.ndarray | None = None,
    binary: bool = True,
) -> int:
    """Write a point cloud; drops non-finite points (NaN guard parity with
    WorldStructure.h:93 ``ensure(isNormal(...))`` — but graceful, not a crash).

    Returns the number of vertices written."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    finite = np.isfinite(points).all(axis=1)
    points = points[finite]
    if colors is not None:
        colors = np.asarray(colors).reshape(-1, 3)[finite].astype(np.uint8)
    else:
        colors = np.full((len(points), 3), 255, dtype=np.uint8)
    if camera_centers is not None and len(camera_centers):
        cc = np.asarray(camera_centers, dtype=np.float32).reshape(-1, 3)
        cc = cc[np.isfinite(cc).all(axis=1)]
        points = np.concatenate([points, cc], axis=0)
        colors = np.concatenate([colors, np.tile(CAMERA_COLOR, (len(cc), 1))], axis=0)

    n = len(points)
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        "ply\n"
        f"format {fmt} 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if binary:
        rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
        rec["xyz"] = points
        rec["rgb"] = colors
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(rec.tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            for p, c in zip(points, colors):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
    return n


def read_ply_points(path: str | Path):
    """Minimal PLY reader for vertex x/y/z (+ optional u8 rgb).  Handles the
    ascii and binary_little_endian files this package writes, plus common
    float/uchar property layouts (the reference's stub loader is
    DenseBuilder.h:23-52)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", "replace")
    body = data[end:]
    fmt = "ascii"
    n = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            props.append((parts[1], parts[2]))

    type_map = {
        "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
        "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
        "short": "<i2", "ushort": "<u2", "int": "<i4", "uint": "<u4",
        "int32": "<i4", "uint32": "<u4",
    }
    if fmt == "ascii":
        rows = np.loadtxt(body.decode("ascii").splitlines()[: n], ndmin=2)
        names = [p[1] for p in props]
        cols = {nm: rows[:, i] for i, nm in enumerate(names)}
    else:
        dtype = np.dtype([(nm, type_map[t]) for t, nm in props])
        rec = np.frombuffer(body[: n * dtype.itemsize], dtype=dtype)
        cols = {nm: rec[nm] for _, nm in props}
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1).astype(np.float32)
    if all(k in cols for k in ("red", "green", "blue")):
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]], axis=-1).astype(np.uint8)
    else:
        rgb = None
    return xyz, rgb


def write_pcd_points(path: str | Path, points: np.ndarray, colors: np.ndarray | None = None) -> int:
    """ASCII PCD writer (parity: WorldStructure::writeToPCDFile,
    src/world/WorldStructure.h:66-81) with the same NaN guard."""
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    finite = np.isfinite(points).all(axis=1)
    points = points[finite]
    if colors is not None:
        colors = np.asarray(colors).reshape(-1, 3)[finite].astype(np.uint32)
        rgb = (colors[:, 0] << 16) | (colors[:, 1] << 8) | colors[:, 2]
    n = len(points)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        fields = "x y z rgb" if colors is not None else "x y z"
        counts = "1 1 1 1" if colors is not None else "1 1 1"
        types = "F F F U" if colors is not None else "F F F"
        sizes = "4 4 4 4" if colors is not None else "4 4 4"
        f.write(
            "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
            f"FIELDS {fields}\nSIZE {sizes}\nTYPE {types}\nCOUNT {counts}\n"
            f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n"
        )
        for i, p in enumerate(points):
            if colors is not None:
                f.write(f"{p[0]} {p[1]} {p[2]} {rgb[i]}\n")
            else:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
    return n


def write_ply_mesh(
    path: str | Path,
    vertices: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray | None = None,
) -> None:
    """Binary PLY triangle mesh writer (for the mesh stage artifacts, parity
    with the OpenMVS mesh PLY outputs consumed at src/main.cpp:180-189)."""
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    has_color = colors is not None
    header = [
        "ply", "format binary_little_endian 1.0",
        f"element vertex {len(vertices)}",
        "property float x", "property float y", "property float z",
    ]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "end_header", "",
    ]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        if has_color:
            rec = np.zeros(len(vertices), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = vertices
            rec["rgb"] = np.asarray(colors).reshape(-1, 3).astype(np.uint8)
        else:
            rec = np.zeros(len(vertices), dtype=[("xyz", "<f4", 3)])
            rec["xyz"] = vertices
        f.write(rec.tobytes())
        frec = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        frec["n"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())
