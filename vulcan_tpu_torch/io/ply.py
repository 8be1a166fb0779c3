"""PLY mesh export: the port's own copy of ``vulcan_tpu/io/ply.py``.

Binary little-endian PLY with per-vertex uchar colours.  The extractor emits
a fixed-capacity triangle soup; the writer optionally welds duplicate
vertices (marching cubes shares every edge vertex between adjacent
triangles) so files are ~6x smaller.  A non-empty mesh is written by the
native runtime's O(n) hash welder (``vulcan_tpu_torch.native.ply_write``,
header comment ``vulcan-tpu mesh (native)``), built at first use; a
failed build raises.  An empty mesh is written by the numpy writer
below.  ``weld_vertices`` (numpy's ``np.unique``, O(n log n)) is a plain
weld that the tests use.

A minimal reader is included for tests and the snapshot/resume path.
"""
from __future__ import annotations

import numpy as np


def weld_vertices(positions: np.ndarray, colors: np.ndarray, decimals: int = 6):
    """Triangle soup (T,3,3) -> (verts (V,3), vert_colors (V,3), faces (T,3))."""
    flat = positions.reshape(-1, 3)
    flat_c = colors.reshape(-1, 3)
    key = np.round(flat, decimals)
    uniq, idx, inv = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    verts = flat[idx]
    vcols = flat_c[idx]
    faces = inv.reshape(-1, 3)
    return verts, vcols, faces


def write_ply(
    path: str,
    positions: np.ndarray,
    colors: np.ndarray | None = None,
    weld: bool = True,
) -> None:
    """Write a triangle mesh.

    ``positions``: (T, 3, 3) triangle soup (world meters).
    ``colors``: matching (T, 3, 3) rgb in [0, 1], optional.
    """
    positions = np.asarray(positions, np.float32)
    if colors is None:
        colors = np.full_like(positions, 0.7)
    colors = np.asarray(colors, np.float32)
    if len(positions):
        from .. import native

        native.ply_write(path, positions, colors, weld=weld)
        return
    # An empty mesh: the numpy writer, as the reference writes it.
    verts = positions.reshape(-1, 3)
    vcols = colors.reshape(-1, 3)
    faces = np.zeros((0, 3), np.int64)

    vcols_u8 = np.clip(vcols * 255.0, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"ply\n")
        f.write(b"format binary_little_endian 1.0\n")
        f.write(b"comment vulcan-tpu mesh\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(
            b"property uchar red\nproperty uchar green\nproperty uchar blue\n"
        )
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        vert_rec = np.zeros(
            len(verts),
            dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)],
        )
        vert_rec["xyz"] = verts
        vert_rec["rgb"] = vcols_u8
        f.write(vert_rec.tobytes())
        face_rec = np.zeros(
            len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)]
        )
        face_rec["n"] = 3
        face_rec["idx"] = faces
        f.write(face_rec.tobytes())


def read_ply(path: str):
    """Minimal reader for files written by ``write_ply``.

    Returns (verts (V,3) f32, colors (V,3) f32 in [0,1], faces (F,3) i32).
    """
    with open(path, "rb") as f:
        assert f.readline().strip() == b"ply"
        n_vert = n_face = 0
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n_vert = int(line.split()[-1])
            elif line.startswith(b"element face"):
                n_face = int(line.split()[-1])
            elif line == b"end_header":
                break
        vert_rec = np.frombuffer(
            f.read(n_vert * 15),
            dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)],
        )
        face_rec = np.frombuffer(
            f.read(n_face * 13), dtype=[("n", "u1"), ("idx", "<i4", 3)]
        )
    return (
        vert_rec["xyz"].copy(),
        vert_rec["rgb"].astype(np.float32) / 255.0,
        face_rec["idx"].copy(),
    )
