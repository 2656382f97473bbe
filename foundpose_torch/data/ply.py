"""Minimal PLY mesh IO (ASCII + binary little-endian): a copy of the
numpy-only foundpose_tpu/data/ply.py, which the port may not import.

Replaces the reference's dependency on bop_toolkit's inout.load_ply /
trimesh (reference: scripts/infer.py:249-251, utils/renderer.py:9). Supports
the BOP model format: vertex positions, normals, colors, texture coords, and
triangular faces.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray  # [V, 3] float32
    faces: Optional[np.ndarray] = None  # [F, 3] int32
    normals: Optional[np.ndarray] = None  # [V, 3]
    colors: Optional[np.ndarray] = None  # [V, 3] uint8
    texcoords: Optional[np.ndarray] = None  # [V, 2]

    def mean_color(self) -> np.ndarray:
        """Average vertex color in [0, 1] (grey fallback).

        (reference helper: utils/renderer_base.py:16-29)
        """
        if self.colors is None:
            return np.array([0.5, 0.5, 0.5], dtype=np.float32)
        return self.colors.astype(np.float32).mean(axis=0) / 255.0


def load_ply(path: str) -> Mesh:
    with open(path, "rb") as f:
        # ---- header ----
        line = f.readline().decode("ascii").strip()
        if line != "ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype or list-spec)])
        current = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("comment") or line.startswith("obj_info") or not line:
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                current = (name, int(count), [])
                elements.append(current)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    current[2].append((parts[4], ("list", parts[2], parts[3])))
                else:
                    current[2].append((parts[2], parts[1]))
            elif line == "end_header":
                break

        verts = faces = None
        normals = colors = texcoords = None

        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().decode("ascii").split() for _ in range(count)]
                data = _parse_ascii(rows, props)
            else:
                data = _parse_binary(f, count, props, fmt)
            if name == "vertex":
                verts = np.stack(
                    [data["x"], data["y"], data["z"]], axis=-1
                ).astype(np.float32)
                if "nx" in data:
                    normals = np.stack(
                        [data["nx"], data["ny"], data["nz"]], axis=-1
                    ).astype(np.float32)
                if "red" in data:
                    colors = np.stack(
                        [data["red"], data["green"], data["blue"]], axis=-1
                    ).astype(np.uint8)
                if "texture_u" in data:
                    texcoords = np.stack(
                        [data["texture_u"], data["texture_v"]], axis=-1
                    ).astype(np.float32)
            elif name == "face":
                key = "vertex_indices" if "vertex_indices" in data else "vertex_index"
                faces = np.asarray(data[key], dtype=np.int32)

    return Mesh(vertices=verts, faces=faces, normals=normals, colors=colors,
                texcoords=texcoords)


def _parse_ascii(rows, props):
    data: Dict[str, list] = {p[0]: [] for p in props}
    for row in rows:
        i = 0
        for pname, ptype in props:
            if isinstance(ptype, tuple):  # list property
                n = int(row[i])
                data[pname].append([float(v) for v in row[i + 1 : i + 1 + n]])
                i += 1 + n
            else:
                data[pname].append(float(row[i]))
                i += 1
    return {k: np.asarray(v) for k, v in data.items()}


def _parse_binary(f, count, props, fmt):
    endian = "<" if "little" in fmt else ">"
    all_scalar = all(not isinstance(p[1], tuple) for p in props)
    if all_scalar:
        dt = np.dtype([(p[0], endian + _PLY_TYPES[p[1]]) for p in props])
        arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
        return {p[0]: np.ascontiguousarray(arr[p[0]]) for p in props}
    # Mixed/list properties: assume the common BOP face layout
    # (uchar count + int indices, constant count). Parse row-wise.
    data: Dict[str, list] = {p[0]: [] for p in props}
    for _ in range(count):
        for pname, ptype in props:
            if isinstance(ptype, tuple):
                _, cnt_t, val_t = ptype
                n = int(
                    np.frombuffer(
                        f.read(np.dtype(_PLY_TYPES[cnt_t]).itemsize),
                        dtype=endian + _PLY_TYPES[cnt_t],
                    )[0]
                )
                vals = np.frombuffer(
                    f.read(np.dtype(_PLY_TYPES[val_t]).itemsize * n),
                    dtype=endian + _PLY_TYPES[val_t],
                )
                data[pname].append(vals)
            else:
                v = np.frombuffer(
                    f.read(np.dtype(_PLY_TYPES[ptype]).itemsize),
                    dtype=endian + _PLY_TYPES[ptype],
                )[0]
                data[pname].append(v)
    return {k: np.asarray(v) for k, v in data.items()}


def save_ply(path: str, mesh: Mesh) -> None:
    """ASCII PLY writer (used for error point-cloud exports, as the reference's
    vis_util.py:78-124 PLY dumps)."""
    v = mesh.vertices
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(v)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if mesh.colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        if mesh.faces is not None:
            f.write(f"element face {len(mesh.faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for i in range(len(v)):
            row = f"{v[i,0]} {v[i,1]} {v[i,2]}"
            if mesh.colors is not None:
                c = mesh.colors[i]
                row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(row + "\n")
        if mesh.faces is not None:
            for face in mesh.faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n")
