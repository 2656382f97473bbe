"""Software rasterizer: ctypes binding to the native C++ z-buffer renderer
(counterpart of foundpose_tpu/renderer/rasterizer.py; cameras are the
port's PinholeCamera, read on the host).

Replaces the reference's pyrender/OpenGL offscreen rasterizer
(reference: utils/renderer.py:30-336). Template rendering is offline, so it
runs on CPU in native code. The port builds its own library from
native/rasterizer.cpp into foundpose_torch/_build/ at first use (never the
JAX package's native/librasterizer.so, which its tests delete and rebuild).
A build or load that fails raises with the compiler's or the loader's
message; only a machine with no C++ compiler and no built library renders
with the vectorized numpy version (~47x slower: 41 vs 1932 ms per 1680x1680
template render), and it warns when it does.

Conventions match the reference: cameras are given as camera->world
(c2w); meshes are registered in model space in millimeters; masks are
depth > 0 (reference: utils/renderer.py:271-296).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import warnings
from typing import Dict, List, Optional

import numpy as np

import torch

from foundpose_torch.data.ply import Mesh
from foundpose_torch.renderer.base import RendererBase, RenderType
from foundpose_torch.structs import PinholeCamera

_SOURCE = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "rasterizer.cpp")
)
BUILD_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "_build"))
# native/Makefile's flags, so both packages' libraries render alike.
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path() -> str:
    """Where the port's library lives: BUILD_DIR, named by a hash of the
    source and the flags, so a changed source builds a new library."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"librasterizer_{digest}.so")


def _bind(path: str):
    lib = ctypes.CDLL(path)
    lib.rasterize_mesh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.rasterize_mesh.restype = None
    return lib


def _load_native():
    """The loaded library, built first when it is missing or not a whole
    library (a file cut short by an interrupted copy). The build runs under
    an flock, compiles to a temporary name and renames it into place, so
    concurrent processes never load a partial file. Returns None only when
    there is neither a library nor a compiler; raises when a build or a
    load fails."""
    path = library_path()
    try:
        return _bind(path)
    except OSError:
        pass  # missing or unloadable: (re)build it below
    cxx = _compiler()
    if cxx is None:
        if os.path.exists(path):
            return _bind(path)  # raises with the loader's message
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "rasterizer.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _bind(path)  # another process built it while this one waited
        except OSError:
            pass
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [cxx, *CXXFLAGS, "-o", tmp, _SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"building the rasterizer failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}"
            )
        os.replace(tmp, path)
    return _bind(path)


# Loaded (and if necessary built) lazily on the first rasterize() call, NOT
# at import time: unrelated importers must not pay the build latency.
# `_NATIVE_TRIED` is set only once a load has succeeded or found neither a
# library nor a compiler; a call that raised leaves it unset, so the next
# call tries again. Tests force the numpy version by setting BOTH
# `_NATIVE = None` and `_NATIVE_TRIED = True`.
_NATIVE = None
_NATIVE_TRIED = False


def _get_native():
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE is None and not _NATIVE_TRIED:
        _NATIVE = _load_native()
        _NATIVE_TRIED = True
        if _NATIVE is None:
            warnings.warn(
                "no C++ compiler and no built rasterizer library: rendering with the "
                "numpy version (~47x slower)", RuntimeWarning, stacklevel=2,
            )
    return _NATIVE


def _host(x, dtype=np.float64) -> np.ndarray:
    """A host array of a camera field (a tensor on any device, or array-like)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def rasterize(
    vertices_cam: np.ndarray,
    faces: np.ndarray,
    colors: Optional[np.ndarray],
    normals_cam: Optional[np.ndarray],
    f: np.ndarray,
    c: np.ndarray,
    width: int,
    height: int,
    shading: int = 1,
    ambient: float = 0.35,
):
    """Rasterizes one mesh in camera space. Returns (color, depth, mask)."""
    vertices_cam = np.ascontiguousarray(vertices_cam, dtype=np.float32)
    faces = np.ascontiguousarray(faces, dtype=np.int32)
    color_buf = np.zeros((height, width, 3), dtype=np.float32)
    depth_buf = np.zeros((height, width), dtype=np.float32)
    mask_buf = np.zeros((height, width), dtype=np.uint8)

    native = _get_native()
    if native is not None:
        colors_p = (
            _fptr(np.ascontiguousarray(colors, dtype=np.float32))
            if colors is not None
            else ctypes.POINTER(ctypes.c_float)()
        )
        normals_p = (
            _fptr(np.ascontiguousarray(normals_cam, dtype=np.float32))
            if normals_cam is not None
            else ctypes.POINTER(ctypes.c_float)()
        )
        native.rasterize_mesh(
            _fptr(vertices_cam), len(vertices_cam),
            faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
            colors_p, normals_p,
            float(f[0]), float(f[1]), float(c[0]), float(c[1]),
            width, height, shading, float(ambient),
            _fptr(color_buf), _fptr(depth_buf),
            mask_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return color_buf, depth_buf, mask_buf

    # ---- numpy fallback (slow; per-face loop with vectorized pixels) ----
    zbuf = np.full((height, width), np.inf, dtype=np.float32)
    v = vertices_cam
    valid_faces = (v[faces][:, :, 2] > 1e-6).all(axis=1)
    proj = v[:, :2] / v[:, 2:3] * f + c
    if colors is None:
        colors = np.full((len(v), 3), 0.5, dtype=np.float32)
    if normals_cam is None:
        e1 = v[faces[:, 1]] - v[faces[:, 0]]
        e2 = v[faces[:, 2]] - v[faces[:, 0]]
        fn = np.cross(e1, e2)
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    for fi in np.nonzero(valid_faces)[0]:
        tri = faces[fi]
        u = proj[tri]
        area = (u[1, 0] - u[0, 0]) * (u[2, 1] - u[0, 1]) - (u[2, 0] - u[0, 0]) * (
            u[1, 1] - u[0, 1]
        )
        if abs(area) < 1e-12:
            continue
        xmin = max(0, int(np.floor(u[:, 0].min())))
        xmax = min(width - 1, int(np.ceil(u[:, 0].max())))
        ymin = max(0, int(np.floor(u[:, 1].min())))
        ymax = min(height - 1, int(np.ceil(u[:, 1].max())))
        if xmin > xmax or ymin > ymax:
            continue
        xs, ys = np.meshgrid(np.arange(xmin, xmax + 1), np.arange(ymin, ymax + 1))
        w0 = ((u[1, 0] - xs) * (u[2, 1] - ys) - (u[2, 0] - xs) * (u[1, 1] - ys)) / area
        w1 = ((u[2, 0] - xs) * (u[0, 1] - ys) - (u[0, 0] - xs) * (u[2, 1] - ys)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        iz = (
            w0 / v[tri[0], 2] + w1 / v[tri[1], 2] + w2 / v[tri[2], 2]
        )
        z = 1.0 / np.maximum(iz, 1e-20)
        sub_z = zbuf[ymin : ymax + 1, xmin : xmax + 1]
        closer = inside & (z < sub_z)
        if not closer.any():
            continue
        a0 = w0 / v[tri[0], 2] * z
        a1 = w1 / v[tri[1], 2] * z
        a2 = w2 / v[tri[2], 2] * z
        if normals_cam is not None:
            n = (
                a0[..., None] * normals_cam[tri[0]]
                + a1[..., None] * normals_cam[tri[1]]
                + a2[..., None] * normals_cam[tri[2]]
            )
        else:
            n = np.broadcast_to(fn[fi], z.shape + (3,))
        pt = (
            a0[..., None] * v[tri[0]]
            + a1[..., None] * v[tri[1]]
            + a2[..., None] * v[tri[2]]
        )
        view = -pt / np.maximum(np.linalg.norm(pt, axis=-1, keepdims=True), 1e-20)
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        lambert = np.abs(np.sum(n * view, axis=-1))
        shade = (
            np.minimum(1.0, ambient + (1 - ambient) * lambert)
            if shading == 1
            else np.ones_like(z)
        )
        col = (
            a0[..., None] * colors[tri[0]]
            + a1[..., None] * colors[tri[1]]
            + a2[..., None] * colors[tri[2]]
        ) * shade[..., None]
        sub_c = color_buf[ymin : ymax + 1, xmin : xmax + 1]
        sub_d = depth_buf[ymin : ymax + 1, xmin : xmax + 1]
        sub_m = mask_buf[ymin : ymax + 1, xmin : xmax + 1]
        sub_z[closer] = z[closer]
        sub_c[closer] = col[closer]
        sub_d[closer] = z[closer]
        sub_m[closer] = 1
    return color_buf, depth_buf, mask_buf


class SoftwareRasterizer(RendererBase):
    """Per-object mesh registry + camera-space rasterization.

    (reference analog: utils/renderer.py PyrenderRasterizer; meshes are cached
    per object like the reference's scene cache, renderer.py:43,99-125)
    """

    def __init__(self, shading: int = 1, ambient: float = 0.35):
        self._meshes: Dict[int, Mesh] = {}
        self.shading = shading
        self.ambient = ambient

    def add_object_model(self, obj_id: int, mesh: Mesh) -> None:
        self._meshes[obj_id] = mesh

    def render_object_model(
        self,
        obj_id: int,
        camera_model_c2w: PinholeCamera,
        render_types: Optional[List[RenderType]] = None,
        background: float = 0.0,
        T_model_to_world: Optional[np.ndarray] = None,
    ) -> Dict[RenderType, np.ndarray]:
        mesh = self._meshes[obj_id]
        t_c2w = _host(camera_model_c2w.T_world_from_eye)
        t_w2c = np.linalg.inv(t_c2w)
        if T_model_to_world is not None:
            t_w2c = t_w2c @ np.asarray(T_model_to_world, dtype=np.float64)
        verts_cam = (mesh.vertices @ t_w2c[:3, :3].T) + t_w2c[:3, 3]
        normals_cam = (
            mesh.normals @ t_w2c[:3, :3].T if mesh.normals is not None else None
        )
        colors = (
            mesh.colors.astype(np.float32) / 255.0 if mesh.colors is not None else None
        )
        color, depth, mask = rasterize(
            verts_cam,
            mesh.faces,
            colors,
            normals_cam,
            _host(camera_model_c2w.f, np.float32),
            _host(camera_model_c2w.c, np.float32),
            camera_model_c2w.width,
            camera_model_c2w.height,
            shading=self.shading,
            ambient=self.ambient,
        )
        if background != 0.0:
            color = np.where(mask[..., None] > 0, color, background)
        out = {
            RenderType.COLOR: color,
            RenderType.DEPTH: depth,
            RenderType.MASK: mask,
        }
        if render_types:
            out = {k: v for k, v in out.items() if k in render_types}
        return out
