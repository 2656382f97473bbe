"""The port's visualisation and renderer against the JAX package's on the
same inputs: every vis/base primitive, the inference tile grid and its
posed-mesh overlays, the error point cloud and the HTML gallery, and the
software rasterizer's colour, depth and mask (native library and numpy
fallback) for one mesh and camera."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)

from foundpose_torch.data.ply import Mesh as TMesh
from foundpose_torch.renderer import base as t_rbase
from foundpose_torch.renderer import rasterizer as t_rast
from foundpose_torch.structs import PinholeCamera as TCamera
from foundpose_torch.vis import base as t_vb
from foundpose_torch.vis import html_report as t_html
from foundpose_torch.vis import inference_vis as t_ivis
from foundpose_tpu.data.ply import Mesh as JMesh
from foundpose_tpu.renderer import base as j_rbase
from foundpose_tpu.renderer import rasterizer as j_rast
from foundpose_tpu.structs import PinholeCamera as JCamera
from foundpose_tpu.vis import base as j_vb
from foundpose_tpu.vis import html_report as j_html
from foundpose_tpu.vis import inference_vis as j_ivis


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    mask = np.zeros((64, 80), np.uint8)
    mask[10:40, 20:60] = 1
    pts = rng.uniform(0, 60, (12, 2))
    return rng, img, mask, pts


PRIMITIVES = {
    "build_grid": lambda m, rng, img, mask, pts: m.build_grid(
        [img, img[:40, :30], mask * 255], cols=2),
    "overlay_mask": lambda m, rng, img, mask, pts: m.overlay_mask(img, mask),
    "overlay_contour": lambda m, rng, img, mask, pts: m.overlay_contour(img, mask),
    "draw_matches": lambda m, rng, img, mask, pts: m.draw_matches(
        img, img[:, ::-1], pts, pts[::-1], rng.uniform(size=len(pts))),
    "write_text": lambda m, rng, img, mask, pts: m.write_text(img, "s1 im2 q=30"),
    "draw_histogram": lambda m, rng, img, mask, pts: m.draw_histogram(
        rng.normal(size=300), bins=16, title="score"),
    "draw_histogram_empty": lambda m, rng, img, mask, pts: m.draw_histogram(np.asarray([])),
    "draw_inliers": lambda m, rng, img, mask, pts: m.draw_inliers(
        img, pts, rng.uniform(size=len(pts)) > 0.5),
    "to_uint8_float": lambda m, rng, img, mask, pts: m.to_uint8(rng.uniform(-0.2, 1.2, (8, 8))),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_vis_primitives_match_jax(name):
    """Each vis/base primitive draws the JAX package's image, pixel for
    pixel, from the same inputs."""
    j = PRIMITIVES[name](j_vb, *_inputs())
    t = PRIMITIVES[name](t_vb, *_inputs())
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def test_inference_tile_grid_matches_jax():
    rng, img, mask, pts = _inputs(1)
    fmap = rng.normal(size=(5, 6, 16)).astype(np.float32)
    args = dict(
        crop_image=img, crop_mask=mask, template_image=img[::-1], corresp_2d=pts,
        corresp_template_2d=pts + 3.0, corresp_scores=rng.uniform(size=len(pts)),
        est_mask=mask[::-1], feature_map=fmap, caption="s1 im0 q=12 score=0.50",
        inlier_mask=rng.uniform(size=len(pts)) > 0.3, pose_overlay=img // 2,
    )
    np.testing.assert_array_equal(t_ivis.vis_inference_results(**args),
                                  j_ivis.vis_inference_results(**args))
    np.testing.assert_array_equal(t_ivis.feature_map_pca_rgb(fmap), j_ivis.feature_map_pca_rgb(fmap))


def _icosahedron(mesh_cls):
    phi = (1 + 5 ** 0.5) / 2
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0], [0, -1, phi],
                  [0, 1, phi], [0, -1, -phi], [0, 1, -phi], [phi, 0, -1], [phi, 0, 1],
                  [-phi, 0, -1], [-phi, 0, 1]], np.float32) * 20.0
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9],
                  [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10],
                  [8, 6, 7], [9, 8, 1]], np.int32)
    colors = np.random.default_rng(7).integers(40, 255, (12, 3)).astype(np.uint8)
    return mesh_cls(vertices=v, faces=f, colors=colors)


def _cameras():
    """The same camera (off-axis, with extrinsics) in both packages."""
    t_c2w = np.eye(4)
    t_c2w[:3, :3] = np.array([[0.96, -0.28, 0.0], [0.28, 0.96, 0.0], [0.0, 0.0, 1.0]])
    t_c2w[:3, 3] = [5.0, -3.0, -40.0]
    j = JCamera.create(f=(110.0, 105.0), c=(47.5, 39.5), width=96, height=80,
                       T_world_from_eye=t_c2w)
    t = TCamera(f=torch.tensor([110.0, 105.0]), c=torch.tensor([47.5, 39.5]),
                T_world_from_eye=torch.tensor(t_c2w, dtype=torch.float32), width=96, height=80)
    return j, t


@pytest.fixture(scope="module")
def makefile_library(tmp_path_factory):
    """The JAX package's library as native/Makefile builds it (its own
    recipe and flags, in a copy of native/), loaded through the JAX
    package's own binding. A copy, because the JAX package's tests delete
    and rebuild native/librasterizer.so while other test processes run, so
    a load of that file could find it half written."""
    native = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
    build = tmp_path_factory.mktemp("native")
    for name in ("Makefile", "rasterizer.cpp"):
        shutil.copy(os.path.join(native, name), build / name)
    env = {k: v for k, v in os.environ.items() if k != "CXXFLAGS"}
    out = subprocess.run(["make", "-C", str(build)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rast, "_LIB_PATHS", [str(build / "librasterizer.so")])
        lib = j_rast._load_native(build=False)
    assert lib is not None
    return lib


@pytest.fixture(params=["native", "numpy"])
def rasterizers(request, monkeypatch):
    """Both packages' rasterizer on its native library (the port's own
    build against native/Makefile's) or, forced, on the numpy fallback."""
    if request.param == "numpy":
        for mod in (j_rast, t_rast):
            monkeypatch.setattr(mod, "_NATIVE", None)
            monkeypatch.setattr(mod, "_NATIVE_TRIED", True)
    else:
        if t_rast._get_native() is None:
            pytest.fail("no C++ compiler: the port's native rasterizer was not built")
        monkeypatch.setattr(j_rast, "_NATIVE", request.getfixturevalue("makefile_library"))
    return request.param


def test_rasterizer_matches_jax(rasterizers):
    """Colour, depth and mask of one mesh under one posed camera."""
    jr = j_rbase.build(j_rbase.RendererType.SOFTWARE_RASTERIZER)
    tr = t_rbase.build(t_rbase.RendererType.SOFTWARE_RASTERIZER)
    jr.add_object_model(3, _icosahedron(JMesh))
    tr.add_object_model(3, _icosahedron(TMesh))
    jcam, tcam = _cameras()
    m2w = np.eye(4)
    m2w[:3, 3] = [0.0, 0.0, 120.0]
    j = jr.render_object_model(3, jcam, T_model_to_world=m2w)
    t = tr.render_object_model(3, tcam, T_model_to_world=m2w)
    for rt in (t_rbase.RenderType.COLOR, t_rbase.RenderType.DEPTH, t_rbase.RenderType.MASK):
        np.testing.assert_array_equal(t[rt], j[j_rbase.RenderType(rt.value)])
    assert t[t_rbase.RenderType.MASK].sum() > 500


def test_pose_overlays_match_jax(rasterizers):
    """render_pose_mask and render_pose_overlay on a crop camera."""
    jr = j_rbase.build(j_rbase.RendererType.SOFTWARE_RASTERIZER)
    tr = t_rbase.build(t_rbase.RendererType.SOFTWARE_RASTERIZER)
    jr.add_object_model(3, _icosahedron(JMesh))
    tr.add_object_model(3, _icosahedron(TMesh))
    jcam, tcam = _cameras()
    r = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    t = np.array([2.0, -1.0, 150.0])
    base = np.random.default_rng(3).integers(0, 256, (80, 96, 3), dtype=np.uint8)
    np.testing.assert_array_equal(t_ivis.render_pose_mask(tr, 3, tcam, r, t),
                                  j_ivis.render_pose_mask(jr, 3, jcam, r, t))
    np.testing.assert_array_equal(t_ivis.render_pose_overlay(tr, 3, tcam, r, t, base),
                                  j_ivis.render_pose_overlay(jr, 3, jcam, r, t, base))


def test_pointcloud_error_and_gallery_match_jax(tmp_path):
    """The error point cloud's PLY bytes; the gallery's HTML apart from its
    title (the port names itself "foundpose report")."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-30, 30, (40, 3)).astype(np.float32)
    r = np.eye(3)
    for mod, name in ((j_ivis, "j.ply"), (t_ivis, "t.ply")):
        mod.vis_pointcloud_error(pts, r, [1.0, 2.0, 503.0], r, [0.0, 0.0, 500.0],
                                 str(tmp_path / name))
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    imgs = [rng.integers(0, 256, (16, 20, 3), dtype=np.uint8) for _ in range(3)]
    recs = [{"score": s} for s in (0.4, 0.9, 0.1)]
    assert t_html.image_to_base64_png(imgs[0]) == j_html.image_to_base64_png(imgs[0])
    for mod, name in ((j_html, "j.html"), (t_html, "t.html")):
        mod.write_gallery(str(tmp_path / name), recs, imgs, metric_key="score", top_n=2)
    j = (tmp_path / "j.html").read_text().replace("foundpose_tpu report", "foundpose report")
    assert (tmp_path / "t.html").read_text() == j


def _run_loader(tmp_path, code):
    """`code` in a fresh interpreter after the port's rasterizer module is
    imported as `rz` with its build directory at `tmp_path` (so nothing
    here touches a library another process may be loading)."""
    prelude = (
        "import os, sys\n"
        "from foundpose_torch.renderer import rasterizer as rz\n"
        f"rz.BUILD_DIR = {str(tmp_path)!r}\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.run([sys.executable, "-c", prelude + code], capture_output=True,
                          text=True, timeout=300, cwd=root)


def test_native_loader_survives_a_rebuild(tmp_path):
    """A library cut short at the port's target path (a half-written file)
    is rebuilt and loaded; `_NATIVE` is set, and only then `_NATIVE_TRIED`."""
    if t_rast._compiler() is None:
        pytest.skip("no C++ compiler on this host")
    out = _run_loader(tmp_path, (
        "path = rz.library_path()\n"
        "assert os.path.dirname(path) == rz.BUILD_DIR\n"
        "os.makedirs(rz.BUILD_DIR, exist_ok=True)\n"
        "open(path, 'wb').write(b'\\x7fELF' + bytes(60))\n"
        "assert rz._NATIVE is None and not rz._NATIVE_TRIED\n"
        "assert rz._get_native() is not None\n"
        "assert rz._NATIVE is not None and rz._NATIVE_TRIED\n"
        "assert os.path.getsize(path) > 4096\n"
        "print('rebuilt', os.listdir(rz.BUILD_DIR))\n"
    ))
    assert out.returncode == 0 and "rebuilt" in out.stdout, out.stderr
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


@pytest.mark.parametrize("source", ["missing", "broken"])
def test_native_loader_raises_when_the_build_fails(tmp_path, source):
    """A build that fails raises (with the compiler's message) instead of
    leaving the process on the numpy version; `_NATIVE_TRIED` stays unset."""
    if t_rast._compiler() is None:
        pytest.skip("no C++ compiler on this host")
    src = tmp_path / "rasterizer.cpp"
    if source == "broken":
        src.write_text("this is not C++\n")
    out = _run_loader(tmp_path, (
        f"rz._SOURCE = {str(src)!r}\n"
        "try:\n"
        "    rz._get_native()\n"
        "except (OSError, RuntimeError) as e:\n"
        "    assert rz._NATIVE is None and not rz._NATIVE_TRIED\n"
        "    print('raised', type(e).__name__, e)\n"
    ))
    assert out.returncode == 0 and "raised" in out.stdout, (out.stdout, out.stderr)
    if source == "broken":
        assert "RuntimeError" in out.stdout and "error" in out.stdout
