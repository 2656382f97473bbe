"""The port's data layer against the JAX package's, on the CPU: PLY meshes,
BOP scene access (the mini_bop fixture of test_bop_data.py), detections
and the mask morphology they use (bit-equal to the JAX reduce_window
pooling on 0/1 masks)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)
from test_bop_data import mini_bop  # noqa: F401  (the fixture)

from foundpose_torch.data import bop as t_bop
from foundpose_torch.data import detections as t_det
from foundpose_torch.data import ply as t_ply
from foundpose_torch.ops import morphology as t_morph
from foundpose_tpu.data import bop as j_bop
from foundpose_tpu.data import detections as j_det
from foundpose_tpu.data import ply as j_ply
from foundpose_tpu.ops import morphology as j_morph


def assert_same_dataclass(got, ref):
    """Every field of two dataclass instances equal (arrays exactly)."""
    assert type(got).__name__ == type(ref).__name__
    for name, r in vars(ref).items():
        g = getattr(got, name)
        if isinstance(r, np.ndarray) or r is None:
            if r is None:
                assert g is None, name
            else:
                assert g.dtype == r.dtype, name
                np.testing.assert_array_equal(g, r, name)
        elif isinstance(r, list):
            assert len(g) == len(r), name
            for a, b in zip(g, r):
                assert_same_dataclass(a, b)
        else:
            assert g == r, name


def binary_ply(path, rng):
    """A binary little-endian PLY with positions, normals, colors and a
    uchar/int face list."""
    v = rng.normal(size=(5, 3)).astype("<f4")
    n = rng.normal(size=(5, 3)).astype("<f4")
    c = rng.integers(0, 256, size=(5, 3)).astype("u1")
    faces = np.array([[0, 1, 2], [2, 3, 4]], "<i4")
    header = (
        "ply\nformat binary_little_endian 1.0\nelement vertex 5\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "element face 2\nproperty list uchar int vertex_indices\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        for i in range(5):
            f.write(v[i].tobytes() + n[i].tobytes() + c[i].tobytes())
        for face in faces:
            f.write(np.uint8(3).tobytes() + face.tobytes())


@pytest.mark.parametrize("kind", ["ascii", "binary"])
def test_load_ply_matches_jax(tmp_path, rng, kind):
    path = str(tmp_path / f"{kind}.ply")
    if kind == "ascii":
        mesh = j_ply.Mesh(
            vertices=rng.normal(size=(6, 3)).astype(np.float32),
            faces=np.array([[0, 1, 2], [3, 4, 5]], np.int32),
            colors=rng.integers(0, 256, size=(6, 3)).astype(np.uint8),
        )
        j_ply.save_ply(path, mesh)
        t_path = str(tmp_path / "port.ply")
        t_ply.save_ply(t_path, t_ply.Mesh(**vars(mesh)))
        assert open(t_path).read() == open(path).read()
    else:
        binary_ply(path, rng)
    got, ref = t_ply.load_ply(path), j_ply.load_ply(path)
    assert_same_dataclass(got, ref)
    np.testing.assert_array_equal(got.mean_color(), ref.mean_color())


def test_prepare_sample_matches_jax(mini_bop):  # noqa: F811
    """Center crop, intrinsics, depth, GT and visible masks: equal."""
    kw = dict(load_depth=True, load_masks=True, crop_size=(630, 476))
    got = t_bop.prepare_sample(mini_bop, "demo", 2, 7, **kw)
    ref = j_bop.prepare_sample(mini_bop, "demo", 2, 7, **kw)
    assert_same_dataclass(got, ref)
    assert got.image.shape == (476, 630, 3) and got.gt[0].mask_visib.sum() == 100 * 150
    assert t_bop.list_scenes(mini_bop, "demo") == j_bop.list_scenes(mini_bop, "demo") == [2]
    assert t_bop.list_images(mini_bop, "demo", 2) == j_bop.list_images(mini_bop, "demo", 2)
    scene = f"{mini_bop}/demo/test/000002"
    for fn in ("load_scene_camera", "load_scene_gt", "load_scene_gt_info"):
        got, ref = getattr(t_bop, fn)(scene), getattr(j_bop, fn)(scene)
        assert got.keys() == ref.keys()
        for k in ref:
            assert repr(got[k]) == repr(ref[k])


@pytest.mark.parametrize("info", [
    {"symmetries_discrete": [[-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 5.0, 0, 0, 0, 1]]},
    {"symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}]},
    {"symmetries_discrete": [[1, 0, 0, 0, 0, -1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1]],
     "symmetries_continuous": [{"axis": [0, 1, 1], "offset": [1, 2, 3]}]},
])
def test_symmetry_transformations_match_jax(info):
    got = t_bop.get_symmetry_transformations(info, max_sym_disc_step=0.1)
    ref = j_bop.get_symmetry_transformations(info, max_sym_disc_step=0.1)
    assert len(got) == len(ref) > 1
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["R"], r["R"])
        np.testing.assert_array_equal(g["t"], r["t"])


def column_major_rle(mask):
    flat = mask.T.flatten()
    counts, run_val, run = [], False, 0
    for v in flat:
        if v == run_val:
            run += 1
        else:
            counts.append(run)
            run_val, run = v, 1
    counts.append(run)
    return {"counts": counts, "size": list(mask.shape)}


def test_detections_match_jax(tmp_path, rng):
    """RLE decoding (uncompressed and compressed), loading, and the top-n
    selection with the 3x3 opening, crop shift and box conversion."""
    masks = [rng.uniform(size=(40, 50)) > 0.4 for _ in range(3)]
    masks[0][5:30, 10:40] = True
    dets = [
        {"scene_id": 1, "image_id": 2, "category_id": 5, "score": s, "bbox": [3.0 * i, 4.0, 20, 25],
         "segmentation": column_major_rle(m), "time": 0.1 * i}
        for i, (s, m) in enumerate(zip((0.5, 0.9, 0.7), masks))
    ]
    path = tmp_path / "dets.json"
    path.write_text(json.dumps(dets))
    assert t_det.load_detections(str(path)).keys() == j_det.load_detections(str(path)).keys()
    for rle in (dets[0]["segmentation"], {"counts": "52203", "size": [3, 4]}):
        np.testing.assert_array_equal(t_det.rle_to_mask(rle), j_det.rle_to_mask(rle))
    kw = dict(max_num_preds=2, crop_offset=(5, 2), image_size=(40, 30))
    got = t_det.instances_for_pose_estimation(dets, **kw)
    ref = j_det.instances_for_pose_estimation(dets, **kw)
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert_same_dataclass(g, r)
    boxes = [np.array([0, 0, 10, 10]), None, np.array([1, 1, 11, 11])]
    assert t_det.associate_gt_by_iou(got[0].box_xyxy, boxes) == j_det.associate_gt_by_iou(
        ref[0].box_xyxy, boxes)


@pytest.mark.parametrize("dtype", [np.float32, bool])
@pytest.mark.parametrize("kernel_size", [3, 5])
def test_morphology_is_bit_equal_to_jax(rng, kernel_size, dtype):
    """erode (zero and replicate borders), dilate and opening on random
    0/1 masks, touching the border: equal bit for bit, dtype kept."""
    for density in (0.2, 0.6, 0.9):
        mask = (rng.uniform(size=(23, 31)) < density).astype(dtype)
        t, j = torch.from_numpy(mask), jnp.asarray(mask)
        pairs = [
            (t_morph.erode(t, kernel_size, "zero"), j_morph.erode(j, kernel_size, "zero")),
            (t_morph.erode(t, kernel_size, "replicate"), j_morph.erode(j, kernel_size, "replicate")),
            (t_morph.dilate(t, kernel_size), j_morph.dilate(j, kernel_size)),
            (t_morph.opening(t, kernel_size), j_morph.opening(j, kernel_size)),
        ]
        for got, ref in pairs:
            ref = np.asarray(ref)
            assert got.numpy().dtype == ref.dtype
            assert got.numpy().tobytes() == ref.tobytes()
    with pytest.raises(ValueError):
        t_morph.erode(torch.from_numpy(mask), kernel_size, "wrap")
