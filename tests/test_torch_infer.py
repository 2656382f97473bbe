"""The port's offline CLI (foundpose_torch.pipeline.infer and the
submission and AR tools after it) against the JAX package's, on one
synthetic BOP split on the CPU in f32 with exact top-k: the same split,
checkpoint and representations go through both, the port taking the JAX
package's RANSAC draws (PRNGKey(batch)) through `draws_fn`.

The split is built without a renderer: two random 640x480 PNGs, objects 1
and 5 with two detections (box + mask) and two GT instances each per image,
an octahedron PLY per object, and per object a representation written by
the JAX package's save_repre whose templates are the tiny ViT's features of
the crops of that object's image-0 detections, lifted to 3D in their crop
cameras (so those crops succeed), plus one random distractor template.
"""

import dataclasses
import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)
from PIL import Image
from test_torch_pipeline import jax_pipeline_draws

from foundpose_torch.data import bop as t_bop
from foundpose_torch.data.ply import Mesh as TMesh, save_ply
from foundpose_torch.models.weights import state_dict_from_jax_params
from foundpose_torch.pipeline import eval_ar as t_eval_ar
from foundpose_torch.pipeline import infer as t_infer
from foundpose_torch.pipeline import inference as t_inf
from foundpose_torch.pipeline import prepare_bop_submission as t_sub
from foundpose_torch.repre import load_repre as t_load_repre, save_repre as t_save_repre
from foundpose_tpu import cameras as j_cameras
from foundpose_tpu.models import dinov2 as j_dinov2
from foundpose_tpu.ops import warp as j_warp
from foundpose_tpu.ops.pca import PCA as JPCA, pca_transform
from foundpose_tpu.ops.tfidf import TfidfConfig, calc_template_tfidf_descriptors
from foundpose_tpu.pipeline import eval_ar as j_eval_ar
from foundpose_tpu.pipeline import infer as j_infer
from foundpose_tpu.pipeline import prepare_bop_submission as j_sub
from foundpose_tpu.repre import make_repre, save_repre
from foundpose_tpu.structs import PinholeCamera as JCamera

LIDS = (1, 5)
K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]])
CROP = (140, 140)
EXTRACTOR = "dinov2_version=vits14-reg_stride=14_facet=token_layer=1_norm=1"
VIT_OVERRIDES = {"embed_dim": 32, "depth": 2, "num_heads": 2, "pos_grid": 10}
# (x, y, w, h) per image, per object: two detections each.
BOXES = {
    0: {1: [(100, 80, 70, 80), (300, 200, 90, 70)], 5: [(430, 120, 80, 80), (190, 300, 100, 90)]},
    1: {1: [(120, 60, 80, 90), (350, 250, 70, 70)], 5: [(400, 140, 90, 60), (60, 320, 80, 100)]},
}
# Poses: R within 1e-4; t within 1e-4 mm (the split is in metres: the
# templates' points lie 0.4-0.6 m in front of their crop cameras).
R_ATOL, T_ATOL = 1e-4, 1e-7


def _rle(mask):
    """COCO uncompressed RLE of a bool mask (column-major runs from 0)."""
    flat = mask.T.flatten()
    counts, val, run = [], False, 0
    for v in flat:
        if bool(v) == val:
            run += 1
        else:
            counts.append(run)
            val, run = bool(v), 1
    counts.append(run)
    return {"counts": counts, "size": list(mask.shape)}


def _octahedron(scale):
    v = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                 np.float32) * scale
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5],
                  [3, 1, 5], [0, 3, 5]], np.int32)
    colors = np.array([[200, 40, 40], [40, 200, 40], [40, 40, 200], [200, 200, 40],
                       [40, 200, 200], [200, 40, 200]], np.uint8)
    return TMesh(vertices=v, faces=f, colors=colors)


def build_split(root, rng, dataset="lmo", boxes=BOXES, size=(640, 480), k=K,
                dataset_crop_size=(640, 480), crop=CROP, extractor=EXTRACTOR,
                vit_overrides=VIT_OVERRIDES):
    """Writes the split, the checkpoint and the representations under
    `root`; returns the InferOpts fields that point at them. `dataset`
    names the split's directory (data/bop.TEST_SPLITS), `boxes` the
    detections per image and object, `size` the images' (width, height)
    and `k` their camera; the objects are those with boxes in image 0. The
    templates are `crop` px crops through the ViT of `extractor` and
    `vit_overrides`."""
    scene = os.path.join(t_bop.split_dir(os.path.join(root, "bop"), dataset), "000001")
    os.makedirs(os.path.join(scene, "rgb"))
    models = os.path.join(root, "bop", dataset, "models")
    os.makedirs(models)
    width, height = size
    lids = tuple(boxes[0])
    images, dets, cams, gts, infos = {}, [], {}, {}, {}
    for im_id, per_obj in boxes.items():
        img = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(scene, "rgb", f"{im_id:06d}.png"))
        images[im_id] = img
        cams[str(im_id)] = {"cam_K": k.flatten().tolist(), "depth_scale": 1.0}
        gts[str(im_id)], infos[str(im_id)] = [], []
        for lid, obj_boxes in per_obj.items():
            for x, y, w, h in obj_boxes:
                mask = np.zeros((height, width), bool)
                mask[y + 5 : y + h - 5, x + 5 : x + w - 5] = True
                dets.append({"scene_id": 1, "image_id": im_id, "category_id": lid,
                             "score": float(rng.uniform(0.5, 1.0)), "bbox": [x, y, w, h],
                             "time": 0.25, "segmentation": _rle(mask)})
                r = _rotation(rng)
                gts[str(im_id)].append({"obj_id": lid, "cam_R_m2c": r.flatten().tolist(),
                                        "cam_t_m2c": [float(rng.uniform(-0.05, 0.05)),
                                                      float(rng.uniform(-0.05, 0.05)), 0.5]})
                infos[str(im_id)].append({"bbox_obj": [x, y, w, h], "bbox_visib": [x, y, w, h],
                                          "visib_fract": 1.0})
    for name, data in (("scene_camera.json", cams), ("scene_gt.json", gts),
                       ("scene_gt_info.json", infos)):
        with open(os.path.join(scene, name), "w") as f:
            json.dump(data, f)
    info = {}
    for lid in lids:
        mesh = _octahedron(0.03 + 0.01 * lid / 5)
        save_ply(os.path.join(models, f"obj_{lid:06d}.ply"), mesh)
        info[str(lid)] = {"diameter": float(2 * mesh.vertices.max() * 2 ** 0.5)}
    with open(os.path.join(models, "models_info.json"), "w") as f:
        json.dump(info, f)
    det_path = os.path.join(root, "detections.json")
    with open(det_path, "w") as f:
        json.dump(dets, f)

    # The tiny ViT, written as an official-name checkpoint both packages load.
    jvit = j_dinov2.resolve_config(extractor, overrides=vit_overrides)
    params = jax.tree.map(np.asarray, j_dinov2.init_params(jax.random.PRNGKey(0), jvit))
    opts = t_infer.InferOpts(extractor_name=extractor, vit_overrides=vit_overrides)
    tvit = t_inf.vit_config_from_opts(dataclasses.asdict(opts))
    weights = os.path.join(root, "tiny_vit.pth")
    torch.save(state_dict_from_jax_params(params, tvit), weights)

    # Representations: image 0's crops of each object as its templates.
    src = JCamera.from_intrinsic_matrix(k.astype(np.float32), width=width, height=height)
    warp = j_warp.make_single_image_warp(crop)
    d = jvit.embed_dim
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    pca = JPCA(mean=jnp.asarray(rng.normal(size=d) * 0.1, jnp.float32),
               components=jnp.asarray(q[:16], jnp.float32),
               explained_variance=jnp.ones(16, jnp.float32))
    for lid in lids:
        xyxy = np.asarray([[x, y, x + w, y + h] for x, y, w, h in boxes[0][lid]], np.float32)
        crop_cams = j_cameras.build_crop_cameras(src, jnp.asarray(xyxy), crop, 0.2)
        crops, _ = warp(jnp.asarray(images[0]), jnp.ones((len(xyxy), height, width), jnp.uint8),
                        src, crop_cams)
        fmaps = np.asarray(j_dinov2.extract_facet(
            params, jvit, j_dinov2.normalize_images(crops.astype(jnp.float32) / 255.0)
        )["feature_maps"])
        n, gh, gw, d = fmaps.shape
        uv = np.stack(np.meshgrid(np.arange(gw) * 14.0 + 7.0, np.arange(gh) * 14.0 + 7.0), -1)
        uv = uv.reshape(-1, 2)
        feats, verts = [], []
        for i in range(n):
            rays = (uv - np.asarray(crop_cams.c[i])) / np.asarray(crop_cams.f[i])
            depth = rng.uniform(0.4, 0.6, size=(len(uv), 1))
            feats.append(fmaps[i].reshape(-1, d))
            verts.append(np.concatenate([rays, np.ones_like(depth)], -1) * depth)
        feats.append(rng.normal(size=(gh * gw, d)))  # the distractor
        verts.append(rng.uniform(-0.05, 0.05, size=(gh * gw, 3)))
        nt = n + 1
        raw = np.concatenate(feats).astype(np.float32)
        projected = np.asarray(pca_transform(pca, jnp.asarray(raw)))
        ids = np.repeat(np.arange(nt), gh * gw).astype(np.int32)
        words = projected[rng.choice(len(projected), 40, replace=False)]
        words = (words + 0.01 * rng.normal(size=words.shape)).astype(np.float32)
        cfg = TfidfConfig(knn_k=3)
        descs, idfs = calc_template_tfidf_descriptors(
            jnp.asarray(projected), jnp.asarray(ids), jnp.asarray(words), nt, cfg)
        tcams = JCamera(f=jnp.asarray(np.concatenate([np.asarray(crop_cams.f), [[100.0, 100.0]]])),
                        c=jnp.full((nt, 2), (crop[0] - 1) / 2),
                        T_world_from_eye=jnp.tile(jnp.eye(4)[None], (nt, 1, 1)),
                        width=crop[0], height=crop[1])
        # Without template images: the JAX package keeps them as pytree
        # metadata, which its jitted step cannot compare from one object to
        # the next (ROADMAP.md Queue 3, fault (f)).
        repre = make_repre(projected, np.concatenate(verts).astype(np.float32), ids, words,
                           np.asarray(idfs), np.asarray(descs), tcams, raw_projector=pca,
                           tfidf_config=cfg)
        save_repre(repre, os.path.join(root, "repre", dataset, "v1", str(lid)))
        templates = np.concatenate([np.asarray(crops), np.zeros((1, *crop, 3), np.uint8)])
        np.save(os.path.join(root, f"templates_{lid}.npy"), templates.transpose(0, 3, 1, 2))
    return dict(
        object_dataset=dataset, object_lids=list(lids), extractor_name=extractor,
        vit_overrides=vit_overrides, weights_path=weights, crop_size=crop,
        dataset_crop_size=dataset_crop_size, match_top_n_templates=2, match_top_k_buddies=50,
        pnp_ransac_iter=64, batch_size=4,
        bop_root=os.path.join(root, "bop"), repre_dir=os.path.join(root, "repre"),
        detections_path=det_path,
    )


def _rotation(rng):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rng.uniform(-0.5, 0.5, 3)).as_matrix()


def jax_draws(fields):
    """draws_fn feeding the JAX package's draws of batch s to the port."""
    return lambda s: jax_pipeline_draws(
        jax.random.PRNGKey(s), fields["batch_size"], fields["match_top_n_templates"],
        fields["pnp_ransac_iter"], fields["match_top_k_buddies"])


def run_capturing(mod, fn, opts, **kw):
    """fn(opts, **kw) with `mod.finalize_object_results` wrapped to record
    each object's (instance, result) pairs; returns (counts, {lid: pairs})."""
    captured = {}
    orig = mod.finalize_object_results

    def capture(opts, lid, results, *args, **kwargs):
        captured[lid] = results
        return orig(opts, lid, results, *args, **kwargs)

    mod.finalize_object_results = capture
    try:
        counts = fn(opts, **kw)
    finally:
        mod.finalize_object_results = orig
    return counts, captured


def run_both(fields, root, mode, tag=""):
    """Both packages' run of `mode` ("single": infer, "multi":
    infer_multi_object) over the split of `fields`, the port taking the
    JAX draws, each followed by its package's submission and AR
    evaluation: {package: counts, results, out_dir, csv, ar}."""
    ds = fields["object_dataset"]
    out = {}
    for pkg, mod, sub, ev in (("jax", j_infer, j_sub, j_eval_ar),
                              ("torch", t_infer, t_sub, t_eval_ar)):
        out_dir = os.path.join(root, f"out_{pkg}_{mode}{tag}")
        extra = {"device": "cpu"} if pkg == "torch" else {}
        opts = mod.InferOpts(**fields, multi_object=mode == "multi", output_dir=out_dir, **extra)
        kw = {"draws_fn": jax_draws(fields)} if pkg == "torch" else {}
        fn = mod.infer_multi_object if mode == "multi" else mod.infer
        counts, captured = run_capturing(mod, fn, opts, **kw)
        csv = sub.prepare(sub.PrepareBopSubmissionOpts(object_dataset=ds, results_dir=out_dir))
        ar = ev.evaluate(ev.EvalArOpts(object_dataset=ds, submission_path=csv,
                                       bop_root=fields["bop_root"]))
        out[pkg] = dict(counts=counts, results=captured, out_dir=out_dir, csv=csv, ar=ar)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' single- and multi-object runs over the split, each
    followed by its package's submission and AR evaluation."""
    root = str(tmp_path_factory.mktemp("split"))
    fields = build_split(root, np.random.default_rng(0))
    out = {"fields": fields, "root": root}
    for mode in ("single", "multi"):
        both = run_both(fields, root, mode)
        out["jax", mode], out["torch", mode] = both["jax"], both["torch"]
    return out


MODES = ["single", "multi"]


def assert_decisions_match(j, t, lids, r_atol=R_ATOL, t_atol=T_ATOL):
    """Every instance of each object: the retrieved template ids, the best
    template and success equal; successful poses within r_atol / t_atol.
    Returns the successes."""
    successes = 0
    for lid in lids:
        jr, tr = j["results"][lid], t["results"][lid]
        assert [(p.scene_id, p.im_id, p.inst_id) for p, _ in tr] == [
            (p.scene_id, p.im_id, p.inst_id) for p, _ in jr]
        for (_, a), (_, b) in zip(tr, jr):
            np.testing.assert_array_equal(a["template_ids"], np.asarray(b["template_ids"]))
            assert (a["best_template"], a["success"]) == (b["best_template"], b["success"])
            if a["success"]:
                successes += 1
                for k in ("R_m2w", "t_m2w", "R_m2c", "t_m2c"):
                    atol = r_atol if k.startswith("R") else t_atol
                    np.testing.assert_allclose(a[k], np.asarray(b[k]), atol=atol, err_msg=k)
    return successes


@pytest.mark.parametrize("mode", MODES)
def test_infer_decisions_match_jax(runs, mode):
    """Every instance: the retrieved template ids, the best template and
    success equal; successful poses within R_ATOL / T_ATOL. Image 0's crops
    are the templates, so some succeed; image 1's are random."""
    j, t = runs["jax", mode], runs["torch", mode]
    assert t["counts"] == j["counts"] == {1: 4, 5: 4}
    assert assert_decisions_match(j, t, LIDS) >= 4


@pytest.mark.parametrize("mode", MODES)
def test_estimated_poses_match_jax(runs, mode):
    """estimated-poses.json, metrics.tsv and metrics-table.tsv for each
    object; the records agree field by field (poses within R_ATOL /
    T_ATOL, the scores and GT errors within 1e-5), the times carry prep and
    pipeline."""
    j, t = runs["jax", mode], runs["torch", mode]
    for lid in LIDS:
        jd = os.path.join(j["out_dir"], "lmo", "v1", str(lid))
        td = os.path.join(t["out_dir"], "lmo", "v1", str(lid))
        for name in ("estimated-poses.json", "metrics.tsv", "metrics-table.tsv", "config.json"):
            assert os.path.exists(os.path.join(td, name)), name
        with open(os.path.join(jd, "estimated-poses.json")) as f:
            jrec = json.load(f)
        with open(os.path.join(td, "estimated-poses.json")) as f:
            trec = json.load(f)
        assert len(trec) == len(jrec) > 0
        for a, b in zip(trec, jrec):
            assert set(a) == set(b)
            for k in ("scene_id", "img_id", "obj_id", "inst_id", "hypothesis_id", "cnos_time"):
                assert a[k] == b[k], k
            np.testing.assert_allclose(float(a["score"]), float(b["score"]), atol=1e-6)
            np.testing.assert_allclose(a["R"], b["R"], atol=R_ATOL)
            np.testing.assert_allclose(a["t"], b["t"], atol=T_ATOL)
            for k in ("mssd", "mspd", "mssd_n", "template_ori_err_deg"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5, err_msg=k)
            assert set(a["time"]) == {"prep", "pipeline"}
        with open(os.path.join(td, "config.json")) as f:
            assert json.load(f)["infer_opts"]["device"] == "cpu"


@pytest.mark.parametrize("mode", MODES)
def test_submission_and_ar_match_jax(runs, mode):
    """The BOP19 CSVs agree row by row except the time column (ids and
    scores equal, R and t within R_ATOL / T_ATOL: the two packages' f32
    solves differ in the last bits); eval_ar's results within 1e-6."""
    assert_submission_matches(runs["jax", mode], runs["torch", mode])


def assert_submission_matches(j, t, r_atol=R_ATOL, t_atol=T_ATOL):
    """test_submission_and_ar_match_jax's comparison of two runs."""
    with open(j["csv"]) as f:
        jl = f.read().strip().split("\n")
    with open(t["csv"]) as f:
        tl = f.read().strip().split("\n")
    assert tl[0] == jl[0] == "scene_id,im_id,obj_id,score,R,t,time"
    assert len(tl) == len(jl) > 1
    for a, b in zip(tl[1:], jl[1:]):
        a, b = a.split(","), b.split(",")
        assert a[:3] == b[:3]
        np.testing.assert_allclose(float(a[3]), float(b[3]), atol=1e-6)
        for col, atol in ((4, r_atol), (5, t_atol)):
            np.testing.assert_allclose(np.array(a[col].split(), float),
                                       np.array(b[col].split(), float), atol=atol)
    assert set(t["ar"]) == set(j["ar"])
    for k, v in j["ar"].items():
        np.testing.assert_allclose(t["ar"][k], v, atol=1e-6, err_msg=k)
    assert all(np.isfinite(v) for v in t["ar"].values())


def test_infer_with_visualisation_writes_the_file_set(runs):
    """vis_results=True on the port: tile grids, the error point clouds,
    the score histogram and the gallery beside the metric table (the file
    set tests/test_integration.py asks of the JAX package)."""
    root, fields = runs["root"], runs["fields"]
    # Object 1's representation with its template images, through the
    # port's loader and writer.
    repre = t_load_repre(os.path.join(fields["repre_dir"], "lmo", "v1", "1"), device="cpu")
    repre = dataclasses.replace(repre, templates=np.load(os.path.join(root, "templates_1.npy")))
    repre_dir = os.path.join(root, "repre_vis")
    t_save_repre(repre, os.path.join(repre_dir, "lmo", "v1", "1"))
    out_dir = os.path.join(root, "out_torch_vis")
    opts = t_infer.InferOpts(**dict(fields, repre_dir=repre_dir, object_lids=[1]),
                             vis_results=True, vis_count=4, output_dir=out_dir, device="cpu")
    t_infer.infer(opts, draws_fn=jax_draws(fields))
    obj_dir = os.path.join(out_dir, "lmo", "v1", "1")
    vis = os.path.join(obj_dir, "vis")
    tiles = glob.glob(os.path.join(vis, "s*_im*_i*.png"))
    assert tiles
    assert glob.glob(os.path.join(vis, "*_error.ply"))
    assert os.path.exists(os.path.join(vis, "score_hist.png"))
    assert os.path.exists(os.path.join(obj_dir, "metrics-table.tsv"))
    assert os.path.exists(os.path.join(obj_dir, "report.html"))
    assert np.asarray(Image.open(tiles[0])).ndim == 3


@pytest.mark.parametrize("multi", [False, True])
def test_cli_main_runs_on_the_cpu(runs, tmp_path, monkeypatch, multi):
    """`python -m foundpose_torch.pipeline.infer --opts-path <json> --set
    device=cpu`, single- and multi-object, writes each object's poses."""
    fields = dict(runs["fields"], multi_object=multi, output_dir=str(tmp_path / "out"))
    path = tmp_path / "opts.json"
    path.write_text(json.dumps({"infer_opts": {k: v for k, v in fields.items()}}))
    monkeypatch.setattr(sys, "argv", ["infer", "--opts-path", str(path), "--set", "device=cpu"])
    t_infer.main()
    for lid in LIDS:
        assert (tmp_path / "out" / "lmo" / "v1" / str(lid) / "estimated-poses.json").exists()


def test_infer_defaults_to_the_card_and_refuses_a_mesh(runs):
    """Without an initialized process group of the mesh's size, a mesh
    raises (the mesh path itself: tests/test_torch_mesh_cli.py)."""
    assert t_infer.InferOpts().device == "cuda"
    opts = t_infer.InferOpts(**runs["fields"], mesh_shape=(2, 1), device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        t_infer.infer(opts)
