"""The port's offline builder (pipeline/gen_templates, pipeline/gen_repre)
against the JAX package's on the CPU, at the size of
tests/test_integration.py: the textured icosahedron, 9 views x 4 in-plane
rotations, 140 px crops, a tiny ViT (32 wide, 2 blocks) whose weights both
packages share (models/weights.state_dict_from_jax_params). Then the port's
whole chain, gen_templates -> gen_repre -> infer -> prepare_bop_submission,
recovers the ground-truth pose within the integration test's bounds."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)
from test_integration import OBJ_ID, TINY_EXTRACTOR, build_synthetic_bop, make_textured_icosahedron

from foundpose_torch.models import dinov2 as t_dinov2
from foundpose_torch.models.weights import state_dict_from_jax_params
from foundpose_torch.ops import kmeans as t_km
from foundpose_torch.pipeline import gen_repre as t_gr
from foundpose_torch.pipeline import gen_templates as t_gtpl
from foundpose_torch.pipeline import inference as t_inf
from foundpose_torch.pipeline import infer as t_infer
from foundpose_torch.pipeline import prepare_bop_submission as t_sub
from foundpose_torch.repre import load_repre
from foundpose_torch.structs import PinholeCamera as TCamera
from foundpose_tpu.models import dinov2 as j_dinov2
from foundpose_tpu.ops import kmeans as j_km
from foundpose_tpu.pipeline import gen_repre as j_gr
from foundpose_tpu.pipeline import gen_templates as j_gtpl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT_OVERRIDES = {"embed_dim": 32, "depth": 2, "num_heads": 2, "pos_grid": 10}
CROP = (140, 140)
# Pose bounds of tests/test_integration.py:246-247.
ROT_DEG, T_MM = 15.0, 30.0
# Registration, port against JAX in f32: feature maps of a 2-block ViT
# within 1e-4 relative L2; vertices within 1e-3 mm (lifted at 300 mm).
FEAT_REL_L2, VERT_ATOL = 1e-4, 1e-3
# Crop cameras, port against JAX, relative to each field's scale (f32
# torch against f32 XLA maths; measured at most 3.1e-5 in the focal, which
# comes from a difference of nearly equal unit vectors, and 1e-5 elsewhere).
CAM_RTOL = 1e-4


def _tpl_opts(**kw):
    return dict(object_dataset="demo", object_lids=[OBJ_ID], min_num_viewpoints=9,
                num_inplane_rotations=4, depth_range=(300.0, 300.0), ssaa_factor=2.0,
                crop_size=CROP, overwrite=True, **kw)


def _repre_opts(**kw):
    return dict(object_dataset="demo", object_lids=[OBJ_ID], extractor_name=TINY_EXTRACTOR,
                apply_pca=True, pca_components=16, cluster_num=64, batch_size=8,
                vit_overrides=VIT_OVERRIDES, overwrite=True, **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The icosahedron's BOP split (tests/test_integration.py), its template
    sets from both packages, and the shared tiny ViT."""
    root = tmp_path_factory.mktemp("builder")
    mesh = make_textured_icosahedron()
    bop_root, det_path, r_gt, t_gt = build_synthetic_bop(root, mesh)
    for pkg, mod in (("jax", j_gtpl), ("torch", t_gtpl)):
        mod.synthesize_templates(mod.GenTemplatesOpts(
            **_tpl_opts(bop_root=bop_root, output_dir=str(root / f"tpl_{pkg}"))))
    jcfg = j_dinov2.resolve_config(TINY_EXTRACTOR, overrides=VIT_OVERRIDES)
    params = jax.tree.map(np.asarray, j_dinov2.init_params(jax.random.PRNGKey(0), jcfg))
    tcfg = t_inf.vit_config_from_opts({"extractor_name": TINY_EXTRACTOR,
                                       "vit_overrides": VIT_OVERRIDES})
    model = t_dinov2.DinoV2(tcfg)
    model.load_state_dict(state_dict_from_jax_params(params, tcfg))
    weights = str(root / "tiny_vit.pth")
    torch.save(state_dict_from_jax_params(params, tcfg), weights)

    def tpl_dir(pkg):
        return os.path.join(root, f"tpl_{pkg}", "demo", "v1", str(OBJ_ID))

    return dict(root=root, bop_root=bop_root, det_path=det_path, r_gt=r_gt, t_gt=t_gt,
                params=params, jcfg=jcfg, model=model.eval(), weights=weights,
                tpl_dir=tpl_dir, mesh=mesh)


def _metadata(world, pkg):
    with open(os.path.join(world["tpl_dir"](pkg), "metadata.json")) as f:
        return json.load(f)


def test_gen_templates_matches_jax(world):
    """Same options, same mesh: the metadata has the JAX package's entries
    key for key (paths aside), boxes equal, cameras within CAM_RTOL
    (translations relative to their norm). The crop cameras differ in
    their last bits, which moves a silhouette pixel or a depth by one PNG
    level (0.1 mm): masks equal on >= 99.99% of pixels, depths within one
    level on >= 99.99%, rgb within one level on >= 99.9%."""
    from PIL import Image

    jm, tm = _metadata(world, "jax"), _metadata(world, "torch")
    assert len(jm) == len(tm) == 36
    for a, b in zip(tm, jm):
        assert a.keys() == b.keys()
        for k in ("dataset", "lid", "template_id", "pose", "visibilities",
                  "mask_is_depth_positive", "boxes_amodal"):
            assert a[k] == b[k], k
        ca, cb = a["cameras"], b["cameras"]
        assert ca.keys() == cb.keys()
        assert (ca["ImageSizeX"], ca["ImageSizeY"]) == (cb["ImageSizeX"], cb["ImageSizeY"])
        for k in ("fx", "fy", "cx", "cy"):
            np.testing.assert_allclose(ca[k], cb[k], rtol=CAM_RTOL)
        for k in ("T_WorldFromCamera", "ModelViewMatrix"):
            ta, tb = np.asarray(ca[k]), np.asarray(cb[k])
            np.testing.assert_allclose(ta[:3, :3], tb[:3, :3], rtol=0, atol=CAM_RTOL / 2)
            np.testing.assert_allclose(ta[:3, 3], tb[:3, 3], rtol=0,
                                       atol=CAM_RTOL * np.linalg.norm(tb[:3, 3]))
        for k in ("rgb_image_path", "depth_map_path", "binary_mask_path"):
            assert os.path.basename(a[k]) == os.path.basename(b[k])
            assert os.path.relpath(a[k], world["tpl_dir"]("torch")) == os.path.relpath(
                b[k], world["tpl_dir"]("jax"))
    for key, atol, share in (("binary_mask_path", 0, 0.9999), ("depth_map_path", 1, 0.9999),
                             ("rgb_image_path", 1, 0.999)):
        same = []
        for a, b in zip(tm, jm):
            x = np.asarray(Image.open(a[key])).astype(np.int64)
            y = np.asarray(Image.open(b[key])).astype(np.int64)
            same.append(np.abs(x - y) <= atol)
        assert np.mean(np.concatenate([s.ravel() for s in same])) >= share, key


def _chunk(world, n=6):
    arrays = j_gr.load_template_arrays(_metadata(world, "jax")[:n],
                                       templates_dir=world["tpl_dir"]("jax"))
    images, depths, masks, cam_f, cam_c, cam_t, _ = arrays
    assert images.dtype == np.uint8 and depths.dtype == np.uint16 and masks is None
    return images, depths, cam_f, cam_c, cam_t


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mask_from_depth", [True, False])
def test_registration_matches_jax(world, mask_from_depth):
    """One uint8 / uint16 chunk through JAX make_registration_fn and the
    port's register_templates, the mask derived from the depth or given as
    a uint8 image: validity equal, features within FEAT_REL_L2, vertices
    within VERT_ATOL mm."""
    images, depths, cam_f, cam_c, cam_t = _chunk(world)
    masks = None if mask_from_depth else (depths > 0).astype(np.uint8)
    register = j_gr.make_registration_fn(world["jcfg"], 14.0, CROP,
                                         mask_from_depth=mask_from_depth)
    jf, jv, jm = (np.asarray(a) for a in register(
        world["params"], jnp.asarray(images), jnp.asarray(depths),
        None if masks is None else jnp.asarray(masks), jnp.asarray(cam_f), jnp.asarray(cam_c),
        jnp.asarray(cam_t)))
    tf, tv, tm = t_gr.register_templates(
        world["model"], 14.0, CROP, torch.from_numpy(images), torch.from_numpy(depths),
        None if masks is None else torch.from_numpy(masks), torch.from_numpy(cam_f),
        torch.from_numpy(cam_c), torch.from_numpy(cam_t))
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert jm.sum() > 50
    assert _rel_l2(tf.numpy(), jf) <= FEAT_REL_L2
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=VERT_ATOL)


def test_registration_fused_switch(world, monkeypatch):
    """use_fused_block=true runs every block through the fused-block wrapper
    (kernel 1 on the card; its plain twin here) in bf16: features within
    3e-2 relative L2 of the unfused f32 registration, validity and vertices
    unchanged."""
    images, depths, cam_f, cam_c, cam_t = _chunk(world, n=4)
    calls = []
    orig = t_dinov2.fused_vit_block

    def counted(x, *args, **kwargs):
        calls.append(x.dtype)
        return orig(x, *args, **kwargs)

    monkeypatch.setattr(t_dinov2, "fused_vit_block", counted)
    fused_cfg = dataclasses.replace(world["model"].cfg, use_fused_block=True)
    fused = t_dinov2.DinoV2(fused_cfg)
    fused.load_state_dict(world["model"].state_dict())
    args = (14.0, CROP, torch.from_numpy(images), torch.from_numpy(depths), None,
            torch.from_numpy(cam_f), torch.from_numpy(cam_c), torch.from_numpy(cam_t))
    f_f, v_f, m_f = t_gr.register_templates(fused.eval(), *args)
    f_u, v_u, m_u = t_gr.register_templates(world["model"], *args)
    assert calls == [torch.bfloat16] * 2
    assert f_f.dtype == torch.float32
    assert _rel_l2(f_f.numpy(), f_u.numpy()) <= 3e-2
    assert torch.equal(m_f, m_u) and torch.equal(v_f, v_u)


def _jax_init_ids(monkeypatch):
    """Wraps the JAX builder's kmeans so that its k-means++ init (the JAX
    draws) is recorded as row ids of the bank it clustered."""
    seen = {}
    orig = j_gr.kmeans

    def recording(samples, num_clusters, key, sample_mask=None, **kw):
        init = np.asarray(j_km._kmeanspp_init(samples.astype(jnp.float32), num_clusters, key,
                                              sample_mask))
        x = np.asarray(samples, np.float32)
        seen["ids"] = np.array([int(np.argmin(np.sum((x - c) ** 2, axis=1))) for c in init])
        np.testing.assert_array_equal(x[seen["ids"]], init)
        return orig(samples, num_clusters, key, sample_mask=sample_mask, **kw)

    monkeypatch.setattr(j_gr, "kmeans", recording)
    return seen


def _poses_from_templates(repre, model, metadata, idx, tpl_dir):
    """The port's pose_from_crops on templates `idx` as query crops (their
    own cameras and masks), same draws: (template ids, R_m2c, t_m2c,
    success, GT R_m2c, GT t_m2c)."""
    images, depths, _, cam_f, cam_c, cam_t, (w, h) = t_gr.load_template_arrays(
        [metadata[i] for i in idx], tpl_dir)
    cams = TCamera(f=torch.from_numpy(cam_f), c=torch.from_numpy(cam_c),
                   T_world_from_eye=torch.from_numpy(cam_t), width=w, height=h)
    config = t_inf.InferenceConfig(crop_size=CROP, top_n_templates=3, top_k_buddies=50,
                                   pnp_ransac_iter=200)
    out = t_inf.pose_from_crops(model, torch.from_numpy(images),
                                torch.from_numpy((depths > 0).astype(np.float32)), cams, repre,
                                config, generator=torch.Generator().manual_seed(0))
    gt = np.linalg.inv(cam_t.astype(np.float64))  # model -> camera
    return (out.template_ids.numpy(), out.R_m2c.numpy(), out.t_m2c.numpy(),
            out.success.numpy(), gt[:, :3, :3], gt[:, :3, 3])


def _rot_err_deg(r, r_gt):
    return np.degrees(np.arccos(np.clip((np.trace(r @ r_gt.T) - 1) / 2, -1, 1)))


def test_generate_repre_matches_jax(world, monkeypatch, tmp_path):
    """Both builders on one JAX-written template set, the port's k-means
    started from the JAX init's rows (the draws of the two packages differ):
    vertices, feat_to_template_ids and the validity equal (vertices within
    VERT_ATOL mm); PCA'd features and words equal up to a per-column sign
    (within 1e-3 relative L2); idfs and tf-idf descriptors within 1e-4.
    Served by the port's pose_from_crops on the same crops and draws, both
    representations retrieve the same templates, and the poses lie within
    the integration bounds."""
    metadata = _metadata(world, "jax")
    tpl_dir = world["tpl_dir"]("jax")
    seen = _jax_init_ids(monkeypatch)
    jopts = j_gr.GenRepreOpts(**_repre_opts())
    j_gr.generate_repre(jopts, metadata, vit_params=world["params"],
                        output_dir=str(tmp_path / "jax"), templates_dir=tpl_dir)
    monkeypatch.setattr(t_km, "_kmeanspp_init",
                        lambda samples, k, gen, mask, norms=None: torch.from_numpy(seen["ids"]))
    topts = t_gr.GenRepreOpts(**_repre_opts(device="cpu"))
    t_gr.generate_repre(topts, metadata, model=world["model"], output_dir=str(tmp_path / "torch"),
                        templates_dir=tpl_dir)
    jr, tr = (load_repre(str(tmp_path / p), device="cpu") for p in ("jax", "torch"))

    np.testing.assert_array_equal(tr.feat_to_template_ids.numpy(), jr.feat_to_template_ids.numpy())
    np.testing.assert_array_equal(tr.bank_mask.numpy(), jr.bank_mask.numpy())
    np.testing.assert_allclose(tr.vertices.numpy(), jr.vertices.numpy(), rtol=0, atol=VERT_ATOL)
    signs = np.sign(np.sum(tr.raw_projector.components.numpy()
                           * jr.raw_projector.components.numpy(), axis=1))
    assert np.all(signs != 0)
    for name in ("feat_vectors", "word_centroids"):
        got = getattr(tr, name).numpy() * signs
        assert _rel_l2(got, getattr(jr, name).numpy()) <= 1e-3, name
    np.testing.assert_allclose(tr.word_idfs.numpy(), jr.word_idfs.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tr.template_descs.numpy(), jr.template_descs.numpy(), rtol=0,
                               atol=1e-4)

    idx = [0, 9, 18, 27, 35]
    res = {k: _poses_from_templates(r, world["model"], metadata, idx, tpl_dir)
           for k, r in (("jax", jr), ("torch", tr))}
    np.testing.assert_array_equal(res["torch"][0], res["jax"][0])
    for ids, r, t, ok, r_gt, t_gt in res.values():
        assert ok.all()
        for i in range(len(idx)):
            assert _rot_err_deg(r[i], r_gt[i]) < ROT_DEG
            assert np.linalg.norm(t[i] - t_gt[i]) < T_MM


def test_port_chain_recovers_the_gt_pose(world, tmp_path):
    """The port alone, through its CLIs' main(): gen_templates ->
    gen_repre (--set device=cpu) -> infer -> prepare_bop_submission on the
    icosahedron's split; the estimate lies within the integration bounds
    of the GT pose; resume skips a built object; the CSV has one row."""
    import sys

    root = str(tmp_path)
    argv = sys.argv
    try:
        sys.argv = ["gen_templates", "--opts-path", os.path.join(ROOT, "configs", "gen_templates", "lmo.json"),
                    "--set", "object_dataset=\"demo\"", "--set", f"object_lids=[{OBJ_ID}]",
                    "--set", "min_num_viewpoints=9", "--set", "num_inplane_rotations=4",
                    "--set", "depth_range=[300.0, 300.0]", "--set", "ssaa_factor=2.0",
                    "--set", "crop_size=[140, 140]", "--set", f"bop_root=\"{world['bop_root']}\"",
                    "--set", f"output_dir=\"{root}/templates\""]
        t_gtpl.main()
        sys.argv = ["gen_repre", "--opts-path", os.path.join(ROOT, "configs", "gen_repre", "lmo.json"),
                    "--set", "object_dataset=\"demo\"", "--set", f"object_lids=[{OBJ_ID}]",
                    "--set", f"extractor_name=\"{TINY_EXTRACTOR}\"",
                    "--set", "pca_components=16", "--set", "cluster_num=64",
                    "--set", "batch_size=8", "--set", f"vit_overrides={json.dumps(VIT_OVERRIDES)}",
                    "--set", f"weights_path=\"{world['weights']}\"", "--set", "device=\"cpu\"",
                    "--set", f"templates_dir=\"{root}/templates\"",
                    "--set", f"output_dir=\"{root}/repre\""]
        t_gr.main()
        sys.argv += ["--set", "resume=true"]
        t_gr.main()  # the repre exists: skipped, not rebuilt
    finally:
        sys.argv = argv
    repre_dir = os.path.join(root, "repre", "demo", "v1", str(OBJ_ID))
    repre = load_repre(repre_dir, device="cpu")
    assert repre.num_templates == 36 and repre.word_centroids.shape == (64, 16)

    opts = t_infer.InferOpts(
        object_dataset="demo", object_lids=[OBJ_ID], extractor_name=TINY_EXTRACTOR,
        crop_size=CROP, match_top_n_templates=3, match_top_k_buddies=50, pnp_ransac_iter=200,
        batch_size=2, vit_overrides=VIT_OVERRIDES, dataset_crop_size=(224, 224),
        weights_path=world["weights"], bop_root=world["bop_root"],
        repre_dir=os.path.join(root, "repre"), detections_path=world["det_path"],
        output_dir=os.path.join(root, "inference"), device="cpu")
    assert t_infer.infer(opts) == {OBJ_ID: 1}
    with open(os.path.join(root, "inference", "demo", "v1", str(OBJ_ID),
                           "estimated-poses.json")) as f:
        results = json.load(f)
    assert len(results) == 1
    r_est = np.asarray(results[0]["R"], dtype=float)
    t_est = np.asarray(results[0]["t"], dtype=float).flatten()
    assert _rot_err_deg(r_est, world["r_gt"]) < ROT_DEG
    assert np.linalg.norm(t_est - world["t_gt"]) < T_MM
    csv = t_sub.prepare(t_sub.PrepareBopSubmissionOpts(
        object_dataset="demo", results_dir=os.path.join(root, "inference")))
    with open(csv) as f:
        assert len(f.read().strip().split("\n")) == 2
