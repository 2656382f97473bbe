"""The port's serving path against the JAX package, in f32 on the CPU:
crop cameras, the single-image warp, stacked representations, the
mixed-object step and PoseEngine (with the JAX engine's RANSAC draws fed to
the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pipeline import make_synthetic_world, render_synthetic_query
from test_torch_pipeline import (
    T,
    assert_same_decisions,
    jax_pipeline_draws,
    torch_camera,
    torch_config,
    torch_repre,
)

from foundpose_torch import cameras as t_cameras
from foundpose_torch import engine as t_engine
from foundpose_torch.models import dinov2 as t_dinov2
from foundpose_torch.models.weights import load_checkpoint, state_dict_from_jax_params
from foundpose_torch.ops import warp as t_warp
from foundpose_torch.pipeline import multi_object as t_multi
from foundpose_torch.repre import stack_repres as t_stack_repres
from foundpose_torch.structs import PinholeCamera as TCamera
from foundpose_tpu import cameras as j_cameras
from foundpose_tpu import engine as j_engine
from foundpose_tpu.models import dinov2 as j_dinov2
from foundpose_tpu.ops import warp as j_warp
from foundpose_tpu.pipeline import inference as j_inf
from foundpose_tpu.pipeline.multi_object import pose_from_features_multi as j_multi
from foundpose_tpu.repre import stack_repres as j_stack_repres
from foundpose_tpu.structs import PinholeCamera as JCamera

K_IMAGE = np.array([[300.0, 0, 159.5], [0, 290.0, 119.5], [0, 0, 1]], np.float32)
BOXES = np.array(
    [[80.0, 60.0, 180.0, 160.0], [100.0, 80.0, 220.0, 200.0], [-20.0, 150.5, 90.25, 260.0]],
    np.float32,
)
TINY_VIT = dict(embed_dim=32, depth=2, num_heads=2, pos_grid=6, layer=1)


def crop_cameras(crop_size=(64, 64)):
    jcam = JCamera.from_intrinsic_matrix(K_IMAGE, width=320, height=240)
    jb = j_cameras.build_crop_cameras(
        jcam, jnp.asarray(BOXES), viewport_size=crop_size, viewport_rel_pad=0.2
    )
    tcam = TCamera.from_intrinsic_matrix(K_IMAGE, width=320, height=240)
    tb = t_cameras.build_crop_cameras(
        tcam, torch.from_numpy(BOXES), viewport_size=crop_size, viewport_rel_pad=0.2
    )
    return jcam, jb, tcam, tb


def test_build_crop_cameras_matches_jax():
    """Batched crop cameras (one box partly off the image): f, c and the
    extrinsics agree to f32 rounding; K and the viewport are carried."""
    jcam, jb, tcam, tb = crop_cameras((420, 420))
    np.testing.assert_allclose(tb.f.numpy(), np.asarray(jb.f), rtol=1e-5)
    np.testing.assert_allclose(tb.c.numpy(), np.asarray(jb.c), rtol=1e-6)
    np.testing.assert_allclose(
        tb.T_world_from_eye.numpy(), np.asarray(jb.T_world_from_eye), atol=1e-6
    )
    np.testing.assert_allclose(tcam.K.numpy(), np.asarray(jcam.K))
    assert (tb.width, tb.height) == (420, 420) and tb.f.shape == (3, 2)


def test_samplers_match_jax_at_borders_and_pixel_centres(rng):
    """Bilinear and nearest sampling at integer centres, half-pixel
    offsets, the last row/column and outside the image: bilinear within
    1e-6, nearest exact (round half to even, the image's dtype kept)."""
    image = rng.uniform(size=(9, 11, 3)).astype(np.float32)
    pts = [(0.0, 0.0), (10.0, 8.0), (10.5, 8.5), (-0.5, 3.0), (-1.0, -1.0), (2.5, 3.5),
           (3.5, 2.5), (11.2, 4.0), (5.25, 7.75), (-0.6, 8.4), (4.0, 9.0)]
    xy = np.concatenate([np.array(pts, np.float32),
                         rng.uniform(-2, 12, size=(50, 2)).astype(np.float32)])
    for img in (image, image[..., 0]):
        np.testing.assert_allclose(
            t_warp.bilinear_sample(T(img), T(xy)).numpy(),
            np.asarray(j_warp.bilinear_sample(jnp.asarray(img), jnp.asarray(xy))), atol=1e-6,
        )
    u8 = (image * 255).astype(np.uint8)
    got = t_warp.nearest_sample(T(u8), T(xy))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_warp.nearest_sample(jnp.asarray(u8), jnp.asarray(xy)))
    )


@pytest.mark.parametrize("interpolation", ["bilinear", "nearest", "area2x"])
def test_warp_image_matches_jax(rng, interpolation):
    """One image into one crop camera of a box partly off the image: within
    1e-4 (nearest on >= 99.9% of pixels: a source coordinate on a rounding
    boundary may flip)."""
    jcam, jb, tcam, tb = crop_cameras()
    image = rng.uniform(size=(240, 320, 3)).astype(np.float32)
    ref = np.asarray(j_warp.warp_image(
        jcam, jax.tree.map(lambda a: a[2], jb), jnp.asarray(image), interpolation=interpolation))
    got = t_warp.warp_image(tcam, tb.index(2), T(image), interpolation=interpolation).numpy()
    assert got.shape == ref.shape == (64, 64, 3)
    close = np.abs(got - ref) <= 1e-4
    assert close.mean() >= (0.999 if interpolation == "nearest" else 1.0)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_single_image_warp_matches_jax(rng, dtype):
    """One image into three crop cameras with per-detection masks. Float:
    crops within 1e-4. uint8: uint8 outputs, crops within one level (the
    source coordinates differ by f32 rounding), masks in {0, 1}. Masks agree
    on >= 99.9% of pixels (a pixel whose source coordinate sits on a
    rounding boundary may flip)."""
    jcam, jb, tcam, tb = crop_cameras()
    image = rng.uniform(size=(240, 320, 3)).astype(np.float32)
    masks = np.zeros((3, 240, 320), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(BOXES.astype(int)):
        masks[i, max(y1, 0) + 5 : y2 - 5, max(x1, 0) + 5 : x2 - 5] = 1.0
    if dtype == "uint8":
        image = (image * 255).astype(np.uint8)
        masks = masks.astype(np.uint8)
    ref_img, ref_msk = j_warp.make_single_image_warp((64, 64))(
        jnp.asarray(image), jnp.asarray(masks), jcam, jb
    )
    got_img, got_msk = t_warp.make_single_image_warp((64, 64))(T(image), T(masks), tcam, tb)
    assert got_img.shape == (3, 64, 64, 3) and got_msk.shape == (3, 64, 64)
    assert str(got_img.dtype) == f"torch.{np.asarray(ref_img).dtype}"
    assert str(got_msk.dtype) == f"torch.{np.asarray(ref_msk).dtype}"
    diff = np.abs(got_img.numpy().astype(np.float32) - np.asarray(ref_img).astype(np.float32))
    assert diff.max() <= (1.0 if dtype == "uint8" else 1e-4)
    assert np.mean(got_msk.numpy() == np.asarray(ref_msk)) >= 0.999
    assert set(np.unique(got_msk.numpy())) <= {0, 1}


def test_stack_repres_matches_jax(rng):
    """Two ragged objects (8 and 6 templates): every stacked field equal,
    template_mask marking the real templates."""
    a, *_ = make_synthetic_world(rng)
    b, *_ = make_synthetic_world(np.random.default_rng(5), num_templates=6, pts_per_template=48)
    ref = j_stack_repres([a, b])
    got = t_stack_repres([torch_repre(a), torch_repre(b)])
    for f in ("vertices", "feat_vectors", "feat_to_template_ids", "feat_mask", "word_centroids",
              "word_idfs", "template_descs", "bank_feats", "bank_vertices", "bank_mask",
              "template_mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    for f in ("f", "c", "T_world_from_eye"):
        np.testing.assert_array_equal(
            getattr(got.template_cameras, f).numpy(), np.asarray(getattr(ref.template_cameras, f))
        )


def test_pose_from_features_multi_matches_jax(rng):
    """A mixed batch over two stacked objects, exact top-k: template ids,
    winner, success and count equal; R and t within 1e-4."""
    repre_a, pts_a, feats_a, ids_a = make_synthetic_world(rng)
    repre_b, pts_b, feats_b, ids_b = make_synthetic_world(rng, num_templates=6, pts_per_template=48)
    fa, ma, ca, _, _ = render_synthetic_query(rng, pts_a, feats_a, ids_a, 2)
    fb, mb, cb, _, _ = render_synthetic_query(rng, pts_b, feats_b, ids_b, 4)
    cams = jax.tree.map(lambda *x: jnp.stack(x), ca, cb)
    jcfg = j_inf.InferenceConfig(top_n_templates=3, top_k_buddies=60, pnp_ransac_iter=200)
    key = jax.random.PRNGKey(0)
    fmaps, masks = np.stack([fa, fb]), np.stack([ma, mb])
    ref = j_multi(jnp.asarray(fmaps), jnp.asarray(masks), cams, jnp.asarray([0, 1]),
                  j_stack_repres([repre_a, repre_b]), key, jcfg)
    got = t_multi.pose_from_features_multi(
        T(fmaps), T(masks), torch_camera(cams), torch.tensor([0, 1]),
        t_stack_repres([torch_repre(repre_a), torch_repre(repre_b)]), torch_config(jcfg),
        draws=T(jax_pipeline_draws(key, 2, 3, 200, 60)),
    )
    assert bool(got.success.all())
    assert_same_decisions(got, ref, pose_atol=1e-4)
    assert int(got.template_ids[1].max()) < 6


def crop_world(rng, je, image, masks, templates):
    """Objects the JAX engine can find in `image`: template i of an object
    is the tiny ViT's feature map of the crop of box templates[i] (boxes as
    in BOXES), each texel lifted to 3D in that crop camera's frame at a
    random depth, so that crop's true pose is the crop camera itself; plus
    one random distractor template per object. Returns {obj_id: repre}."""
    from foundpose_tpu.ops.tfidf import TfidfConfig, calc_template_tfidf_descriptors
    from foundpose_tpu.repre import make_repre

    src = JCamera.from_intrinsic_matrix(K_IMAGE, width=320, height=240)
    cams = j_cameras.build_crop_cameras(src, jnp.asarray(BOXES), je.config.crop_size, 0.2)
    crops, _ = je._warp_single(jnp.asarray(image, jnp.float32) / 255.0, jnp.asarray(masks), src, cams)
    fmaps = np.asarray(j_dinov2.extract_facet(
        je.vit_params, je.vit_cfg, j_dinov2.normalize_images(crops))["feature_maps"])
    n, gh, gw, d = fmaps.shape
    uv = np.stack(np.meshgrid(np.arange(gw) * 14.0 + 7.0, np.arange(gh) * 14.0 + 7.0), -1)
    uv = uv.reshape(-1, 2)
    repres = {}
    for obj_id, boxes in templates.items():
        feats, verts = [], []
        for i in boxes:
            rays = (uv - np.asarray(cams.c[i])) / np.asarray(cams.f[i])
            depth = rng.uniform(0.4, 0.6, size=(len(uv), 1))
            feats.append(fmaps[i].reshape(-1, d))
            verts.append(np.concatenate([rays, np.ones_like(depth)], -1) * depth)
        feats.append(rng.normal(size=(gh * gw, d)))
        verts.append(rng.uniform(-0.1, 0.1, size=(gh * gw, 3)))
        feats = np.concatenate(feats).astype(np.float32)
        ids = np.repeat(np.arange(len(boxes) + 1), gh * gw).astype(np.int32)
        words = feats[rng.choice(len(feats), 40, replace=False)] + 0.01 * rng.normal(size=(40, d))
        cfg = TfidfConfig(knn_k=3)
        descs, idfs = calc_template_tfidf_descriptors(
            jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(words, jnp.float32), len(boxes) + 1, cfg)
        nt = len(boxes) + 1
        tcams = JCamera(f=jnp.full((nt, 2), 100.0), c=jnp.full((nt, 2), 41.5),
                        T_world_from_eye=jnp.tile(jnp.eye(4)[None], (nt, 1, 1)), width=84, height=84)
        repres[obj_id] = make_repre(
            feats, np.concatenate(verts).astype(np.float32), ids, np.asarray(words, np.float32),
            np.asarray(idfs), np.asarray(descs), tcams, tfidf_config=cfg)
    return repres


def tiny_engines(tmp_path):
    """The JAX engine, assembled as tests/test_engine.py does, and the
    port's PoseEngine on the CPU with the same weights (an official-name
    checkpoint written here). The port takes the JAX engine's RANSAC draws:
    PRNGKey(counter) per chunk."""
    jvit = j_dinov2.DinoV2Config(
        variant="vits14", swiglu=False, patch_size=14, num_register_tokens=4, stride=14,
        facet="token", apply_norm=True, mlp_ratio=4.0, **TINY_VIT,
    )
    params = jax.tree.map(np.asarray, j_dinov2.init_params(jax.random.PRNGKey(0), jvit))
    jcfg = j_inf.InferenceConfig(
        crop_size=(84, 84), grid_cell_size=14.0, top_n_templates=2, top_k_buddies=16,
        pnp_ransac_iter=50, lm_iters=3,
    )
    je = j_engine.PoseEngine.__new__(j_engine.PoseEngine)
    je.vit_cfg, je.vit_params, je.config, je.batch_size = jvit, params, jcfg, 2
    je._repres, je._multi_cache, je._counter = {}, None, 0
    je._step = j_inf.jit_pose_from_crops(jvit, jcfg)
    je._warp_single = j_engine._make_single_image_warp(jcfg.crop_size)

    path = str(tmp_path / "tiny.pth")
    tvit = t_dinov2.DinoV2Config(**{f: getattr(jvit, f) for f in (
        "variant", "swiglu", "patch_size", "num_register_tokens", "stride", "facet",
        "apply_norm", "mlp_ratio", *TINY_VIT)})
    torch.save(state_dict_from_jax_params(params, tvit), path)
    te = t_engine.PoseEngine(weights_path=path, config=torch_config(jcfg), batch_size=2,
                             extractor_overrides=TINY_VIT, device="cpu")
    te._draws = lambda b: T(jax_pipeline_draws(
        jax.random.PRNGKey(te._counter), b, jcfg.top_n_templates, jcfg.pnp_ransac_iter,
        jcfg.top_k_buddies))
    return je, te


def assert_same_results(got, ref, expect_success):
    """Winner, success and count equal per detection, success where the
    world says so; successful poses within 1e-4 (a failed detection's pose
    comes from near-tied matches of a wrong template and is not compared)."""
    assert len(got) == len(ref)
    assert [g["success"] for g in got] == expect_success
    for g, r in zip(got, ref):
        assert (g["best_template"], g["success"], g["quality"]) == (
            r["best_template"], r["success"], r["quality"])
        np.testing.assert_allclose(g["crop_camera"].f.numpy(), np.asarray(r["crop_camera"].f),
                                   rtol=1e-5)
        if g["success"]:
            np.testing.assert_allclose(g["R_m2c"], r["R_m2c"], atol=1e-4)
            np.testing.assert_allclose(g["t_m2c"], r["t_m2c"], atol=1e-4)
            np.testing.assert_allclose(g["score"], r["score"], atol=1e-6)


def test_engine_matches_jax_engine(rng, tmp_path):
    """estimate() on three detections (two chunks of batch 2, the second
    padded), without masks and with bool masks, then estimate_mixed() over
    two objects: the JAX engine's decisions and poses. Object 3 was built
    from boxes 0 and 2, object 7 from box 1."""
    je, te = tiny_engines(tmp_path)
    image = (rng.uniform(size=(240, 320, 3)) * 255).astype(np.uint8)
    boxes = list(BOXES)
    masks = [np.zeros((240, 320), bool) for _ in boxes]
    for m, (x1, y1, x2, y2) in zip(masks, BOXES.astype(int)):
        m[max(y1, 0) : y2, max(x1, 0) : x2] = True
    repres = crop_world(rng, je, image, np.ones((3, 240, 320), np.float32), {3: [0, 2], 7: [1]})
    for obj_id, r in repres.items():
        je.register_object(obj_id, r)
        te.register_object(obj_id, torch_repre(r))

    assert te.estimate(3, image, [], K_IMAGE) == []
    assert_same_results(te.estimate(3, image, boxes, K_IMAGE),
                        je.estimate(3, image, boxes, K_IMAGE), [True, False, True])
    assert_same_results(te.estimate(7, image, boxes, K_IMAGE, masks),
                        je.estimate(7, image, boxes, K_IMAGE, masks), [False, True, False])
    dets = [{"obj_id": o, "box_xyxy": b} for o, b in zip((3, 7, 3), boxes)]
    assert_same_results(te.estimate_mixed(image, dets, K_IMAGE),
                        je.estimate_mixed(image, dets, K_IMAGE), [True, True, True])
    assert te._counter == je._counter == 6
    te.unregister_object(7)
    assert te.object_ids == [3] and te._multi_cache is None


def test_engine_refuses_a_mesh():
    """A mesh needs an initialized process group of its size (the mesh
    path itself: tests/test_torch_mesh_engine.py)."""
    with pytest.raises(ValueError, match="torchrun"):
        t_engine.PoseEngine(mesh_shape=(2, 1), device="cpu")


def test_load_checkpoint_reads_official_names(tmp_path):
    """An official-name state dict (with the unused mask_token, under
    "model") loads exactly; a missing parameter raises."""
    cfg = t_dinov2.DinoV2Config(variant="vits14", **TINY_VIT)
    src = t_dinov2.DinoV2(cfg)
    state = {k: torch.randn_like(v) for k, v in src.state_dict().items()}
    path = tmp_path / "ckpt.pth"
    torch.save({"model": {**state, "mask_token": torch.zeros(1, 32)}}, path)
    model = load_checkpoint(str(path), cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
    del state["norm.bias"]
    torch.save(state, path)
    with pytest.raises(ValueError):
        load_checkpoint(str(path), cfg)
