"""The port's online step as a whole against the JAX package's, in f32 on
the CPU, with the JAX RANSAC draws fed to the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)
from test_pipeline import make_synthetic_world, render_synthetic_query

from foundpose_torch.models import dinov2 as t_dinov2
from foundpose_torch.models.weights import state_dict_from_jax_params
from foundpose_torch.ops.pca import PCA as TPCA
from foundpose_torch.ops.tfidf import TfidfConfig as TTfidfConfig
from foundpose_torch.pipeline import inference as t_inf
from foundpose_torch.repre import ObjectRepre as TRepre
from foundpose_torch.structs import PinholeCamera as TCamera
from foundpose_tpu.models import dinov2 as j_dinov2
from foundpose_tpu.pipeline import inference as j_inf
from foundpose_tpu.structs import PinholeCamera as JCamera


def T(a):
    return torch.from_numpy(np.array(a))


def torch_camera(cam):
    return TCamera(T(cam.f), T(cam.c), T(cam.T_world_from_eye), cam.width, cam.height)


def torch_repre(r):
    """The JAX ObjectRepre's arrays, as the port's ObjectRepre."""
    proj = r.raw_projector
    return TRepre(
        **{f: T(getattr(r, f)) for f in (
            "vertices", "feat_vectors", "feat_to_template_ids", "feat_mask",
            "word_centroids", "word_idfs", "template_descs", "bank_feats",
            "bank_vertices", "bank_mask")},
        template_cameras=torch_camera(r.template_cameras),
        raw_projector=None if proj is None else TPCA(
            T(proj.mean), T(proj.components), T(proj.explained_variance), proj.whiten),
        template_mask=None if r.template_mask is None else T(r.template_mask),
        tfidf_config=TTfidfConfig(*r.tfidf_config),
    )


def jax_pipeline_draws(key, b, top_n, h, k):
    """The draws the JAX step makes: split(key, 2B) -> crop keys B..2B,
    split(crop_key, top_n + 1), randint((H, 6), 0, K) per template."""
    crop_keys = jax.random.split(key, 2 * b)[b:]
    out = np.zeros((b, top_n, h, 6), np.int64)
    for i in range(b):
        pnp_keys = jax.random.split(crop_keys[i], top_n + 1)
        for j in range(top_n):
            out[i, j] = np.asarray(jax.random.randint(pnp_keys[j], (h, 6), 0, k))
    return out


def torch_config(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(t_inf.InferenceConfig)}
    fields["compute_dtype"] = torch.float32
    return t_inf.InferenceConfig(**fields)


def assert_same_decisions(got, ref, pose_atol=None):
    """Retrieval, winner, success and the winner's inlier count agree.

    Losing templates' RANSAC counts are not compared: on sets of random
    correspondences a hypothesis can sit on the inlier boundary, and the
    JAX package's CPU path counts with the projection test while the port
    (like the TPU kernel) uses the division-free test."""
    np.testing.assert_array_equal(got.template_ids.numpy(), np.asarray(ref.template_ids))
    np.testing.assert_array_equal(got.best_template.numpy(), np.asarray(ref.best_template))
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(ref.success))
    np.testing.assert_array_equal(got.quality.numpy(), np.asarray(ref.quality))
    if pose_atol is not None:
        for name in ("R_m2c", "t_m2c", "R_m2w", "t_m2w"):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(ref, name)), atol=pose_atol
            )


@pytest.mark.parametrize("approx_topk", [True, False])
def test_pose_from_features_matches_jax_on_structured_world(rng, approx_topk):
    """tests/test_pipeline.py's world: template_ids, best_template and
    success equal; R and t within 1e-4."""
    repre, obj_points, obj_feats, tpl_point_ids = make_synthetic_world(rng)
    fmaps, masks, cams = [], [], []
    for target in (2, 5):
        fmap, mask, cam, _, _ = render_synthetic_query(
            rng, obj_points, obj_feats, tpl_point_ids, target
        )
        fmaps.append(fmap)
        masks.append(mask)
        cams.append(cam)
    cameras = jax.tree.map(lambda *x: jnp.stack(x), *cams)
    jcfg = j_inf.InferenceConfig(
        top_n_templates=3, top_k_buddies=60, pnp_ransac_iter=200, approx_topk=approx_topk
    )
    key = jax.random.PRNGKey(0)
    ref = j_inf.pose_from_features(
        jnp.asarray(np.stack(fmaps)), jnp.asarray(np.stack(masks)), cameras, repre, key, jcfg
    )
    draws = jax_pipeline_draws(key, 2, 3, 200, 60)
    got = t_inf.pose_from_features(
        T(np.stack(fmaps)), T(np.stack(masks)), torch_camera(cameras), torch_repre(repre),
        torch_config(jcfg), draws=T(draws),
    )
    assert bool(got.success.all())
    assert_same_decisions(got, ref, pose_atol=1e-4)
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score), atol=1e-6)


@pytest.mark.parametrize("swiglu", [False, True])
def test_pose_from_crops_tiny_vit_matches_jax(rng, swiglu):
    """Tiny ViT (GELU MLP, or SwiGLU as ViT-G's): feature maps within 1e-4;
    fed the same feature maps, the port makes the JAX package's decisions;
    its own pose_from_crops agrees with both."""
    cfg_kw = dict(
        variant="vits14", embed_dim=32, depth=2, num_heads=2, mlp_ratio=4.0,
        swiglu=swiglu, patch_size=14, num_register_tokens=4, pos_grid=6,
        stride=14, facet="token", layer=1, apply_norm=True,
    )
    jvit = j_dinov2.DinoV2Config(**cfg_kw)
    params = jax.tree.map(np.asarray, j_dinov2.init_params(jax.random.PRNGKey(0), jvit))
    tvit = t_dinov2.DinoV2Config(**cfg_kw)
    model = t_dinov2.DinoV2(tvit)
    model.load_state_dict(state_dict_from_jax_params(params, tvit))
    repre, *_ = make_synthetic_world(rng, feat_dim=32)

    b, hw = 2, 84
    crops = rng.uniform(size=(b, hw, hw, 3)).astype(np.float32)
    masks = np.ones((b, hw, hw), np.float32)
    cam = JCamera(
        f=jnp.tile(jnp.asarray([[100.0, 100.0]]), (b, 1)),
        c=jnp.tile(jnp.asarray([[41.5, 41.5]]), (b, 1)),
        T_world_from_eye=jnp.tile(jnp.eye(4)[None], (b, 1, 1)), width=hw, height=hw,
    )
    jcfg = j_inf.InferenceConfig(
        crop_size=(hw, hw), top_n_templates=3, top_k_buddies=20, pnp_ransac_iter=50,
        approx_topk=True,
    )
    key = jax.random.PRNGKey(1)
    fmaps_j = j_dinov2.extract_facet(
        params, jvit, j_dinov2.normalize_images(jnp.asarray(crops))
    )["feature_maps"]
    ref = j_inf.pose_from_features(fmaps_j, jnp.asarray(masks), cam, repre, key, jcfg)

    tcfg = torch_config(jcfg)
    trep = torch_repre(repre)
    tcam = torch_camera(cam)
    draws = T(jax_pipeline_draws(key, b, 3, 50, 20))
    fmaps_t = t_dinov2.extract_facet(model, t_dinov2.normalize_images(T(crops)))["feature_maps"]
    np.testing.assert_allclose(fmaps_t.numpy(), np.asarray(fmaps_j), atol=1e-4)

    same_maps = t_inf.pose_from_features(
        T(fmaps_j), T(masks), tcam, trep, tcfg, draws=draws
    )
    assert_same_decisions(same_maps, ref)
    full = t_inf.pose_from_crops(model, T(crops), T(masks), tcam, trep, tcfg, draws=draws)
    assert_same_decisions(full, ref)
    assert full.best_corresp_2d.shape == (b, 20, 2)
