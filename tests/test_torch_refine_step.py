"""The port's online step with featuremetric refinement against the JAX
package's, on the CPU: the mixed-object step, and pose_from_crops under
configs/infer/lmo_refine.json's switches with a tiny ViT, with the JAX
RANSAC draws fed to the port. Tolerances as in test_torch_featuremetric.py.
(A file of its own so that the test runner's workers compile the JAX
steps of the two files side by side.)"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)
from test_pipeline import make_synthetic_world, render_synthetic_query
from test_torch_featuremetric import DTYPES, assert_same_refined, lmo_refine_opts
from test_torch_pipeline import T, jax_pipeline_draws, torch_camera, torch_config, torch_repre

from foundpose_torch.models import dinov2 as t_dinov2
from foundpose_torch.models.weights import state_dict_from_jax_params
from foundpose_torch.pipeline import inference as t_inf
from foundpose_torch.pipeline import multi_object as t_multi
from foundpose_torch.repre import stack_repres as t_stack_repres
from foundpose_tpu.models import dinov2 as j_dinov2
from foundpose_tpu.pipeline import inference as j_inf
from foundpose_tpu.pipeline.multi_object import pose_from_features_multi as j_multi
from foundpose_tpu.repre import stack_repres as j_stack_repres
from foundpose_tpu.structs import PinholeCamera as JCamera


def test_multi_object_step_with_refinement_matches_jax(rng):
    """A mixed batch over two stacked objects with refinement on, f32: the
    winner bank and the PCA projector are gathered per crop by object
    index."""
    repre_a, pts_a, feats_a, ids_a = make_synthetic_world(rng)
    repre_b, pts_b, feats_b, ids_b = make_synthetic_world(rng, num_templates=6, pts_per_template=48)
    fa, ma, ca, _, _ = render_synthetic_query(rng, pts_a, feats_a, ids_a, 2)
    fb, mb, cb, _, _ = render_synthetic_query(rng, pts_b, feats_b, ids_b, 4)
    cams = jax.tree.map(lambda *x: jnp.stack(x), ca, cb)
    jcfg = j_inf.InferenceConfig(top_n_templates=3, top_k_buddies=60, pnp_ransac_iter=200,
                                 refine_featuremetric=True)
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
    assert_same_refined(got, ref, "float32")


def crop_feature_world(rng, fmaps, cam):
    """A JAX repre whose template i is crop i's own feature map, each texel
    lifted to 3D at a random depth in that crop camera's frame (so crop i's
    true pose is the identity), plus one random distractor template."""
    from foundpose_tpu.ops.tfidf import TfidfConfig, calc_template_tfidf_descriptors
    from foundpose_tpu.repre import make_repre

    b, gh, gw, d = fmaps.shape
    uv = np.stack(np.meshgrid(np.arange(gw) * 14.0 + 7.0, np.arange(gh) * 14.0 + 7.0), -1).reshape(-1, 2)
    rays = np.concatenate([(uv - np.asarray(cam.c[0])) / np.asarray(cam.f[0]), np.ones((len(uv), 1))], -1)
    feats = [fmaps[i].reshape(-1, d) for i in range(b)] + [rng.normal(size=(gh * gw, d))]
    verts = [rays * rng.uniform(0.4, 0.6, size=(len(uv), 1)) for _ in range(b)]
    verts.append(rng.uniform(-0.1, 0.1, size=(gh * gw, 3)))
    feats = np.concatenate(feats).astype(np.float32)
    ids = np.repeat(np.arange(b + 1), gh * gw).astype(np.int32)
    words = (feats[rng.choice(len(feats), 40, replace=False)] + 0.01 * rng.normal(size=(40, d))).astype(np.float32)
    cfg = TfidfConfig(knn_k=3)
    descs, idfs = calc_template_tfidf_descriptors(
        jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(words), b + 1, cfg)
    tcams = JCamera(f=jnp.full((b + 1, 2), 100.0), c=jnp.full((b + 1, 2), 41.5),
                    T_world_from_eye=jnp.tile(jnp.eye(4)[None], (b + 1, 1, 1)), width=84, height=84)
    return make_repre(feats, np.concatenate(verts).astype(np.float32), ids, words,
                      np.asarray(idfs), np.asarray(descs), tcams, tfidf_config=cfg)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pose_from_crops_under_lmo_refine_json_matches_jax(rng, dtype):
    """pose_from_crops under lmo_refine.json's switches (fused block, tanh
    GELU, capped softmax, approx top-k, refinement on), cut to a tiny ViT
    (64 wide, depth 2) on 84 px crops with 3 templates, 20 buddies and 50
    hypotheses, in f32 and in bf16, against JAX pose_from_features fed the
    port's feature maps and the same draws. Every crop finds itself; R and
    t within POSE_ATOL."""
    jdt, tdt = DTYPES[dtype]
    opts = lmo_refine_opts()
    cfg = dataclasses.replace(
        t_inf.inference_config_from_opts(opts), crop_size=(84, 84), top_n_templates=3,
        top_k_buddies=20, pnp_ransac_iter=50, compute_dtype=tdt,
    )
    tvit = dataclasses.replace(t_inf.vit_config_from_opts(opts), embed_dim=64, depth=2,
                               num_heads=1, pos_grid=6, layer=1)
    jvit = j_dinov2.DinoV2Config(**{f.name: getattr(tvit, f.name) for f in dataclasses.fields(tvit)})
    params = jax.tree.map(np.asarray, j_dinov2.init_params(jax.random.PRNGKey(0), jvit))
    model = t_dinov2.DinoV2(tvit)
    model.load_state_dict(state_dict_from_jax_params(params, tvit))

    b, hw = 3, 84
    crops = rng.uniform(size=(b, hw, hw, 3)).astype(np.float32)
    masks = np.ones((b, hw, hw), np.float32)
    cam = JCamera(f=jnp.full((b, 2), 100.0), c=jnp.full((b, 2), 41.5),
                  T_world_from_eye=jnp.tile(jnp.eye(4)[None], (b, 1, 1)), width=hw, height=hw)
    fmaps = t_dinov2.extract_facet(model, t_inf.preprocess_crops(T(crops), cfg))["feature_maps"].float()
    repre = crop_feature_world(rng, fmaps.numpy(), cam)
    key = jax.random.PRNGKey(1)
    jcfg = j_inf.InferenceConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "compute_dtype"},
        compute_dtype=jdt,
    )
    ref = j_inf.pose_from_features(jnp.asarray(fmaps.numpy()), jnp.asarray(masks), cam, repre, key, jcfg)
    got = t_inf.pose_from_crops(
        model, T(crops), T(masks), torch_camera(cam), torch_repre(repre), cfg,
        draws=T(jax_pipeline_draws(key, b, 3, 50, 20)),
    )
    assert got.success.tolist() == [True] * b
    assert got.best_template.tolist() == list(range(b))
    assert_same_refined(got, ref, dtype)
