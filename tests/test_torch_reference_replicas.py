"""The reference replicas and the ViT parity leg of the port
(foundpose_torch/benchmarks/{hf_dinov2,host_standins,reference_baseline,
reference_offline_baseline}.py and cross_parity.vit_parity_leg) on the CPU:

- hf_dinov2's two models against transformers' Dinov2Model and
  Dinov2WithRegistersModel, both loaded from one to_hf_state_dict: every
  hidden state and the final layernorm within 1e-5, at the native grid and
  at an interpolated one, with the GELU and the SwiGLU MLP;
- the port's vit_parity_leg against the JAX benchmarks/cross_parity.py leg
  (the port's ViT against hf_dinov2, the JAX ViT against transformers) on
  the JAX init's weights: both <= 2e-4 at 518 px (one crop), the two
  deltas within 1e-3 of each other at 84 px (two crops);
- the numpy PCA and Lloyd stand-ins against scikit-learn's PCA and KMeans;
- both replicas' main() at tiny sizes: the JAX scripts' JSON keys, every
  figure finite.
"""

import os
import sys

# transformers would also import TensorFlow (~7 s), which no test here uses.
os.environ.setdefault("USE_TF", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch_cpu  # noqa: E402, F401 (torch's CPU threads: this process's share)

from foundpose_torch.benchmarks import (cross_parity, hf_dinov2, host_standins,  # noqa: E402
                                        reference_baseline, reference_offline_baseline)
from foundpose_torch.models import bench_weights, dinov2, weights  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A ViT small enough for the CPU: one head of 64, the width of the card's
# attention kernel; hidden_states[9] needs 9 layers.
TINY_HF = dict(hidden_size=64, num_attention_heads=1, num_hidden_layers=9)

# benchmarks/reference_baseline.py:237-256, the result dict of main().
BASELINE_KEYS = {"metric", "measured_this_host", "host", "stage_seconds_per_crop",
                 "adjusted_reference_estimate", "adjustment", "n_crops"}
BASELINE_STAGES = {"warp", "vit", "grid_sample", "pca", "words", "tfidf_retrieval", "buddies",
                   "pnp"}
# benchmarks/reference_offline_baseline.py:142, the report of main().
OFFLINE_KEYS = {"metric", "host", "gen_templates", "gen_repre", "adjustment",
                "adjusted_total_s_per_object"}
OFFLINE_SUBKEYS = {
    "gen_templates": {"per_view_cpu_s", "measured_cpu_s_per_object_excl_render",
                      "adjusted_s_per_object", "adjusted_templates_per_s"},
    "gen_repre": {"per_template_s", "pca_s", "kmeans_s_extrapolated", "tfidf_s",
                  "measured_s_per_object", "adjusted_s_per_object", "adjusted_templates_per_s"},
    "adjustment": {"render_gl_s_per_view", "vit_gpu_s", "cpu_scale", "kmeans_gpu_speedup"},
}
# The keys the port adds to both.
ADDED_KEYS = {"card", "cpu_count"}


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def random_tree(tree, rng, scale=0.3):
    """Every leaf of a parameter tree replaced by normal draws (layer
    scales, norms and biases too, so that none of them is a no-op)."""
    if isinstance(tree, dict):
        return {k: random_tree(v, rng, scale) for k, v in tree.items()}
    return (rng.normal(size=np.shape(tree)) * scale).astype(np.float32)


def tiny_pair(registers, swiglu):
    """(transformers model, hf_dinov2 model): 2 layers, 64 wide, one head
    of 64, 84 px pretraining grid, loaded from one to_hf_state_dict."""
    import transformers

    cfg = dinov2.DinoV2Config(embed_dim=64, depth=2, num_heads=1, pos_grid=6, swiglu=swiglu,
                              num_register_tokens=4 if registers else 0)
    params = random_tree(bench_weights.init_params(cfg, torch.Generator().manual_seed(0)),
                         np.random.default_rng(1))
    sd = weights.to_hf_state_dict(params, cfg)
    kw = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=1, mlp_ratio=4,
              patch_size=14, image_size=84, use_swiglu_ffn=swiglu, layer_norm_eps=1e-6,
              hidden_act="gelu", attn_implementation="eager")
    ours_cfg = hf_dinov2.Dinov2Config(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                                      image_size=84, use_swiglu_ffn=swiglu)
    if registers:
        theirs = transformers.Dinov2WithRegistersModel(
            transformers.Dinov2WithRegistersConfig(num_register_tokens=4, **kw))
        ours = hf_dinov2.Dinov2WithRegistersModel(ours_cfg)
    else:
        theirs = transformers.Dinov2Model(transformers.Dinov2Config(**kw))
        ours = hf_dinov2.Dinov2Model(ours_cfg)
    missing, unexpected = theirs.load_state_dict(sd, strict=False)
    assert missing == ["embeddings.mask_token"] and not unexpected
    assert set(ours.state_dict()) == set(theirs.state_dict())
    return theirs.eval(), hf_dinov2.load_hf_state_dict(ours, sd)


@pytest.mark.parametrize("size", [84, 56], ids=["native", "interpolated"])
@pytest.mark.parametrize("swiglu", [False, True], ids=["gelu", "swiglu"])
@pytest.mark.parametrize("registers", [False, True],
                         ids=["Dinov2Model", "Dinov2WithRegistersModel"])
def test_hf_dinov2_matches_transformers(registers, swiglu, size):
    """Every hidden state and the final layernorm within 1e-5 of
    transformers' eager forward, at the native 6 x 6 grid and at 4 x 4,
    where each class's own interpolation recipe runs (antialiased for the
    registers model)."""
    pytest.importorskip("transformers")
    theirs, ours = tiny_pair(registers, swiglu)
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(2, 3, size, size))
                         .astype(np.float32))
    with torch.no_grad():
        want = theirs(x, output_hidden_states=True)
        got = ours(x, output_hidden_states=True)
    assert len(got.hidden_states) == len(want.hidden_states) == 3
    for g, w in zip(got.hidden_states, want.hidden_states):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.last_hidden_state.numpy(), want.last_hidden_state.numpy(),
                               atol=1e-5)


def test_load_hf_state_dict_allows_only_the_mask_token_missing():
    cfg = dinov2.DinoV2Config(embed_dim=64, depth=2, num_heads=1, pos_grid=6)
    sd = weights.to_hf_state_dict(
        bench_weights.init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    hf_cfg = hf_dinov2.Dinov2Config(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                                    image_size=84)
    hf_dinov2.load_hf_state_dict(hf_dinov2.Dinov2WithRegistersModel(hf_cfg), sd)
    with pytest.raises(ValueError, match="layernorm.bias"):
        hf_dinov2.load_hf_state_dict(hf_dinov2.Dinov2WithRegistersModel(hf_cfg),
                                     {k: v for k, v in sd.items() if k != "layernorm.bias"})
    with pytest.raises(ValueError, match="register_tokens"):
        hf_dinov2.load_hf_state_dict(hf_dinov2.Dinov2Model(hf_cfg), sd)


@pytest.fixture(scope="module")
def jax_vits_params():
    """The JAX leg's weights: the JAX package's ViT-S/14-reg
    init_params(PRNGKey(0)), as a numpy tree."""
    import jax

    from foundpose_tpu.models import dinov2 as j_dinov2

    cfg = j_dinov2.parse_model_name(
        "dinov2_version=vits14-reg_stride=14_facet=token_layer=9_norm=1")
    return jax.tree.map(np.asarray, j_dinov2.init_params(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("size, n_crops", [(None, 1), (84, 2)],
                         ids=["native_518px", "interpolated_84px"])
def test_vit_parity_leg_matches_the_jax_leg(jax_vits_params, size, n_crops):
    """At 518 px neither side interpolates: both deltas within 2e-4, the
    JAX package's bound against transformers (tests/test_dinov2.py). At 84
    px both compare the official +0.1 recipe with the registers model's
    antialiased one, so the two deltas agree within 1e-3."""
    pytest.importorskip("transformers")
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    import cross_parity as jp

    want = jp.vit_parity_leg(n_crops=n_crops, size=size)
    got = cross_parity.vit_parity_leg(n_crops=n_crops, size=size, params_np=jax_vits_params,
                                      device="cpu")
    if size is None:
        assert want <= 2e-4 and got <= 2e-4, (want, got)
    else:
        assert abs(got - want) <= 1e-3, (want, got)


def test_pca_standin_matches_sklearn():
    """explained_variance_ at rtol 1e-5, transform up to each component's
    sign at atol 1e-4."""
    sklearn_pca = pytest.importorskip("sklearn.decomposition")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(600, 24)) @ rng.normal(size=(24, 24)) + rng.normal(size=24)
    want = sklearn_pca.PCA(n_components=8).fit(x)
    got = host_standins.PCA(n_components=8).fit(x)
    np.testing.assert_allclose(got.explained_variance_, want.explained_variance_, rtol=1e-5)
    tw, tg = want.transform(x), got.transform(x)
    signs = np.sign(np.sum(tw * tg, axis=0))
    np.testing.assert_allclose(tg * signs, tw, atol=1e-4)


def test_kmeans_lloyd_matches_sklearn():
    """From one init, 3 Lloyd steps: the same labels and centres within
    1e-4 as KMeans(algorithm="lloyd", max_iter=3, tol=0), on blobs where no
    cluster empties."""
    sklearn_cluster = pytest.importorskip("sklearn.cluster")
    rng = np.random.default_rng(0)
    k = 16
    means = rng.normal(size=(k, 8)) * 6.0
    x = (means[rng.integers(0, k, 3000)] + rng.normal(size=(3000, 8))).astype(np.float32)
    init = (means + rng.normal(size=means.shape)).astype(np.float32)
    want = sklearn_cluster.KMeans(n_clusters=k, init=init, n_init=1, algorithm="lloyd",
                                  max_iter=3, tol=0.0).fit(x)
    centers, labels, _ = host_standins.kmeans_lloyd(x, k, 3, init=init)
    assert np.bincount(labels, minlength=k).min() > 0
    np.testing.assert_array_equal(labels, want.labels_)
    np.testing.assert_allclose(centers, want.cluster_centers_, atol=1e-4)


def test_kmeans_lloyd_random_init_draws_distinct_rows():
    x = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    centers, labels, steps = host_standins.kmeans_lloyd(x, 8, 0, seed=3)
    rows = np.random.default_rng(3).choice(64, size=8, replace=False)
    np.testing.assert_array_equal(centers, x[rows])
    assert steps == 0 and labels.shape == (64,)


def test_reference_baseline_main_reports_the_jax_keys():
    pytest.importorskip("cv2")
    r = reference_baseline.main(
        ["--device", "cpu", "--crops", "2", "--templates", "8", "--words", "64", "--pca-dim",
         "32", "--buddies", "40"], vit_overrides=TINY_HF)
    assert set(r) == BASELINE_KEYS | ADDED_KEYS | {"adjusted_with_measured_vit"}
    assert set(r["stage_seconds_per_crop"]) == BASELINE_STAGES
    assert set(r["adjustment"]) == {"vit_gpu_seconds", "cpu_scale"}
    figures = [r["measured_this_host"], r["adjusted_reference_estimate"],
               r["adjusted_with_measured_vit"], *r["stage_seconds_per_crop"].values()]
    assert np.isfinite(figures).all() and min(figures) >= 0.0
    assert r["n_crops"] == 2 and r["card"] == "cpu"


def test_reference_offline_baseline_main_reports_the_jax_keys():
    pytest.importorskip("cv2")
    r = reference_offline_baseline.main(
        ["--device", "cpu", "--views", "1", "--reps", "1", "--templates", "8"],
        vit_overrides=TINY_HF, pca_cap=2000, pca_dim=32, num_words=64, kmeans_rows=1024,
        tfidf_reps=2)
    assert set(r) == OFFLINE_KEYS | ADDED_KEYS
    for key, sub in OFFLINE_SUBKEYS.items():
        assert set(r[key]) == sub, key
    assert set(r["gen_templates"]["per_view_cpu_s"]) == {"warp_map_s", "remap_s", "resize_s",
                                                         "png_s"}
    assert set(r["gen_repre"]["per_template_s"]) == {"load_s", "erode_grid_lift_s", "vit_s",
                                                     "grid_sample_s"}
    figures = [v for v in leaves({k: r[k] for k in ("gen_templates", "gen_repre",
                                                    "adjusted_total_s_per_object")})]
    assert np.isfinite(figures).all() and min(figures) >= 0.0


@pytest.mark.parametrize("entry", ["vit_parity_leg", "reference_baseline",
                                   "reference_offline_baseline"])
def test_entry_points_refuse_the_card_without_one(entry):
    """Each runs on the card by default and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    run = {"vit_parity_leg": cross_parity.vit_parity_leg,
           "reference_baseline": reference_baseline.run,
           "reference_offline_baseline": reference_offline_baseline.run}[entry]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run()


def test_hf_dinov2_stands_apart_from_the_port():
    """hf_dinov2 imports nothing of the port, so that its agreement with
    the port's ViT is evidence about both."""
    import ast

    tree = ast.parse(open(hf_dinov2.__file__).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.startswith(("foundpose", "transformers"))], names
