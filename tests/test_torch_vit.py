"""Parity of the port's ViT (block twin, extract_facet, weights) with the
JAX package on small shapes, in f32 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)
from jax.experimental.pallas import tpu as pltpu

from foundpose_torch.models import bench_weights as t_bench
from foundpose_torch.models import dinov2 as t_dinov2
from foundpose_torch.models.weights import state_dict_from_jax_params
from foundpose_torch.ops.vit_block import fused_vit_block, fused_vit_block_plain
from foundpose_tpu.models import bench_weights as j_bench
from foundpose_tpu.models import dinov2 as j_dinov2
from foundpose_tpu.models.weights import params_from_torch_state_dict
from foundpose_tpu.ops.vit_block import fused_vit_block as j_fused_vit_block


def tiny_cfg(**kw):
    base = dict(
        variant="vits14", embed_dim=64, depth=3, num_heads=4, mlp_ratio=4.0,
        swiglu=False, patch_size=14, num_register_tokens=4, pos_grid=6,
        stride=14, facet="token", layer=2, apply_norm=True,
    )
    base.update(kw)
    return base


def random_layer(rng, d=64, hidden=256):
    """One block's weights in the JAX layout, with a non-trivial layer scale
    so the residual branches matter."""
    n = lambda *s, scale=0.1: (rng.normal(size=s) * scale).astype(np.float32)
    return {
        "norm1_scale": 1.0 + n(d), "norm1_bias": n(d),
        "qkv_kernel": n(d, 3 * d, scale=0.3), "qkv_bias": n(3 * d),
        "proj_kernel": n(d, d), "proj_bias": n(d), "ls1": 0.5 + n(d),
        "norm2_scale": 1.0 + n(d), "norm2_bias": n(d), "ls2": 0.5 + n(d),
        "fc1_kernel": n(d, hidden), "fc1_bias": n(hidden),
        "fc2_kernel": n(hidden, d), "fc2_bias": n(d),
    }


def torch_layer(layer):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    out = {k: t(v) for k, v in layer.items() if not k.endswith("_kernel")}
    for name in ("qkv", "proj", "fc1", "fc2"):
        out[f"{name}_weight"] = t(np.asarray(layer[f"{name}_kernel"]).T)
    return out


def jax_params(cfg_kw, seed=0, layerscale=0.1):
    cfg = j_dinov2.DinoV2Config(**cfg_kw)
    params = jax.tree.map(np.asarray, j_dinov2.init_params(jax.random.PRNGKey(seed), cfg))
    params["blocks"]["ls1"] = np.full_like(params["blocks"]["ls1"], layerscale)
    params["blocks"]["ls2"] = np.full_like(params["blocks"]["ls2"], layerscale)
    return cfg, params


def torch_model(cfg_kw, params):
    cfg = t_dinov2.DinoV2Config(**cfg_kw)
    model = t_dinov2.DinoV2(cfg)
    model.load_state_dict(state_dict_from_jax_params(params, cfg))
    return model.eval()


@pytest.mark.parametrize("stabilizer", ["capped", "column"])
@pytest.mark.parametrize("approx_gelu", [True, False])
def test_block_twin_matches_pallas_block(rng, stabilizer, approx_gelu):
    """Block twin == JAX fused_vit_block (interpret mode): d=64, 4 heads,
    100 tokens padded to 112, f32. atol 2e-4 as tests/test_vit_block.py."""
    layer = random_layer(rng)
    t, t_pad, d = 100, 112, 64
    x = rng.normal(size=(2, t_pad, d)).astype(np.float32)
    kw = dict(seq_len=t, num_heads=4, head_dim=16, eps=1e-6, approx_gelu=approx_gelu,
              softmax_stabilizer=stabilizer)
    with pltpu.force_tpu_interpret_mode():
        ref = j_fused_vit_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()}, **kw)
    out = fused_vit_block(torch.from_numpy(x), torch_layer(layer), **kw)
    np.testing.assert_allclose(out[:, :t].numpy(), np.asarray(ref)[:, :t], atol=2e-4)


@pytest.mark.parametrize("stabilizer,approx_gelu", [("capped", True), ("column", False)])
def test_block_twin_matches_pallas_block_at_kernel_head_dim(rng, stabilizer, approx_gelu):
    """The same at the CUDA kernel's head_dim 64: d=128, 2 heads, hidden
    512, 141 tokens padded to 144 (ragged seq_len), f32, atol 2e-4."""
    layer = random_layer(rng, d=128, hidden=512)
    t, t_pad, d = 141, 144, 128
    x = rng.normal(size=(2, t_pad, d)).astype(np.float32)
    kw = dict(seq_len=t, num_heads=2, head_dim=64, eps=1e-6, approx_gelu=approx_gelu,
              softmax_stabilizer=stabilizer)
    with pltpu.force_tpu_interpret_mode():
        ref = j_fused_vit_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()}, **kw)
    out = fused_vit_block(torch.from_numpy(x), torch_layer(layer), **kw)
    np.testing.assert_allclose(out[:, :t].numpy(), np.asarray(ref)[:, :t], atol=2e-4)


def test_block_twin_bf16_rounding_points(rng):
    """In bf16 the twin rounds where the Pallas kernel does; equal to the
    f32 block within bf16 resolution, and bf16 where the kernel is."""
    layer = torch_layer(random_layer(rng))
    x = torch.from_numpy(rng.normal(size=(1, 40, 64)).astype(np.float32))
    kw = dict(num_heads=4, head_dim=16, approx_gelu=True, softmax_stabilizer="capped")
    ref = fused_vit_block_plain(x, layer, **kw)
    out = fused_vit_block_plain(
        x.bfloat16(), {k: v.bfloat16() for k, v in layer.items()}, **kw
    )
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=0.1, rtol=0.05)


@pytest.mark.parametrize("facet", ["token", "key"])
def test_extract_facet_matches_jax_unfused(rng, facet):
    """extract_facet on a 98 px image (7x7 grid from a 6x6 position grid:
    the bicubic resize runs) == the JAX unfused path, atol 1e-4."""
    kw = tiny_cfg(facet=facet)
    jcfg, params = jax_params(kw)
    imgs = rng.uniform(size=(2, 98, 98, 3)).astype(np.float32)
    ref = j_dinov2.extract_facet(params, jcfg, j_dinov2.normalize_images(jnp.asarray(imgs)))
    model = torch_model(kw, params)
    out = t_dinov2.extract_facet(model, t_dinov2.normalize_images(torch.from_numpy(imgs)))
    np.testing.assert_allclose(
        out["feature_maps"].numpy(), np.asarray(ref["feature_maps"]), atol=1e-4
    )
    np.testing.assert_allclose(out["cls_tokens"].numpy(), np.asarray(ref["cls_tokens"]), atol=1e-4)


def test_unfused_vit_matches_jax_pallas_attention(rng):
    """Tiny unfused ViT (64 wide, depth 2, 84 px), f32: the port's unfused
    block (attention through ops/attention) == the JAX package's with the
    Pallas attention kernel in interpret mode, atol 1e-4 as
    tests/test_attention.py."""
    kw = tiny_cfg(depth=2, layer=1)
    jcfg, params = jax_params(kw)
    imgs = rng.uniform(size=(1, 84, 84, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = j_dinov2.extract_facet(
            params, dataclasses.replace(jcfg, use_pallas_attention=True), jnp.asarray(imgs)
        )
    out = t_dinov2.extract_facet(torch_model(kw, params), torch.from_numpy(imgs))
    np.testing.assert_allclose(
        out["feature_maps"].numpy(), np.asarray(ref["feature_maps"]), atol=1e-4
    )


def test_exact_config_runs_the_unfused_block(rng, monkeypatch):
    """lmo_exact.json's switches (no fused block, f32) resolve to the
    unfused block, which never reaches the fused-block kernel (bf16 only on
    the card); lmo.json keeps the fused block. A tiny f32 model under the
    exact switches matches the JAX package's unfused path, atol 1e-4."""
    from foundpose_torch.pipeline import inference as t_inf

    tiny = {k: v for k, v in tiny_cfg(depth=2, layer=1).items() if k != "variant"}
    name = "dinov2_version=vits14-reg_stride=14_facet=token_layer=9_norm=1"
    exact = t_inf.vit_config_from_opts(
        {"infer_opts": {"extractor_name": name, "use_pallas_attention": True, "vit_overrides": tiny}}
    )
    fused = t_inf.vit_config_from_opts(
        {"infer_opts": {"extractor_name": name, "use_fused_block": True}}
    )
    assert not exact.use_fused_block and fused.use_fused_block

    def no_fused_block(*args, **kwargs):
        raise AssertionError("the exact configuration reached the fused block")

    monkeypatch.setattr(t_dinov2, "fused_vit_block", no_fused_block)
    jcfg, params = jax_params(tiny_cfg(depth=2, layer=1))
    model = t_dinov2.DinoV2(exact)
    model.load_state_dict(state_dict_from_jax_params(params, exact))
    imgs = rng.uniform(size=(2, 84, 84, 3)).astype(np.float32)
    ref = j_dinov2.extract_facet(params, jcfg, jnp.asarray(imgs))
    out = t_dinov2.extract_facet(model, torch.from_numpy(imgs))
    np.testing.assert_allclose(
        out["feature_maps"].numpy(), np.asarray(ref["feature_maps"]), atol=1e-4
    )


@pytest.mark.parametrize("grid", [(7, 7), (5, 9), (6, 6)])
def test_interpolate_pos_embed_matches_jax(rng, grid):
    pos = rng.normal(size=(1, 1 + 36, 16)).astype(np.float32)
    ref = j_dinov2.interpolate_pos_embed(jnp.asarray(pos), grid, 6)
    out = t_dinov2.interpolate_pos_embed(torch.from_numpy(pos), grid, 6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_state_dict_round_trip_is_exact():
    """state_dict_from_jax_params inverts params_from_torch_state_dict."""
    kw = tiny_cfg()
    jcfg, params = jax_params(kw, seed=3)
    back = params_from_torch_state_dict(
        state_dict_from_jax_params(params, t_dinov2.DinoV2Config(**kw)), jcfg
    )
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a)
    # And the module takes the official names without leftovers.
    model = t_dinov2.DinoV2(t_dinov2.DinoV2Config(**kw))
    missing, unexpected = model.load_state_dict(
        state_dict_from_jax_params(params, t_dinov2.DinoV2Config(**kw)), strict=True
    )
    assert not missing and not unexpected


def test_calibration_pass_matches_jax_numpy_pass(rng):
    """The copied numpy calibration gives the JAX module's per-layer maxima
    and scales on the same weights, and realistic_params hits the target."""
    kw = tiny_cfg(layer=1)
    jcfg, params = jax_params(kw, seed=5)
    copy = lambda p: {**p, "blocks": {k: np.array(v) for k, v in p["blocks"].items()}}
    imgs = rng.uniform(size=(1, 84, 84, 3)).astype(np.float32)
    m_j, s_j = j_bench._np_blocks_pass(copy(params), jcfg, imgs, 30.0)
    m_t, s_t = t_bench._np_blocks_pass(copy(params), t_dinov2.DinoV2Config(**kw), imgs, 30.0)
    np.testing.assert_allclose(m_t, m_j, rtol=1e-5)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5)
    tcfg = t_dinov2.DinoV2Config(**kw)
    p = t_bench.realistic_params(0, tcfg, probe_size=84, probe_batch=1)
    np.testing.assert_allclose(
        t_bench.attention_logit_maxima(p, tcfg, probe_size=84, probe_batch=1), 30.0, rtol=1e-4
    )
    assert np.allclose(p["blocks"]["ls1"], 0.1)


@pytest.mark.parametrize(
    "name",
    [
        "dinov2_version=vits14-reg_stride=14_facet=token_layer=9_norm=1",
        "dinov2_version=vitl14_stride=14_facet=key_layer=18_norm=1",
        "dinov2_vitb14",
    ],
)
def test_parse_model_name_matches_jax(name):
    j = j_dinov2.parse_model_name(name)
    t = t_dinov2.parse_model_name(name)
    for field in dataclasses.fields(t):
        if hasattr(j, field.name):
            assert getattr(t, field.name) == getattr(j, field.name), field.name
