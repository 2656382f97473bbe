"""Parity of the port's SwiGLU ViT (DINOv2 ViT-G/14's block) and the ViT
entry points with the JAX package on small shapes, in f32 on the CPU: the
block twin against the Pallas kernel (interpret mode), extract_facet,
extract_attention_maps, forward_full, make_extractor, the weight bridges
(official names, transformers names), the calibration pass, utils/flops
and utils/profiling."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu  # noqa: F401 (torch's CPU threads: this process's share)
from jax.experimental.pallas import tpu as pltpu

from foundpose_torch.models import bench_weights as t_bench
from foundpose_torch.models import dinov2 as t_dinov2
from foundpose_torch.models import weights as t_weights
from foundpose_torch.ops.vit_block import fused_vit_block, fused_vit_block_plain
from foundpose_torch.utils import flops as t_flops
from foundpose_torch.utils import profiling as t_profiling
from foundpose_tpu.models import bench_weights as j_bench
from foundpose_tpu.models import dinov2 as j_dinov2
from foundpose_tpu.models import weights as j_weights
from foundpose_tpu.ops.vit_block import fused_vit_block as j_fused_vit_block
from foundpose_tpu.utils import flops as j_flops

def tiny_cfg(**kw):
    """A 3-block SwiGLU ViT: 64 wide, 4 heads of 16, hidden 176."""
    base = dict(
        variant="vitg14", embed_dim=64, depth=3, num_heads=4, mlp_ratio=4.0,
        swiglu=True, patch_size=14, num_register_tokens=4, pos_grid=6,
        stride=14, facet="token", layer=2, apply_norm=True,
    )
    base.update(kw)
    return base


def jax_params(cfg_kw, seed=0, layerscale=0.1):
    cfg = j_dinov2.DinoV2Config(**cfg_kw)
    params = jax.tree.map(np.asarray, j_dinov2.init_params(jax.random.PRNGKey(seed), cfg))
    params["blocks"]["ls1"] = np.full_like(params["blocks"]["ls1"], layerscale)
    params["blocks"]["ls2"] = np.full_like(params["blocks"]["ls2"], layerscale)
    return cfg, params


def torch_model(cfg_kw, params):
    cfg = t_dinov2.DinoV2Config(**cfg_kw)
    model = t_dinov2.DinoV2(cfg)
    model.load_state_dict(t_weights.state_dict_from_jax_params(params, cfg))
    return model.eval()


def swiglu_layer(rng, d, hidden):
    """One SwiGLU block's weights in the JAX layout (w12 [d, 2h]: gate
    columns first), with a layer scale that lets the branches matter."""
    n = lambda *s, scale=0.1: (rng.normal(size=s) * scale).astype(np.float32)
    return {
        "norm1_scale": 1.0 + n(d), "norm1_bias": n(d),
        "qkv_kernel": n(d, 3 * d, scale=0.15), "qkv_bias": n(3 * d),
        "proj_kernel": n(d, d), "proj_bias": n(d), "ls1": 0.5 + n(d),
        "norm2_scale": 1.0 + n(d), "norm2_bias": n(d), "ls2": 0.5 + n(d),
        "w12_kernel": n(d, 2 * hidden), "w12_bias": n(2 * hidden),
        "w3_kernel": n(hidden, d), "w3_bias": n(d),
    }


def torch_layer(layer):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    out = {k: t(v) for k, v in layer.items() if not k.endswith("_kernel")}
    for name in ("qkv", "proj", "w12", "w3"):
        out[f"{name}_weight"] = t(np.asarray(layer[f"{name}_kernel"]).T)
    return out


@pytest.mark.parametrize("stabilizer", ["capped", "column"])
def test_swiglu_block_twin_matches_pallas_block(rng, stabilizer):
    """SwiGLU block twin == JAX fused_vit_block (interpret mode) at the CUDA
    kernel's head_dim 64: d=192, 3 heads, hidden 512 (a multiple of 32, so
    the shape also passes the kernel wrapper's checks), 141 tokens padded
    to 144 (ragged seq_len), f32, atol 2e-4 as the GELU block's tests."""
    d, hidden, t, t_pad = 192, 512, 141, 144
    layer = swiglu_layer(rng, d, hidden)
    x = rng.normal(size=(2, t_pad, d)).astype(np.float32)
    kw = dict(seq_len=t, num_heads=3, head_dim=64, eps=1e-6, softmax_stabilizer=stabilizer)
    with pltpu.force_tpu_interpret_mode():
        ref = j_fused_vit_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in layer.items()}, **kw)
    out = fused_vit_block(torch.from_numpy(x), torch_layer(layer), **kw)
    np.testing.assert_allclose(out[:, :t].numpy(), np.asarray(ref)[:, :t], atol=2e-4)


def test_swiglu_block_twin_bf16_rounding_points(rng):
    """In bf16 the SwiGLU twin rounds where the Pallas kernel does (h =
    silu(gate) * value formed in f32, rounded once): its w12 -> w3 branch
    equals that rounding applied to the f32 computation exactly, and the
    whole block stays within bf16 resolution of the f32 block."""
    d, hidden = 64, 96
    layer = torch_layer(swiglu_layer(rng, d, hidden))
    x = torch.from_numpy(rng.normal(size=(1, 40, d)).astype(np.float32))
    kw = dict(num_heads=4, head_dim=16, softmax_stabilizer="capped")
    ref = fused_vit_block_plain(x, layer, **kw)
    l16 = {k: v.bfloat16() for k, v in layer.items()}
    out = fused_vit_block_plain(x.bfloat16(), l16, **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=0.1, rtol=0.05)
    # The MLP's rounding points: with proj zeroed the attention half passes
    # x unchanged, and with ls2 = 1 the output is x + y2 rounded once, where
    # y2 = bf16(w3 . bf16(silu(gate) * value) + b3) from f32 gate and value.
    p = {**l16, "proj_weight": torch.zeros_like(l16["proj_weight"]),
         "proj_bias": torch.zeros_like(l16["proj_bias"]),
         "ls2": torch.ones(d, dtype=torch.bfloat16)}
    rows = torch.from_numpy(rng.normal(size=(40, d)).astype(np.float32)).bfloat16()
    got = fused_vit_block_plain(rows[None], p, **kw)[0]
    ln = t_dinov2.layer_norm(rows, p["norm2_scale"], p["norm2_bias"], 1e-6)
    h12 = ln.float() @ p["w12_weight"].float().t() + p["w12_bias"].float()
    h = (torch.nn.functional.silu(h12[:, :hidden]) * h12[:, hidden:]).bfloat16()
    y2 = (h.float() @ p["w3_weight"].float().t() + p["w3_bias"].float()).bfloat16()
    torch.testing.assert_close(got, rows + y2, rtol=0, atol=0)


@pytest.mark.parametrize("facet", ["token", "key"])
@pytest.mark.parametrize("fused", [False, True])
def test_swiglu_extract_facet_matches_jax(rng, facet, fused):
    """extract_facet of a tiny SwiGLU ViT on a 98 px image (7x7 grid from a
    6x6 position grid) == the JAX package's extract_facet with the same
    switch (the fused block in interpret mode), atol 1e-4."""
    kw = tiny_cfg(facet=facet)
    jcfg, params = jax_params(kw)
    imgs = rng.uniform(size=(2, 98, 98, 3)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = j_dinov2.extract_facet(
            params, dataclasses.replace(jcfg, use_fused_block=fused),
            j_dinov2.normalize_images(jnp.asarray(imgs)),
        )
    model = torch_model(dict(kw, use_fused_block=fused), params)
    out = t_dinov2.extract_facet(model, t_dinov2.normalize_images(torch.from_numpy(imgs)))
    for k in ("feature_maps", "cls_tokens"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-4)


def test_swiglu_state_dict_round_trip_is_exact():
    """state_dict_from_jax_params inverts params_from_torch_state_dict for
    SwiGLU (w12_kernel (in, out) <-> mlp.w12.weight (out, in), w3 alike),
    and the module takes the official names without leftovers."""
    kw = tiny_cfg()
    jcfg, params = jax_params(kw, seed=3)
    cfg = t_dinov2.DinoV2Config(**kw)
    sd = t_weights.state_dict_from_jax_params(params, cfg)
    assert "blocks.0.mlp.w12.weight" in sd and "blocks.0.mlp.fc1.weight" not in sd
    back = j_weights.params_from_torch_state_dict(sd, jcfg)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a)
    missing, unexpected = t_dinov2.DinoV2(cfg).load_state_dict(sd, strict=True)
    assert not missing and not unexpected


def test_load_checkpoint_official_swiglu_pth(rng, tmp_path):
    """An official-name SwiGLU `.pth` (with mask_token, under "model")
    loads through weights.load_checkpoint; its features are the JAX
    package's from the same file (its load_checkpoint), atol 1e-4."""
    kw = tiny_cfg(layer=1)
    jcfg, params = jax_params(kw, seed=4)
    cfg = t_dinov2.DinoV2Config(**kw)
    sd = t_weights.state_dict_from_jax_params(params, cfg)
    sd["mask_token"] = torch.zeros(1, cfg.embed_dim)
    path = str(tmp_path / "dinov2_vitg14_reg4_pretrain.pth")
    torch.save({"model": sd}, path)
    model = t_weights.load_checkpoint(path, cfg)
    jp = j_weights.load_checkpoint(path, jcfg)
    imgs = rng.uniform(size=(1, 84, 84, 3)).astype(np.float32)
    ref = j_dinov2.extract_facet(jp, jcfg, jnp.asarray(imgs))["feature_maps"]
    out = t_dinov2.extract_facet(model, torch.from_numpy(imgs))["feature_maps"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_vitg14_module_has_the_official_shapes():
    """DinoV2(parse_model_name("dinov2_vitg14-reg")) builds (on the meta
    device: 1.1B parameters) with exactly the official names, at the shapes
    the JAX package's tree has (jax.eval_shape of its init_params): 40
    blocks, w12 [8192, 1536], w3 [1536, 4096]."""
    name = "dinov2_vitg14-reg"
    with torch.device("meta"):
        model = t_dinov2.DinoV2(t_dinov2.parse_model_name(name))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    tree = jax.eval_shape(
        lambda k: j_dinov2.init_params(k, j_dinov2.parse_model_name(name)), jax.random.PRNGKey(0)
    )
    blocks = tree["blocks"]
    assert blocks["w12_kernel"].shape == (40, 1536, 8192)
    want = {
        "patch_embed.proj.weight": (1536, 3, 14, 14), "patch_embed.proj.bias": (1536,),
        "cls_token": tree["cls_token"].shape, "pos_embed": tree["pos_embed"].shape,
        "register_tokens": tree["register_tokens"].shape,
        "norm.weight": (1536,), "norm.bias": (1536,),
    }
    linear = {"attn.qkv": "qkv", "attn.proj": "proj", "mlp.w12": "w12", "mlp.w3": "w3"}
    for i in range(40):
        for part in ("norm1", "norm2"):
            want[f"blocks.{i}.{part}.weight"] = want[f"blocks.{i}.{part}.bias"] = (1536,)
        want[f"blocks.{i}.ls1.gamma"] = want[f"blocks.{i}.ls2.gamma"] = (1536,)
        for mod, jname in linear.items():
            kin, kout = blocks[f"{jname}_kernel"].shape[1:]
            want[f"blocks.{i}.{mod}.weight"] = (kout, kin)
            want[f"blocks.{i}.{mod}.bias"] = blocks[f"{jname}_bias"].shape[1:]
    assert got == want


@pytest.mark.parametrize("swiglu", [False, True])
def test_to_hf_state_dict_matches_jax(swiglu):
    """to_hf_state_dict == the JAX package's, key by key and bit for bit
    (GELU: mlp.fc1/fc2; SwiGLU: mlp.weights_in/weights_out)."""
    kw = tiny_cfg(swiglu=swiglu, variant="vitg14" if swiglu else "vits14")
    jcfg, params = jax_params(kw, seed=6)
    ref = j_weights.to_hf_state_dict(params, jcfg)
    got = t_weights.to_hf_state_dict(params, t_dinov2.DinoV2Config(**kw))
    assert sorted(got) == sorted(ref)
    assert ("encoder.layer.0.mlp.weights_in.weight" in got) == swiglu
    for k, v in ref.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape, k
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_swiglu_calibration_pass_matches_jax_numpy_pass(rng):
    """The copied numpy calibration with SwiGLU MLPs gives the JAX module's
    per-layer maxima and scales on the same weights; realistic_params
    draws w12 [d, 2h] / w3 [h, d] and hits the logit target."""
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
    d, h = tcfg.embed_dim, tcfg.mlp_hidden
    assert p["blocks"]["w12_kernel"].shape == (3, d, 2 * h)
    assert p["blocks"]["w3_kernel"].shape == (3, h, d) and "fc1_kernel" not in p["blocks"]
    np.testing.assert_allclose(
        t_bench.attention_logit_maxima(p, tcfg, probe_size=84, probe_batch=1), 30.0, rtol=1e-4
    )


@pytest.mark.parametrize("swiglu", [False, True])
def test_attention_maps_and_forward_full_match_jax(rng, swiglu):
    """extract_attention_maps (block `layer`'s f32 softmax, class and
    register tokens included) and forward_full (all blocks, final norm)
    == the JAX package's, atol 1e-5 and 1e-4."""
    kw = tiny_cfg(swiglu=swiglu, layer=1)
    jcfg, params = jax_params(kw, seed=7)
    model = torch_model(kw, params)
    imgs = rng.uniform(size=(2, 84, 84, 3)).astype(np.float32)
    ref = j_dinov2.extract_attention_maps(params, jcfg, jnp.asarray(imgs))
    got = t_dinov2.extract_attention_maps(model, torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and got.shape == (2, 4, 41, 41)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    ref = j_dinov2.forward_full(params, jcfg, jnp.asarray(imgs))
    got = t_dinov2.forward_full(model, torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_make_extractor_matches_jax(rng):
    """make_extractor: the same config as the JAX factory's, and extract
    (normalization, compute dtype, extract_facet) gives its feature maps
    for ViT-S/14 at its published widths on a 56 px image, atol 1e-4."""
    name = "dinov2_version=vits14_stride=14_facet=key_layer=2_norm=1"
    jcfg, jextract = j_dinov2.make_extractor(name)
    tcfg, textract = t_dinov2.make_extractor(name)
    for field in dataclasses.fields(tcfg):
        if hasattr(jcfg, field.name):
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    params = jax.tree.map(np.asarray, j_dinov2.init_params(jax.random.PRNGKey(2), jcfg))
    model = t_dinov2.DinoV2(tcfg)
    model.load_state_dict(t_weights.state_dict_from_jax_params(params, tcfg))
    imgs = rng.uniform(size=(1, 56, 56, 3)).astype(np.float32)
    ref = jextract(params, jnp.asarray(imgs))
    got = textract(model.eval(), torch.from_numpy(imgs))
    assert got["feature_maps"].dtype == torch.float32
    np.testing.assert_allclose(
        got["feature_maps"].numpy(), np.asarray(ref["feature_maps"]), atol=1e-4
    )
    got16 = textract(model, torch.from_numpy(imgs), compute_dtype=torch.bfloat16)
    assert got16["feature_maps"].dtype == torch.bfloat16


@pytest.mark.parametrize("facet", ["token", "key"])
@pytest.mark.parametrize("variant", ["vits14", "vitb14", "vitl14", "vitg14"])
def test_flops_match_jax(variant, facet):
    """utils/flops == the JAX package's, exactly, for every DINOv2 release
    (ViT-G's SwiGLU MLP counts 3 d h) and the token and key facets."""
    name = f"dinov2_version={variant}-reg_stride=14_facet={facet}_layer=9_norm=1"
    jcfg, tcfg = j_dinov2.parse_model_name(name), t_dinov2.parse_model_name(name)
    for px in (420, 224):
        assert t_flops.vit_flops_per_crop(tcfg, px) == j_flops.vit_flops_per_crop(jcfg, px)
    args = (420, tcfg.embed_dim, 256, 2048, 512, 5)
    assert t_flops.pipeline_flops_per_crop(tcfg, *args) == j_flops.pipeline_flops_per_crop(
        jcfg, *args)
    if variant == "vitg14" and facet == "token":
        # One ViT-G layer over 16 crops of 905 tokens: 900.4 GFLOP.
        assert 16 * t_flops.vit_layer_flops(tcfg, 905) == 900_415_979_520


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    """profiling.trace on the CPU writes a Chrome-format trace of its body."""
    log_dir = tmp_path / "trace"
    with t_profiling.trace(str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(log_dir, t_profiling.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_lmo_json_with_the_vitg_extractor_resolves_to_vitg():
    """configs/infer/lmo.json with extractor_name overridden (the CLI's
    --set) gives DINOv2 ViT-G/14-reg at its published widths on the fused
    bf16 path with the capped softmax: 1536 wide, 24 heads of 64, SwiGLU
    hidden 4096, 40 blocks to layer 39, hidden a multiple of 32 as the
    block kernel needs."""
    from foundpose_torch.pipeline import infer, inference
    from foundpose_torch.utils import config as config_util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = "dinov2_version=vitg14-reg_stride=14_facet=token_layer=39_norm=1"
    opts = config_util.load_opts(infer.InferOpts, [
        "--opts-path", os.path.join(root, "configs", "infer", "lmo.json"),
        "--set", f"extractor_name={name}",
    ])
    o = dataclasses.asdict(opts)
    vit = inference.vit_config_from_opts(o)
    assert (vit.embed_dim, vit.num_heads, vit.head_dim, vit.mlp_hidden) == (1536, 24, 64, 4096)
    assert vit.swiglu and vit.depth == 40 and vit.layer == 39 and vit.num_register_tokens == 4
    assert vit.use_fused_block and vit.softmax_stabilizer == "capped"
    assert vit.mlp_hidden % 32 == 0
    assert inference.inference_config_from_opts(o).compute_dtype == torch.bfloat16
