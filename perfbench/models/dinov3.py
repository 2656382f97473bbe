"""The `dinov3` backbone family: DINOv3 ViT-7B/16 (facebookresearch/dinov3,
hub entry `dinov3_vit7b16`; Siméoni et al. 2025, arXiv:2508.10104).

The reference's reading of a configuration (`shape`), the weights made on
the device from the seed (`make_weights`), the program's `DinoV3` on them
(`program`, `extract`), the ViT's operations and bytes (`feat_dim`,
`vit_flops_per_crop`, `vit_bytes`, and for the kernel readers
`attention_flops_per_crop`, `attention_bytes`, `qkv_flops_per_crop`,
`qkv_bytes`) and the CPU-sized copy of a configuration (`tiny`). The
reference is `perfbench/reference/dinov3.py`. The program is imported only
inside `program` and `extract`.

Weights: as the `dinov2` family makes them (no checkpoint ships):
truncated normal (std 0.02, cut at +-0.04), zero biases, unit norms, layer
scale 0.1; then, block by block over a fixed probe batch (2 images of 192
px: a 12 x 12 grid at patch 16, 32 x 32 at the tiny cut's patch 6) each
layer's q and k rows scaled so that its largest |attention logit|, with
RoPE applied as attention sees it, is 30. Drawn by one torch.Generator on
the device, tensor by tensor in a fixed order (each draw under 2**31
values), calibrated there in float32 with TF32 off. Every block of the
model is made, as a checkpoint holds them (40 at ViT-7B: 26.8 GB of
float32), and the program's module is built on the same tensors (no second
copy).

Operations are 2 x multiply-adds of the dense products and attention (RoPE,
softmax and the norms are elementwise and not counted). Bytes count each
weight and each activation input read once and each output written once,
in the compute dtype.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict

import torch

from perfbench.reference import dinov3 as ref
from perfbench.reference.precision import Precision, exact_f32

TARGET_LOGIT = 30.0
LAYER_SCALE = 0.1
PROBE_PX, PROBE_BATCH = 192, 2


def shape(opts: Dict[str, Any]) -> ref.VitShape:
    """The reference's own reading of a configuration's ViT: the extractor
    string and the overrides of its widths."""
    fields = {f.name for f in dataclasses.fields(ref.VitShape)}
    names = {"patch_size": "patch", "storage_tokens": "storage", "layer_norm_eps": "eps"}
    sizes = {names.get(k, k): v for k, v in (opts.get("vit_overrides") or {}).items()
             if names.get(k, k) in fields}
    return ref.parse_extractor(opts["extractor_name"], **sizes)


def _trunc(gen, *size, device):
    t = torch.empty(size, device=device)
    torch.nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=gen)
    return t


def init(s: ref.VitShape, gen: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random weights: {"top": tensors, "blocks": tensors stacked over depth}."""
    d, h, n, p = s.embed_dim, s.mlp_hidden, s.depth, s.patch
    full = lambda v, *sh: torch.full(sh, v, device=device)  # noqa: E731
    top = {
        "patch_embed.proj.weight": _trunc(gen, d, 3, p, p, device=device),
        "patch_embed.proj.bias": full(0.0, d),
        "cls_token": _trunc(gen, 1, 1, d, device=device),
        "storage_tokens": _trunc(gen, 1, s.storage, d, device=device),
        "norm.weight": full(1.0, d), "norm.bias": full(0.0, d),
    }
    blocks = {
        "norm1.weight": full(1.0, n, d), "norm1.bias": full(0.0, n, d),
        "attn.qkv.weight": torch.empty(n, 3 * d, d, device=device),
        "attn.proj.weight": torch.empty(n, d, d, device=device),
        "attn.proj.bias": full(0.0, n, d), "ls1.gamma": full(LAYER_SCALE, n, d),
        "norm2.weight": full(1.0, n, d), "norm2.bias": full(0.0, n, d),
        "mlp.w12.weight": torch.empty(n, 2 * h, d, device=device),
        "mlp.w12.bias": full(0.0, n, 2 * h),
        "mlp.w3.weight": torch.empty(n, d, h, device=device),
        "mlp.w3.bias": full(0.0, n, d), "ls2.gamma": full(LAYER_SCALE, n, d),
    }
    for i in range(n):
        for name in ("attn.qkv.weight", "attn.proj.weight", "mlp.w12.weight", "mlp.w3.weight"):
            torch.nn.init.trunc_normal_(blocks[name][i], std=0.02, a=-0.04, b=0.04, generator=gen)
    return {"top": top, "blocks": blocks}


def _logit_max(x, w, s, rope, prec):
    q, k, _ = ref.qkv(x, w, s, rope, prec)
    return float((q @ k.transpose(-1, -2)).abs().amax()) / math.sqrt(s.head_dim)


@torch.no_grad()
def calibrate(weights, s: ref.VitShape, gen: torch.Generator) -> list:
    """Scales each layer's q and k rows of blocks [0, layer] in place so
    that its largest |attention logit| on the probe batch, RoPE applied, is
    TARGET_LOGIT (RoPE rotates q and k by the same angles, so the logits
    scale with the rows). Returns the per-layer maxima after scaling."""
    blocks, d = weights["blocks"], s.embed_dim
    device = blocks["attn.qkv.weight"].device
    prec = Precision()
    probe = torch.rand(PROBE_BATCH, PROBE_PX, PROBE_PX, 3, generator=gen, device=device)
    grid = PROBE_PX // s.patch
    rope = ref.rope_tables(grid, grid, s.head_dim, s.rope_base, device)
    maxima = []
    with exact_f32():
        x, _ = ref.embed(weights["top"], s, probe, prec)
        for i in range(min(s.layer + 1, s.depth)):
            w = ref.block_weights(blocks, i)
            r = math.sqrt(TARGET_LOGIT / _logit_max(x, w, s, rope, prec))
            blocks["attn.qkv.weight"][i, : 2 * d] *= r
            maxima.append(_logit_max(x, w, s, rope, prec))
            x = ref.block(x, w, s, rope, prec)
    if any(abs(m / TARGET_LOGIT - 1.0) > 1e-4 for m in maxima):
        raise RuntimeError(f"logit calibration failed: {maxima}")
    return maxima


def make_weights(s: ref.VitShape, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Calibrated weights of shape `s` from `seed`, on `device`, in the
    layout `reference.dinov3.feature_maps` takes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = init(s, gen, device)
    calibrate(weights, s, gen)
    return weights


def state_dict(weights) -> Dict[str, torch.Tensor]:
    """The weights as one state dict of the program's `DinoV3` (views, no copies)."""
    sd = dict(weights["top"])
    for k, v in weights["blocks"].items():
        for i in range(v.shape[0]):
            sd[f"blocks.{i}.{k}"] = v[i]
    return sd


def program(weights, opts: Dict[str, Any], device):
    """(the program's DinoV3 on `weights`' own tensors, the extractor name,
    the overrides of the extractor's published widths and switches) of a
    configuration's `infer_opts`."""
    from foundpose_torch.models import dinov3
    from foundpose_torch.pipeline import inference

    vit_cfg = inference.vit_config_from_opts(opts)
    named = dinov3.parse_model_name(opts["extractor_name"])
    overrides = {f.name: getattr(vit_cfg, f.name) for f in dataclasses.fields(vit_cfg)
                 if getattr(vit_cfg, f.name) != getattr(named, f.name)}
    with torch.device("meta"):
        model = dinov3.DinoV3(vit_cfg)
    model.load_state_dict(state_dict(weights), assign=True)
    return model.eval(), opts["extractor_name"], overrides


def extract(model, images: torch.Tensor) -> torch.Tensor:
    """The program's ViT stage as `pose_from_crops` runs it, on images as
    `inference.preprocess_crops` makes them: feature maps [B, gh, gw, D]."""
    from foundpose_torch.models import dinov3

    return dinov3.extract_facet(model, images)["feature_maps"]


def feat_dim(s: ref.VitShape) -> int:
    """Width of the feature maps, the PCA's input."""
    return s.embed_dim


def _tokens(s: ref.VitShape, crop_px: int) -> int:
    grid = crop_px // s.patch
    return grid * grid + 1 + s.storage


def qkv_flops_per_crop(s: ref.VitShape, crop_px: int) -> int:
    """The qkv projections of the blocks run whole (those that rotate q and
    k in their epilogue), for one crop."""
    d = s.embed_dim
    return s.blocks_run * 2 * _tokens(s, crop_px) * 3 * d * d


def attention_flops_per_crop(s: ref.VitShape, crop_px: int) -> int:
    """Attention's two products (q k^T and p v) in the blocks run, one crop."""
    n = _tokens(s, crop_px)
    return s.blocks_run * 2 * 2 * n * n * s.embed_dim


def vit_flops_per_crop(s: ref.VitShape, crop_px: int) -> int:
    """The facet forward of one crop: the patch embedding, the blocks it
    runs (qkv and proj, the SwiGLU MLP's three products, attention) and a
    query, key or value facet's own qkv projection."""
    d, h = s.embed_dim, s.mlp_hidden
    grid = crop_px // s.patch
    n = _tokens(s, crop_px)
    patch = 2 * grid * grid * 3 * s.patch ** 2 * d
    dense = s.blocks_run * 2 * n * (4 * d * d + 3 * d * h)
    facet = 0 if s.facet == "token" else 2 * n * 3 * d * d
    return patch + dense + attention_flops_per_crop(s, crop_px) + facet


def vit_bytes(s: ref.VitShape, crop_px: int, batch: int, elem: int = 2) -> int:
    """Bytes the ViT stage of one batch must move at least: every weight of
    the blocks it runs read once, the images read once, and each block's
    input tokens read and output tokens written once."""
    d, h = s.embed_dim, s.mlp_hidden
    blocks = s.blocks_run
    weights = blocks * (4 * d * d + 3 * d * h) + (3 * d * d if s.facet != "token" else 0)
    weights += 3 * s.patch ** 2 * d
    n_tok = _tokens(s, crop_px)
    acts = batch * (crop_px * crop_px * 3 + 2 * blocks * n_tok * d + n_tok * d)
    return elem * (weights + acts)


def qkv_bytes(s: ref.VitShape, crop_px: int, batch: int, elem: int = 2) -> int:
    """The qkv GEMMs of one batch: each block's weights and its normalised
    input read once, q, k and v written once, and the rotary tables (f32)
    read once."""
    d, n = s.embed_dim, _tokens(s, crop_px)
    tables = 2 * (crop_px // s.patch) ** 2 * (s.head_dim // 2) * 4
    return s.blocks_run * (elem * (3 * d * d + batch * n * 4 * d) + tables)


def attention_bytes(s: ref.VitShape, crop_px: int, batch: int, elem: int = 2) -> int:
    """Attention of one batch: q, k and v read once and its output written
    once, in every block run."""
    return s.blocks_run * elem * batch * _tokens(s, crop_px) * 4 * s.embed_dim


def tiny(opts: Dict[str, Any]) -> Dict[str, Any]:
    """`infer_opts` with the ViT cut to what the harness's tests run on the
    CPU at 84 px crops (which 16 does not divide): 3 blocks of 256 wide
    with 2 heads of 128, RoPE and 4 storage tokens kept, the features taken
    at block 1, patches and grid cells of 12 (a 7 x 7 grid)."""
    return dict(opts, extractor_name=re.sub(r"layer=\d+", "layer=1", opts["extractor_name"]),
                grid_cell_size=12.0,
                vit_overrides=dict(opts.get("vit_overrides") or {}, embed_dim=256, num_heads=2,
                                   depth=3, patch_size=12, stride=12))
