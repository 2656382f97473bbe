"""The `dinov2` backbone family: DINOv2 ViT-S/B/L/G/14, with or without registers.

The reference's reading of a configuration (`shape`), the weights made on
the device from the seed (`make_weights`), the program's `DinoV2` holding
them (`program`, `extract`), the ViT's operations and bytes (`feat_dim`,
`vit_flops_per_crop`, `vit_bytes`) and the CPU-sized copy of a
configuration the harness's tests run (`tiny`). The reference itself is
`perfbench/reference/dinov2.py`. The program is imported only inside
`program` and `extract`, so the rest runs with the program unimportable.

Weights: no checkpoint ships, and plain random weights give attention
logits far below pretrained DINOv2's (about +-30), where the capped
softmax and bf16 would be exercised too gently. So, as the program's own
calibrated bench weights do: truncated-normal init (std 0.02, cut at
+-0.04), layer scale 0.1, then block by block over a fixed probe batch (2
images of 154 px) each layer's q and k rows scaled so that its largest
|attention logit| is 30. Everything is drawn by one torch.Generator on
the device, each stacked tensor in one call, and calibrated there in
float32 with TF32 off.

Operations are 2 x multiply-adds of the dense products and attention,
counted from the configuration's shapes (the program's `utils/flops`,
frozen here). Bytes count each weight and each activation input read once
and each output written once, in the compute dtype.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict

import torch

from perfbench.reference import dinov2 as ref
from perfbench.reference.precision import Precision, exact_f32

TARGET_LOGIT = 30.0
LAYER_SCALE = 0.1
PROBE_PX, PROBE_BATCH = 154, 2


def shape(opts: Dict[str, Any]) -> ref.VitShape:
    """The reference's own reading of a configuration's ViT: the extractor
    string, the GELU form and the overrides of its widths."""
    fields = {f.name for f in dataclasses.fields(ref.VitShape)}
    sizes = {k: v for k, v in (opts.get("vit_overrides") or {}).items() if k in fields}
    return ref.parse_extractor(opts["extractor_name"],
                               approx_gelu=bool(opts.get("approx_gelu", False)), **sizes)


def _trunc(gen, *shape, device):
    t = torch.empty(shape, device=device)
    torch.nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=gen)
    return t


def init(s: ref.VitShape, gen: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Random weights: {"top": tensors, "blocks": tensors stacked over depth},
    under the official DINOv2 names."""
    d, h, n, p = s.embed_dim, s.mlp_hidden, s.depth, s.patch
    ones, zeros = (lambda *sh: torch.ones(sh, device=device)), (
        lambda *sh: torch.zeros(sh, device=device))
    blocks = {
        "norm1.weight": ones(n, d), "norm1.bias": zeros(n, d),
        "attn.qkv.weight": _trunc(gen, n, 3 * d, d, device=device),
        "attn.qkv.bias": zeros(n, 3 * d),
        "attn.proj.weight": _trunc(gen, n, d, d, device=device), "attn.proj.bias": zeros(n, d),
        "ls1.gamma": torch.full((n, d), LAYER_SCALE, device=device),
        "norm2.weight": ones(n, d), "norm2.bias": zeros(n, d),
        "ls2.gamma": torch.full((n, d), LAYER_SCALE, device=device),
    }
    if s.swiglu:
        blocks.update({"mlp.w12.weight": _trunc(gen, n, 2 * h, d, device=device),
                       "mlp.w12.bias": zeros(n, 2 * h),
                       "mlp.w3.weight": _trunc(gen, n, d, h, device=device),
                       "mlp.w3.bias": zeros(n, d)})
    else:
        blocks.update({"mlp.fc1.weight": _trunc(gen, n, h, d, device=device),
                       "mlp.fc1.bias": zeros(n, h),
                       "mlp.fc2.weight": _trunc(gen, n, d, h, device=device),
                       "mlp.fc2.bias": zeros(n, d)})
    top = {
        "patch_embed.proj.weight": _trunc(gen, d, 3, p, p, device=device),
        "patch_embed.proj.bias": zeros(d),
        "cls_token": _trunc(gen, 1, 1, d, device=device),
        "pos_embed": _trunc(gen, 1, 1 + s.pos_grid ** 2, d, device=device),
        "norm.weight": ones(d), "norm.bias": zeros(d),
    }
    if s.registers:
        top["register_tokens"] = _trunc(gen, 1, s.registers, d, device=device)
    return {"top": top, "blocks": blocks}


def _logit_max(x, w, s, prec):
    q, k, _ = ref.qkv(x, w, s, prec)
    return float((q @ k.transpose(-1, -2)).abs().amax()) / math.sqrt(s.head_dim)


@torch.no_grad()
def calibrate(weights, s: ref.VitShape, gen: torch.Generator) -> list:
    """Scales each layer's q and k rows of blocks [0, layer] in place so
    that its largest |attention logit| on the probe batch is TARGET_LOGIT.
    Returns the per-layer maxima after scaling."""
    blocks, d = weights["blocks"], s.embed_dim
    device = blocks["attn.qkv.weight"].device
    prec = Precision()
    probe = torch.rand(PROBE_BATCH, PROBE_PX, PROBE_PX, 3, generator=gen, device=device)
    maxima = []
    with exact_f32():
        x, _ = ref.embed(weights["top"], s, probe, prec)
        for i in range(s.layer + 1):
            w = ref.block_weights(blocks, i)
            r = math.sqrt(TARGET_LOGIT / _logit_max(x, w, s, prec))
            blocks["attn.qkv.weight"][i, : 2 * d] *= r
            blocks["attn.qkv.bias"][i, : 2 * d] *= r
            maxima.append(_logit_max(x, w, s, prec))
            x = ref.block(x, w, s, prec)
    if any(abs(m / TARGET_LOGIT - 1.0) > 1e-4 for m in maxima):
        raise RuntimeError(f"logit calibration failed: {maxima}")
    return maxima


def make_weights(s: ref.VitShape, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Calibrated weights of shape `s` from `seed`, on `device`, in the
    layout `reference.dinov2.feature_maps` takes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = init(s, gen, device)
    calibrate(weights, s, gen)
    return weights


def state_dict(weights) -> Dict[str, torch.Tensor]:
    """The weights as one official-name state dict (views, no copies)."""
    sd = dict(weights["top"])
    for k, v in weights["blocks"].items():
        for i in range(v.shape[0]):
            sd[f"blocks.{i}.{k}"] = v[i]
    return sd


def program(weights, opts: Dict[str, Any], device):
    """(the program's DinoV2 holding a copy of `weights`, the extractor
    name, the overrides of the extractor's published widths and switches)
    of a configuration's `infer_opts`."""
    from foundpose_torch.models import dinov2
    from foundpose_torch.pipeline import inference

    vit_cfg = inference.vit_config_from_opts(opts)
    named = dinov2.parse_model_name(opts["extractor_name"])
    overrides = {f.name: getattr(vit_cfg, f.name) for f in dataclasses.fields(vit_cfg)
                 if getattr(vit_cfg, f.name) != getattr(named, f.name)}
    with torch.device("meta"):
        model = dinov2.DinoV2(vit_cfg)
    model = model.to_empty(device=device).eval()
    model.load_state_dict(state_dict(weights))
    return model, opts["extractor_name"], overrides


def extract(model, images: torch.Tensor) -> torch.Tensor:
    """The program's ViT stage as `pose_from_crops` runs it, on images as
    `inference.preprocess_crops` makes them: feature maps [B, gh, gw, D]."""
    from foundpose_torch.models import dinov2

    return dinov2.extract_facet(model, images)["feature_maps"]


def feat_dim(s: ref.VitShape) -> int:
    """Width of the feature maps, the PCA's input."""
    return s.embed_dim


def _tokens(s: ref.VitShape, crop_px: int) -> int:
    grid = crop_px // s.patch
    return grid * grid + 1 + s.registers


def _layer_flops(s: ref.VitShape, n_tok: int) -> int:
    """One block over n_tok tokens of one image: qkv and proj, the MLP, and
    attention's two products."""
    d, h = s.embed_dim, s.mlp_hidden
    mlp_macs = 3 * d * h if s.swiglu else 2 * d * h
    return 2 * (n_tok * (4 * d * d + mlp_macs) + 2 * n_tok * n_tok * d)


def vit_flops_per_crop(s: ref.VitShape, crop_px: int) -> int:
    """The facet forward of one crop: the patch embedding and the blocks
    it runs (a query, key or value facet adds one qkv projection)."""
    d = s.embed_dim
    grid = crop_px // s.patch
    n_tok = _tokens(s, crop_px)
    patch = 2 * grid * grid * 3 * s.patch ** 2 * d
    layer = _layer_flops(s, n_tok)
    if s.facet == "token":
        return patch + (s.layer + 1) * layer
    return patch + s.layer * layer + 2 * n_tok * 3 * d * d


def vit_bytes(s: ref.VitShape, crop_px: int, batch: int, elem: int = 2) -> int:
    """Bytes the ViT stage of one batch must move at least: every weight of
    the blocks it runs read once, the images read once, and each block's
    input tokens read and output tokens written once."""
    d, h = s.embed_dim, s.mlp_hidden
    mlp = 3 * d * h if s.swiglu else 2 * d * h
    per_block = 4 * d * d + mlp
    blocks = s.blocks_run
    weights = blocks * per_block + (3 * d * d if s.facet != "token" else 0)
    weights += 3 * s.patch ** 2 * d
    n_tok = _tokens(s, crop_px)
    acts = batch * (crop_px * crop_px * 3 + 2 * blocks * n_tok * d + n_tok * d)
    return elem * (weights + acts)


def tiny(opts: Dict[str, Any]) -> Dict[str, Any]:
    """`infer_opts` with the ViT cut to what the harness's tests run on the
    CPU: 3 blocks of 128 wide with 64-wide heads and a 6 x 6 position grid
    (84 px crops), the features taken at block 1."""
    return dict(opts, extractor_name=re.sub(r"layer=\d+", "layer=1", opts["extractor_name"]),
                vit_overrides=dict(opts.get("vit_overrides") or {}, embed_dim=128, num_heads=2,
                                   depth=3, pos_grid=6))
