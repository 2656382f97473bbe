"""Plain DINOv2 (Oquab et al. 2023, facebookresearch/dinov2) up to a facet:
the reference of the `dinov2` backbone family (`perfbench/models/dinov2.py`).

Weights come as a dict under the official state-dict names, with every
block's tensors stacked on a leading axis (`blocks` below): the layout in
which the benchmark makes them. Pre-norm blocks, layer scale, tanh or erf
GELU (or SwiGLU), position embeddings resized bicubically with DINOv2's
+0.1 in the scale factor, register tokens after the class token. The
harness calls `feature_maps`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Precision

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# Published widths of the DINOv2 releases (model card).
VARIANTS = {
    "vits14": dict(embed_dim=384, depth=12, num_heads=6, swiglu=False),
    "vitb14": dict(embed_dim=768, depth=12, num_heads=12, swiglu=False),
    "vitl14": dict(embed_dim=1024, depth=24, num_heads=16, swiglu=False),
    "vitg14": dict(embed_dim=1536, depth=40, num_heads=24, swiglu=True),
}


@dataclasses.dataclass(frozen=True)
class VitShape:
    embed_dim: int
    depth: int
    num_heads: int
    swiglu: bool
    registers: int
    layer: int
    facet: str = "token"
    apply_norm: bool = True
    approx_gelu: bool = True
    patch: int = 14
    pos_grid: int = 37
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        if self.swiglu:
            return (int(self.embed_dim * 4 * 2 / 3) + 7) // 8 * 8
        return self.embed_dim * 4

    @property
    def blocks_run(self) -> int:
        """Whole blocks before the facet: [0, layer] for tokens, [0, layer)
        for a query, key or value facet (whose layer adds its qkv)."""
        return self.layer + 1 if self.facet == "token" else self.layer


def parse_extractor(name: str, **overrides) -> VitShape:
    """VitShape of FoundPose's extractor string
    `dinov2_version=<v>_stride=14_facet=<f>_layer=<l>_norm=<0|1>`."""
    fields = dict(item.split("=", 1) for item in name.split("_")[1:])
    version = fields["version"]
    base = version[:-4] if version.endswith("-reg") else version
    if int(fields.get("stride", 14)) != 14:
        raise ValueError("the reference takes stride 14 only")
    shape = dict(VARIANTS[base], registers=4 if version.endswith("-reg") else 0,
                 layer=int(fields["layer"]), facet=fields.get("facet", "token"),
                 apply_norm=bool(int(fields.get("norm", 1))))
    shape.update(overrides)
    return VitShape(**shape)


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w.float() + b.float()


def gelu(x, approx: bool):
    if approx:
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def block_weights(blocks: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in blocks.items()}


def embed(top: Dict[str, torch.Tensor], s: VitShape, images: torch.Tensor, prec: Precision):
    """Images [B, H, W, 3] in [0, 1] -> tokens [B, 1 + R + N, D] f32 and the
    patch grid (gh, gw)."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    x = (images.float() - mean) / std
    b, ih, iw, _ = x.shape
    p, d = s.patch, s.embed_dim
    gh, gw = ih // p, iw // p
    patches = x[:, : gh * p, : gw * p].reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5)
    w = top["patch_embed.proj.weight"].permute(0, 2, 3, 1).reshape(d, p * p * 3)
    x = prec.linear(patches.reshape(b, gh * gw, p * p * 3), w, top["patch_embed.proj.bias"])
    pos = top["pos_embed"].float()
    if (gh, gw) != (s.pos_grid, s.pos_grid):
        g = s.pos_grid
        grid = pos[:, 1:].reshape(1, g, g, d).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, scale_factor=((gh + 0.1) / g, (gw + 0.1) / g),
                             mode="bicubic", align_corners=False)
        pos = torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, d)], dim=1)
    x = torch.cat([top["cls_token"].float().expand(b, 1, d), x], dim=1) + pos
    if s.registers:
        regs = top["register_tokens"].float().expand(b, s.registers, d)
        x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
    return x, (gh, gw)


def qkv(x, w, s: VitShape, prec: Precision):
    """LayerNorm 1 and the qkv projection: q, k, v [B, heads, T, hd]."""
    b, t, _ = x.shape
    xn = layer_norm(x, w["norm1.weight"], w["norm1.bias"], s.eps)
    out = prec.linear(xn, w["attn.qkv.weight"], w["attn.qkv.bias"])
    return out.reshape(b, t, 3, s.num_heads, s.head_dim).permute(2, 0, 3, 1, 4)


def block(x, w, s: VitShape, prec: Precision):
    """One pre-norm transformer block over tokens [B, T, D]."""
    b, t, d = x.shape
    q, k, v = qkv(x, w, s, prec)
    att = torch.softmax(prec.mm(q, k.transpose(-1, -2)) / math.sqrt(s.head_dim), dim=-1)
    att = prec.mm(att, v).transpose(1, 2).reshape(b, t, d)
    x = x + w["ls1.gamma"].float() * prec.linear(att, w["attn.proj.weight"], w["attn.proj.bias"])
    xn = layer_norm(x, w["norm2.weight"], w["norm2.bias"], s.eps)
    if s.swiglu:
        a, v2 = prec.linear(xn, w["mlp.w12.weight"], w["mlp.w12.bias"]).chunk(2, dim=-1)
        h = prec.linear(F.silu(a) * v2, w["mlp.w3.weight"], w["mlp.w3.bias"])
    else:
        h = gelu(prec.linear(xn, w["mlp.fc1.weight"], w["mlp.fc1.bias"]), s.approx_gelu)
        h = prec.linear(h, w["mlp.fc2.weight"], w["mlp.fc2.bias"])
    return x + w["ls2.gamma"].float() * h


def feature_maps(weights, s: VitShape, images: torch.Tensor, prec: Precision,
                 rows: int = 16) -> torch.Tensor:
    """The facet's patch features [B, gh, gw, D] of images [B, H, W, 3] in
    [0, 1], `rows` images at a time; register tokens dropped, the final
    LayerNorm applied when the facet asks for it."""
    top, blocks = weights["top"], weights["blocks"]
    out = []
    for r in range(0, images.shape[0], rows):
        x, (gh, gw) = embed(top, s, images[r : r + rows], prec)
        for i in range(s.blocks_run):
            x = block(x, block_weights(blocks, i), s, prec)
        if s.facet != "token":
            sel = qkv(x, block_weights(blocks, s.layer), s, prec)[
                {"query": 0, "key": 1, "value": 2}[s.facet]]  # [B, heads, T, hd]
            x = sel.permute(0, 2, 3, 1).reshape(x.shape[0], x.shape[1], s.embed_dim)
        x = torch.cat([x[:, :1], x[:, 1 + s.registers :]], dim=1)
        if s.apply_norm:
            x = layer_norm(x, top["norm.weight"], top["norm.bias"], s.eps)
        out.append(x[:, 1:].reshape(x.shape[0], gh, gw, s.embed_dim))
    return torch.cat(out)
