"""Plain DINOv3 ViT (Siméoni et al. 2025, arXiv:2508.10104;
facebookresearch/dinov3, hub entry `dinov3_vit7b16`) up to a facet: the
reference of the `dinov3` backbone family (`perfbench/models/dinov3.py`).

Weights come as {"top": tensors, "blocks": tensors stacked over depth}
under the hub's state-dict names, but for each block's MLP, whose w1
(gate) and w2 (value) are packed as `mlp.w12` (rows [:H], [H:]); the qkv
projection has no bias. The equations:

- tokens [cls, storage tokens, patches]; the patch embedding a 16 x 16
  convolution of stride 16 with a bias, no position table;
- pre-norm blocks: x += ls1 * proj(attn(LN1(x))), then
  x += ls2 * w3(silu(w1 LN2(x)) * w2 LN2(x));
- axial 2-D RoPE on q and k of the patch tokens (the class and storage
  tokens not rotated): per axis the coordinates (i + 0.5) / n * 2 - 1,
  periods base ** (j / (hd / 4)), j < hd / 4, angles 2 pi coord / period
  (row axis, then column axis), tiled twice to hd; x cos + rotate_half(x) sin
  with rotate_half(x) = [-x[hd/2:], x[:hd/2]], in float32;
- the facet: the tokens after block `layer` (or block `layer`'s rotated
  query or key, its value), storage tokens dropped, the final LayerNorm on
  the class and patch tokens.

Departures from the hub's code, none of which changes the function: the
convolution is one product over the unfolded patches (the same sums, in
float32 with no TF32 on the card); w1 and w2 are slices of the packed
w12. Every matrix product goes through `prec`, so the control lowers it.
The harness calls `feature_maps`. `foundpose_torch/benchmarks/reference_dinov3.py`
is the same arithmetic on the hub's own layout; the two agree bit for bit.
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

# Published widths (facebookresearch/dinov3, hub/backbones.py).
VARIANTS = {
    "vit7b16": dict(embed_dim=4096, depth=40, num_heads=32, ffn_ratio=3.0, patch=16),
}


@dataclasses.dataclass(frozen=True)
class VitShape:
    embed_dim: int
    depth: int
    num_heads: int
    ffn_ratio: float
    patch: int
    layer: int
    facet: str = "token"
    apply_norm: bool = True
    storage: int = 4
    rope_base: float = 100.0
    eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        """SwiGLU's hidden width, "swiglu64": 2/3 of d * ffn_ratio, rounded up to 64."""
        return (int(self.embed_dim * self.ffn_ratio * 2 / 3) + 63) // 64 * 64

    @property
    def blocks_run(self) -> int:
        """Whole blocks before the facet: [0, layer] for tokens, [0, layer)
        for a query, key or value facet (whose layer adds its qkv)."""
        return self.layer + 1 if self.facet == "token" else self.layer


def parse_extractor(name: str, **overrides) -> VitShape:
    """VitShape of `dinov3_version=<v>_stride=16_facet=<f>_layer=<l>_norm=<0|1>`."""
    fields = dict(item.split("=", 1) for item in name.split("_")[1:])
    shape = dict(VARIANTS[fields["version"]], layer=int(fields["layer"]),
                 facet=fields.get("facet", "token"), apply_norm=bool(int(fields.get("norm", 1))))
    if int(fields.get("stride", shape["patch"])) != shape["patch"]:
        raise ValueError("the reference takes a stride equal to the patch")
    shape.update(overrides)
    return VitShape(**shape)


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w.float() + b.float()


def rope_tables(gh: int, gw: int, head_dim: int, base: float, device):
    """cos and sin [gh * gw, head_dim] of a gh x gw grid, float32."""
    f32 = torch.float32
    periods = base ** (2 * torch.arange(head_dim // 4, dtype=f32) / (head_dim // 2))
    coords_h = torch.arange(0.5, gh, dtype=f32) / gh
    coords_w = torch.arange(0.5, gw, dtype=f32) / gw
    coords = torch.stack(torch.meshgrid(coords_h, coords_w, indexing="ij"), dim=-1).flatten(0, 1)
    coords = 2.0 * coords - 1.0
    angles = (2 * math.pi * coords[:, :, None] / periods[None, None, :]).flatten(1, 2).tile(2)
    return torch.cos(angles).to(device), torch.sin(angles).to(device)


def rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope_apply(x, cos, sin):
    return x * cos + rotate_half(x) * sin


def block_weights(blocks: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in blocks.items()}


def embed(top: Dict[str, torch.Tensor], s: VitShape, images: torch.Tensor, prec: Precision):
    """Images [B, H, W, 3] in [0, 1] -> tokens [B, 1 + S + N, D] f32 and the
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
    prefix = torch.cat([top["cls_token"].float(), top["storage_tokens"].float()], dim=1)
    return torch.cat([prefix.expand(b, -1, d), x], dim=1), (gh, gw)


def qkv(x, w, s: VitShape, rope, prec: Precision):
    """LayerNorm 1, the qkv projection (no bias) and RoPE on q and k of the
    patch tokens: q, k, v [B, heads, T, hd]."""
    b, t, _ = x.shape
    xn = layer_norm(x, w["norm1.weight"], w["norm1.bias"], s.eps)
    out = prec.mm(xn, w["attn.qkv.weight"].t())
    q, k, v = out.reshape(b, t, 3, s.num_heads, s.head_dim).permute(2, 0, 3, 1, 4)
    cos, sin = rope
    n = 1 + s.storage
    q = torch.cat([q[:, :, :n], rope_apply(q[:, :, n:], cos, sin)], dim=2)
    k = torch.cat([k[:, :, :n], rope_apply(k[:, :, n:], cos, sin)], dim=2)
    return q, k, v


def block(x, w, s: VitShape, rope, prec: Precision):
    """One pre-norm block over tokens [B, T, D]."""
    b, t, d = x.shape
    q, k, v = qkv(x, w, s, rope, prec)
    att = torch.softmax(prec.mm(q, k.transpose(-1, -2)) / math.sqrt(s.head_dim), dim=-1)
    att = prec.mm(att, v).transpose(1, 2).reshape(b, t, d)
    x = x + w["ls1.gamma"].float() * prec.linear(att, w["attn.proj.weight"], w["attn.proj.bias"])
    xn = layer_norm(x, w["norm2.weight"], w["norm2.bias"], s.eps)
    h = s.mlp_hidden
    w12, b12 = w["mlp.w12.weight"], w["mlp.w12.bias"]
    gate = prec.linear(xn, w12[:h], b12[:h])
    value = prec.linear(xn, w12[h:], b12[h:])
    y = prec.linear(F.silu(gate) * value, w["mlp.w3.weight"], w["mlp.w3.bias"])
    return x + w["ls2.gamma"].float() * y


def feature_maps(weights, s: VitShape, images: torch.Tensor, prec: Precision,
                 rows: int = 4) -> torch.Tensor:
    """The facet's patch features [B, gh, gw, D] of images [B, H, W, 3] in
    [0, 1], `rows` images at a time; storage tokens dropped, the final
    LayerNorm applied when the facet asks for it."""
    top, blocks = weights["top"], weights["blocks"]
    p = s.patch
    rope = rope_tables(images.shape[1] // p, images.shape[2] // p, s.head_dim, s.rope_base,
                       images.device)
    out = []
    for r in range(0, images.shape[0], rows):
        x, (gh, gw) = embed(top, s, images[r : r + rows], prec)
        for i in range(s.blocks_run):
            x = block(x, block_weights(blocks, i), s, rope, prec)
        if s.facet != "token":
            sel = qkv(x, block_weights(blocks, s.layer), s, rope, prec)[
                ("query", "key", "value").index(s.facet)]  # [B, heads, T, hd]
            x = sel.permute(0, 2, 3, 1).reshape(x.shape[0], x.shape[1], s.embed_dim)
        x = torch.cat([x[:, :1], x[:, 1 + s.storage :]], dim=1)
        if s.apply_norm:
            x = layer_norm(x, top["norm.weight"], top["norm.bias"], s.eps)
        out.append(x[:, 1:].reshape(x.shape[0], gh, gw, s.embed_dim))
    return torch.cat(out)
