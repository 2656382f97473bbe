"""An independent plain-PyTorch DINOv3 ViT (Siméoni et al. 2025,
arXiv:2508.10104; facebookresearch/dinov3, hub entry `dinov3_vit7b16`) up
to a facet, in float32 with TF32 off, on the hub's state-dict names
(`patch_embed.proj.*`, `cls_token`, `storage_tokens`,
`blocks.{i}.norm1|attn.qkv|attn.proj|ls1.gamma|norm2|mlp.w1|mlp.w2|mlp.w3|ls2.gamma`,
`norm.*`; the qkv projection without a bias, as the hub builds the 7B).

The equations, from the paper and the hub's code:
- tokens [cls, storage tokens, patches]; the patch embedding a p x p
  convolution of stride p with a bias; no position table;
- pre-norm blocks: x += ls1 * proj(attn(LN1(x))), then
  x += ls2 * w3(silu(w1 LN2(x)) * w2 LN2(x)); softmax(q k^T / sqrt(hd)) v;
- axial 2-D RoPE on q and k of the patch tokens only (the 1 + S prefix
  tokens are not rotated): per axis the coordinates (i + 0.5) / n * 2 - 1,
  periods base ** (2j / (hd / 2)) for j < hd / 4, angles
  2 pi coord / period with the row axis's hd / 4 columns first, tiled twice
  to hd; x cos + rotate_half(x) sin, rotate_half(x) = [-x[hd/2:], x[:hd/2]];
- the facet: tokens after block `layer` (a query or key facet: block
  `layer`'s rotated q or k, head-minor as FoundPose flattens them),
  storage tokens dropped, the final LayerNorm on the class and patch tokens.

Departures, none of which changes the function: the convolution is one
product over the unfolded patches (the same sums; no cuDNN, so no TF32);
the hub computes RoPE in its own dtype, here everything is float32; the
hub's LayerNorm is torch's, here its formula. It imports nothing of
`foundpose_torch` and nothing of JAX: its agreement with the port's
`models/dinov3` is evidence about both. `perfbench/reference/dinov3.py` is
the same arithmetic on the benchmark's stacked weights, product for product.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class Dinov3Shape:
    """The published ViT-7B/16 by default."""

    embed_dim: int = 4096
    depth: int = 40
    num_heads: int = 32
    ffn_ratio: float = 3.0
    patch: int = 16
    storage: int = 4
    layer: int = 30
    facet: str = "token"
    apply_norm: bool = True
    rope_base: float = 100.0
    eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        """"swiglu64": 2/3 of d * ffn_ratio, rounded up to 64."""
        return (int(self.embed_dim * self.ffn_ratio * 2 / 3) + 63) // 64 * 64


@contextlib.contextmanager
def _exact_f32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.t()
    return y if b is None else y + b


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def rope_tables(gh: int, gw: int, head_dim: int, base: float, device):
    """cos and sin [gh * gw, head_dim] of a gh x gw patch grid."""
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


def _embed(sd: Dict[str, torch.Tensor], s: Dinov3Shape, images: torch.Tensor):
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    x = (images.float() - mean) / std
    b, ih, iw, _ = x.shape
    p, d = s.patch, s.embed_dim
    gh, gw = ih // p, iw // p
    patches = x[:, : gh * p, : gw * p].reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5)
    w = sd["patch_embed.proj.weight"].permute(0, 2, 3, 1).reshape(d, p * p * 3)
    x = _linear(patches.reshape(b, gh * gw, p * p * 3), w, sd["patch_embed.proj.bias"])
    prefix = torch.cat([sd["cls_token"], sd["storage_tokens"]], dim=1)
    return torch.cat([prefix.expand(b, -1, d), x], dim=1), (gh, gw)


def _qkv(x, sd, i: int, s: Dinov3Shape, rope):
    pre = f"blocks.{i}."
    b, t, _ = x.shape
    xn = layer_norm(x, sd[pre + "norm1.weight"], sd[pre + "norm1.bias"], s.eps)
    out = _linear(xn, sd[pre + "attn.qkv.weight"], sd.get(pre + "attn.qkv.bias"))
    q, k, v = out.reshape(b, t, 3, s.num_heads, s.head_dim).permute(2, 0, 3, 1, 4)
    cos, sin = rope
    n = 1 + s.storage
    q = torch.cat([q[:, :, :n], rope_apply(q[:, :, n:], cos, sin)], dim=2)
    k = torch.cat([k[:, :, :n], rope_apply(k[:, :, n:], cos, sin)], dim=2)
    return q, k, v


def _block(x, sd, i: int, s: Dinov3Shape, rope):
    pre = f"blocks.{i}."
    b, t, d = x.shape
    q, k, v = _qkv(x, sd, i, s, rope)
    att = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(s.head_dim), dim=-1)
    att = (att @ v).transpose(1, 2).reshape(b, t, d)
    x = x + sd[pre + "ls1.gamma"] * _linear(att, sd[pre + "attn.proj.weight"],
                                            sd[pre + "attn.proj.bias"])
    xn = layer_norm(x, sd[pre + "norm2.weight"], sd[pre + "norm2.bias"], s.eps)
    gate = _linear(xn, sd[pre + "mlp.w1.weight"], sd[pre + "mlp.w1.bias"])
    value = _linear(xn, sd[pre + "mlp.w2.weight"], sd[pre + "mlp.w2.bias"])
    y = _linear(F.silu(gate) * value, sd[pre + "mlp.w3.weight"], sd[pre + "mlp.w3.bias"])
    return x + sd[pre + "ls2.gamma"] * y


@torch.no_grad()
def feature_maps(sd: Dict[str, torch.Tensor], s: Dinov3Shape, images: torch.Tensor,
                 rows: int = 4) -> torch.Tensor:
    """The facet's patch features [B, gh, gw, D] f32 of images [B, H, W, 3]
    in [0, 1], `rows` images at a time. `sd`: float32 tensors on the
    images' device."""
    p = s.patch
    rope = rope_tables(images.shape[1] // p, images.shape[2] // p, s.head_dim, s.rope_base,
                       images.device)
    blocks_run = s.layer + 1 if s.facet == "token" else s.layer
    out = []
    with _exact_f32():
        for r in range(0, images.shape[0], rows):
            x, (gh, gw) = _embed(sd, s, images[r : r + rows])
            for i in range(blocks_run):
                x = _block(x, sd, i, s, rope)
            if s.facet != "token":
                sel = _qkv(x, sd, s.layer, s, rope)[("query", "key", "value").index(s.facet)]
                x = sel.permute(0, 2, 3, 1).reshape(x.shape[0], x.shape[1], s.embed_dim)
            x = torch.cat([x[:, :1], x[:, 1 + s.storage :]], dim=1)
            if s.apply_norm:
                x = layer_norm(x, sd["norm.weight"], sd["norm.bias"], s.eps)
            out.append(x[:, 1:].reshape(x.shape[0], gh, gw, s.embed_dim))
    return torch.cat(out)
