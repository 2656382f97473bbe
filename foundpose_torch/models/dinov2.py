"""DINOv2 ViT with intermediate-facet extraction (counterpart of
foundpose_tpu/models/dinov2.py).

`DinoV2` is an nn.Module whose parameters carry the official DINOv2
state-dict names (patch_embed.proj.*, cls_token, pos_embed,
register_tokens, blocks.{i}.norm1|attn.qkv|attn.proj|ls1.gamma|norm2|
mlp.fc1|mlp.fc2 (SwiGLU, ViT-G: mlp.w12|mlp.w3)|ls2.gamma, norm.*), so an
official checkpoint loads with `load_state_dict`. Parameters stay f32;
each forward casts them to the images' dtype, as the JAX package does.
With `use_fused_block` each transformer block runs through
ops/vit_block.fused_vit_block (one CUDA kernel sequence, bf16 only);
without it, the unfused block runs its dense
products with torch.matmul and its attention through
ops/attention.fused_attention_bhtd. Either way the CUDA kernel runs on the
GPU and its plain twin on the CPU. Public functions keep the JAX package's
NHWC image layout.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from foundpose_torch.ops.attention import fused_attention_bhtd
from foundpose_torch.structs import to_device
from foundpose_torch.ops.vit_block import Rope, fused_vit_block, gelu, layer_norm, swiglu

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_VARIANTS = {
    "vits14": dict(embed_dim=384, depth=12, num_heads=6, mlp_ratio=4.0, swiglu=False),
    "vitb14": dict(embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0, swiglu=False),
    "vitl14": dict(embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4.0, swiglu=False),
    "vitg14": dict(embed_dim=1536, depth=40, num_heads=24, mlp_ratio=4.0, swiglu=True),
}


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    family: ClassVar[str] = "dinov2"  # the model-name DSL's first field (models.backbone)

    variant: str = "vits14"
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    swiglu: bool = False
    patch_size: int = 14
    num_register_tokens: int = 4
    pos_grid: int = 37
    layer_norm_eps: float = 1e-6
    stride: int = 14
    facet: str = "token"
    layer: int = 9
    apply_norm: bool = True
    # tanh GELU instead of the exact erf GELU (the shipped configs set it).
    approx_gelu: bool = False
    # The whole block as one kernel sequence (ops/vit_block.py). Off: the
    # unfused block, whose attention always runs through ops/attention (the
    # JAX package's `use_pallas_attention` has no counterpart here).
    use_fused_block: bool = False
    # Fused block only: "column" subtracts the per-query max; "capped" skips
    # the max and caps p = min(exp2(l), 1e30) (see ops/vit_block.py).
    softmax_stabilizer: str = "column"

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        if self.swiglu:
            return (int(self.embed_dim * self.mlp_ratio * 2 / 3) + 7) // 8 * 8
        return int(self.embed_dim * self.mlp_ratio)


_IGNORED_DSL_KEYS = frozenset({"logbin"})


def parse_model_name(model_name: str) -> DinoV2Config:
    """Parses the model-name DSL ("dinov2_<version>" or
    "dinov2_version=<v>_stride=<s>_facet=<f>_layer=<l>_norm=<0|1>")."""
    items = model_name.split("_")
    if items[0] != "dinov2":
        raise ValueError(f"not a dinov2 model name: {model_name}")
    version, stride, facet, layer, norm = "vits14-reg", 14, "token", 9, True
    if len(items) == 2 and "=" not in items[1]:
        version = items[1]
    else:
        for item in items[1:]:
            if "=" not in item:
                raise ValueError(
                    f"malformed dinov2 model-name item {item!r} in {model_name!r} "
                    "(expected key=value)"
                )
            k, v = item.split("=", 1)
            if k == "version":
                version = v
            elif k == "stride":
                stride = int(v)
            elif k == "facet":
                if v not in ("token", "query", "key", "value", "attn"):
                    raise ValueError(f"unknown dinov2 facet {v!r} in {model_name!r}")
                facet = v
            elif k == "layer":
                layer = int(v)
            elif k == "norm":
                norm = bool(int(v))
            elif k not in _IGNORED_DSL_KEYS:
                raise ValueError(f"unknown dinov2 model-name key {k!r} in {model_name!r}")
    has_reg = version.endswith("-reg")
    base = version[:-4] if has_reg else version
    if base not in _VARIANTS:
        raise ValueError(f"unknown dinov2 variant: {version}")
    return DinoV2Config(
        variant=base,
        num_register_tokens=4 if has_reg else 0,
        stride=stride,
        facet=facet,
        layer=layer,
        apply_norm=norm,
        **_VARIANTS[base],
    )


# ---------------------------------------------------------------------------
# Modules (official DINOv2 parameter names)
# ---------------------------------------------------------------------------


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: DinoV2Config):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, stride=cfg.stride)


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)


class _LayerScale(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((d,), 1e-5))


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)


class _SwiGLU(nn.Module):
    """DINOv2's SwiGLUFFNFused: w12 holds the gate rows [:h] and the value
    rows [h:]; silu(gate) * value feeds w3."""

    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(d, 2 * hidden)
        self.w3 = nn.Linear(hidden, d)


class Block(nn.Module):
    def __init__(self, cfg: DinoV2Config):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attn = _Attention(d)
        self.ls1 = _LayerScale(d)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = (_SwiGLU if cfg.swiglu else _Mlp)(d, cfg.mlp_hidden)
        self.ls2 = _LayerScale(d)

    def kernel_params(self, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        """This layer's weights for ops/vit_block (its BLOCK_KEYS of the
        layer's MLP), all cast to `dtype` (the JAX package casts every block
        parameter, LayerNorm and layer scale included, to the compute
        dtype). A qkv projection without a bias (DINOv3's) gets zeros."""
        qkv = self.attn.qkv
        src = {
            "norm1_scale": self.norm1.weight, "norm1_bias": self.norm1.bias,
            "qkv_weight": qkv.weight,
            "qkv_bias": qkv.weight.new_zeros(qkv.out_features) if qkv.bias is None else qkv.bias,
            "proj_weight": self.attn.proj.weight, "proj_bias": self.attn.proj.bias,
            "ls1": self.ls1.gamma,
            "norm2_scale": self.norm2.weight, "norm2_bias": self.norm2.bias,
            "ls2": self.ls2.gamma,
        }
        for name, lin in self.mlp.named_children():
            src[f"{name}_weight"], src[f"{name}_bias"] = lin.weight, lin.bias
        return {k: v.detach().to(dtype).contiguous() for k, v in src.items()}


class DinoV2(nn.Module):
    """DINOv2 ViT; `forward` is `extract_facet`."""

    def __init__(self, cfg: DinoV2Config):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = _PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid**2, d))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    @torch.no_grad()
    def forward(self, images_nhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
        return extract_facet(self, images_nhwc)


# The family's module class, as `models.backbone` gives it.
Model = DinoV2


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _torch_bicubic_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """Dense (out, in) matrix of F.interpolate(mode="bicubic",
    align_corners=False) with an explicit scale_factor: src = (dst + 0.5) /
    scale - 0.5, cubic a = -0.75, border replication."""
    a = -0.75

    def cubic(t):
        t = np.abs(t)
        return np.where(
            t <= 1.0,
            (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0,
            np.where(t < 2.0, a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a, 0.0),
        )

    m = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        src = (i + 0.5) / scale - 0.5
        base = int(np.floor(src))
        for tap in range(-1, 3):
            j = base + tap
            m[i, min(max(j, 0), in_size - 1)] += cubic(src - j)
    return m.astype(np.float32)


def interpolate_pos_embed(
    pos_embed: torch.Tensor, grid_hw: Tuple[int, int], pos_grid: int
) -> torch.Tensor:
    """Bicubic resize of the patch position embeddings to a new grid, with
    the reference's +0.1 in the scale factor."""
    gh, gw = grid_hw
    if (gh, gw) == (pos_grid, pos_grid):
        return pos_embed
    d = pos_embed.shape[-1]
    grid = pos_embed[:, 1:].reshape(1, pos_grid, pos_grid, d).float()
    dev = pos_embed.device
    mh = to_device(_torch_bicubic_matrix(pos_grid, gh, (gh + 0.1) / pos_grid), dev)
    mw = to_device(_torch_bicubic_matrix(pos_grid, gw, (gw + 0.1) / pos_grid), dev)
    resized = torch.einsum("oi,bijd->bojd", mh, grid)
    resized = torch.einsum("pj,bojd->bopd", mw, resized)
    return torch.cat([pos_embed[:, :1].float(), resized.reshape(1, gh * gw, d)], dim=1)


def embed_tokens(
    model: DinoV2, images_nhwc: torch.Tensor
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Patchify + cls + pos embed + register tokens (after CLS, without a
    position embedding). Returns (tokens [B, 1+R+N, D], (gh, gw))."""
    cfg = model.cfg
    dt = images_nhwc.dtype
    b, ih, iw, _ = images_nhwc.shape
    p = cfg.patch_size
    gh = 1 + (ih - p) // cfg.stride
    gw = 1 + (iw - p) // cfg.stride
    conv = model.patch_embed.proj
    if cfg.stride == p:
        # Non-overlapping patches: one matmul over the unfolded image rather
        # than a cuDNN convolution, which would round f32 to TF32 under
        # cuDNN's default switch.
        patches = images_nhwc[:, : gh * p, : gw * p].reshape(b, gh, p, gw, p, 3)
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3)
        w = conv.weight.to(dt).permute(0, 2, 3, 1).reshape(cfg.embed_dim, p * p * 3)
        x = patches @ w.t() + conv.bias.to(dt)
    else:
        x = F.conv2d(
            images_nhwc.permute(0, 3, 1, 2), conv.weight.to(dt), stride=cfg.stride
        )  # [B, D, gh, gw]
        x = x.permute(0, 2, 3, 1) + conv.bias.to(dt)
        x = x.reshape(b, gh * gw, cfg.embed_dim)
    cls = model.cls_token.to(dt).expand(b, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    pos = interpolate_pos_embed(model.pos_embed, (gh, gw), cfg.pos_grid)
    x = x + pos.to(dt)
    if cfg.num_register_tokens:
        regs = model.register_tokens.to(dt).expand(b, cfg.num_register_tokens, cfg.embed_dim)
        x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
    return x, (gh, gw)


def unfused_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: DinoV2Config) -> torch.Tensor:
    """The JAX package's unfused pre-norm block over x [B, T, D] with one
    layer's weights `p` (Block.kernel_params): head-major qkv, attention
    through ops/attention, proj, layer-scaled residuals, f32 LayerNorm
    statistics, exact or tanh GELU, or SwiGLU."""
    b, t, d = x.shape
    eps = cfg.layer_norm_eps
    xn = layer_norm(x, p["norm1_scale"], p["norm1_bias"], eps)
    qkv = F.linear(xn, p["qkv_weight"], p["qkv_bias"])
    qkv = qkv.reshape(b, t, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4).contiguous()
    attn = fused_attention_bhtd(qkv[0], qkv[1], qkv[2])  # [B, H, T, Dh]
    attn = F.linear(attn.transpose(1, 2).reshape(b, t, d), p["proj_weight"], p["proj_bias"])
    x = x + p["ls1"] * attn
    xn = layer_norm(x, p["norm2_scale"], p["norm2_bias"], eps)
    return x + p["ls2"] * mlp(xn, p, cfg)


def mlp(xn: torch.Tensor, p: Dict[str, torch.Tensor], cfg: DinoV2Config) -> torch.Tensor:
    """The JAX package's `_mlp`: fc1 -> GELU -> fc2, or w12 -> silu(gate) *
    value -> w3, in the dtype of `xn`."""
    if cfg.swiglu:
        return F.linear(swiglu(F.linear(xn, p["w12_weight"], p["w12_bias"])),
                        p["w3_weight"], p["w3_bias"])
    h = gelu(F.linear(xn, p["fc1_weight"], p["fc1_bias"]), cfg.approx_gelu)
    return F.linear(h, p["fc2_weight"], p["fc2_bias"])


def run_blocks(model: DinoV2, x: torch.Tensor, upto: int,
               rope: Optional[Rope] = None) -> torch.Tensor:
    """Runs blocks [0, upto): the fused block kernel or the unfused block,
    by `cfg.use_fused_block` (CPU tensors take the plain twins); `rope`
    (DINOv3, whose config takes the fused block only): the rotary tables
    and prefix of q and k."""
    cfg = model.cfg
    for blk in list(model.blocks)[:upto]:
        p = blk.kernel_params(x.dtype)
        if not cfg.use_fused_block:
            x = unfused_block(x, p, cfg)
            continue
        x = fused_vit_block(
            x,
            p,
            seq_len=x.shape[1],
            num_heads=cfg.num_heads,
            head_dim=cfg.head_dim,
            eps=cfg.layer_norm_eps,
            approx_gelu=cfg.approx_gelu,
            softmax_stabilizer=cfg.softmax_stabilizer,
            rope=rope,
        )
    return x


@torch.no_grad()
def extract_facet(model: DinoV2, images_nhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Runs the ViT up to `cfg.layer` and returns the requested facet:
    {"cls_tokens": [B, D], "feature_maps": [B, gh, gw, D]}, register tokens
    dropped, final LayerNorm applied if cfg.apply_norm."""
    cfg = model.cfg
    x, grid_hw = embed_tokens(model, images_nhwc)
    x = run_blocks(model, x, facet_depth(cfg))
    return facet_outputs(model, facet_tokens(model, x), grid_hw)


def facet_depth(cfg: DinoV2Config) -> int:
    """Blocks that extract_facet runs whole: [0, layer] for the token
    facet; [0, layer) for a query, key or value facet, whose layer adds its
    qkv projection alone."""
    return cfg.layer + 1 if cfg.facet == "token" else cfg.layer


def facet_tokens(model: DinoV2, x: torch.Tensor) -> torch.Tensor:
    """The facet's tokens [B, T, D] from the tokens after facet_depth(cfg)
    blocks."""
    cfg = model.cfg
    if cfg.facet == "token":
        return x
    if cfg.facet in ("query", "key", "value"):
        p = model.blocks[cfg.layer].kernel_params(x.dtype)
        xn = layer_norm(x, p["norm1_scale"], p["norm1_bias"], cfg.layer_norm_eps)
        qkv = F.linear(xn, p["qkv_weight"], p["qkv_bias"])
        b, t, _ = qkv.shape
        qkv = qkv.reshape(b, t, 3, cfg.num_heads, cfg.head_dim)
        return head_minor(qkv[:, :, {"query": 0, "key": 1, "value": 2}[cfg.facet]])
    if cfg.facet == "attn":
        raise ValueError("facet='attn' is not a descriptor facet")
    raise ValueError(f"unsupported facet: {cfg.facet}")


def head_minor(sel: torch.Tensor) -> torch.Tensor:
    """[B, T, nh, hd] query/key/value heads -> [B, T, nh * hd] flattened
    head-minor, as the reference's permute(0, 2, 3, 1).flatten."""
    b, t, nh, hd = sel.shape
    return sel.transpose(2, 3).reshape(b, t, nh * hd)


def facet_outputs(
    model: DinoV2, feats: torch.Tensor, grid_hw: Tuple[int, int]
) -> Dict[str, torch.Tensor]:
    """Facet tokens [B, 1+R+N, D] -> {"cls_tokens", "feature_maps"}:
    register tokens dropped, the final LayerNorm applied if cfg.apply_norm."""
    cfg = model.cfg
    cls_tokens = feats[:, 0]
    patch_tokens = feats[:, 1 + cfg.num_register_tokens :]
    if cfg.apply_norm:
        tokens = torch.cat([cls_tokens[:, None], patch_tokens], dim=1)
        dt = tokens.dtype
        tokens = layer_norm(
            tokens, model.norm.weight.to(dt), model.norm.bias.to(dt), cfg.layer_norm_eps
        )
        cls_tokens = tokens[:, 0]
        patch_tokens = tokens[:, 1:]
    b = patch_tokens.shape[0]
    fmap = patch_tokens.reshape(b, *grid_hw, patch_tokens.shape[-1])
    return {"cls_tokens": cls_tokens, "feature_maps": fmap}


def normalize_images(images_nhwc: torch.Tensor) -> torch.Tensor:
    """ImageNet-stat normalization of [..., 3] images."""
    mean = to_device(torch.tensor(IMAGENET_MEAN, dtype=images_nhwc.dtype), images_nhwc.device)
    std = to_device(torch.tensor(IMAGENET_STD, dtype=images_nhwc.dtype), images_nhwc.device)
    return (images_nhwc - mean) / std


@torch.no_grad()
def extract_attention_maps(model: DinoV2, images_nhwc: torch.Tensor) -> torch.Tensor:
    """Post-softmax attention probabilities [B, heads, T, T] of block
    `cfg.layer` (the reference's facet="attn"; T counts the class and
    register tokens): blocks [0, layer), then LN1 -> qkv -> logits scaled
    in the compute dtype -> f32 softmax. An extraction endpoint: the plain
    route whatever the fused-block switch."""
    cfg = model.cfg
    x, _ = embed_tokens(model, images_nhwc)
    x = run_blocks(model, x, cfg.layer)
    p = model.blocks[cfg.layer].kernel_params(x.dtype)
    xn = layer_norm(x, p["norm1_scale"], p["norm1_bias"], cfg.layer_norm_eps)
    qkv = F.linear(xn, p["qkv_weight"], p["qkv_bias"])
    b, t, _ = qkv.shape
    qkv = qkv.reshape(b, t, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
    logits = (qkv[0] @ qkv[1].transpose(-1, -2)) * (cfg.head_dim**-0.5)
    return torch.softmax(logits.float(), dim=-1)


@torch.no_grad()
def forward_full(model: DinoV2, images_nhwc: torch.Tensor) -> torch.Tensor:
    """All `cfg.depth` blocks, then the final LayerNorm: tokens [B, T, D]."""
    cfg = model.cfg
    x, _ = embed_tokens(model, images_nhwc)
    x = run_blocks(model, x, cfg.depth)
    return layer_norm(x, model.norm.weight, model.norm.bias, cfg.layer_norm_eps)


def make_extractor(model_name: str):
    """(cfg, extract) for a model-name DSL string; extract(model,
    images_nhwc, compute_dtype=torch.float32) normalizes the images, casts
    them and runs extract_facet."""
    cfg = parse_model_name(model_name)

    def extract(model: DinoV2, images_nhwc: torch.Tensor, compute_dtype=torch.float32):
        return extract_facet(model, normalize_images(images_nhwc).to(compute_dtype))

    return cfg, extract


def load_or_init(cfg: DinoV2Config, weights_path: Optional[str] = None, seed: int = 0) -> DinoV2:
    """DinoV2 (eval mode, on the CPU) from an official-name checkpoint, or
    without one bench_weights' random weights from `seed`."""
    from foundpose_torch.models import bench_weights, weights  # both import this module

    if weights_path:
        return weights.load_checkpoint(weights_path, cfg)
    model = DinoV2(cfg)
    params = bench_weights.init_params(cfg, torch.Generator().manual_seed(seed))
    model.load_state_dict(weights.state_dict_from_jax_params(params, cfg))
    return model.eval()
