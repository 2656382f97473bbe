"""DINOv3 ViT with intermediate-facet extraction (Siméoni et al. 2025,
arXiv:2508.10104; facebookresearch/dinov3, hub entry `dinov3_vit7b16`).

The JAX package has no DINOv3. The block is DINOv2's pre-norm block with
LayerScale and a SwiGLU MLP (`dinov2.Block`'s parameters and
`kernel_params`, `dinov2.run_blocks`, kernel 1), at heads of 128; what
differs is around it:

- tokens are [cls, storage tokens, patches] (DINOv3's "storage tokens" are
  DINOv2's registers under another name), with no learned position table;
- axial 2-D RoPE on q and k of the patch tokens, the prefix tokens not
  rotated: per axis the coordinates (i + 0.5) / n * 2 - 1, periods
  base ** (j / (hd / 4)) for j < hd / 4, angles 2 pi coord / period (the
  row axis in columns [0, hd / 4), the column axis in [hd / 4, hd / 2)),
  tiled twice across the head; x cos + rotate_half(x) sin in f32. The
  tables here are the untiled [HW, hd / 2] half (`rope_tables`), which
  `ops/vit_block` applies to head columns c and c + hd / 2 alike;
- the qkv projection has no bias (the kernel gets zeros); the SwiGLU
  hidden width is int(d * ffn_ratio * 2 / 3) rounded up to 64 ("swiglu64").

`DinoV3` carries the hub's state-dict names but for the MLP, whose w1 (gate)
and w2 (value) are packed as `mlp.w12` (rows [:H] gate, [H:] value) as
kernel 1 takes them; `load_checkpoint` packs a hub checkpoint. Parameters
stay f32; each forward casts them to the images' dtype. The model-name DSL
is DINOv2's with the family `dinov3`:
"dinov3_version=vit7b16_stride=16_facet=token_layer=30_norm=1".
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from foundpose_torch.models import dinov2
from foundpose_torch.models.dinov2 import normalize_images  # noqa: F401  (the family's)
from foundpose_torch.ops.vit_block import Rope, apply_rope, layer_norm
from foundpose_torch.utils import profiling

# Published widths (facebookresearch/dinov3, hub/backbones.py).
_VARIANTS = {
    "vit7b16": dict(embed_dim=4096, depth=40, num_heads=32, ffn_ratio=3.0, patch_size=16),
}


@dataclasses.dataclass(frozen=True)
class DinoV3Config:
    family: ClassVar[str] = "dinov3"
    swiglu: ClassVar[bool] = True

    variant: str = "vit7b16"
    embed_dim: int = 4096
    depth: int = 40
    num_heads: int = 32
    ffn_ratio: float = 3.0
    patch_size: int = 16
    storage_tokens: int = 4
    rope_base: float = 100.0
    # The hub's "layernormbf16" norm layer: nn.LayerNorm with eps 1e-5.
    layer_norm_eps: float = 1e-5
    stride: int = 16
    facet: str = "token"
    layer: int = 30
    apply_norm: bool = True
    # Read by the shared options path and by kernel 1; a SwiGLU block has no GELU.
    approx_gelu: bool = False
    # Always the fused block (kernel 1; its twin on the CPU): the unfused
    # block's attention, kernel 4, takes heads of 64 only and has no RoPE.
    use_fused_block: bool = True
    softmax_stabilizer: str = "column"

    def __post_init__(self):
        if not self.use_fused_block:
            raise ValueError("dinov3 runs the fused block only: set use_fused_block true")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        hidden = int(self.embed_dim * self.ffn_ratio * 2 / 3)
        return (hidden + 63) // 64 * 64

    @property
    def num_register_tokens(self) -> int:
        """The storage tokens, under the name `dinov2.facet_outputs` reads."""
        return self.storage_tokens


def parse_model_name(model_name: str) -> DinoV3Config:
    """DinoV3Config of "dinov3_version=<v>_stride=<s>_facet=<f>_layer=<l>_norm=<0|1>"
    (or "dinov3_<version>")."""
    items = model_name.split("_")
    if items[0] != "dinov3":
        raise ValueError(f"not a dinov3 model name: {model_name}")
    fields = {"version": items[1]} if len(items) == 2 and "=" not in items[1] else {}
    for item in items[1:] if not fields else ():
        if "=" not in item:
            raise ValueError(f"malformed dinov3 model-name item {item!r} in {model_name!r} "
                             "(expected key=value)")
        k, v = item.split("=", 1)
        if k not in ("version", "stride", "facet", "layer", "norm"):
            raise ValueError(f"unknown dinov3 model-name key {k!r} in {model_name!r}")
        fields[k] = v
    version = fields.get("version", "vit7b16")
    if version not in _VARIANTS:
        raise ValueError(f"unknown dinov3 variant: {version}")
    facet = fields.get("facet", "token")
    if facet not in ("token", "query", "key", "value"):
        raise ValueError(f"unknown dinov3 facet {facet!r} in {model_name!r}")
    return DinoV3Config(variant=version, stride=int(fields.get("stride", 16)), facet=facet,
                        layer=int(fields.get("layer", 30)),
                        apply_norm=bool(int(fields.get("norm", 1))), **_VARIANTS[version])


# ---------------------------------------------------------------------------
# Modules (the hub's names; the MLP's w1 and w2 packed as w12)
# ---------------------------------------------------------------------------


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d, bias=False)
        self.proj = nn.Linear(d, d)


class Block(nn.Module):
    kernel_params = dinov2.Block.kernel_params

    def __init__(self, cfg: DinoV3Config):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attn = _Attention(d)
        self.ls1 = dinov2._LayerScale(d)
        self.norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = dinov2._SwiGLU(d, cfg.mlp_hidden)
        self.ls2 = dinov2._LayerScale(d)


class DinoV3(nn.Module):
    """DINOv3 ViT; `forward` is `extract_facet`."""

    def __init__(self, cfg: DinoV3Config):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = dinov2._PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.storage_tokens = nn.Parameter(torch.zeros(1, cfg.storage_tokens, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    @torch.no_grad()
    def forward(self, images_nhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
        return extract_facet(self, images_nhwc)


# The family's module class, as `models.backbone` gives it.
Model = DinoV3


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

_ROPE_CACHE: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def rope_tables(gh: int, gw: int, device, head_dim: int = 128,
                base: float = 100.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [gh * gw, head_dim / 2] f32 of a gh x gw patch grid, row
    major, computed on the CPU in f32 as the hub's RopePositionEmbedding
    (normalize_coords="separate", no jitter or rescale at inference) and
    cached per (gh, gw, device, head_dim, base); `rope_tables.builds` counts
    the misses."""
    key = (gh, gw, str(torch.device(device)), head_dim, float(base))
    hit = _ROPE_CACHE.get(key)
    if hit is not None:
        return hit
    f32 = torch.float32
    periods = base ** (2 * torch.arange(head_dim // 4, dtype=f32) / (head_dim // 2))
    coords_h = torch.arange(0.5, gh, dtype=f32) / gh
    coords_w = torch.arange(0.5, gw, dtype=f32) / gw
    coords = torch.stack(torch.meshgrid(coords_h, coords_w, indexing="ij"), dim=-1).flatten(0, 1)
    coords = 2.0 * coords - 1.0
    angles = (2 * math.pi * coords[:, :, None] / periods[None, None, :]).flatten(1, 2)
    tables = (torch.cos(angles).to(device), torch.sin(angles).to(device))
    _ROPE_CACHE[key] = tables
    rope_tables.builds += 1
    return tables


rope_tables.builds = 0


def grid_size(cfg: DinoV3Config, image_hw: Tuple[int, int]) -> Tuple[int, int]:
    return tuple(1 + (n - cfg.patch_size) // cfg.stride for n in image_hw)


def embed_tokens(model: DinoV3, images_nhwc: torch.Tensor
                 ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Patchify + cls + storage tokens, no position table. Returns (tokens
    [B, 1 + S + N, D], (gh, gw))."""
    cfg = model.cfg
    dt = images_nhwc.dtype
    b, ih, iw, _ = images_nhwc.shape
    p, d = cfg.patch_size, cfg.embed_dim
    if cfg.stride != p:
        raise ValueError(f"dinov3: the patch embedding takes stride {p} (its patch), got "
                         f"{cfg.stride}")
    gh, gw = grid_size(cfg, (ih, iw))
    # One matmul over the unfolded image (as dinov2.embed_tokens).
    conv = model.patch_embed.proj
    patches = images_nhwc[:, : gh * p, : gw * p].reshape(b, gh, p, gw, p, 3)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3)
    w = conv.weight.to(dt).permute(0, 2, 3, 1).reshape(d, p * p * 3)
    x = patches @ w.t() + conv.bias.to(dt)
    prefix = torch.cat([model.cls_token, model.storage_tokens], dim=1).to(dt)
    return torch.cat([prefix.expand(b, -1, d), x], dim=1), (gh, gw)


def facet_tokens(model: DinoV3, x: torch.Tensor, rope: Rope) -> torch.Tensor:
    """The facet's tokens [B, T, D] from the tokens after
    `dinov2.facet_depth(cfg)` blocks; a query or key facet is rotated, as
    attention sees it."""
    cfg = model.cfg
    if cfg.facet == "token":
        return x
    if cfg.facet not in ("query", "key", "value"):
        raise ValueError(f"unsupported facet: {cfg.facet}")
    p = model.blocks[cfg.layer].kernel_params(x.dtype)
    xn = layer_norm(x, p["norm1_scale"], p["norm1_bias"], cfg.layer_norm_eps)
    qkv = F.linear(xn, p["qkv_weight"])
    b, t, _ = qkv.shape
    sel = qkv.reshape(b, t, 3, cfg.num_heads, cfg.head_dim)[:, :, ("query", "key", "value")
                                                           .index(cfg.facet)]
    if cfg.facet != "value":
        sel = apply_rope(sel.float(), rope).to(x.dtype)
    return dinov2.head_minor(sel)


@torch.no_grad()
def extract_facet(model: DinoV3, images_nhwc: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Runs the ViT up to `cfg.layer` and returns the requested facet:
    {"cls_tokens": [B, D], "feature_maps": [B, gh, gw, D]}, storage tokens
    dropped, final LayerNorm applied if cfg.apply_norm."""
    cfg = model.cfg
    with profiling.span("rope"):
        gh, gw = grid_size(cfg, images_nhwc.shape[1:3])
        cos, sin = rope_tables(gh, gw, images_nhwc.device, cfg.head_dim, cfg.rope_base)
        rope = (cos, sin, 1 + cfg.storage_tokens)
    with profiling.span("embed"):
        x, grid_hw = embed_tokens(model, images_nhwc)
    with profiling.span("blocks"):
        x = dinov2.run_blocks(model, x, dinov2.facet_depth(cfg), rope=rope)
    with profiling.span("facet"):
        return dinov2.facet_outputs(model, facet_tokens(model, x, rope), grid_hw)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

# Hub checkpoint entries the module does not hold: the RoPE periods (computed
# here), the masking token and the local-crop class norm of training.
_HUB_ONLY = ("rope_embed.periods", "mask_token", "local_cls_norm.weight", "local_cls_norm.bias")


def load_checkpoint(path: str, cfg: DinoV3Config) -> DinoV3:
    """DinoV3 (eval mode, on the CPU) from a hub state dict (bare or under
    "model"): each block's mlp.w1 and mlp.w2 are packed into mlp.w12."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in state and isinstance(state["model"], dict):
        state = state["model"]
    state = {k: v for k, v in state.items() if k not in _HUB_ONLY}
    for i in range(cfg.depth):
        pre = f"blocks.{i}.mlp."
        for kind in ("weight", "bias"):
            if f"{pre}w1.{kind}" in state:
                state[f"{pre}w12.{kind}"] = torch.cat(
                    [state.pop(f"{pre}w1.{kind}"), state.pop(f"{pre}w2.{kind}")])
    model = DinoV3(cfg)
    missing, unexpected = model.load_state_dict(state, strict=False)
    if missing or unexpected:
        raise ValueError(f"checkpoint {path} does not fit {cfg.variant}: missing {missing}, "
                         f"unexpected {unexpected}")
    return model.eval()


def init_weights(model: DinoV3, generator: torch.Generator, layer_scale: float = 0.1) -> DinoV3:
    """Random weights in place: truncated normal (std 0.02, cut at +-0.04)
    for the tokens and every projection, zero biases, unit norms, layer
    scale `layer_scale`. No logit calibration (at 6.7 B parameters the
    host forward it needs would take minutes)."""
    with torch.no_grad():
        for name, t in model.named_parameters():
            owner = name.rsplit(".", 2)[-2] if name.count(".") else ""
            if owner.startswith("ls"):
                t.fill_(layer_scale)
            elif owner.startswith("norm"):
                t.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                t.zero_()
            else:
                nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)
    return model.eval()


def load_or_init(cfg: DinoV3Config, weights_path: Optional[str] = None,
                 seed: int = 0) -> DinoV3:
    """DinoV3 (eval mode, on the CPU) from a hub checkpoint, or random
    weights from `seed` (`init_weights`)."""
    if weights_path:
        return load_checkpoint(weights_path, cfg)
    return init_weights(DinoV3(cfg), torch.Generator().manual_seed(seed))
