"""An independent plain-PyTorch DINOv2 in the module layout of the
`transformers` package (version 4.57.6: models/dinov2/modeling_dinov2.py
and models/dinov2_with_registers/modeling_dinov2_with_registers.py), the
stand-in for `transformers` where it is not installed.

`Dinov2Model` (no registers) and `Dinov2WithRegistersModel` have
transformers' `state_dict()` keys (embeddings.*, encoder.layer.{i}.*,
layernorm.*), so `foundpose_torch.models.weights.to_hf_state_dict` loads
into them through `load_hf_state_dict`, which allows `embeddings.mask_token`
alone to be missing. The math is transformers' eager path: per-head q, k
and v from three linears, logits `q @ k^T * head_dim**-0.5`, softmax in f32,
`p @ v`, the output dense; exact erf GELU between fc1 and fc2, or the
SwiGLU MLP (`weights_in`, `silu(x1) * x2`, `weights_out`) where the config
asks for it; layer scales `lambda1`; the final `layernorm`. Each class
interpolates the position embeddings by its own recipe when the patch grid
differs from the pretraining grid: bicubic to `size=(H / patch, W /
patch)` with `align_corners=False`, and with `antialias=True` as well for
the registers model. The official DINOv2 recipe (a scale factor with +0.1,
`foundpose_torch.models.dinov2.interpolate_pos_embed`) differs from both,
so away from the native grid the two implementations disagree by design.

It imports nothing of `foundpose_torch.models` or `foundpose_torch.ops`
and nothing of `transformers`: its agreement with the port's ViT is
evidence about both. The patch embedding is a convolution, run with
cuDNN's TF32 switch off, so that on the card it stays in f32 whatever the
caller's switch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class Dinov2Config:
    """transformers' `Dinov2Config` / `Dinov2WithRegistersConfig` fields
    that inference reads (their defaults; `num_register_tokens` is read by
    the registers model alone)."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: int = 4
    layer_norm_eps: float = 1e-6
    image_size: int = 224
    patch_size: int = 14
    use_swiglu_ffn: bool = False
    num_register_tokens: int = 4


@dataclasses.dataclass
class Dinov2Output:
    """`last_hidden_state` (after `layernorm`) and, when asked for,
    `hidden_states`: the embeddings, then each layer's output."""

    last_hidden_state: torch.Tensor
    hidden_states: Optional[Tuple[torch.Tensor, ...]] = None


class Dinov2PatchEmbeddings(nn.Module):
    def __init__(self, config: Dinov2Config):
        super().__init__()
        p = config.patch_size
        self.num_patches = (config.image_size // p) ** 2
        self.projection = nn.Conv2d(3, config.hidden_size, p, stride=p)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            x = self.projection(pixel_values)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        return x.flatten(2).transpose(1, 2)


class Dinov2Embeddings(nn.Module):
    """Class token, patch embeddings and position embeddings; transformers'
    `Dinov2Embeddings.interpolate_pos_encoding` (no antialias)."""

    antialias = False

    def __init__(self, config: Dinov2Config):
        super().__init__()
        d = config.hidden_size
        self.config = config
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.mask_token = nn.Parameter(torch.zeros(1, d))
        self.patch_embeddings = Dinov2PatchEmbeddings(config)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, self.patch_embeddings.num_patches + 1, d))

    def interpolate_pos_encoding(self, embeddings: torch.Tensor, height: int,
                                 width: int) -> torch.Tensor:
        num_patches = embeddings.shape[1] - 1
        num_positions = self.position_embeddings.shape[1] - 1
        if num_patches == num_positions and height == width:
            return self.position_embeddings
        d = embeddings.shape[-1]
        side = int(num_positions**0.5)
        grid = self.position_embeddings[:, 1:].reshape(1, side, side, d).permute(0, 3, 1, 2)
        p = self.config.patch_size
        grid = F.interpolate(grid.float(), size=(height // p, width // p), mode="bicubic",
                             align_corners=False, antialias=self.antialias)
        grid = grid.to(self.position_embeddings.dtype).permute(0, 2, 3, 1).reshape(1, -1, d)
        return torch.cat([self.position_embeddings[:, :1], grid], dim=1)

    def tokens(self, pixel_values: torch.Tensor) -> torch.Tensor:
        b, _, height, width = pixel_values.shape
        x = self.patch_embeddings(
            pixel_values.to(self.patch_embeddings.projection.weight.dtype))
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        return x + self.interpolate_pos_encoding(x, height, width)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self.tokens(pixel_values)


class Dinov2WithRegistersEmbeddings(Dinov2Embeddings):
    """As `Dinov2Embeddings`, with transformers'
    `Dinov2WithRegistersEmbeddings` recipe (antialias) and the register
    tokens inserted after the class token, without a position embedding."""

    antialias = True

    def __init__(self, config: Dinov2Config):
        super().__init__(config)
        self.register_tokens = nn.Parameter(
            torch.zeros(1, config.num_register_tokens, config.hidden_size))

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = self.tokens(pixel_values)
        regs = self.register_tokens.expand(x.shape[0], -1, -1)
        return torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)


class Dinov2SelfAttention(nn.Module):
    def __init__(self, config: Dinov2Config):
        super().__init__()
        d = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = d // self.num_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape

        def heads(lin):
            return lin(x).view(b, t, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        logits = torch.matmul(q, k.transpose(-1, -2)) * self.head_dim**-0.5
        probs = torch.softmax(logits, dim=-1, dtype=torch.float32).to(q.dtype)
        return torch.matmul(probs, v).transpose(1, 2).reshape(b, t, d)


class Dinov2SelfOutput(nn.Module):
    def __init__(self, config: Dinov2Config):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)


class Dinov2Attention(nn.Module):
    def __init__(self, config: Dinov2Config):
        super().__init__()
        self.attention = Dinov2SelfAttention(config)
        self.output = Dinov2SelfOutput(config)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output(self.attention(x))


class Dinov2LayerScale(nn.Module):
    def __init__(self, config: Dinov2Config):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(config.hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.lambda1


class Dinov2MLP(nn.Module):
    def __init__(self, config: Dinov2Config):
        super().__init__()
        hidden = config.hidden_size * config.mlp_ratio
        self.fc1 = nn.Linear(config.hidden_size, hidden)
        self.fc2 = nn.Linear(hidden, config.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Dinov2SwiGLUFFN(nn.Module):
    def __init__(self, config: Dinov2Config):
        super().__init__()
        hidden = (int(config.hidden_size * config.mlp_ratio * 2 / 3) + 7) // 8 * 8
        self.weights_in = nn.Linear(config.hidden_size, 2 * hidden)
        self.weights_out = nn.Linear(hidden, config.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.weights_in(x).chunk(2, dim=-1)
        return self.weights_out(F.silu(x1) * x2)


class Dinov2Layer(nn.Module):
    """Pre-norm block: x + ls1 * attn(norm1(x)), then + ls2 * mlp(norm2(.))."""

    def __init__(self, config: Dinov2Config):
        super().__init__()
        d, eps = config.hidden_size, config.layer_norm_eps
        self.norm1 = nn.LayerNorm(d, eps=eps)
        self.attention = Dinov2Attention(config)
        self.layer_scale1 = Dinov2LayerScale(config)
        self.norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = Dinov2SwiGLUFFN(config) if config.use_swiglu_ffn else Dinov2MLP(config)
        self.layer_scale2 = Dinov2LayerScale(config)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_scale1(self.attention(self.norm1(x))) + x
        return self.layer_scale2(self.mlp(self.norm2(x))) + x


class Dinov2Encoder(nn.Module):
    def __init__(self, config: Dinov2Config):
        super().__init__()
        self.layer = nn.ModuleList(Dinov2Layer(config) for _ in range(config.num_hidden_layers))


class Dinov2Model(nn.Module):
    """DINOv2 without registers (transformers' `Dinov2Model`)."""

    embeddings_class = Dinov2Embeddings

    def __init__(self, config: Dinov2Config):
        super().__init__()
        self.config = config
        self.embeddings = self.embeddings_class(config)
        self.encoder = Dinov2Encoder(config)
        self.layernorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor,
                output_hidden_states: bool = False) -> Dinov2Output:
        """pixel_values [B, C, H, W] -> Dinov2Output."""
        x = self.embeddings(pixel_values)
        hidden = [x]
        for layer in self.encoder.layer:
            x = layer(x)
            hidden.append(x)
        out = self.layernorm(x)
        return Dinov2Output(out, tuple(hidden) if output_hidden_states else None)


class Dinov2WithRegistersModel(Dinov2Model):
    """DINOv2 with register tokens (transformers'
    `Dinov2WithRegistersModel`); tokens are [cls, registers, patches]."""

    embeddings_class = Dinov2WithRegistersEmbeddings


def load_hf_state_dict(model: Dinov2Model, state_dict) -> Dinov2Model:
    """Loads a state dict under transformers' names (e.g. `to_hf_state_dict`)
    into `model`: every key must be used and every parameter loaded but
    `embeddings.mask_token`, which inference never reads; else raises."""
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    if set(missing) - {"embeddings.mask_token"} or unexpected:
        raise ValueError(f"state dict does not fit: missing {missing}, unexpected {unexpected}")
    return model.eval()
