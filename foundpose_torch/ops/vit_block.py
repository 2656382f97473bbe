"""One pre-norm DINOv2 transformer block: the hand-written CUDA kernel
(csrc/vit_block.cu) and its plain PyTorch twin.

Counterpart of foundpose_tpu/ops/vit_block.py, whose Pallas kernel runs
LN1 -> qkv -> per-head softmax attention -> proj -> layer-scaled residual ->
LN2 -> fc1 -> GELU -> fc2 -> layer-scaled residual for one image per grid
step. The twin computes the same function at the same rounding points:

- products take the inputs in the working dtype and accumulate in f32;
- log2(e)/sqrt(head_dim) is folded into q before q is cast to the working
  dtype, and the softmax runs in base 2;
- "capped" softmax: p = min(exp2(l), 1e30), no max reduction; "column":
  the per-query max is subtracted;
- the normalizer is the f32 sum of p rounded to the working dtype, floored
  at 1e-30 and applied as a multiply by its reciprocal;
- proj and fc2 outputs are rounded to the working dtype before
  x + ls * y, which is evaluated in the working dtype.

At f32 this coincides with the JAX package's unfused block. Keys at or past
`seq_len` are masked out of the softmax; rows past it are computed but carry
no meaning. The CUDA kernel takes bf16 only; SwiGLU (ViT-G) is not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from foundpose_torch import _kernels

_LOG2E = 1.4426950408889634
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_SQRT_HALF = math.sqrt(0.5)

BLOCK_KEYS = (
    "norm1_scale", "norm1_bias", "qkv_weight", "qkv_bias", "proj_weight",
    "proj_bias", "ls1", "norm2_scale", "norm2_bias", "fc1_weight", "fc1_bias",
    "fc2_weight", "fc2_bias", "ls2",
)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with f32 statistics; output in x's dtype."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """jax.nn.gelu, term for term."""
    if approximate:
        cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
        return x * cdf
    return 0.5 * x * torch.special.erfc(-x * _SQRT_HALF)


def _linear_f32(x, w, b):
    """x @ w.T + b with inputs in their dtype and f32 accumulation/output."""
    return x.float() @ w.float().t() + b.float()


def fused_vit_block_plain(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    seq_len: Optional[int] = None,
    num_heads: int = 6,
    head_dim: int = 64,
    eps: float = 1e-6,
    approx_gelu: bool = False,
    softmax_stabilizer: str = "column",
) -> torch.Tensor:
    """Plain PyTorch block over x [B, T, D]; `p` holds one layer's weights
    (BLOCK_KEYS, nn.Linear layout) in x's dtype."""
    b, t, d = x.shape
    dt = x.dtype
    seq_len = t if seq_len is None else seq_len
    scale = head_dim ** -0.5 * _LOG2E

    xn = layer_norm(x, p["norm1_scale"], p["norm1_bias"], eps)
    qkv = _linear_f32(xn, p["qkv_weight"], p["qkv_bias"])  # [B, T, 3D] f32

    def heads(a):
        return a.reshape(b, t, num_heads, head_dim).transpose(1, 2).float()

    q = heads((qkv[..., :d] * scale).to(dt))
    k = heads(qkv[..., d : 2 * d].to(dt))
    v = heads(qkv[..., 2 * d :].to(dt))
    logits = q @ k.transpose(-1, -2)  # [B, H, Tq, Tk], base-2 logits
    if seq_len < t:
        kmask = torch.zeros(t, device=x.device)
        kmask[seq_len:] = -torch.inf
        logits = logits + kmask
    if softmax_stabilizer == "capped":
        probs = torch.clamp_max(torch.exp2(logits), 1e30)
    elif softmax_stabilizer == "column":
        probs = torch.exp2(logits - torch.amax(logits, dim=-1, keepdim=True))
    else:
        raise ValueError(f"unknown softmax_stabilizer {softmax_stabilizer!r}")
    pr = probs.to(dt).float()
    o = pr @ v
    s = torch.clamp_min(torch.sum(pr, dim=-1, keepdim=True), 1e-30)
    attn = (o * (1.0 / s)).to(dt).transpose(1, 2).reshape(b, t, d)

    y = _linear_f32(attn, p["proj_weight"], p["proj_bias"]).to(dt)
    x = x + p["ls1"].to(dt) * y
    xn2 = layer_norm(x, p["norm2_scale"], p["norm2_bias"], eps)
    h1 = gelu(_linear_f32(xn2, p["fc1_weight"], p["fc1_bias"]), approx_gelu).to(dt)
    y2 = _linear_f32(h1, p["fc2_weight"], p["fc2_bias"]).to(dt)
    return x + p["ls2"].to(dt) * y2


def fused_vit_block(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    seq_len: Optional[int] = None,
    num_heads: int = 6,
    head_dim: int = 64,
    eps: float = 1e-6,
    approx_gelu: bool = False,
    softmax_stabilizer: str = "column",
) -> torch.Tensor:
    """One block over x [B, T, D]: the CUDA kernel for a CUDA tensor, the
    plain twin for a CPU tensor."""
    if x.device.type == "cpu":
        return fused_vit_block_plain(
            x, p, seq_len, num_heads, head_dim, eps, approx_gelu, softmax_stabilizer
        )
    if softmax_stabilizer not in ("capped", "column"):
        raise ValueError(f"unknown softmax_stabilizer {softmax_stabilizer!r}")
    b, t, d = x.shape
    hidden = p["fc1_weight"].shape[0]
    seq_len = t if seq_len is None else seq_len
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_vit_block: the CUDA kernel takes bfloat16, got {x.dtype}")
    if head_dim != 64 or d != num_heads * head_dim or d % 32 or hidden % 32:
        raise ValueError(
            f"fused_vit_block: unsupported shape d={d} heads={num_heads} "
            f"head_dim={head_dim} hidden={hidden}"
        )
    if not 1 <= seq_len <= t:
        raise ValueError(f"seq_len={seq_len} outside [1, {t}]")
    expected = {
        "qkv_weight": (3 * d, d), "qkv_bias": (3 * d,), "proj_weight": (d, d),
        "fc1_weight": (hidden, d), "fc1_bias": (hidden,), "fc2_weight": (d, hidden),
    }
    w = [p[k] for k in BLOCK_KEYS]
    for k, shape in expected.items():
        if tuple(p[k].shape) != shape:
            raise ValueError(f"fused_vit_block: {k} has shape {tuple(p[k].shape)}, want {shape}")
    for k, a in zip(BLOCK_KEYS, w):
        if a.dtype != torch.bfloat16:
            raise ValueError(f"fused_vit_block: {k} must be bfloat16, got {a.dtype}")
    dev = _kernels.require_cuda("fused_vit_block", x, *w)
    if any(a.data_ptr() % 16 for a in (x, *w)):
        raise ValueError("fused_vit_block: inputs must be 16-byte aligned (TMA, 16-byte loads)")
    m = b * t
    out = torch.empty_like(x)
    xn = torch.empty(m, d, dtype=x.dtype, device=dev)
    qkv = torch.empty(m, 3 * d, dtype=x.dtype, device=dev)
    attn = torch.empty(m, d, dtype=x.dtype, device=dev)
    x1 = torch.empty(m, d, dtype=x.dtype, device=dev)
    h = torch.empty(m, hidden, dtype=x.dtype, device=dev)
    rc = _kernels.library().fp_vit_block(
        x.data_ptr(), out.data_ptr(), *(a.data_ptr() for a in w),
        xn.data_ptr(), qkv.data_ptr(), attn.data_ptr(), x1.data_ptr(), h.data_ptr(),
        b, t, seq_len, d, hidden, num_heads, eps, head_dim ** -0.5 * _LOG2E,
        int(approx_gelu), int(softmax_stabilizer == "capped"),
        _kernels.stream_ptr(dev),
    )
    _kernels.check(rc, "fp_vit_block")
    fused_vit_block.launches += 1
    return out


fused_vit_block.launches = 0
