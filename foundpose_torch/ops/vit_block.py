"""One pre-norm ViT block (DINOv2, DINOv3): the hand-written CUDA kernel
(csrc/vit_block.cu) and its plain PyTorch twin.

Counterpart of foundpose_tpu/ops/vit_block.py, whose Pallas kernel runs
LN1 -> qkv -> per-head softmax attention -> proj -> layer-scaled residual ->
LN2 -> MLP -> layer-scaled residual for one image per grid step. The MLP is
fc1 -> GELU -> fc2, or for SwiGLU models (ViT-G) w12 -> silu(gate) * value
-> w3, where w12's rows [:H] are the gate and [H:] the value. The twin
computes the same function at the same rounding points:

- products take the inputs in the working dtype and accumulate in f32;
- log2(e)/sqrt(head_dim) is folded into q before q is cast to the working
  dtype, and the softmax runs in base 2;
- `rope` (DINOv3's axial RoPE; heads of 128): q and k of tokens at or past
  its `prefix` are rotated in f32 by the [T - prefix, 64] f32 tables,
  x1 cos - x2 sin and x2 cos + x1 sin over head columns c and c + 64, after
  the bias and before the q scale and the one cast to the working dtype;
- "capped" softmax: p = min(exp2(l), 1e30), no max reduction; "column":
  the per-query max is subtracted;
- the normalizer is the f32 sum of p rounded to the working dtype, floored
  at 1e-30 and applied as a multiply by its reciprocal;
- SwiGLU: gate and value leave the w12 product in f32, silu(gate) * value
  is formed in f32 and rounded to the working dtype once;
- proj and fc2 (w3) outputs are rounded to the working dtype before
  x + ls * y, which is evaluated in the working dtype.

At f32 this coincides with the JAX package's unfused block. Keys at or past
`seq_len` are masked out of the softmax; rows past it are computed but carry
no meaning. The CUDA kernel takes bf16 only, heads of 64 or 128, widths up
to 4,096, and `rope` at heads of 128.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from foundpose_torch import _kernels

_LOG2E = 1.4426950408889634
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_SQRT_HALF = math.sqrt(0.5)

_ATTN_KEYS = (
    "norm1_scale", "norm1_bias", "qkv_weight", "qkv_bias", "proj_weight",
    "proj_bias", "ls1", "norm2_scale", "norm2_bias",
)
# One layer's weights by MLP variant, in the kernel's argument order.
BLOCK_KEYS = {
    "gelu": (*_ATTN_KEYS, "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias", "ls2"),
    "swiglu": (*_ATTN_KEYS, "w12_weight", "w12_bias", "w3_weight", "w3_bias", "ls2"),
}


def is_swiglu(p: Dict[str, torch.Tensor]) -> bool:
    """Whether the layer weights `p` hold a SwiGLU MLP (w12/w3)."""
    return "w12_weight" in p


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


def swiglu(h: torch.Tensor) -> torch.Tensor:
    """silu(gate) * value over h = [..., 2H] (gate h[..., :H], value
    h[..., H:]), in h's dtype."""
    gate, value = h.chunk(2, dim=-1)
    return torch.nn.functional.silu(gate) * value


def _linear_f32(x, w, b):
    """x @ w.T + b with inputs in their dtype and f32 accumulation/output."""
    return x.float() @ w.float().t() + b.float()


Rope = Tuple[torch.Tensor, torch.Tensor, int]  # (cos, sin [T - prefix, hd / 2] f32, prefix)


def apply_rope(a: torch.Tensor, rope: Rope) -> torch.Tensor:
    """Heads a [B, T, H, hd] f32 with tokens [prefix, T) rotated:
    x1 cos - x2 sin and x2 cos + x1 sin over columns c and c + hd / 2 (the
    reference's x cos + rotate_half(x) sin, product for product)."""
    cos, sin, prefix = rope
    half = a.shape[-1] // 2
    x = a[:, prefix:]
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[None, :, None], sin[None, :, None]
    rotated = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([a[:, :prefix], rotated], dim=1)


def plain_qkv(xn: torch.Tensor, p: Dict[str, torch.Tensor], num_heads: int, head_dim: int,
              rope: Optional[Rope] = None):
    """The twin's qkv GEMM over xn [B, T, D]: q (softmax scale folded in),
    k and v heads [B, H, T, hd], f32 tensors holding xn's dtype, each cast
    once from the f32 product, q and k rotated by `rope` before it."""
    b, t, d = xn.shape
    dt = xn.dtype
    scale = head_dim ** -0.5 * _LOG2E
    qkv = _linear_f32(xn, p["qkv_weight"], p["qkv_bias"])  # [B, T, 3D] f32
    q_f32, k_f32 = qkv[..., :d], qkv[..., d : 2 * d]
    if rope is not None:
        q_f32, k_f32 = (apply_rope(a.reshape(b, t, num_heads, head_dim), rope).reshape(b, t, d)
                        for a in (q_f32, k_f32))

    def heads(a):
        return a.reshape(b, t, num_heads, head_dim).transpose(1, 2).float()

    return heads((q_f32 * scale).to(dt)), heads(k_f32.to(dt)), heads(qkv[..., 2 * d :].to(dt))


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_len: int,
                    softmax_stabilizer: str, dt: torch.dtype) -> torch.Tensor:
    """The twin's attention over `plain_qkv`'s heads (base-2 logits, keys
    past `seq_len` masked), p cast to `dt` before the value product:
    [B, T, D] in `dt`."""
    b, h, t, hd = q.shape
    logits = q @ k.transpose(-1, -2)  # [B, H, Tq, Tk], base-2 logits
    if seq_len < t:
        kmask = torch.zeros(t, device=q.device)
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
    return (o * (1.0 / s)).to(dt).transpose(1, 2).reshape(b, t, h * hd)


def fused_vit_block_plain(
    x: torch.Tensor,
    p: Dict[str, torch.Tensor],
    seq_len: Optional[int] = None,
    num_heads: int = 6,
    head_dim: int = 64,
    eps: float = 1e-6,
    approx_gelu: bool = False,
    softmax_stabilizer: str = "column",
    rope: Optional[Rope] = None,
) -> torch.Tensor:
    """Plain PyTorch block over x [B, T, D]; `p` holds one layer's weights
    (BLOCK_KEYS["gelu"] or ["swiglu"], nn.Linear layout) in x's dtype."""
    dt = x.dtype
    seq_len = x.shape[1] if seq_len is None else seq_len

    xn = layer_norm(x, p["norm1_scale"], p["norm1_bias"], eps)
    q, k, v = plain_qkv(xn, p, num_heads, head_dim, rope)
    attn = plain_attention(q, k, v, seq_len, softmax_stabilizer, dt)

    y = _linear_f32(attn, p["proj_weight"], p["proj_bias"]).to(dt)
    x = x + p["ls1"].to(dt) * y
    xn2 = layer_norm(x, p["norm2_scale"], p["norm2_bias"], eps)
    if is_swiglu(p):
        h1 = swiglu(_linear_f32(xn2, p["w12_weight"], p["w12_bias"])).to(dt)
        y2 = _linear_f32(h1, p["w3_weight"], p["w3_bias"]).to(dt)
    else:
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
    rope: Optional[Rope] = None,
) -> torch.Tensor:
    """One block over x [B, T, D]: the CUDA kernel for a CUDA tensor, the
    plain twin for a CPU tensor. `rope`: (cos, sin, prefix), the rotary
    tables [T - prefix, head_dim / 2] f32 of tokens [prefix, T)."""
    if x.device.type == "cpu":
        return fused_vit_block_plain(
            x, p, seq_len, num_heads, head_dim, eps, approx_gelu, softmax_stabilizer, rope
        )
    if softmax_stabilizer not in ("capped", "column"):
        raise ValueError(f"unknown softmax_stabilizer {softmax_stabilizer!r}")
    b, t, d = x.shape
    swi = is_swiglu(p)
    w1, w2 = ("w12", "w3") if swi else ("fc1", "fc2")
    hidden = p[f"{w2}_weight"].shape[1]
    seq_len = t if seq_len is None else seq_len
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fused_vit_block: the CUDA kernel takes bfloat16, got {x.dtype}")
    if head_dim not in (64, 128) or d != num_heads * head_dim or d > 4096 or hidden % 32:
        raise ValueError(
            f"fused_vit_block: unsupported shape d={d} heads={num_heads} "
            f"head_dim={head_dim} hidden={hidden}"
        )
    tables = ()
    if rope is not None:
        cos, sin, prefix = rope
        if head_dim != 128 or not 0 <= prefix < t:
            raise ValueError(f"fused_vit_block: rope takes heads of 128 and a prefix in "
                             f"[0, {t}), got head_dim={head_dim} prefix={prefix}")
        for name, a in (("cos", cos), ("sin", sin)):
            if a.dtype != torch.float32 or tuple(a.shape) != (t - prefix, head_dim // 2):
                raise ValueError(f"fused_vit_block: rope {name} must be float32 "
                                 f"{(t - prefix, head_dim // 2)}, got {a.dtype} "
                                 f"{tuple(a.shape)}")
        tables = (cos, sin)
    if not 1 <= seq_len <= t:
        raise ValueError(f"seq_len={seq_len} outside [1, {t}]")
    w1_rows = 2 * hidden if swi else hidden
    expected = {
        "qkv_weight": (3 * d, d), "qkv_bias": (3 * d,), "proj_weight": (d, d),
        f"{w1}_weight": (w1_rows, d), f"{w1}_bias": (w1_rows,), f"{w2}_weight": (d, hidden),
        f"{w2}_bias": (d,),
    }
    keys = BLOCK_KEYS["swiglu" if swi else "gelu"]
    w = [p[k] for k in keys]
    for k, shape in expected.items():
        if tuple(p[k].shape) != shape:
            raise ValueError(f"fused_vit_block: {k} has shape {tuple(p[k].shape)}, want {shape}")
    for k, a in zip(keys, w):
        if a.dtype != torch.bfloat16:
            raise ValueError(f"fused_vit_block: {k} must be bfloat16, got {a.dtype}")
    dev = _kernels.require_cuda("fused_vit_block", x, *w, *tables)
    if any(a.data_ptr() % 16 for a in (x, *w, *tables)):
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
        int(approx_gelu), int(softmax_stabilizer == "capped"), int(swi), head_dim,
        *((a.data_ptr() for a in tables) if tables else (None, None)), rope[2] if tables else 0,
        _kernels.stream_ptr(dev),
    )
    _kernels.check(rc, "fp_vit_block")
    fused_vit_block.launches += 1
    fused_vit_block.rope_launches += bool(tables)
    return out


fused_vit_block.launches = 0
# Of `launches`, those with rotary tables (the qkv GEMM's EPI_QKV_ROPE).
fused_vit_block.rope_launches = 0
