"""Multi-head softmax attention: the hand-written CUDA kernel
(csrc/attention.cu) and its plain PyTorch twin.

Counterpart of foundpose_tpu/ops/attention.py, whose Pallas kernel
computes, for each (batch * head, query tile):

- f32 logits (k . q) * Dh^-0.5 from inputs in their own dtype;
- keys at or past `seq_len` masked to -inf, the per-query max subtracted,
  base-e exp, the f32 sum;
- weights p / sum cast to v's dtype, then weights . v accumulated in f32
  and cast to q's dtype.

The twin evaluates exactly that. The kernel takes f32 and bf16, head_dim
64, any T (no padding, nothing of length T kept resident):
- f32: SIMT FMA (no TF32), one pass with an online softmax, divided by the
  sum after the value product; in f32 the cast of p / sum is the identity,
  so this changes the rounding order only.
- bf16: tensor cores with f32 accumulation, two passes over K (max and sum,
  then weights and values), so the weights p / sum are cast to bf16 before
  the value product as the contract says.
Unlike ops/vit_block, the softmax runs in base e and, in bf16, the weights
are normalized before the value product.
"""

from __future__ import annotations

from typing import Optional

import torch

from foundpose_torch import _kernels


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_len: Optional[int] = None
) -> torch.Tensor:
    """Plain PyTorch attention over [..., T, Dh] inputs; keys at or past
    `seq_len` are masked out."""
    t, dh = k.shape[-2], q.shape[-1]
    seq_len = t if seq_len is None else seq_len
    logits = (q.float() @ k.float().transpose(-1, -2)) * dh ** -0.5
    if seq_len < t:
        kmask = torch.zeros(t, device=q.device)
        kmask[seq_len:] = -torch.inf
        logits = logits + kmask
    p = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    w = (p / torch.sum(p, dim=-1, keepdim=True)).to(v.dtype)
    return (w.float() @ v.float()).to(q.dtype)


def _attention_flat(q, k, v, seq_len):
    """q, k, v [BH, T, Dh] on the card -> [BH, T, Dh] through the kernel."""
    bh, t, dh = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention: the CUDA kernel takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("attention: q, k and v must share one dtype")
    if dh != 64:
        raise ValueError(f"attention: the CUDA kernel takes head_dim 64, got {dh}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention: shapes {q.shape} {k.shape} {v.shape} differ")
    if not 1 <= seq_len <= t:
        raise ValueError(f"seq_len={seq_len} outside [1, {t}]")
    dev = _kernels.require_cuda("attention", q, k, v)
    if any(a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError("attention: inputs must be 16-byte aligned")
    out = torch.empty_like(q)
    rc = _kernels.library().fp_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bh, t, seq_len, dh, int(q.dtype == torch.bfloat16), dh ** -0.5,
        _kernels.stream_ptr(dev),
    )
    _kernels.check(rc, "fp_attention")
    fused_attention_bhtd.launches += 1
    return out


def fused_attention_bhtd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_len: Optional[int] = None
) -> torch.Tensor:
    """Attention in head-major layout: [B, H, T, Dh] -> [B, H, T, Dh]. The
    CUDA kernel for CUDA tensors, the twin for CPU tensors."""
    b, h, t, dh = q.shape
    seq_len = t if seq_len is None else seq_len
    if q.device.type == "cpu":
        return attention_plain(q, k, v, seq_len)
    flat = [a.reshape(b * h, t, dh) for a in (q, k, v)]
    return _attention_flat(*flat, seq_len).reshape(b, h, t, dh)


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seq_len: Optional[int] = None
) -> torch.Tensor:
    """Attention over [B, T, H, Dh] -> [B, T, H, Dh] (pays two layout
    transposes; prefer fused_attention_bhtd)."""
    def bhtd(a):
        return a.transpose(1, 2).contiguous()

    return fused_attention_bhtd(bhtd(q), bhtd(k), bhtd(v), seq_len).transpose(1, 2)


fused_attention_bhtd.launches = 0
