"""DINOv2 weights made on the device from the seed, at a trained model's scale.

No checkpoint ships, and plain random weights give attention logits far
below pretrained DINOv2's (about +-30), where the capped softmax and bf16
would be exercised too gently. So, as the program's own calibrated bench
weights do: truncated-normal init (std 0.02, cut at +-0.04), layer scale
0.1, then block by block over a fixed probe batch (2 images of 154 px) each
layer's q and k rows scaled so that its largest |attention logit| is 30.
Everything is drawn by one torch.Generator on the device, each stacked
tensor in one call, and calibrated there in float32 with TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from perfbench.reference import vit
from perfbench.reference.precision import Precision, exact_f32

TARGET_LOGIT = 30.0
LAYER_SCALE = 0.1
PROBE_PX, PROBE_BATCH = 154, 2


def _trunc(gen, *shape, device):
    t = torch.empty(shape, device=device)
    torch.nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=gen)
    return t


def init(s: vit.VitShape, gen: torch.Generator, device) -> Dict[str, Dict[str, torch.Tensor]]:
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
    q, k, _ = vit.qkv(x, w, s, prec)
    return float((q @ k.transpose(-1, -2)).abs().amax()) / math.sqrt(s.head_dim)


@torch.no_grad()
def calibrate(weights, s: vit.VitShape, gen: torch.Generator) -> list:
    """Scales each layer's q and k rows of blocks [0, layer] in place so
    that its largest |attention logit| on the probe batch is TARGET_LOGIT.
    Returns the per-layer maxima after scaling."""
    blocks, d = weights["blocks"], s.embed_dim
    device = blocks["attn.qkv.weight"].device
    prec = Precision()
    probe = torch.rand(PROBE_BATCH, PROBE_PX, PROBE_PX, 3, generator=gen, device=device)
    maxima = []
    with exact_f32():
        x, _ = vit.embed(weights["top"], s, probe, prec)
        for i in range(s.layer + 1):
            w = vit.block_weights(blocks, i)
            r = math.sqrt(TARGET_LOGIT / _logit_max(x, w, s, prec))
            blocks["attn.qkv.weight"][i, : 2 * d] *= r
            blocks["attn.qkv.bias"][i, : 2 * d] *= r
            maxima.append(_logit_max(x, w, s, prec))
            x = vit.block(x, w, s, prec)
    if any(abs(m / TARGET_LOGIT - 1.0) > 1e-4 for m in maxima):
        raise RuntimeError(f"logit calibration failed: {maxima}")
    return maxima


def make(s: vit.VitShape, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Calibrated weights of shape `s` from `seed`, on `device`."""
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
