"""Deterministic "realistic-statistics" ViT weights (counterpart of
foundpose_tpu/models/bench_weights.py).

No pretrained DINOv2 checkpoint ships with the repository, and plain random
init gives attention logits far smaller than pretrained DINOv2 shows (about
+-30). The "capped" softmax and bf16 compute are only exercised honestly at
those scales, so this module builds a reproducible weight set with them:

1. random init from a seeded torch.Generator (truncated normal, std 0.02,
   as the JAX package's init_params);
2. layer scale set to a trained-model magnitude (0.1 by default);
3. a numpy forward over a fixed probe batch, block by block, that rescales
   each layer's q/k projection so its max |attention logit| equals the
   target (30 by default).

The weights are random-derived: they pin the numerical regime, not
accuracy. Step 3 is the JAX module's numpy calibration, copied.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from foundpose_torch.models import dinov2


def init_params(cfg: dinov2.DinoV2Config, generator: torch.Generator) -> Dict[str, Any]:
    """Random parameter tree in the JAX layout (numpy, blocks stacked)."""
    d, h = cfg.embed_dim, cfg.mlp_hidden

    def trunc(*shape):
        t = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)
        return t.numpy()

    def const(shape, v):
        return np.full(shape, v, np.float32)

    depth = cfg.depth
    blocks = {
        "norm1_scale": const((depth, d), 1.0), "norm1_bias": const((depth, d), 0.0),
        "qkv_kernel": np.stack([trunc(d, 3 * d) for _ in range(depth)]),
        "qkv_bias": const((depth, 3 * d), 0.0),
        "proj_kernel": np.stack([trunc(d, d) for _ in range(depth)]),
        "proj_bias": const((depth, d), 0.0),
        "ls1": const((depth, d), 1e-5),
        "norm2_scale": const((depth, d), 1.0), "norm2_bias": const((depth, d), 0.0),
        "ls2": const((depth, d), 1e-5),
    }
    if cfg.swiglu:  # w12: gate columns [:h], value columns [h:]
        blocks.update(
            w12_kernel=np.stack([trunc(d, 2 * h) for _ in range(depth)]),
            w12_bias=const((depth, 2 * h), 0.0),
            w3_kernel=np.stack([trunc(h, d) for _ in range(depth)]),
            w3_bias=const((depth, d), 0.0),
        )
    else:
        blocks.update(
            fc1_kernel=np.stack([trunc(d, h) for _ in range(depth)]),
            fc1_bias=const((depth, h), 0.0),
            fc2_kernel=np.stack([trunc(h, d) for _ in range(depth)]),
            fc2_bias=const((depth, d), 0.0),
        )
    params = {
        "patch_kernel": trunc(cfg.patch_size, cfg.patch_size, 3, d),
        "patch_bias": const((d,), 0.0),
        "cls_token": trunc(1, 1, d),
        "pos_embed": trunc(1, 1 + cfg.pos_grid**2, d),
        "blocks": blocks,
        "norm_scale": const((d,), 1.0),
        "norm_bias": const((d,), 0.0),
    }
    if cfg.num_register_tokens:
        params["register_tokens"] = trunc(1, cfg.num_register_tokens, d)
    return params


def _np_layer_norm(x, scale, bias, eps):
    mean = x.mean(axis=-1, keepdims=True)
    var = ((x - mean) ** 2).mean(axis=-1, keepdims=True)
    return (x - mean) / np.sqrt(var + eps) * scale + bias


def _np_gelu(x: np.ndarray) -> np.ndarray:
    return 0.5 * x * (1.0 + torch.erf(torch.from_numpy(x / math.sqrt(2.0))).numpy())


def _np_embed(params, cfg: dinov2.DinoV2Config, images: np.ndarray) -> np.ndarray:
    """Numpy replica of dinov2.embed_tokens for stride == patch_size."""
    if cfg.stride != cfg.patch_size:
        raise NotImplementedError("probe embedding assumes stride == patch")
    mean = np.asarray(dinov2.IMAGENET_MEAN, np.float32)
    std = np.asarray(dinov2.IMAGENET_STD, np.float32)
    x = (images.astype(np.float32) - mean) / std
    b, ih, iw, _ = x.shape
    p, d = cfg.patch_size, cfg.embed_dim
    gh, gw = ih // p, iw // p
    x = x[:, : gh * p, : gw * p]
    x = (
        x.reshape(b, gh, p, gw, p, 3)
        .transpose(0, 1, 3, 2, 4, 5)
        .reshape(b, gh * gw, p * p * 3)
    )
    x = x @ params["patch_kernel"].reshape(p * p * 3, d) + params["patch_bias"]
    cls = np.broadcast_to(params["cls_token"], (b, 1, d))
    x = np.concatenate([cls, x], axis=1)
    pos = params["pos_embed"]
    if (gh, gw) != (cfg.pos_grid, cfg.pos_grid):
        g = cfg.pos_grid
        mh = dinov2._torch_bicubic_matrix(g, gh, (gh + 0.1) / g)
        mw = dinov2._torch_bicubic_matrix(g, gw, (gw + 0.1) / g)
        grid = pos[:, 1:].reshape(g, g, d)
        grid = np.einsum("oi,ijd->ojd", mh, grid)
        grid = np.einsum("pj,ojd->opd", mw, grid)
        pos = np.concatenate([pos[:, :1], grid.reshape(1, gh * gw, d)], axis=1)
    x = x + pos
    if cfg.num_register_tokens:
        regs = np.broadcast_to(params["register_tokens"], (b, cfg.num_register_tokens, d))
        x = np.concatenate([x[:, :1], regs, x[:, 1:]], axis=1)
    return x.astype(np.float32)


def _np_blocks_pass(
    params, cfg: dinov2.DinoV2Config, images: np.ndarray, target_logit: Optional[float]
) -> Tuple[np.ndarray, np.ndarray]:
    """Runs blocks [0, cfg.layer] of a numpy param tree on `images`; with
    `target_logit`, rescales each layer's q/k slices in place so that
    layer's max |logit| equals it. Returns (per-layer max |logit| after any
    rescale, per-layer logit scale applied)."""
    d, nh, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    eps = cfg.layer_norm_eps
    blocks = params["blocks"]
    x = _np_embed(params, cfg, images)
    maxima = np.ones(cfg.layer + 1, np.float32)
    scales = np.ones(cfg.layer + 1, np.float32)
    for i in range(cfg.layer + 1):
        xn = _np_layer_norm(x, blocks["norm1_scale"][i], blocks["norm1_bias"][i], eps)
        qkv = xn @ blocks["qkv_kernel"][i] + blocks["qkv_bias"][i]
        b, t, _ = qkv.shape
        q, k, v = [a.reshape(b, t, nh, hd) for a in np.split(qkv, 3, axis=-1)]
        logits = np.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
        cur = float(np.abs(logits).max())
        if target_logit is not None and cur > 0.0:
            s = target_logit / cur
            r = math.sqrt(s)
            blocks["qkv_kernel"][i][:, : 2 * d] *= r
            blocks["qkv_bias"][i][: 2 * d] *= r
            logits *= s
            cur = target_logit
            scales[i] = s
        maxima[i] = cur
        p_att = np.exp(logits - logits.max(axis=-1, keepdims=True))
        p_att /= p_att.sum(axis=-1, keepdims=True)
        out = np.einsum("bhts,bshd->bthd", p_att, v).reshape(b, t, d)
        out = out @ blocks["proj_kernel"][i] + blocks["proj_bias"][i]
        x = x + blocks["ls1"][i] * out
        xn = _np_layer_norm(x, blocks["norm2_scale"][i], blocks["norm2_bias"][i], eps)
        if cfg.swiglu:
            x12 = xn @ blocks["w12_kernel"][i] + blocks["w12_bias"][i]
            x1, x2 = np.split(x12, 2, axis=-1)
            h = (x1 / (1.0 + np.exp(-x1))) * x2
            mlp = h @ blocks["w3_kernel"][i] + blocks["w3_bias"][i]
        else:
            h = _np_gelu(xn @ blocks["fc1_kernel"][i] + blocks["fc1_bias"][i])
            mlp = h @ blocks["fc2_kernel"][i] + blocks["fc2_bias"][i]
        x = x + blocks["ls2"][i] * mlp
    return maxima, scales


def _probe_images(probe_size: int, probe_batch: int) -> np.ndarray:
    """Fixed probe batch of uniform [0, 1) RGB, the inputs' statistics."""
    rng = np.random.default_rng(20260819)
    return rng.uniform(size=(probe_batch, probe_size, probe_size, 3)).astype(np.float32)


def attention_logit_maxima(
    params, cfg: dinov2.DinoV2Config, probe_size: int = 154, probe_batch: int = 2
) -> np.ndarray:
    """Max |pre-softmax attention logit| per layer (blocks 0..cfg.layer) of
    a numpy param tree on the probe batch."""
    tree = {k: v for k, v in params.items() if k != "blocks"}
    tree["blocks"] = {k: np.array(v) for k, v in params["blocks"].items()}
    maxima, _ = _np_blocks_pass(tree, cfg, _probe_images(probe_size, probe_batch), None)
    return maxima


@torch.no_grad()
def model_logit_maxima(model: dinov2.DinoV2, images: torch.Tensor) -> torch.Tensor:
    """attention_logit_maxima of a DinoV2 module on `images` (NHWC in [0,
    1]) in f32 on the module's device: max |pre-softmax attention logit|
    of blocks 0..cfg.layer, the unfused f32 block carrying the tokens from
    block to block. Returns a [layer + 1] tensor on that device."""
    import dataclasses

    from foundpose_torch.ops.vit_block import layer_norm

    cfg = dataclasses.replace(model.cfg, use_fused_block=False)
    x, _ = dinov2.embed_tokens(model, dinov2.normalize_images(images))
    b, t, _ = x.shape
    maxima = []
    for blk in list(model.blocks)[: cfg.layer + 1]:
        p = blk.kernel_params(torch.float32)
        xn = layer_norm(x, p["norm1_scale"], p["norm1_bias"], cfg.layer_norm_eps)
        qkv = torch.nn.functional.linear(xn, p["qkv_weight"], p["qkv_bias"])
        q, k, _ = qkv.reshape(b, t, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
        maxima.append((q @ k.transpose(-1, -2)).abs().amax() / cfg.head_dim**0.5)
        x = dinov2.unfused_block(x, p, cfg)
    return torch.stack(maxima)


def realistic_params(
    seed: int,
    cfg: dinov2.DinoV2Config,
    target_logit: float = 30.0,
    layerscale: float = 0.1,
    probe_size: int = 154,
    probe_batch: int = 2,
) -> Dict[str, Any]:
    """init + logit/residual calibration; a numpy tree in the JAX layout,
    the same for the same arguments."""
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    ls = np.full((cfg.depth, cfg.embed_dim), layerscale, np.float32)
    params["blocks"]["ls1"] = ls
    params["blocks"]["ls2"] = ls.copy()
    images = _probe_images(probe_size, probe_batch)
    maxima, _ = _np_blocks_pass(params, cfg, images, target_logit)
    if not np.allclose(maxima, target_logit, rtol=1e-4):
        raise RuntimeError(f"logit calibration failed: {maxima}")
    return params
