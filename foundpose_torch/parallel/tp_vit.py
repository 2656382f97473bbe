"""Tensor-parallel DINOv2 forward: attention heads and MLP hidden units split
over the `model` mesh axis (counterpart of foundpose_tpu/parallel/tp_vit.py).

The standard Megatron split, on torch.distributed:

- the qkv projection split on the head axis: each rank computes attention
  for its nh/n heads (ops/attention, the CUDA kernel on the card);
- the output projection split on its input (head) axis: each rank makes a
  partial [B, T, D] sum, combined by ONE `_psum` per layer;
- MLP fc1 split on the hidden axis, fc2 on its input axis: a second `_psum`.

Two psums of [B, T, D] a layer is the least collective traffic of this
split; LayerNorm, layer scale and the residuals are local, and the bias of
each psum'd product is added once, after the sum. The partial products are
formed and summed in f32 and rounded to the compute dtype once, as the
unsplit product rounds its f32 accumulator once. The fused block kernel
computes a whole layer in one launch, so the two mid-layer psums cannot be
placed inside it: the TP path runs the unfused block math, as the JAX
package's does. Activations stay replicated over `model`, so crops can also
be split over `data` in the same mesh.

SwiGLU blocks (ViT-G) are not ported (models/dinov2.Block raises).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.nn.functional as F

from foundpose_torch.models import dinov2
from foundpose_torch.models.dinov2 import DinoV2, DinoV2Config
from foundpose_torch.ops.attention import fused_attention_bhtd
from foundpose_torch.ops.vit_block import gelu, layer_norm
from foundpose_torch.parallel import mesh as mesh_mod
from foundpose_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

_FACETS = {"query": 0, "key": 1, "value": 2}


def validate_tp(cfg: DinoV2Config, n_model: int) -> None:
    """The model axis must divide both the head count and the MLP width."""
    if cfg.swiglu:
        raise NotImplementedError("SwiGLU (ViT-G) blocks are not ported")
    if cfg.num_heads % n_model:
        raise ValueError(f"model axis {n_model} does not divide num_heads={cfg.num_heads}")
    if cfg.mlp_hidden % n_model:
        raise ValueError(f"model axis {n_model} does not divide mlp_hidden={cfg.mlp_hidden}")


@dataclasses.dataclass
class TPParams:
    """One rank's share of a DinoV2: `model` for the replicated parameters
    (patch embedding, tokens, position embedding, final norm) and, per
    layer, the block weights (Block.kernel_params names, f32) with qkv,
    proj, fc1 and fc2 cut to this rank's heads and hidden units."""

    model: DinoV2
    blocks: List[Dict[str, torch.Tensor]]
    index: int
    count: int

    @property
    def cfg(self) -> DinoV2Config:
        return self.model.cfg


def prepare_tp_params(model: DinoV2, n_model: int, index: int) -> TPParams:
    """Shard `index` of `n_model` of the model's block weights (the
    counterpart of prepare_tp_params + the _BLOCK_SPECS placement):

      qkv.weight [3D, D] rows as (3, nh, hd, D), sliced on nh; its bias too
      proj.weight [D, D] columns as (D, nh, hd), sliced on nh
      fc1 rows and bias, fc2 columns: sliced on the hidden axis
    """
    cfg = model.cfg
    validate_tp(cfg, n_model)
    nh, hd, d = cfg.num_heads, cfg.head_dim, cfg.embed_dim
    nl, hl = nh // n_model, cfg.mlp_hidden // n_model
    heads = slice(index * nl, (index + 1) * nl)
    hidden = slice(index * hl, (index + 1) * hl)
    blocks = []
    for blk in model.blocks:
        p = blk.kernel_params(torch.float32)
        p["qkv_weight"] = p["qkv_weight"].reshape(3, nh, hd, d)[:, heads].reshape(3 * nl * hd, d)
        p["qkv_bias"] = p["qkv_bias"].reshape(3, nh, hd)[:, heads].reshape(3 * nl * hd)
        p["proj_weight"] = p["proj_weight"].reshape(d, nh, hd)[:, heads].reshape(d, nl * hd)
        p["fc1_weight"] = p["fc1_weight"][hidden]
        p["fc1_bias"] = p["fc1_bias"][hidden]
        p["fc2_weight"] = p["fc2_weight"][:, hidden]
        blocks.append({k: v.contiguous() for k, v in p.items()})
    return TPParams(model=model, blocks=blocks, index=index, count=n_model)


def _reduce(partial: torch.Tensor, bias: torch.Tensor, mesh, dtype) -> torch.Tensor:
    """psum of an f32 partial product over `model`, its bias added once."""
    return (mesh_mod._psum(partial, mesh, MODEL_AXIS) + bias.float()).to(dtype)


def _tp_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: DinoV2Config, mesh):
    """One block over this rank's heads and hidden units: exactly two
    _psums of [B, T, D]."""
    b, t, _ = x.shape
    hd, eps = cfg.head_dim, cfg.layer_norm_eps
    nl = p["qkv_weight"].shape[0] // (3 * hd)
    xn = layer_norm(x, p["norm1_scale"], p["norm1_bias"], eps)
    qkv = F.linear(xn, p["qkv_weight"], p["qkv_bias"])
    qkv = qkv.reshape(b, t, 3, nl, hd).permute(2, 0, 3, 1, 4).contiguous()
    attn = fused_attention_bhtd(qkv[0], qkv[1], qkv[2]).transpose(1, 2).reshape(b, t, nl * hd)
    a = _reduce(F.linear(attn.float(), p["proj_weight"].float()), p["proj_bias"], mesh, x.dtype)
    x = x + p["ls1"] * a
    xn = layer_norm(x, p["norm2_scale"], p["norm2_bias"], eps)
    h = gelu(F.linear(xn, p["fc1_weight"], p["fc1_bias"]), cfg.approx_gelu)
    m = _reduce(F.linear(h.float(), p["fc2_weight"].float()), p["fc2_bias"], mesh, x.dtype)
    return x + p["ls2"] * m


def _cast(p: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    return {k: v.to(dtype) for k, v in p.items()}


def tp_extract_local(params: TPParams, images: torch.Tensor, mesh) -> Dict[str, torch.Tensor]:
    """This rank's crops (normalized, in the compute dtype) through the TP
    blocks: dinov2.extract_facet's facets and norm. The query/key/value
    facets gather every rank's heads over `model` and flatten head-minor."""
    cfg = params.cfg
    x, grid = dinov2.embed_tokens(params.model, images)
    upto = cfg.layer + 1 if cfg.facet == "token" else cfg.layer
    for p in params.blocks[:upto]:
        x = _tp_block(x, _cast(p, x.dtype), cfg, mesh)
    if cfg.facet == "token":
        feats = x
    elif cfg.facet in _FACETS:
        p = _cast(params.blocks[cfg.layer], x.dtype)
        b, t, d = x.shape
        nl = p["qkv_weight"].shape[0] // (3 * cfg.head_dim)
        xn = layer_norm(x, p["norm1_scale"], p["norm1_bias"], cfg.layer_norm_eps)
        i = _FACETS[cfg.facet]
        w = p["qkv_weight"].reshape(3, nl * cfg.head_dim, d)[i]
        bias = p["qkv_bias"].reshape(3, nl * cfg.head_dim)[i]
        sel = F.linear(xn, w, bias).reshape(b, t, nl, cfg.head_dim)
        sel = mesh_mod._all_gather(sel, mesh, MODEL_AXIS)  # [n, B, T, nl, hd], rank order
        feats = dinov2.head_minor(sel.permute(1, 2, 0, 3, 4).reshape(b, t, -1, cfg.head_dim))
    else:
        raise ValueError(f"unsupported facet: {cfg.facet}")
    return dinov2.facet_outputs(params.model, feats, grid)


def make_tp_extractor(mesh, cfg: DinoV2Config):
    """Returns extract(params_tp, images_nhwc, compute_dtype=torch.float32)
    -> the facet dict of the whole batch on every rank: each rank runs its
    `data` rows (all rows without a data axis) through the TP blocks, and
    the rows are gathered over `data`. params_tp from prepare_tp_params
    with this rank's `model` coordinate."""
    validate_tp(cfg, mesh_mod.axis_size(mesh, MODEL_AXIS))

    def extract(params_tp: TPParams, images_nhwc: torch.Tensor, compute_dtype=torch.float32):
        rows = mesh_mod.data_slice(mesh, images_nhwc.shape[0])
        images = dinov2.normalize_images(images_nhwc[rows]).to(compute_dtype)
        out = tp_extract_local(params_tp, images, mesh)
        return {k: mesh_mod._all_gather(v, mesh, DATA_AXIS).flatten(0, 1) for k, v in out.items()}

    return extract
