"""DINOv2 weights: official checkpoints, the JAX package's parameter tree
and the transformers naming (counterpart of foundpose_tpu/models/weights.py).

`DinoV2` carries the official state-dict names, so an official
`dinov2_<variant>[_reg4]_pretrain.pth` loads with `load_state_dict`
(`strict=False`: the checkpoint also holds `mask_token`, which feature
extraction does not use). The JAX package stores the same weights as a
numpy/jax tree with blocks stacked on axis 0, conv kernels in HWIO and
linear kernels as (in, out); `state_dict_from_jax_params` is the exact
inverse of the JAX package's `params_from_torch_state_dict`, and
`to_hf_state_dict` gives the same tree under the transformers
`Dinov2WithRegistersModel` names.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from foundpose_torch import models
from foundpose_torch.models.dinov2 import DinoV2, DinoV2Config


def load_checkpoint(path: str, cfg: DinoV2Config) -> DinoV2:
    """DinoV2 (eval mode, on the CPU) from an official-name `.pth` state
    dict, bare or under a "model" key. Every parameter of `cfg`'s model must
    be present; the checkpoint may also hold `mask_token`."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in state and isinstance(state["model"], dict):
        state = state["model"]
    model = DinoV2(cfg)
    missing, unexpected = model.load_state_dict(state, strict=False)
    unexpected = [k for k in unexpected if k != "mask_token"]
    if missing or unexpected:
        raise ValueError(
            f"checkpoint {path} does not fit {cfg.variant}: missing {missing}, "
            f"unexpected {unexpected}"
        )
    return model.eval()


def load_or_init(cfg, weights_path: Optional[str] = None, seed: int = 0) -> torch.nn.Module:
    """The ViT of `cfg`'s backbone family (eval mode, on the CPU) by the
    family's `load_or_init`: from its checkpoint at `weights_path`, or
    without one random weights from `seed`."""
    return models.backbone(cfg.family).load_or_init(cfg, weights_path, seed)


def module_from_jax_params(params_np: Dict[str, Any], cfg: DinoV2Config, device) -> DinoV2:
    """DinoV2 (eval mode) on `device` from a numpy tree in the JAX layout,
    converted and copied one block at a time: the f32 tree, a whole state
    dict and a module on the host would hold 3 x 4.5 GB at ViT-G."""
    import dataclasses

    with torch.device("meta"):
        model = DinoV2(cfg)
    model = model.to_empty(device=device).eval()
    one = dataclasses.replace(cfg, depth=1)
    head = {k: v for k, v in params_np.items() if k != "blocks"}
    loaded = set()
    with torch.no_grad():
        for i in range(cfg.depth):
            tree = dict(head, blocks={k: v[i : i + 1] for k, v in params_np["blocks"].items()})
            for k, v in state_dict_from_jax_params(tree, one).items():
                name = k.replace("blocks.0.", f"blocks.{i}.", 1)
                if name not in loaded:
                    model.get_parameter(name).copy_(v)
                    loaded.add(name)
    if loaded != set(model.state_dict()):
        raise RuntimeError(f"parameters left unloaded: {set(model.state_dict()) - loaded}")
    return model


def state_dict_from_jax_params(
    params_np: Dict[str, Any], cfg: DinoV2Config
) -> Dict[str, torch.Tensor]:
    """Official-layout state dict (f32 torch tensors) from the JAX param tree."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))

    sd = {
        # HWIO (P, P, 3, D) -> OIHW (D, 3, P, P).
        "patch_embed.proj.weight": t(np.asarray(params_np["patch_kernel"]).transpose(3, 2, 0, 1)),
        "patch_embed.proj.bias": t(params_np["patch_bias"]),
        "cls_token": t(params_np["cls_token"]),
        "pos_embed": t(params_np["pos_embed"]),
        "norm.weight": t(params_np["norm_scale"]),
        "norm.bias": t(params_np["norm_bias"]),
    }
    if cfg.num_register_tokens:
        sd["register_tokens"] = t(params_np["register_tokens"])
    blocks = {k: np.asarray(v) for k, v in params_np["blocks"].items()}
    mlp = ("w12", "w3") if cfg.swiglu else ("fc1", "fc2")
    linear = {"attn.qkv": "qkv", "attn.proj": "proj", **{f"mlp.{m}": m for m in mlp}}
    for i in range(cfg.depth):
        pre = f"blocks.{i}"
        sd[f"{pre}.norm1.weight"] = t(blocks["norm1_scale"][i])
        sd[f"{pre}.norm1.bias"] = t(blocks["norm1_bias"][i])
        sd[f"{pre}.norm2.weight"] = t(blocks["norm2_scale"][i])
        sd[f"{pre}.norm2.bias"] = t(blocks["norm2_bias"][i])
        sd[f"{pre}.ls1.gamma"] = t(blocks["ls1"][i])
        sd[f"{pre}.ls2.gamma"] = t(blocks["ls2"][i])
        for name, jax_name in linear.items():
            # (in, out) -> nn.Linear's (out, in).
            sd[f"{pre}.{name}.weight"] = t(blocks[f"{jax_name}_kernel"][i].T)
            sd[f"{pre}.{name}.bias"] = t(blocks[f"{jax_name}_bias"][i])
    return sd


def to_hf_state_dict(params_np: Dict[str, Any], cfg: DinoV2Config) -> Dict[str, torch.Tensor]:
    """The JAX param tree under the transformers `Dinov2WithRegistersModel`
    names (f32 torch tensors): q, k and v split out of qkv, layer scales as
    `lambda1`, and the SwiGLU MLP as `mlp.weights_in` / `mlp.weights_out`."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))

    sd = {
        "embeddings.cls_token": t(params_np["cls_token"]),
        "embeddings.position_embeddings": t(params_np["pos_embed"]),
        # HWIO (P, P, 3, D) -> OIHW (D, 3, P, P).
        "embeddings.patch_embeddings.projection.weight": t(
            np.asarray(params_np["patch_kernel"]).transpose(3, 2, 0, 1)),
        "embeddings.patch_embeddings.projection.bias": t(params_np["patch_bias"]),
        "layernorm.weight": t(params_np["norm_scale"]),
        "layernorm.bias": t(params_np["norm_bias"]),
    }
    if cfg.num_register_tokens:
        sd["embeddings.register_tokens"] = t(params_np["register_tokens"])
    d = cfg.embed_dim
    mlp = {"weights_in": "w12", "weights_out": "w3"} if cfg.swiglu else {"fc1": "fc1", "fc2": "fc2"}
    for i in range(cfg.depth):
        b = {k: np.asarray(v[i]) for k, v in params_np["blocks"].items()}
        pre = f"encoder.layer.{i}"
        qkv_w, qkv_b = b["qkv_kernel"].T, b["qkv_bias"]  # (3D, D): q, k, v rows
        sd[f"{pre}.norm1.weight"] = t(b["norm1_scale"])
        sd[f"{pre}.norm1.bias"] = t(b["norm1_bias"])
        for j, name in enumerate(("query", "key", "value")):
            sd[f"{pre}.attention.attention.{name}.weight"] = t(qkv_w[j * d : (j + 1) * d])
            sd[f"{pre}.attention.attention.{name}.bias"] = t(qkv_b[j * d : (j + 1) * d])
        sd[f"{pre}.attention.output.dense.weight"] = t(b["proj_kernel"].T)
        sd[f"{pre}.attention.output.dense.bias"] = t(b["proj_bias"])
        sd[f"{pre}.layer_scale1.lambda1"] = t(b["ls1"])
        sd[f"{pre}.norm2.weight"] = t(b["norm2_scale"])
        sd[f"{pre}.norm2.bias"] = t(b["norm2_bias"])
        sd[f"{pre}.layer_scale2.lambda1"] = t(b["ls2"])
        for hf_name, name in mlp.items():
            sd[f"{pre}.mlp.{hf_name}.weight"] = t(b[f"{name}_kernel"].T)
            sd[f"{pre}.mlp.{hf_name}.bias"] = t(b[f"{name}_bias"])
    return sd
