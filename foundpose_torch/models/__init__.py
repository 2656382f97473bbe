"""models layer of foundpose_torch: the ViT backbones, found by family.

A model name's family is its first `_`-separated field: "dinov2" for
"dinov2_version=vits14-reg_stride=14_facet=token_layer=9_norm=1", "dinov3"
for "dinov3_version=vit7b16_stride=16_facet=token_layer=30_norm=1".
`backbone(name)` gives the family's module, which defines
`parse_model_name` (the name to its config, whose class attribute `family`
names the family again), `Model` (the nn.Module class built from that
config), `load_or_init` (config, checkpoint path or None, seed -> the
module), `extract_facet` (model, images NHWC -> {"cls_tokens",
"feature_maps"}) and `normalize_images`; `backbone_of(model)` gives it by
the model's config. Every caller that builds, loads or runs a ViT goes
through one of the two.
"""

from __future__ import annotations

import importlib
from types import ModuleType

FAMILIES = ("dinov2", "dinov3")


def backbone(name: str) -> ModuleType:
    """The backbone family module of a model name (or of a bare family name)."""
    family = name.split("_")[0]
    if family not in FAMILIES:
        raise ValueError(f"unknown backbone family {family!r} in {name!r}; known: {FAMILIES}")
    return importlib.import_module(f"foundpose_torch.models.{family}")


def backbone_of(model) -> ModuleType:
    """The backbone family module of a built model, by its config's
    `family`. A module with no `cfg` is run as the step ran every ViT
    before there were families, through `dinov2.extract_facet` (where a
    caller may have put its own)."""
    cfg = getattr(model, "cfg", None)
    return backbone("dinov2" if cfg is None else cfg.family)
