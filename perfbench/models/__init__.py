"""Backbone families: everything that depends on the ViT, found by name.

A configuration's family is the first `_`-separated field of its
`infer_opts.extractor_name` (`dinov2` for `dinov2_version=vits14-reg_...`).
`perfbench/models/<family>.py` reads the configuration, makes the weights
from the seed, builds the program's module on them and counts the ViT's
operations and bytes; `perfbench/reference/<family>.py` is the plain
reference whose `feature_maps` the check runs. README.md, "Adding a
backbone family", gives the interface.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any, Dict


def name(opts: Dict[str, Any]) -> str:
    """The family of a configuration's `infer_opts`."""
    return opts["extractor_name"].split("_")[0]


def _load(package: str, family_name: str) -> ModuleType:
    if not family_name.isidentifier():
        raise ValueError(f"no backbone family {family_name!r}")
    return importlib.import_module(f"perfbench.{package}.{family_name}")


def family(family_name: str) -> ModuleType:
    """perfbench/models/<family>.py."""
    return _load("models", family_name)


def reference(family_name: str) -> ModuleType:
    """perfbench/reference/<family>.py."""
    return _load("reference", family_name)
