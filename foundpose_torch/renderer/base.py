"""Renderer interface: render types and abstract base (counterpart of
foundpose_tpu/renderer/base.py; cameras are the port's PinholeCamera).

Mirrors the reference's renderer layer contract
(reference: utils/renderer_base.py:32-120 and the reference's renderer factory)
with a software-rasterizer backend instead of pyrender/OpenGL.
"""

from __future__ import annotations

import abc
import enum
from typing import Dict, Optional

import numpy as np

from foundpose_torch.data.ply import Mesh
from foundpose_torch.structs import PinholeCamera


class RenderType(enum.Enum):
    COLOR = "color"
    DEPTH = "depth"
    MASK = "mask"
    NORMAL = "normal"


class RendererBase(abc.ABC):
    """Renders registered object models from arbitrary cameras."""

    @abc.abstractmethod
    def add_object_model(self, obj_id: int, mesh: Mesh) -> None:
        ...

    @abc.abstractmethod
    def render_object_model(
        self,
        obj_id: int,
        camera_model_c2w: PinholeCamera,
        render_types: Optional[list] = None,
        background: float = 0.0,
    ) -> Dict[RenderType, np.ndarray]:
        ...


class RendererType(enum.Enum):
    SOFTWARE_RASTERIZER = "software_rasterizer"


def build(renderer_type: RendererType = RendererType.SOFTWARE_RASTERIZER,
          **kwargs) -> RendererBase:
    """Renderer factory (the reference's renderer factory, :18-35)."""
    from foundpose_torch.renderer.rasterizer import SoftwareRasterizer

    if renderer_type == RendererType.SOFTWARE_RASTERIZER:
        return SoftwareRasterizer(**kwargs)
    raise ValueError(f"unknown renderer type: {renderer_type}")
