"""Core data structures (counterpart of foundpose_tpu/structs.py)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PinholeCamera:
    """Pinhole camera with (fx, fy) focal, principal point and extrinsics.

    `T_world_from_eye` maps eye (camera) coordinates to world coordinates.
    Tensor fields may carry leading batch dimensions (one camera per crop or
    per template).
    """

    f: torch.Tensor  # [..., 2]
    c: torch.Tensor  # [..., 2]
    T_world_from_eye: torch.Tensor  # [..., 4, 4]
    width: int = 0
    height: int = 0

    def to(self, device) -> "PinholeCamera":
        return dataclasses.replace(
            self,
            f=self.f.to(device),
            c=self.c.to(device),
            T_world_from_eye=self.T_world_from_eye.to(device),
        )
