"""Core data structures (counterpart of foundpose_tpu/structs.py)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from foundpose_torch import geometry


def to_device(a, device) -> torch.Tensor:
    """A host array, tensor or nested list on `device`. On the card the copy
    goes through pinned memory with non_blocking=True, so it neither waits
    for the queued device work nor blocks the host (a copy from pageable
    memory synchronizes)."""
    t = torch.as_tensor(a)
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass
class PinholeCamera:
    """Pinhole camera with (fx, fy) focal, principal point and extrinsics.

    `T_world_from_eye` maps eye (camera) coordinates to world coordinates.
    Tensor fields may carry leading batch dimensions (one camera per crop or
    per template). The projection methods broadcast the camera's batch
    dimensions against the points' leading dimensions, so a batch of cameras
    [B] maps points [B, H, W, 3] after `expand_pixels(2)`.
    """

    f: torch.Tensor  # [..., 2]
    c: torch.Tensor  # [..., 2]
    T_world_from_eye: torch.Tensor  # [..., 4, 4]
    width: int = 0
    height: int = 0

    @classmethod
    def from_intrinsic_matrix(
        cls, K, width: int, height: int,
        T_world_from_eye: Optional[torch.Tensor] = None, dtype=torch.float32,
    ) -> "PinholeCamera":
        """Camera from a [..., 3, 3] intrinsic matrix; identity extrinsics
        unless given ([..., 3|4, 4])."""
        K = torch.as_tensor(K, dtype=dtype)
        if T_world_from_eye is None:
            T = torch.eye(4, dtype=dtype, device=K.device).expand(*K.shape[:-2], 4, 4)
        else:
            T = torch.as_tensor(T_world_from_eye, dtype=dtype, device=K.device)
            if T.shape[-2:] == (3, 4):
                T = geometry.as_4x4_rt(T[..., :3, :3], T[..., :3, 3])
        return cls(
            f=torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1),
            c=torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1),
            T_world_from_eye=T.contiguous(), width=int(width), height=int(height),
        )

    @property
    def K(self) -> torch.Tensor:
        """[..., 3, 3] intrinsic matrix."""
        fx, fy = self.f[..., 0], self.f[..., 1]
        cx, cy = self.c[..., 0], self.c[..., 1]
        zero = torch.zeros_like(fx)
        one = torch.ones_like(fx)
        return torch.stack(
            [
                torch.stack([fx, zero, cx], dim=-1),
                torch.stack([zero, fy, cy], dim=-1),
                torch.stack([zero, zero, one], dim=-1),
            ],
            dim=-2,
        )

    # ---- batching -----------------------------------------------------------

    def to(self, device) -> "PinholeCamera":
        return dataclasses.replace(
            self,
            f=self.f.to(device),
            c=self.c.to(device),
            T_world_from_eye=self.T_world_from_eye.to(device),
        )

    def broadcast(self, n: int) -> "PinholeCamera":
        """One camera repeated over a new leading batch of n."""
        return dataclasses.replace(
            self,
            f=self.f.expand(n, 2),
            c=self.c.expand(n, 2),
            T_world_from_eye=self.T_world_from_eye.expand(n, 4, 4),
        )

    def index(self, idx) -> "PinholeCamera":
        """The camera(s) at `idx` of the leading batch axis."""
        return dataclasses.replace(
            self, f=self.f[idx], c=self.c[idx], T_world_from_eye=self.T_world_from_eye[idx]
        )

    def expand_pixels(self, n: int) -> "PinholeCamera":
        """A view with n singleton axes after the batch axes, so the camera
        broadcasts against points laid out [..., H, W, 3] for n = 2."""
        def grow(a, tail):
            return a.reshape(*a.shape[: a.dim() - tail], *([1] * n), *a.shape[a.dim() - tail :])

        return dataclasses.replace(
            self, f=grow(self.f, 1), c=grow(self.c, 1),
            T_world_from_eye=grow(self.T_world_from_eye, 2),
        )

    # ---- projections ------------------------------------------------------

    def eye_to_window(self, v: torch.Tensor) -> torch.Tensor:
        """Eye-space points [..., 3] -> 2D window coordinates [..., 2]."""
        return v[..., :2] / v[..., 2:3] * self.f + self.c

    def window_to_eye(self, w: torch.Tensor) -> torch.Tensor:
        """2D window coordinates -> unit-length eye rays [..., 3]."""
        q = (w - self.c) / self.f
        return geometry.normalized(torch.cat([q, torch.ones_like(q[..., :1])], dim=-1))

    def world_to_eye(self, v: torch.Tensor) -> torch.Tensor:
        t = self.T_world_from_eye
        d = v - t[..., :3, 3]
        return torch.sum(t[..., :3, :3] * d[..., :, None], dim=-2)

    def world_to_window(self, v: torch.Tensor) -> torch.Tensor:
        return self.eye_to_window(self.world_to_eye(v))

    def eye_to_world(self, v: torch.Tensor) -> torch.Tensor:
        t = self.T_world_from_eye
        return torch.sum(t[..., :3, :3] * v[..., None, :], dim=-1) + t[..., :3, 3]
