"""3D geometry primitives (counterpart of foundpose_tpu/geometry.py).

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch


def transform_points(matrix: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Applies rigid transform(s) [..., 3|4, 4] to [..., 3] points."""
    return torch.einsum("...ij,...j->...i", matrix[..., :3, :3], points) + matrix[..., :3, 3]


def skew_matrix(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def as_4x4_rt(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Builds [..., 4, 4] homogeneous transforms from [..., 3, 3] + [..., 3]."""
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = r.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([r, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype, device=r.device)
    bottom = bottom.expand(*batch, 1, 4)
    return torch.cat([top, bottom], dim=-2)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    theta = torch.sqrt(torch.sum(rvec * rvec, dim=-1, keepdim=True))
    small = theta[..., 0] < 1e-8
    axis = rvec / torch.where(theta < 1e-8, torch.ones_like(theta), theta)
    k = skew_matrix(axis)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(k.shape)
    r = eye + s * k + (1.0 - c) * (k @ k)
    return torch.where(small[..., None, None], eye + skew_matrix(rvec), r)


def rotation_error_deg(r_est: torch.Tensor, r_gt: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation error in degrees."""
    r = r_est @ r_gt.transpose(-1, -2)
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))
