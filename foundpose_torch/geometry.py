"""3D geometry primitives (counterpart of foundpose_tpu/geometry.py).

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch


def transform_points(matrix: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Applies rigid transform(s) [..., 3|4, 4] to [..., 3] points."""
    return torch.einsum("...ij,...j->...i", matrix[..., :3, :3], points) + matrix[..., :3, 3]


def normalized(v: torch.Tensor, eps: float = 5.43e-20) -> torch.Tensor:
    """Unit-length copy of [..., 3] vectors, safe for near-zero input."""
    return v / torch.clamp_min(torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), eps)


def inverse_se3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of rigid transform(s) [..., 4, 4]."""
    r_t = m[..., :3, :3].transpose(-1, -2)
    return as_4x4_rt(r_t, -torch.einsum("...ij,...j->...i", r_t, m[..., :3, 3]))


def from_two_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation taking direction `a` to direction `b` (Rodrigues form, with
    the JAX package's guard at sin ~ 0)."""
    a = normalized(a)
    b = normalized(b)
    v = torch.cross(a.expand_as(b), b, dim=-1)
    s2 = torch.sum(v * v, dim=-1)[..., None, None]
    c = torch.sum(a * b, dim=-1)[..., None, None]
    vm = skew_matrix(v)
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(vm.shape)
    return eye + vm + (vm @ vm) * (1.0 - c) / torch.clamp_min(s2, 1e-15)


def gen_look_at_matrix(
    orig_camera_from_world: torch.Tensor, center_in_world: torch.Tensor
) -> torch.Tensor:
    """Re-aims camera(s) so the +Z axis passes through `center_in_world`;
    returns the new camera_from_world [..., 4, 4] (camera angle 0)."""
    center_local = transform_points(orig_camera_from_world, center_in_world)
    z_axis = torch.tensor([0.0, 0.0, 1.0], dtype=center_local.dtype, device=center_local.device)
    delta_r_local = from_two_vectors(z_axis, normalized(center_local))
    orig_world_from_camera = inverse_se3(orig_camera_from_world)
    rot = orig_world_from_camera[..., :3, :3] @ delta_r_local
    return inverse_se3(as_4x4_rt(rot, orig_world_from_camera[..., :3, 3]))


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
