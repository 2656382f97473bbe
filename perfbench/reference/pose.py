"""Pose from 2D-3D correspondences and pose errors, plain.

The reference's solve is the direct linear transform over every valid
correspondence in normalised image coordinates, in float64, its 3 x 3 part
projected onto the nearest rotation. On a crop whose correspondences are all exact
it returns the exact pose; it carries no RANSAC, so it is only the
control's solve, never a judge of the program's.
"""

from __future__ import annotations

import torch

from perfbench.reference.precision import Precision


def dlt_pose(c2d, c3d, valid, f, c, prec: Precision):
    """(R [B, 3, 3], t [B, 3]) mapping model points into the camera, from
    c2d [B, K, 2] pixels, c3d [B, K, 3], valid [B, K], intrinsics f, c [B, 2].
    A crop with fewer than 6 valid correspondences gets the identity."""
    x = (c2d.double() - c.double()[:, None]) / f.double()[:, None]
    X = torch.cat([c3d.double(), torch.ones_like(c3d[..., :1]).double()], dim=-1)
    zero = torch.zeros_like(X)
    rows_u = torch.cat([X, zero, -x[..., :1] * X], dim=-1)
    rows_v = torch.cat([zero, X, -x[..., 1:] * X], dim=-1)
    a = torch.cat([rows_u, rows_v], dim=1) * torch.cat([valid, valid], dim=1)[..., None]
    ata = prec.solve_mm(a.transpose(1, 2), a)
    p = torch.linalg.eigh(ata).eigenvectors[..., 0].reshape(-1, 3, 4)
    u, sv, vh = torch.linalg.svd(p[:, :, :3])
    r = u @ vh
    sign = torch.sign(torch.linalg.det(r))
    scale = sv.mean(-1) * sign
    r = r * sign[:, None, None]
    t = p[:, :, 3] / scale[:, None]
    ok = valid.sum(-1) >= 6
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand_as(r)
    return torch.where(ok[:, None, None], r, eye).float(), torch.where(ok[:, None], t, 0).float()


def rotation_error_deg(r_est, r_true):
    """Geodesic angle between rotations [..., 3, 3], in degrees (float64),
    from both the trace and the skew part, so that a small angle keeps its
    digits when the matrices are float32."""
    r = r_est.double() @ r_true.double().transpose(-1, -2)
    cos = (r.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    skew = torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                        r[..., 1, 0] - r[..., 0, 1]], -1)
    return torch.rad2deg(torch.atan2(skew.norm(dim=-1) / 2.0, cos))
