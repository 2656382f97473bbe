"""Featuremetric pose refinement: Levenberg-Marquardt over dense
patch-feature residuals (counterpart of foundpose_tpu/pose/featuremetric.py).

For a template's registered 3D points X_i with descriptors f_i, the pose
projects X_i into the query crop, the crop's feature map is sampled
bilinearly there, and LM minimises sum_i || F(pi(R X_i + t)) - f_i ||^2 over
a left-multiplied SE(3) twist (R <- exp(-dw^) R, t <- t - dt). The Jacobian
is analytic: the bilinear field's spatial gradient (from the same four
corner gathers as the value) composed with the pinhole Jacobian.

Where the JAX package vmaps one crop's refinement, the port runs each LM
iteration as one set of tensor ops over the whole batch of crops: the
damping factor and the accept/reject decision are per crop, and nothing in
the loop reads a value back to the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from foundpose_torch import geometry


def _corners(feature_map: torch.Tensor, pts_px: torch.Tensor, crop_size: Tuple[int, int]):
    """The four bilinear corners [B, N, D] of [B, Hf, Wf, D] maps at
    image-space points [B, N, 2] (each crop at its own points; zero outside
    the map), the fractional offsets fx, fy [B, N, 1] and the map-per-pixel
    scales sx, sy (grid_sample align_corners=False: pixel p -> map
    coordinate p * (fm / image) - 0.5)."""
    b, hf, wf, d = feature_map.shape
    iw, ih = crop_size
    sx = wf / iw
    sy = hf / ih
    u = pts_px[..., 0] * sx - 0.5
    v = pts_px[..., 1] * sy - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    flat = feature_map.reshape(b * hf * wf, d)
    base = (torch.arange(b, device=feature_map.device) * (hf * wf))[:, None]
    zero = torch.zeros((), dtype=feature_map.dtype, device=feature_map.device)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < wf) & (yi >= 0) & (yi < hf)
        idx = base + torch.clamp(yi, 0, hf - 1) * wf + torch.clamp(xi, 0, wf - 1)
        return torch.where(valid[..., None], flat[idx], zero)

    corners = (gather(y0i, x0i), gather(y0i, x0i + 1), gather(y0i + 1, x0i), gather(y0i + 1, x0i + 1))
    return corners, fx, fy, sx, sy


def _rows(corners, fx):
    c00, c10, c01, c11 = corners
    return c00 * (1.0 - fx) + c10 * fx, c01 * (1.0 - fx) + c11 * fx


def _sample(feature_map, pts_px, crop_size) -> torch.Tensor:
    """The bilinear value alone of `_sample_with_grad`."""
    corners, fx, fy, _, _ = _corners(feature_map, pts_px, crop_size)
    top, bot = _rows(corners, fx)
    return top * (1.0 - fy) + bot * fy


def _sample_with_grad(
    feature_map: torch.Tensor, pts_px: torch.Tensor, crop_size: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bilinear value and analytic spatial gradient of [B, Hf, Wf, D] maps
    at image-space points [B, N, 2].

    The value is ops/sampling.sample_feature_map's. Returns (val, d/dx,
    d/dy), each [B, N, D] in per-image-pixel units. The weights are f32, so
    bf16 corners give f32 results; the corner differences of d/dx are taken
    in the map's dtype, as in the JAX package.
    """
    corners, fx, fy, sx, sy = _corners(feature_map, pts_px, crop_size)
    c00, c10, c01, c11 = corners
    top, bot = _rows(corners, fx)
    val = top * (1.0 - fy) + bot * fy
    dval_dx = ((c10 - c00) * (1.0 - fy) + (c11 - c01) * fy) * sx
    dval_dy = (bot - top) * sy
    return val, dval_dx, dval_dy


def refine_pose_featuremetric(
    r0: torch.Tensor,
    t0: torch.Tensor,
    feature_map: torch.Tensor,
    cam_f: torch.Tensor,
    cam_c: torch.Tensor,
    pts3d: torch.Tensor,
    feats: torch.Tensor,
    valid: torch.Tensor,
    crop_size: Tuple[int, int] = (420, 420),
    iters: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LM refinement of a batch of poses against the crops' feature maps.

    Args:
        r0 [B, 3, 3], t0 [B, 3]: coarse poses (model -> crop camera).
        feature_map: [B, Hf, Wf, D] crop feature maps, in the space of
            `feats` (PCA space on the shipped configurations).
        cam_f, cam_c: [B, 2] crop intrinsics.
        pts3d [B, N, 3], feats [B, N, D], valid [B, N] bool: each crop's
            template points and descriptors.
    Returns:
        (R [B, 3, 3], t [B, 3], final cost [B]).

    A step is kept per crop where it lowers the cost; the damping lam
    starts at 1e-2 and is scaled by 0.3 on a kept step and 5 otherwise,
    within [1e-6, 1e8]. `iters` steps always run. A crop with no point in
    view gets J = 0 and a zero step. The normal equations are f32
    (matmuls without TF32, as the JAX package's HIGHEST precision).
    """
    w_px, h_px = crop_size
    pts32 = pts3d.float()
    feats32 = feats.float()
    cam_f = cam_f.float()
    cam_c = cam_c.float()
    eye6 = 1e-9 * torch.eye(6, dtype=torch.float32, device=r0.device)

    def project(r, t):
        cam = torch.einsum("bij,bnj->bni", r, pts32) + t[:, None]
        z = torch.clamp_min(cam[..., 2], 1e-6)
        proj = cam[..., :2] / z[..., None] * cam_f[:, None] + cam_c[:, None]
        return cam, z, proj

    def point_weight(cam, proj):
        inside = (
            (proj[..., 0] > 0)
            & (proj[..., 0] < w_px - 1)
            & (proj[..., 1] > 0)
            & (proj[..., 1] < h_px - 1)
        )
        return (valid & inside & (cam[..., 2] > 0)).float()

    def cost_at(r, t):
        cam, _, proj = project(r, t)
        val = _sample(feature_map, proj, crop_size)
        res = (val.float() - feats32) * point_weight(cam, proj)[..., None]
        return torch.sum(res * res, dim=(1, 2))

    fx_c = cam_f[:, 0:1]
    fy_c = cam_f[:, 1:2]
    r = r0.float()
    t = t0.float()
    lam = torch.full((r.shape[0],), 1e-2, dtype=torch.float32, device=r.device)
    for _ in range(iters):
        cam, z, proj = project(r, t)
        val, gx, gy = _sample_with_grad(feature_map, proj, crop_size)
        w = point_weight(cam, proj)
        res = (val.float() - feats32) * w[..., None]
        cost = torch.sum(res * res, dim=(1, 2))
        # du/d(delta) [B, N, 2, 6] for the left twist q = exp(dw^)(R X) + t
        # + dt: dq/ddw = -[cam - t]^x, dq/ddt = I, composed with the
        # pinhole Jacobian A = dproj/dq.
        zeros = torch.zeros_like(z)
        a_row0 = torch.stack([fx_c / z, zeros, -fx_c * cam[..., 0] / (z * z)], -1)
        a_row1 = torch.stack([zeros, fy_c / z, -fy_c * cam[..., 1] / (z * z)], -1)
        a = torch.stack([a_row0, a_row1], dim=-2)  # [B, N, 2, 3]
        skew = geometry.skew_matrix(cam - t[:, None])  # [B, N, 3, 3]
        du = torch.cat([-(a @ skew), a], dim=-1)  # [B, N, 2, 6]
        # J [B, N, D, 6]: the field gradient composed with du, masked.
        gxf = (gx.float() * w[..., None])[..., None]
        gyf = (gy.float() * w[..., None])[..., None]
        jac = gxf * du[:, :, None, 0, :] + gyf * du[:, :, None, 1, :]
        # Broadcast-and-sum over (n, d): as one [6, N*D] x [N*D, 6] GEMM per
        # crop, cuBLAS picks a small-N kernel that took 4 ms a step on the
        # H100 at N*D = 131,072.
        jtj = torch.sum(jac[..., :, None] * jac[..., None, :], dim=(1, 2))
        jtr = torch.sum(jac * res[..., None], dim=(1, 2))
        damped = jtj + lam[:, None, None] * torch.diag_embed(torch.diagonal(jtj, dim1=-2, dim2=-1)) + eye6
        # solve_ex: no error check, so no device-to-host sync.
        delta = torch.linalg.solve_ex(damped, jtr[..., None], check_errors=False)[0][..., 0]
        r_new = geometry.rodrigues(-delta[:, :3]) @ r
        t_new = t - delta[:, 3:]
        new_cost = cost_at(r_new, t_new)
        improved = new_cost < cost
        r = torch.where(improved[:, None, None], r_new, r)
        t = torch.where(improved[:, None], t_new, t)
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 5.0), 1e-6, 1e8)
    return r, t, cost_at(r, t)
