"""Symmetry-aware pose error metrics: MSSD, MSPD, rotation and translation
errors, mask IoU (counterpart of foundpose_tpu/eval/errors.py).

The symmetry loop is a batched axis: all symmetry transforms are evaluated
at once as [S, N, 3] products. Inputs are tensors of one dtype (the
evaluator passes f32).
"""

from __future__ import annotations

from typing import Tuple

import torch

from foundpose_torch import geometry


def _apply_pose(r: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,nj->...ni", r, pts) + t[..., None, :]


def _best_symmetry(err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """err [S, N] -> (the smallest per-symmetry maximum, the argmax vertex
    of that symmetry)."""
    max_per_sym = torch.amax(err, dim=-1)
    best = torch.argmin(max_per_sym)
    return max_per_sym[best], torch.argmax(err[best])


def _symmetric_gt(r_gt, t_gt, sym_r, sym_t):
    r_sym = torch.einsum("ij,sjk->sik", r_gt, sym_r)
    t_sym = torch.einsum("ij,sj->si", r_gt, sym_t) + t_gt
    return r_sym, t_sym


def mssd(
    r_est: torch.Tensor, t_est: torch.Tensor, r_gt: torch.Tensor, t_gt: torch.Tensor,
    pts: torch.Tensor, sym_r: torch.Tensor, sym_t: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximum Symmetry-aware Surface Distance of model points pts [N, 3]
    under symmetries sym_r [S, 3, 3], sym_t [S, 3]: (error, argmax vertex
    of the best symmetry)."""
    pts_est = _apply_pose(r_est, t_est, pts)  # [N, 3]
    pts_gt = _apply_pose(*_symmetric_gt(r_gt, t_gt, sym_r, sym_t), pts)  # [S, N, 3]
    return _best_symmetry(torch.linalg.vector_norm(pts_gt - pts_est[None], dim=-1))


def mspd(
    r_est: torch.Tensor, t_est: torch.Tensor, r_gt: torch.Tensor, t_gt: torch.Tensor,
    k: torch.Tensor, pts: torch.Tensor, sym_r: torch.Tensor, sym_t: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximum Symmetry-aware Projection Distance under intrinsics k [3, 3]:
    (error in pixels, argmax vertex of the best symmetry)."""

    def project(r, t):
        uvw = torch.einsum("ij,...nj->...ni", k, _apply_pose(r, t, pts))
        return uvw[..., :2] / uvw[..., 2:3]

    proj_est = project(r_est, t_est)  # [N, 2]
    proj_gt = project(*_symmetric_gt(r_gt, t_gt, sym_r, sym_t))  # [S, N, 2]
    return _best_symmetry(torch.linalg.vector_norm(proj_est[None] - proj_gt, dim=-1))


def rotation_error_deg(r_est: torch.Tensor, r_gt: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation error in degrees."""
    return geometry.rotation_error_deg(r_est, r_gt)


def translation_error(t_est: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    """L2 translation error."""
    return torch.linalg.vector_norm(t_est - t_gt, dim=-1)


def mask_iou(mask1: torch.Tensor, mask2: torch.Tensor) -> torch.Tensor:
    """IoU of two binary masks (0 when both are empty)."""
    m1 = mask1 > 0
    m2 = mask2 > 0
    inter = torch.sum((m1 & m2).float())
    union = torch.sum((m1 | m2).float())
    return torch.where(union > 0, inter / torch.clamp_min(union, 1.0), 0.0)


def vertex_error_percentiles(
    r_est: torch.Tensor, t_est: torch.Tensor, r_gt: torch.Tensor, t_gt: torch.Tensor,
    pts: torch.Tensor,
) -> dict:
    """Mean, median, 90th percentile (linear interpolation) and maximum of
    the per-vertex distances between the two poses."""
    err = torch.linalg.vector_norm(
        _apply_pose(r_est, t_est, pts) - _apply_pose(r_gt, t_gt, pts), dim=-1
    )
    return {
        "mean": torch.mean(err),
        "p50": torch.quantile(err, 0.5),
        "p90": torch.quantile(err, 0.9),
        "max": torch.amax(err),
    }
