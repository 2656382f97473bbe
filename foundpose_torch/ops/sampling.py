"""Query-grid generation, mask filtering and grid feature sampling
(counterpart of foundpose_tpu/ops/sampling.py)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from foundpose_torch.ops.warp import bilinear_sample


def grid_points(grid_size: Tuple[int, int], cell_size: float, device=None) -> torch.Tensor:
    """[(W/cell)*(H/cell), 2] (x, y) cell centres, row-major over y then x."""
    w, h = grid_size
    cols = int(w / cell_size)
    rows = int(h / cell_size)
    half = cell_size / 2.0
    xs = torch.linspace(half, w - half, cols, dtype=torch.float32, device=device)
    ys = torch.linspace(half, h - half, rows, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def points_in_mask(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Validity [..., Q] of [Q, 2] points against [..., H, W] masks: the
    +0.5-rounded pixel must lie inside the canvas and on the mask."""
    h, w = mask.shape[-2], mask.shape[-1]
    pi = torch.floor(points + 0.5).long()
    x, y = pi[..., 0], pi[..., 1]
    in_canvas = (x > 0) & (x < w) & (y > 0) & (y < h)
    xc = torch.clamp(x, 0, w - 1)
    yc = torch.clamp(y, 0, h - 1)
    on_mask = mask[..., yc, xc] > 0
    return in_canvas & on_mask


def sample_feature_map(
    feature_map_hwc: torch.Tensor, points: torch.Tensor, image_size: Tuple[int, int]
) -> torch.Tensor:
    """Bilinear features of an [Hf, Wf, C] map at image-space points
    [..., 2], or of a batch [B, Hf, Wf, C] at [B, ..., 2] -> [(B,) ..., C].

    grid_sample's align_corners=False convention over a map coarser than
    the image: image coordinate p maps to map coordinate p * (fm / image) -
    0.5, zero outside the map. image_size is (width, height).
    """
    hf, wf = feature_map_hwc.shape[-3], feature_map_hwc.shape[-2]
    iw, ih = image_size
    scale = torch.tensor([wf / iw, hf / ih], dtype=points.dtype, device=points.device)
    return bilinear_sample(feature_map_hwc, points * scale - 0.5)


def sample_grid_features(
    feature_map_hwc: torch.Tensor,
    points: torch.Tensor,
    image_size: Tuple[int, int],
    cell_size: float,
) -> torch.Tensor:
    """Features [..., Q, C] of a [..., Hf, Wf, C] map at the [Q, 2] points.

    PRECONDITION for the fast path: `points` is the row-major grid of
    `grid_points(image_size, cell_size)`; the port does not inspect the
    values (that would cost a device-to-host copy a request), so callers
    with other points of the same count call `sample_feature_map`. When the
    grid matches the map one cell per texel (stride-14 DINOv2 on 14-px
    cells, the shipped configurations) every cell centre lands on a texel
    and sampling is a reshape; otherwise the points are sampled
    bilinearly.
    """
    hf, wf = feature_map_hwc.shape[-3], feature_map_hwc.shape[-2]
    cols = int(image_size[0] / cell_size)
    rows = int(image_size[1] / cell_size)
    if (
        (wf, hf) == (cols, rows)
        and image_size[0] / wf == cell_size
        and image_size[1] / hf == cell_size
        and points.shape[0] == rows * cols
    ):
        return feature_map_hwc.reshape(
            *feature_map_hwc.shape[:-3], rows * cols, feature_map_hwc.shape[-1]
        )
    if feature_map_hwc.dim() == 4:
        points = points.expand(feature_map_hwc.shape[0], *points.shape)
    return sample_feature_map(feature_map_hwc, points, image_size)


def lift_points_to_3d(
    points: torch.Tensor, depth_image: torch.Tensor, cam_f: torch.Tensor, cam_c: torch.Tensor
) -> torch.Tensor:
    """Camera-space 3D points [..., N, 3] of image points [N, 2] (or
    [..., N, 2]) on depth images [..., H, W], with intrinsics cam_f, cam_c
    [..., 2]: the ray through each point at the averaged focal, scaled to
    the depth read at the floored pixel (clamped to the image). (reference:
    utils/feature_util.py:134-157)"""
    h, w = depth_image.shape[-2], depth_image.shape[-1]
    focal = 0.5 * (cam_f[..., 0] + cam_f[..., 1])
    xy = points - cam_c[..., None, :]
    ray = torch.cat([xy, focal[..., None, None].expand(*xy.shape[:-1], 1)], dim=-1)
    xi = torch.clamp(torch.floor(points[..., 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.floor(points[..., 1]).long(), 0, h - 1)
    flat = depth_image.reshape(*depth_image.shape[:-2], h * w)
    idx = (yi * w + xi).expand(*flat.shape[:-1], xy.shape[-2])
    depths = torch.gather(flat, -1, idx)
    return ray * (depths / ray[..., 2])[..., None]


def subsample_points(
    valid: torch.Tensor, max_count: int, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """Randomly keeps at most `max_count` valid points per row of [..., Q]."""
    scores = torch.rand(
        valid.shape, generator=generator, device=valid.device, dtype=torch.float32
    )
    scores = torch.where(valid, scores, torch.full_like(scores, -1.0))
    thresh = torch.topk(scores, max_count, dim=-1).values[..., -1:]
    return valid & (scores >= thresh)
