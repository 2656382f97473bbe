"""Crop cameras for detection boxes (counterpart of the crop-camera part of
foundpose_tpu/cameras.py; view sampling comes with the offline
template generation).

Every function broadcasts over leading batch dimensions, so the cameras of
all boxes of one image are built by one call whose op count does not grow
with the number of boxes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from foundpose_torch import geometry
from foundpose_torch.structs import PinholeCamera


def calc_crop_box(
    box: torch.Tensor, scaling_factor: float = 1.0, make_square: bool = True
) -> torch.Tensor:
    """Inflates [..., 4] (x1, y1, x2, y2) boxes and optionally squares them."""
    bw = box[..., 2] - box[..., 0]
    bh = box[..., 3] - box[..., 1]
    w = bw * scaling_factor
    h = bh * scaling_factor
    if make_square:
        w = h = torch.maximum(w, h)
    x_pad = 0.5 * (w - bw)
    y_pad = 0.5 * (h - bh)
    return torch.stack(
        [box[..., 0] - x_pad, box[..., 1] - y_pad, box[..., 2] + x_pad, box[..., 3] + y_pad],
        dim=-1,
    )


def construct_crop_camera(
    box: torch.Tensor,
    camera_c2w: PinholeCamera,
    viewport_size: Tuple[int, int],
    viewport_rel_pad: float,
) -> PinholeCamera:
    """Virtual pinhole camera(s) aimed at 2D box(es) of the source camera.

    The optical axis passes through the centroid of the box corners' viewing
    directions; the focal length makes the bounding sphere of those
    directions, padded by `viewport_rel_pad`, fill the viewport.
    """
    f = 0.5 * (camera_c2w.f[..., 0] + camera_c2w.f[..., 1])
    cx, cy = camera_c2w.c[..., 0], camera_c2w.c[..., 1]
    corners_x = torch.stack([box[..., 0], box[..., 2], box[..., 0], box[..., 2]], dim=-1) - cx[..., None]
    corners_y = torch.stack([box[..., 1], box[..., 1], box[..., 3], box[..., 3]], dim=-1) - cy[..., None]
    corners_z = f[..., None].expand_as(corners_x)
    corners = torch.stack([corners_x, corners_y, corners_z], dim=-1)  # [..., 4, 3]
    corners = corners / torch.linalg.vector_norm(corners, dim=-1, keepdim=True)

    centroid = torch.mean(corners, dim=-2)
    centroid_in_w = geometry.transform_points(camera_c2w.T_world_from_eye, centroid)
    radius = torch.amax(torch.linalg.vector_norm(corners - centroid[..., None, :], dim=-1), dim=-1)

    trans_w2c = geometry.inverse_se3(camera_c2w.T_world_from_eye)
    trans_w2vc = geometry.gen_look_at_matrix(trans_w2c, centroid_in_w)
    centroid_in_vc = geometry.transform_points(trans_w2vc, centroid_in_w)

    fx_fy_orig = camera_c2w.f
    radius_2d = fx_fy_orig * (radius / centroid_in_vc[..., 2])[..., None]
    extent_2d = (1.0 + viewport_rel_pad) * radius_2d
    cx_cy = torch.tensor(viewport_size, dtype=fx_fy_orig.dtype, device=fx_fy_orig.device) / 2.0 - 0.5
    fx_fy = fx_fy_orig * cx_cy / extent_2d
    return PinholeCamera(
        f=fx_fy,
        c=cx_cy.expand_as(fx_fy).contiguous(),
        T_world_from_eye=geometry.inverse_se3(trans_w2vc),
        width=int(viewport_size[0]),
        height=int(viewport_size[1]),
    )


def build_crop_cameras(
    camera_c2w: PinholeCamera,
    boxes_xyxy: torch.Tensor,
    viewport_size: Tuple[int, int],
    viewport_rel_pad: float,
) -> PinholeCamera:
    """Batched crop cameras [N] for N boxes [N, 4] of ONE source camera."""
    crop_boxes = calc_crop_box(boxes_xyxy, make_square=True)
    return construct_crop_camera(
        crop_boxes, camera_c2w.broadcast(boxes_xyxy.shape[0]), viewport_size, viewport_rel_pad
    )
