"""Crop cameras for detection boxes and view-sphere sampling for the
offline template generation (counterpart of foundpose_tpu/cameras.py).

Every crop-camera function broadcasts over leading batch dimensions, so the
cameras of all boxes of one image are built by one call whose op count does
not grow with the number of boxes. View sampling is host numpy in float64,
as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# View-sphere sampling (host numpy, feeds the offline template generation).
# ---------------------------------------------------------------------------


def fibonacci_sphere(n_pts: int, radius: float = 1.0) -> np.ndarray:
    """Odd-count Fibonacci lattice [n_pts, 3] on a sphere. (reference:
    utils/misc.py:47-89)"""
    if n_pts % 2 != 1:
        raise ValueError(f"fibonacci_sphere takes an odd point count, got {n_pts}")
    half = n_pts // 2
    phi = (math.sqrt(5.0) + 1.0) / 2.0
    ga = 2.0 * math.pi * (phi - 1.0)
    i = np.arange(-half, half + 1, dtype=np.float64)
    lat = np.arcsin(2.0 * i / (2 * half + 1))
    lon = np.mod(ga * i, 2.0 * math.pi)
    s = np.cos(lat) * radius
    return np.stack([np.cos(lon) * s, np.sin(lon) * s, np.tan(lat) * s], axis=-1)


def sample_views(
    min_n_views: int,
    radius: float = 1.0,
    azimuth_range: Tuple[float, float] = (0.0, 2.0 * math.pi),
    elev_range: Tuple[float, float] = (-0.5 * math.pi, 0.5 * math.pi),
) -> List[dict]:
    """Camera views on a sphere looking at the origin (OpenCV frame): a list
    of {"R": 3x3, "t": 3x1} world-to-camera transforms. (reference:
    utils/misc.py:91-168)"""
    n_views = min_n_views if min_n_views % 2 == 1 else min_n_views + 1
    pts = fibonacci_sphere(n_views, radius=radius)

    views = []
    for pt in pts:
        azimuth = math.atan2(pt[1], pt[0])
        if azimuth < 0:
            azimuth += 2.0 * math.pi
        a = np.linalg.norm(pt)
        b = np.linalg.norm([pt[0], pt[1], 0.0])
        elev = math.acos(np.clip(b / a, -1.0, 1.0))
        if pt[2] < 0:
            elev = -elev
        if not (
            azimuth_range[0] <= azimuth <= azimuth_range[1]
            and elev_range[0] <= elev <= elev_range[1]
        ):
            continue

        # gluLookAt-style frame, then the OpenGL -> OpenCV flip about X.
        fwd = -pt / np.linalg.norm(pt)
        up = np.array([0.0, 0.0, 1.0])
        side = np.cross(fwd, up)
        if np.count_nonzero(side) == 0:
            side = np.array([1.0, 0.0, 0.0])
        side /= np.linalg.norm(side)
        up = np.cross(side, fwd)
        r = np.diag([1.0, -1.0, -1.0]) @ np.stack([side, up, -fwd], axis=0)
        t = -r @ pt.reshape(3, 1)
        views.append({"R": r, "t": t})
    return views


def inplane_rotated_views(views: List[dict], num_inplane_rotations: int) -> List[dict]:
    """Each view repeated at num_inplane_rotations rotations about the
    optical axis. (reference: scripts/gen_templates.py:167-183)"""
    out = []
    step = 2.0 * math.pi / num_inplane_rotations
    for view in views:
        for i in range(num_inplane_rotations):
            angle = i * step
            rz = np.array(
                [
                    [math.cos(angle), -math.sin(angle), 0.0],
                    [math.sin(angle), math.cos(angle), 0.0],
                    [0.0, 0.0, 1.0],
                ]
            )
            out.append({"R": rz @ view["R"], "t": rz @ view["t"]})
    return out


def view_sphere_radii(depth_range: Tuple[float, float], num_spheres: int) -> List[float]:
    """View-sphere radii spanning a depth range. (reference:
    scripts/gen_templates.py:147-154)"""
    depth_min, depth_max = depth_range
    if num_spheres == 1:
        return [0.5 * (depth_min + depth_max)]
    step = (depth_max - depth_min) / (num_spheres - 1)
    return [depth_min + i * step for i in range(num_spheres)]
