"""Crop cameras of detection boxes and the warp of an image into them.

FoundPose crops each detection by a virtual pinhole camera that turns
about the source camera's centre to look through the box: the box is
squared, its four corner rays are averaged into the optical axis (the
shortest rotation from +z), and the focal length makes the corner rays'
bounding sphere, padded by `rel_pad`, fill the crop. The image is resampled
with OpenCV's conventions (integer coordinates at pixel centres, taps
outside the image read 0): four bilinear samples at quarter-pixel offsets
averaged (area filtering of a 2x reduction), masks by the nearest pixel.
Computed in float64; the crops stay unrounded in [0, 1], as the program
warps a frame it has divided by 255.
"""

from __future__ import annotations

import torch

from perfbench.reference.precision import Precision


def _normalized(v):
    return v / v.norm(dim=-1, keepdim=True).clamp_min(1e-300)


def _shortest_rotation(a, b):
    """Rotation taking unit direction a [3] onto unit directions b [N, 3]."""
    v = torch.cross(a.expand_as(b), b, dim=-1)
    s2 = (v * v).sum(-1)[:, None, None]
    cos = (b * a).sum(-1)[:, None, None]
    z = torch.zeros_like(v[:, 0])
    vx = torch.stack([torch.stack([z, -v[:, 2], v[:, 1]], -1),
                      torch.stack([v[:, 2], z, -v[:, 0]], -1),
                      torch.stack([-v[:, 1], v[:, 0], z], -1)], dim=-2)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + vx + vx @ vx * (1.0 - cos) / s2.clamp_min(1e-15)


def crop_cameras(K, boxes, crop_px: int, rel_pad: float = 0.2):
    """Crop cameras of boxes [N, 4] (x1, y1, x2, y2) in an image of
    intrinsics K [3, 3], all in float64: focal [N, 2], centre [N, 2] and the
    rotation R [N, 3, 3] from crop eye to image eye."""
    K = torch.as_tensor(K, dtype=torch.float64)
    boxes = torch.as_tensor(boxes, dtype=torch.float64)
    f_src = torch.stack([K[0, 0], K[1, 1]])
    c_src = torch.stack([K[0, 2], K[1, 2]])
    side = torch.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    mid = (boxes[:, :2] + boxes[:, 2:]) / 2.0
    lo, hi = mid - side[:, None] / 2.0, mid + side[:, None] / 2.0
    xs = torch.stack([lo[:, 0], hi[:, 0], lo[:, 0], hi[:, 0]], -1) - c_src[0]
    ys = torch.stack([lo[:, 1], lo[:, 1], hi[:, 1], hi[:, 1]], -1) - c_src[1]
    corners = _normalized(torch.stack([xs, ys, f_src.mean().expand_as(xs)], -1))
    centroid = corners.mean(1)
    radius = (corners - centroid[:, None]).norm(dim=-1).amax(-1)
    rot = _shortest_rotation(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64),
                             _normalized(centroid))
    depth = (rot.transpose(1, 2) @ centroid[..., None])[:, 2, 0]
    extent = (1.0 + rel_pad) * f_src * (radius / depth)[:, None]
    c = torch.full_like(extent, crop_px / 2.0 - 0.5)
    return f_src * c / extent, c, rot


def _source_pixels(K, f, c, rot, xy, prec: Precision):
    """Image pixels [N, h, w, 2] seen by crop pixels xy [h, w, 2]; -1 where
    the ray points behind the image camera."""
    K = torch.as_tensor(K, dtype=torch.float64, device=xy.device)
    q = (xy[None] - c[:, None, None]) / f[:, None, None]
    ray = _normalized(torch.cat([q, torch.ones_like(q[..., :1])], -1))
    src = torch.einsum("nij,nhwj->nhwi", rot, ray)
    px = src[..., :2] / src[..., 2:] * torch.stack([K[0, 0], K[1, 1]]) + torch.stack(
        [K[0, 2], K[1, 2]])
    return torch.where(src[..., 2:] < 0, -1.0, prec.coords(px))


def _taps(image, x, y):
    h, w = image.shape[:2]
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    v = image[y.clamp(0, h - 1), x.clamp(0, w - 1)]
    return torch.where(inside[..., None], v, 0.0)


def warp(image_u8, K, f, c, rot, crop_px: int, prec: Precision = None):
    """(crops [N, crop_px, crop_px, 3] float32 in [0, 1], masks [N, crop_px,
    crop_px] uint8) of a uint8 image [H, W, 3] warped into the crop cameras,
    with an all-ones mask warped beside it."""
    prec = prec or Precision()
    img = image_u8.double() / 255.0
    ar = torch.arange(crop_px, dtype=torch.float64, device=img.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    grid = torch.stack([gx, gy], -1)
    f, c, rot = f.to(img.device), c.to(img.device), rot.to(img.device)
    acc = 0.0
    for dx in (-0.25, 0.25):
        for dy in (-0.25, 0.25):
            p = _source_pixels(K, f, c, rot, grid + torch.tensor([dx, dy], device=img.device,
                                                                 dtype=torch.float64), prec)
            x0, y0 = torch.floor(p[..., 0]), torch.floor(p[..., 1])
            wx, wy = (p[..., 0] - x0)[..., None], (p[..., 1] - y0)[..., None]
            x0, y0 = x0.long(), y0.long()
            top = _taps(img, x0, y0) * (1 - wx) + _taps(img, x0 + 1, y0) * wx
            bot = _taps(img, x0, y0 + 1) * (1 - wx) + _taps(img, x0 + 1, y0 + 1) * wx
            acc = acc + top * (1 - wy) + bot * wy
    crops = (acc / 4.0).float()
    p = _source_pixels(K, f, c, rot, grid, prec)
    xi, yi = torch.round(p[..., 0]).long(), torch.round(p[..., 1]).long()
    h, w = image_u8.shape[:2]
    masks = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)).to(torch.uint8)
    return crops, masks
