"""Camera-to-camera image and depth warping as gather-based resampling
(counterpart of foundpose_tpu/ops/warp.py).

The samplers port the JAX package's arithmetic rather than calling
F.grid_sample: integer coordinates are pixel centres (cv2.remap's
convention), each of the four bilinear taps outside the image reads
`fill_value`, and nearest sampling rounds half to even. Destination
cameras may carry a leading batch axis: one source image is warped into
every crop camera of a detection set without being replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from foundpose_torch.structs import PinholeCamera, to_device


def _gather(image: torch.Tensor, yi, xi, fill, batch: Optional[torch.Tensor] = None):
    """image [(N,) H, W, C] at integer (yi, xi) [...] (of image `batch` [...]
    when batched) -> [..., C]; out-of-range taps read `fill`."""
    h, w = image.shape[-3], image.shape[-2]
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
    if batch is not None:
        idx = idx + batch * (h * w)
    vals = image.reshape(-1, image.shape[-1])[idx]
    return torch.where(valid[..., None], vals, fill)


def _bilinear(image, xy, fill_value, batch=None):
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    fill = torch.full((), fill_value, dtype=torch.float32, device=image.device)
    v00 = _gather(image, y0i, x0i, fill, batch)
    v01 = _gather(image, y0i, x0i + 1, fill, batch)
    v10 = _gather(image, y0i + 1, x0i, fill, batch)
    v11 = _gather(image, y0i + 1, x0i + 1, fill, batch)
    top = v00 * (1.0 - wx) + v01 * wx
    bot = v10 * (1.0 - wx) + v11 * wx
    return top * (1.0 - wy) + bot * wy


def _nearest(image, xy, fill_value, batch=None):
    xi = torch.round(xy[..., 0]).long()
    yi = torch.round(xy[..., 1]).long()
    fill = torch.full((), fill_value, dtype=image.dtype, device=image.device)
    return _gather(image, yi, xi, fill, batch)


def bilinear_sample(image: torch.Tensor, xy: torch.Tensor, fill_value: float = 0.0) -> torch.Tensor:
    """Bilinear samples of an [H, W] or [H, W, C] image at float pixel
    coordinates xy [..., 2] -> [...] or [..., C]; of a batch [N, H, W, C]
    at xy [N, ..., 2], each image at its own points -> [N, ..., C]."""
    if image.dim() == 2:
        return _bilinear(image[..., None], xy, fill_value)[..., 0]
    if image.dim() == 4:
        batch = torch.arange(image.shape[0], device=image.device)
        return _bilinear(image, xy, fill_value, batch.reshape(-1, *[1] * (xy.dim() - 2)))
    return _bilinear(image, xy, fill_value)


def nearest_sample(image: torch.Tensor, xy: torch.Tensor, fill_value: float = 0.0) -> torch.Tensor:
    """Nearest-neighbour samples with bilinear_sample's conventions; the
    image's dtype is kept."""
    if image.dim() == 2:
        return _nearest(image[..., None], xy, fill_value)[..., 0]
    return _nearest(image, xy, fill_value)


def _pixel_grid(height: int, width: int, device) -> torch.Tensor:
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([px, py], dim=-1)  # [H, W, 2] (x, y)


def _source_coords(src_camera, dst_camera, win, depth_check):
    dst = dst_camera.expand_pixels(2)
    src_eye = src_camera.world_to_eye(dst.eye_to_world(dst.window_to_eye(win)))
    src_win = src_camera.eye_to_window(src_eye)
    if depth_check:
        src_win = torch.where(src_eye[..., 2:3] < 0, -1.0, src_win)
    return src_win


def backward_map(
    src_camera: PinholeCamera, dst_camera: PinholeCamera, depth_check: bool = True
) -> torch.Tensor:
    """Source coordinates [(B,) dst_H, dst_W, 2] of every destination pixel."""
    win = _pixel_grid(dst_camera.height, dst_camera.width, dst_camera.f.device)
    return _source_coords(src_camera, dst_camera, win, depth_check)


def warp_image(
    src_camera: PinholeCamera,
    dst_camera: PinholeCamera,
    src_image: torch.Tensor,
    interpolation: str = "bilinear",
    depth_check: bool = True,
) -> torch.Tensor:
    """Warps an [H, W(, C)] image from the source camera to the destination
    camera(s). "area2x" averages four bilinear samples taken at destination
    quarter-pixel offsets (the JAX package's stand-in for cv2.INTER_AREA)."""
    if interpolation == "area2x":
        grid = _pixel_grid(dst_camera.height, dst_camera.width, dst_camera.f.device)
        offsets = to_device([[dx, dy] for dx in (-0.25, 0.25) for dy in (-0.25, 0.25)], grid.device)
        acc = None
        for offset in offsets:
            s = bilinear_sample(src_image, _source_coords(src_camera, dst_camera, grid + offset,
                                                          depth_check))
            acc = s if acc is None else acc + s
        return acc / 4.0
    src_win = backward_map(src_camera, dst_camera, depth_check=depth_check)
    if interpolation == "bilinear":
        return bilinear_sample(src_image, src_win)
    if interpolation == "nearest":
        return nearest_sample(src_image, src_win)
    raise ValueError(f"unknown interpolation: {interpolation}")


def warp_depth_image(
    src_camera: PinholeCamera,
    dst_camera: PinholeCamera,
    src_depth: torch.Tensor,
    depth_check: bool = True,
) -> torch.Tensor:
    """Warps an [H, W] depth image into one destination camera, re-projecting
    each valid (> 0) depth into the destination's eye frame before the
    nearest-neighbour warp. (reference: utils/misc.py:522-556)"""
    h, w = src_depth.shape
    rays = src_camera.window_to_eye(_pixel_grid(h, w, src_depth.device))  # unit rays
    valid = src_depth > 0
    rz = torch.where(rays[..., 2] == 0, 1.0, rays[..., 2])
    scale = torch.where(valid, src_depth / rz, 0.0)
    pts_dst = dst_camera.world_to_eye(src_camera.eye_to_world(rays * scale[..., None]))
    new_depth = torch.where(valid, pts_dst[..., 2], 0.0)
    return warp_image(
        src_camera, dst_camera, new_depth, interpolation="nearest", depth_check=depth_check
    )


def make_single_image_warp(crop_size: Tuple[int, int]):
    """Warp of ONE image into many crop cameras.

    warp(image [H, W, 3], masks [B, H, W], src_cam, dst_cams [B]) ->
    (crops [B, h, w, 3], crop_masks [B, h, w]): the image by "area2x", each
    detection's mask into its own crop camera by "nearest". A uint8 image
    gives uint8 crops and uint8 {0, 1} masks (computed in f32, then
    re-quantized as cv2.remap on uint8 would); float inputs keep float
    outputs.
    """
    width, height = int(crop_size[0]), int(crop_size[1])

    def warp(image, masks, src_cam: PinholeCamera, dst_cams: PinholeCamera):
        u8 = image.dtype == torch.uint8
        img = image.float() / 255.0 if u8 else image
        dst = dataclasses.replace(dst_cams, width=width, height=height)
        out_imgs = warp_image(src_cam, dst, img, interpolation="area2x")
        src_win = backward_map(src_cam, dst)
        batch = torch.arange(masks.shape[0], device=masks.device)[:, None, None]
        out_msks = _nearest(masks.float()[..., None], src_win, 0.0, batch)[..., 0]
        if u8:
            out_imgs = torch.clamp(torch.round(out_imgs * 255.0), 0, 255).to(torch.uint8)
            out_msks = (out_msks > 0.5).to(torch.uint8)
        return out_imgs, out_msks

    return warp
