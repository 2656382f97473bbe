"""Binary morphology as max pooling (counterpart of
foundpose_tpu/ops/morphology.py, whose reduce_window min/max pooling this
restates with F.max_pool2d: a min over a window is 1 - the max of 1 - m).
Masks are [..., H, W]; the result has the mask's dtype and is exactly 0 or
1, as the JAX package's."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _max_window(m: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Max over kernel_size x kernel_size windows, outside the image
    neutral."""
    h, w = m.shape[-2], m.shape[-1]
    out = F.max_pool2d(m.reshape(-1, 1, h, w), kernel_size, stride=1, padding=kernel_size // 2)
    return out.reshape(*m.shape[:-2], *out.shape[-2:])


def erode(mask: torch.Tensor, kernel_size: int = 5, border: str = "zero") -> torch.Tensor:
    """Binary erosion with a square all-ones kernel.

    border="zero": outside is 0, so pixels whose window leaves the image
    erode away (kornia's default); border="replicate": outside is neutral
    and border pixels survive (cv2.erode's default)."""
    m = (mask > 0).float()
    out = 1.0 - _max_window(1.0 - m, kernel_size)
    if border == "zero":
        h, w = out.shape[-2], out.shape[-1]
        pad = kernel_size // 2
        ys = torch.arange(h, device=mask.device)[:, None]
        xs = torch.arange(w, device=mask.device)[None, :]
        interior = (ys >= pad) & (ys < h - pad) & (xs >= pad) & (xs < w - pad)
        out = torch.where(interior, out, 0.0)
    elif border != "replicate":
        raise ValueError(f"unknown border mode: {border}")
    return out.to(mask.dtype)


def dilate(mask: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Binary dilation with a square all-ones kernel (outside = 0)."""
    return _max_window((mask > 0).float(), kernel_size).to(mask.dtype)


def opening(mask: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Morphological opening (erode then dilate), as cv2.MORPH_OPEN."""
    return dilate(erode(mask, kernel_size, border="replicate"), kernel_size)
