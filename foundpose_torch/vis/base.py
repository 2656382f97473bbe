"""Plot primitives: tiles, overlays, keypoints, match lines, contours
(a copy of foundpose_tpu/vis/base.py, which the port may not import, without
its uncalled draw_keypoints, draw_box, scatter_2d and embed_tsne; cv2 is
imported inside the functions that draw, so the module imports without it).

Host-side re-design of the reference plotting helpers
(reference: utils/vis_base_util.py:46-449). cv2-based (no matplotlib state),
operating on uint8 HWC images.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def to_uint8(image: np.ndarray) -> np.ndarray:
    if image.dtype == np.uint8:
        return image
    return (255.0 * np.clip(image, 0.0, 1.0)).astype(np.uint8)


def ensure_rgb(image: np.ndarray) -> np.ndarray:
    img = to_uint8(image)
    if img.ndim == 2:
        return np.stack([img] * 3, axis=-1)
    return img


def build_grid(
    tiles: Sequence[np.ndarray], cols: int = 4, pad: int = 2, pad_value: int = 255
) -> np.ndarray:
    """Assembles equally-sized tiles into a grid image.

    (reference: utils/vis_base_util.py image grids)
    """
    tiles = [ensure_rgb(t) for t in tiles]
    h = max(t.shape[0] for t in tiles)
    w = max(t.shape[1] for t in tiles)
    norm = []
    for t in tiles:
        canvas = np.full((h, w, 3), pad_value, dtype=np.uint8)
        canvas[: t.shape[0], : t.shape[1]] = t
        norm.append(canvas)
    rows = -(-len(norm) // cols)
    grid = np.full(
        (rows * (h + pad) - pad, cols * (w + pad) - pad, 3), pad_value, dtype=np.uint8
    )
    for i, t in enumerate(norm):
        r, c = divmod(i, cols)
        grid[r * (h + pad) : r * (h + pad) + h, c * (w + pad) : c * (w + pad) + w] = t
    return grid


def overlay_mask(
    image: np.ndarray, mask: np.ndarray, color=(0, 255, 0), alpha: float = 0.45
) -> np.ndarray:
    img = ensure_rgb(image).astype(np.float32)
    m = (np.asarray(mask) > 0)[..., None].astype(np.float32)
    colored = np.asarray(color, dtype=np.float32)
    out = img * (1 - alpha * m) + colored * alpha * m
    return out.astype(np.uint8)


def overlay_contour(
    image: np.ndarray, mask: np.ndarray, color=(255, 0, 0), thickness: int = 2
) -> np.ndarray:
    """Draws the mask contour onto the image (pose-overlay style,
    reference: utils/vis_base_util.py contour overlay)."""
    import cv2

    img = ensure_rgb(image).copy()
    m = (np.asarray(mask) > 0).astype(np.uint8)
    contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    cv2.drawContours(img, contours, -1, color, thickness)
    return img


def draw_matches(
    image_left: np.ndarray,
    image_right: np.ndarray,
    pts_left: np.ndarray,
    pts_right: np.ndarray,
    scores: Optional[np.ndarray] = None,
    max_draw: int = 100,
) -> np.ndarray:
    """Side-by-side images with confidence-colored match lines.

    (reference: utils/vis_base_util.py match-line plots used by vis_util)
    """
    import cv2

    left = ensure_rgb(image_left)
    right = ensure_rgb(image_right)
    h = max(left.shape[0], right.shape[0])
    canvas = np.zeros((h, left.shape[1] + right.shape[1], 3), dtype=np.uint8)
    canvas[: left.shape[0], : left.shape[1]] = left
    canvas[: right.shape[0], left.shape[1] :] = right
    off = left.shape[1]
    n = min(len(pts_left), max_draw)
    for i in range(n):
        s = float(scores[i]) if scores is not None else 1.0
        color = (int(255 * (1 - s)), int(255 * s), 0)
        p1 = (int(round(pts_left[i][0])), int(round(pts_left[i][1])))
        p2 = (int(round(pts_right[i][0])) + off, int(round(pts_right[i][1])))
        cv2.line(canvas, p1, p2, color, 1, cv2.LINE_AA)
    return canvas


def write_text(
    image: np.ndarray, text: str, org: Tuple[int, int] = (5, 18), scale: float = 0.5
) -> np.ndarray:
    """Text banner on an image (reference: utils/render_vis_util.py:27-87)."""
    import cv2

    img = ensure_rgb(image).copy()
    cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, (0, 0, 0), 3,
                cv2.LINE_AA)
    cv2.putText(img, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, (255, 255, 255), 1,
                cv2.LINE_AA)
    return img


def draw_histogram(
    values: np.ndarray,
    bins: int = 32,
    size: Tuple[int, int] = (320, 200),
    color=(80, 140, 255),
    title: Optional[str] = None,
) -> np.ndarray:
    """Renders a histogram of `values` as an image (cv2-drawn; matplotlib-free
    counterpart of the reference's histogram plots,
    reference: utils/vis_base_util.py:46-437)."""
    import cv2

    w, h = size
    img = np.full((h, w, 3), 255, dtype=np.uint8)
    vals = np.asarray(values, dtype=np.float64).ravel()
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return write_text(img, "no data")
    hist, edges = np.histogram(vals, bins=bins)
    peak = max(int(hist.max()), 1)
    margin = 18
    bar_w = (w - 2 * margin) / bins
    for i, count in enumerate(hist):
        x1 = int(margin + i * bar_w)
        x2 = int(margin + (i + 1) * bar_w) - 1
        y1 = h - margin
        y2 = int(y1 - (h - 2 * margin) * (count / peak))
        cv2.rectangle(img, (x1, y2), (x2, y1), color, -1)
    cv2.rectangle(img, (margin, margin), (w - margin, h - margin), (0, 0, 0), 1)
    img = write_text(img, f"{edges[0]:.3g}", org=(margin, h - 4), scale=0.35)
    img = write_text(img, f"{edges[-1]:.3g}", org=(w - 3 * margin, h - 4), scale=0.35)
    if title:
        img = write_text(img, title, org=(margin, 14), scale=0.4)
    return img


def draw_inliers(
    image: np.ndarray,
    points: np.ndarray,
    inlier_mask: np.ndarray,
    radius: int = 2,
) -> np.ndarray:
    """Correspondence points colored green (inlier) / red (outlier)
    (reference: utils/vis_util.py inlier plots)."""
    import cv2

    img = ensure_rgb(image).copy()
    inl = np.asarray(inlier_mask).astype(bool)
    for p, ok in zip(np.asarray(points), inl):
        color = (0, 200, 0) if ok else (220, 0, 0)
        cv2.circle(img, (int(round(p[0])), int(round(p[1]))), radius, color, -1)
    return img
