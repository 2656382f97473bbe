"""CNOS/FastSAM detection input: JSON loading, RLE masks, instance selection
(counterpart of foundpose_tpu/data/detections.py; the mask opening runs in
the port's ops/morphology on the CPU).

Host-side re-design of the reference detection layer
(reference: utils/infer_pose_util.py:24-151). Includes a numpy COCO
uncompressed-RLE decoder so bop_toolkit's pycoco_utils is not needed.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from foundpose_torch.ops import morphology


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    """Decodes COCO uncompressed RLE {"counts": [...], "size": [h, w]} to a
    bool [H, W] mask (column-major runs, starting with zeros)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _decode_compressed_rle(counts, h * w)
    flat = np.zeros(h * w, dtype=bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos : pos + c] = True
        pos += c
        val = not val
    return flat.reshape(w, h).T  # column-major


def _decode_compressed_rle(s: str, n_pixels: int) -> List[int]:
    """COCO compressed-RLE (LEB128-style) string decoder."""
    counts = []
    p = 0
    prev = 0
    data = s.encode("ascii") if isinstance(s, str) else s
    while p < len(data):
        x = 0
        k = 0
        more = True
        while more:
            c = data[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
        prev = x
    return counts


@dataclasses.dataclass
class Detection:
    scene_id: int
    im_id: int
    obj_id: int
    score: float
    box_xyxy: np.ndarray  # [4]
    mask: Optional[np.ndarray] = None  # [H, W] bool
    time: float = 0.0


def load_detections(
    path: str,
) -> Dict[Tuple[int, int, int], List[Dict[str, Any]]]:
    """Loads a CNOS-format detections JSON keyed by (scene, image, category).

    (reference: utils/infer_pose_util.py:24-41)
    """
    with open(path) as f:
        raw = json.load(f)
    out: Dict[Tuple[int, int, int], List[Dict[str, Any]]] = {}
    for det in raw:
        key = (int(det["scene_id"]), int(det["image_id"]), int(det["category_id"]))
        out.setdefault(key, []).append(det)
    return out


def instances_for_pose_estimation(
    detections: List[Dict[str, Any]],
    max_num_preds: int,
    crop_offset: Tuple[int, int] = (0, 0),
    mask_opening_kernel: int = 3,
    image_size: Optional[Tuple[int, int]] = None,
) -> List[Detection]:
    """Selects the top-scoring detections and prepares masks/boxes.

    Pipeline per detection (reference: utils/infer_pose_util.py:44-137):
    RLE -> binary mask, 3x3 morphological opening, center-crop shift, xywh ->
    xyxy box. Returns at most `max_num_preds` by descending score.
    """
    dets = sorted(detections, key=lambda d: -d["score"])[:max_num_preds]
    x_off, y_off = crop_offset
    out: List[Detection] = []
    for d in dets:
        mask = None
        if "segmentation" in d:
            mask = rle_to_mask(d["segmentation"])
            mask = morphology.opening(
                torch.from_numpy(mask.astype(np.float32)), mask_opening_kernel
            ).numpy().astype(bool)
            if x_off or y_off:
                mask = mask[y_off:, x_off:]
            if image_size is not None:
                mask = mask[: image_size[1], : image_size[0]]
        x, y, w, h = d["bbox"]
        box = np.asarray(
            [x - x_off, y - y_off, x - x_off + w, y - y_off + h], dtype=np.float32
        )
        out.append(
            Detection(
                scene_id=int(d["scene_id"]),
                im_id=int(d["image_id"]),
                obj_id=int(d["category_id"]),
                score=float(d["score"]),
                box_xyxy=box,
                mask=mask,
                time=float(d.get("time", 0.0)),
            )
        )
    return out


def associate_gt_by_iou(det_box: np.ndarray, gt_boxes: List[np.ndarray]) -> int:
    """Index of the best-IoU GT box, -1 if none (reference: :115-128)."""
    best, best_iou = -1, 0.0
    for i, g in enumerate(gt_boxes):
        if g is None:
            continue
        ix1 = max(det_box[0], g[0])
        iy1 = max(det_box[1], g[1])
        ix2 = min(det_box[2], g[2])
        iy2 = min(det_box[3], g[3])
        inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
        a1 = (det_box[2] - det_box[0]) * (det_box[3] - det_box[1])
        a2 = (g[2] - g[0]) * (g[3] - g[1])
        union = a1 + a2 - inter
        iou = inter / union if union > 0 else 0.0
        if iou > best_iou:
            best, best_iou = i, iou
    return best
