"""BOP dataset access: scene metadata, images, GT annotations, symmetries
(a copy of foundpose_tpu/data/bop.py, which the port may not import; PIL is
imported where an image is read, so the module imports without it).

Host-side re-design of the reference's BOP layer
(reference: utils/data_util.py:22-337 and the bop_toolkit usages at
scripts/infer.py:132-169). The output of `prepare_sample` is a batched-ready
numpy sample; center-cropping to ViT-stride-divisible sizes matches the
reference's DatasetOpts (utils/data_util.py:22-34).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from foundpose_torch.data.ply import Mesh, load_ply


# Default center-crop sizes making width/height divisible by the ViT patch 14
# (reference: utils/data_util.py:22-34).
DEFAULT_CROP_SIZES = {
    "lmo": (630, 476),
    "lm": (630, 476),
    "tudl": (630, 476),
    "ycbv": (630, 476),
    "tless": (630, 532),
    "icbin": (630, 476),
    "itodd": (1246, 952),
    "hb": (630, 476),
}

TEST_SPLITS = {
    "lmo": ("test", None),
    "lm": ("test", None),
    "tudl": ("test", None),
    "ycbv": ("test", None),
    "tless": ("test_primesense", "primesense"),
    "icbin": ("test", None),
    "itodd": ("test", None),
    "hb": ("test_primesense", "primesense"),
}

OBJECT_IDS = {
    "lmo": [1, 5, 6, 8, 9, 10, 11, 12],
    "tudl": [1, 2, 3],
    "ycbv": list(range(1, 22)),
    "tless": list(range(1, 31)),
    "icbin": [1, 2],
    "hb": list(range(1, 34)),
}


@dataclasses.dataclass
class GtAnnotation:
    obj_id: int
    R_m2c: np.ndarray  # [3, 3]
    t_m2c: np.ndarray  # [3]
    box_amodal: Optional[np.ndarray] = None  # [4] xyxy
    box_visib: Optional[np.ndarray] = None  # [4] xyxy
    visib_fract: float = 1.0
    mask_visib: Optional[np.ndarray] = None  # [H, W] bool


@dataclasses.dataclass
class Sample:
    scene_id: int
    im_id: int
    image: np.ndarray  # [H, W, 3] uint8 (center-cropped)
    depth: Optional[np.ndarray]  # [H, W] float32 mm
    K: np.ndarray  # [3, 3] of the cropped camera
    gt: List[GtAnnotation]
    crop_offset: Tuple[int, int]  # (x0, y0) of the center crop in the original


def split_dir(bop_root: str, dataset: str) -> str:
    split, _ = TEST_SPLITS.get(dataset, ("test", None))
    return os.path.join(bop_root, dataset, split)


def models_dir(bop_root: str, dataset: str, model_type: str = "") -> str:
    suffix = f"_{model_type}" if model_type else ""
    return os.path.join(bop_root, dataset, f"models{suffix}")


def load_json(path: str, keys_to_int: bool = True) -> Any:
    with open(path) as f:
        data = json.load(f)
    if keys_to_int and isinstance(data, dict):
        data = {int(k) if k.lstrip("-").isdigit() else k: v for k, v in data.items()}
    return data


def list_scenes(bop_root: str, dataset: str) -> List[int]:
    d = split_dir(bop_root, dataset)
    return sorted(int(s) for s in os.listdir(d) if s.isdigit())


def list_images(bop_root: str, dataset: str, scene_id: int) -> List[int]:
    scene = os.path.join(split_dir(bop_root, dataset), f"{scene_id:06d}")
    cam = load_json(os.path.join(scene, "scene_camera.json"))
    return sorted(cam.keys())


def load_scene_camera(scene_dir: str) -> Dict[int, Dict[str, np.ndarray]]:
    """scene_camera.json -> {im_id: {"K": 3x3, "depth_scale": float}}.

    (reference parser: utils/data_util.py:165-224)
    """
    raw = load_json(os.path.join(scene_dir, "scene_camera.json"))
    out = {}
    for im_id, c in raw.items():
        out[im_id] = {
            "K": np.asarray(c["cam_K"], dtype=np.float64).reshape(3, 3),
            "depth_scale": float(c.get("depth_scale", 1.0)),
        }
    return out


def load_scene_gt(scene_dir: str) -> Dict[int, List[Dict[str, Any]]]:
    """scene_gt.json -> {im_id: [{"obj_id", "R", "t"}]}.

    (reference parser: utils/data_util.py:226-296)
    """
    path = os.path.join(scene_dir, "scene_gt.json")
    if not os.path.exists(path):
        return {}
    raw = load_json(path)
    out = {}
    for im_id, anns in raw.items():
        items = []
        for a in anns:
            items.append(
                {
                    "obj_id": int(a["obj_id"]),
                    "R": np.asarray(a["cam_R_m2c"], dtype=np.float64).reshape(3, 3),
                    "t": np.asarray(a["cam_t_m2c"], dtype=np.float64).reshape(3),
                }
            )
        out[im_id] = items
    return out


def load_scene_gt_info(scene_dir: str) -> Dict[int, List[Dict[str, Any]]]:
    path = os.path.join(scene_dir, "scene_gt_info.json")
    if not os.path.exists(path):
        return {}
    return load_json(path)


def _center_crop_bounds(w: int, h: int, crop_wh: Tuple[int, int]):
    cw, ch = min(crop_wh[0], w), min(crop_wh[1], h)
    x0 = (w - cw) // 2
    y0 = (h - ch) // 2
    return x0, y0, cw, ch


def prepare_sample(
    bop_root: str,
    dataset: str,
    scene_id: int,
    im_id: int,
    load_depth: bool = False,
    load_gt: bool = True,
    load_masks: bool = False,
    crop_size: Optional[Tuple[int, int]] = None,
) -> Sample:
    """Loads one test image with a ViT-divisible center crop applied.

    (reference: utils/data_util.py:37-162)
    """
    from PIL import Image

    scene_dir = os.path.join(split_dir(bop_root, dataset), f"{scene_id:06d}")
    cams = load_scene_camera(scene_dir)
    cam = cams[im_id]

    rgb_dir = "rgb" if os.path.isdir(os.path.join(scene_dir, "rgb")) else "gray"
    img_path = None
    for ext in (".png", ".jpg", ".tif"):
        p = os.path.join(scene_dir, rgb_dir, f"{im_id:06d}{ext}")
        if os.path.exists(p):
            img_path = p
            break
    if img_path is None:
        raise FileNotFoundError(f"no image for {scene_dir}/{rgb_dir}/{im_id:06d}")
    image = np.asarray(Image.open(img_path).convert("RGB"))

    h, w = image.shape[:2]
    crop_wh = crop_size or DEFAULT_CROP_SIZES.get(dataset, (630, 476))
    x0, y0, cw, ch = _center_crop_bounds(w, h, crop_wh)
    image = image[y0 : y0 + ch, x0 : x0 + cw]

    # Cropping shifts the principal point (reference: utils/data_util.py:299-337).
    K = cam["K"].copy()
    K[0, 2] -= x0
    K[1, 2] -= y0

    depth = None
    if load_depth:
        dp = os.path.join(scene_dir, "depth", f"{im_id:06d}.png")
        depth = np.asarray(Image.open(dp)).astype(np.float32) * cam["depth_scale"]
        depth = depth[y0 : y0 + ch, x0 : x0 + cw]

    gt: List[GtAnnotation] = []
    if load_gt:
        gts = load_scene_gt(scene_dir).get(im_id, [])
        infos = load_scene_gt_info(scene_dir).get(im_id, [{}] * len(gts))
        for gt_id, (g, info) in enumerate(zip(gts, infos)):
            box = info.get("bbox_obj")
            box_v = info.get("bbox_visib")

            def shift_box(b):
                if b is None:
                    return None
                x, y, bw, bh = b
                return np.asarray(
                    [x - x0, y - y0, x - x0 + bw, y - y0 + bh], dtype=np.float32
                )

            mask_visib = None
            if load_masks:
                mp = os.path.join(
                    scene_dir, "mask_visib", f"{im_id:06d}_{gt_id:06d}.png"
                )
                if os.path.exists(mp):
                    m = np.asarray(Image.open(mp)) > 0
                    mask_visib = m[y0 : y0 + ch, x0 : x0 + cw]
            gt.append(
                GtAnnotation(
                    obj_id=g["obj_id"],
                    R_m2c=g["R"],
                    t_m2c=g["t"],
                    box_amodal=shift_box(box),
                    box_visib=shift_box(box_v),
                    visib_fract=float(info.get("visib_fract", 1.0)),
                    mask_visib=mask_visib,
                )
            )

    return Sample(
        scene_id=scene_id,
        im_id=im_id,
        image=image,
        depth=depth,
        K=K,
        gt=gt,
        crop_offset=(x0, y0),
    )


# ---------------------------------------------------------------------------
# Object models + symmetries
# ---------------------------------------------------------------------------


def load_object_model(
    bop_root: str, dataset: str, obj_id: int, model_type: str = ""
) -> Mesh:
    return load_ply(
        os.path.join(models_dir(bop_root, dataset, model_type), f"obj_{obj_id:06d}.ply")
    )


def load_models_info(bop_root: str, dataset: str, model_type: str = "") -> Dict:
    return load_json(
        os.path.join(models_dir(bop_root, dataset, model_type), "models_info.json")
    )


def get_symmetry_transformations(
    model_info: Dict[str, Any], max_sym_disc_step: float = 0.01
) -> List[Dict[str, np.ndarray]]:
    """Discretized symmetry set, matching bop_toolkit's semantics
    (used by the reference at scripts/infer.py:251-253 for MSSD/MSPD):
    discrete symmetries from `symmetries_discrete`, continuous axes sampled so
    adjacent steps move surface points by <= max_sym_disc_step * diameter.
    """
    trans_disc = [{"R": np.eye(3), "t": np.zeros(3)}]
    for sym in model_info.get("symmetries_discrete", []):
        m = np.asarray(sym, dtype=np.float64).reshape(4, 4)
        trans_disc.append({"R": m[:3, :3], "t": m[:3, 3]})

    trans_cont = []
    for sym in model_info.get("symmetries_continuous", []):
        axis = np.asarray(sym["axis"], dtype=np.float64)
        offset = np.asarray(sym.get("offset", [0, 0, 0]), dtype=np.float64)
        # Number of discretized steps (bop_toolkit formula).
        n = max(int(np.ceil(np.pi / max_sym_disc_step)), 1)
        for i in range(1, n):
            angle = i * 2.0 * np.pi / n
            c, s = np.cos(angle), np.sin(angle)
            a = axis / np.linalg.norm(axis)
            k = np.array(
                [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]
            )
            r = np.eye(3) + s * k + (1 - c) * (k @ k)
            t = -r @ offset + offset
            trans_cont.append({"R": r, "t": t})

    if not trans_cont:
        return trans_disc
    out = []
    for td in trans_disc:
        out.append(td)
        for tc in trans_cont:
            out.append({"R": tc["R"] @ td["R"], "t": tc["R"] @ td["t"] + tc["t"]})
    return out
