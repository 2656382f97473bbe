"""Crops per second of the offline infer CLI on one NVIDIA GPU, host work
included, on a synthetic BOP split on disk (counterpart of
benchmarks/cli_throughput.py).

    python -m foundpose_torch.benchmarks.cli_throughput [--images 40] [--dets 4] \\
        [--batch 64] [--workdir DIR] [--regen]                  # needs a CUDA GPU

What bench.py leaves out, this measures: the wall crops/s `pipeline.infer`
sustains with PNG decoding, detection loading, crop cameras, warps, the
step and the evaluator in the loop. The split is written once into
`--workdir` (default: a temporary directory, removed afterwards): 644 x
476 images with `--dets` rendered instances of a coloured icosahedron each
(random orientations at 400-520 mm, f 600), GT and CNOS detections with
RLE masks. The representation is built by the port's gen_templates (57 x
14 = 798 templates of 420 px) and gen_repre (fused bf16 ViT, PCA 256,
2,048 words) with the weights infer uses without a checkpoint
(bench_weights' random weights from seed 0), so the timed poses match
real templates. infer runs at configs/infer/lmo.json's switches (fused
bf16 ViT, tanh GELU, capped softmax, approximate top-k) at `--batch`;
the first pass warms up, the second is timed. A workdir whose stamp
matches the options is reused without rebuilding.

Prints one JSON line {"metric": "cli_crops_per_sec", ...} with the JAX
script's keys plus `card`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

OBJ_ID = 1
IMG_W, IMG_H = 644, 476  # ViT-14-divisible: the dataset crop is the whole image
EXTRACTOR = "dinov2_version=vits14-reg_stride=14_facet=token_layer=9_norm=1"
STAMP_VERSION = "gen-v2"


def _mesh():
    """The JAX script's icosahedron: 40 mm, vertex colours from seed 7."""
    from foundpose_torch.benchmarks.builder_full_scale import make_icosphere
    from foundpose_torch.data.ply import Mesh

    ico = make_icosphere(40.0, 0)
    colors = np.random.default_rng(7).integers(40, 255, size=(len(ico.vertices), 3))
    return Mesh(vertices=ico.vertices, faces=ico.faces, colors=colors.astype(np.uint8))


def rle_counts(mask: np.ndarray):
    """COCO uncompressed RLE counts of a bool mask (column-major runs,
    starting with zeros)."""
    flat = mask.T.ravel().astype(np.int8)
    bounds = np.concatenate([[0], np.flatnonzero(np.diff(flat)) + 1, [flat.size]])
    counts = np.diff(bounds).tolist()
    return [0] + counts if flat[0] else counts


def build_split(workdir: str, n_images: int, dets_per_image: int) -> str:
    """One scene of n_images PNGs, each with up to dets_per_image rendered
    instances (those of fewer than 200 pixels dropped), their GT and CNOS
    detections; returns the detections file's path."""
    from PIL import Image
    from scipy.spatial.transform import Rotation

    from foundpose_torch.data.ply import save_ply
    from foundpose_torch.renderer.base import RendererType, RenderType, build
    from foundpose_torch.structs import PinholeCamera

    mesh = _mesh()
    scene = os.path.join(workdir, "bop", "demo", "test", "000001")
    models = os.path.join(workdir, "bop", "demo", "models")
    os.makedirs(os.path.join(scene, "rgb"), exist_ok=True)
    os.makedirs(models, exist_ok=True)
    save_ply(os.path.join(models, f"obj_{OBJ_ID:06d}.ply"), mesh)
    diameter = float(np.linalg.norm(mesh.vertices.max(axis=0) - mesh.vertices.min(axis=0)))
    with open(os.path.join(models, "models_info.json"), "w") as f:
        json.dump({str(OBJ_ID): {"diameter": diameter}}, f)
    k = np.array([[600.0, 0, IMG_W / 2 - 0.5], [0, 600.0, IMG_H / 2 - 0.5], [0, 0, 1.0]])
    renderer = build(RendererType.SOFTWARE_RASTERIZER)
    renderer.add_object_model(OBJ_ID, mesh)
    rng = np.random.default_rng(0)
    cams, gts, infos, dets = {}, {}, {}, []
    for im_id in range(n_images):
        rgb = rng.integers(0, 60, size=(IMG_H, IMG_W, 3)).astype(np.uint8)
        gts[str(im_id)], infos[str(im_id)] = [], []
        for _ in range(dets_per_image):
            r_m2c = Rotation.from_euler("xyz", rng.uniform(0, 2 * np.pi, 3)).as_matrix()
            t_m2c = np.array([rng.uniform(-120, 120), rng.uniform(-80, 80),
                              rng.uniform(400, 520)])
            pose = np.eye(4)
            pose[:3, :3], pose[:3, 3] = r_m2c, t_m2c
            cam = PinholeCamera.from_intrinsic_matrix(
                k, IMG_W, IMG_H, T_world_from_eye=torch.as_tensor(np.linalg.inv(pose)))
            out = renderer.render_object_model(OBJ_ID, cam)
            mask = np.asarray(out[RenderType.MASK]) > 0
            if mask.sum() < 200:
                continue
            inst = (255 * np.clip(np.asarray(out[RenderType.COLOR]), 0, 1)).astype(np.uint8)
            rgb[mask] = inst[mask]
            ys, xs = np.nonzero(mask)
            box = [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                   int(ys.max() - ys.min() + 1)]
            gts[str(im_id)].append({"obj_id": OBJ_ID, "cam_R_m2c": r_m2c.flatten().tolist(),
                                    "cam_t_m2c": t_m2c.tolist()})
            infos[str(im_id)].append({"bbox_obj": box, "bbox_visib": box, "visib_fract": 1.0})
            dets.append({"scene_id": 1, "image_id": im_id, "category_id": OBJ_ID,
                         "score": float(rng.uniform(0.5, 1.0)), "bbox": box, "time": 0.05,
                         "segmentation": {"counts": rle_counts(mask), "size": [IMG_H, IMG_W]}})
        Image.fromarray(rgb).save(os.path.join(scene, "rgb", f"{im_id:06d}.png"))
        cams[str(im_id)] = {"cam_K": k.flatten().tolist(), "depth_scale": 0.1}
    for name, data in (("scene_camera.json", cams), ("scene_gt.json", gts),
                       ("scene_gt_info.json", infos)):
        with open(os.path.join(scene, name), "w") as f:
            json.dump(data, f)
    det_path = os.path.join(workdir, "detections.json")
    with open(det_path, "w") as f:
        json.dump(dets, f)
    return det_path


def build_repre(workdir: str, device, vit_overrides=None, viewpoints: int = 57,
                rotations: int = 14) -> str:
    """The object's representation from its own templates, at LM-O's
    configuration (viewpoints x rotations templates of 420 px), with the
    ViT weights infer uses; returns the representations' root."""
    from foundpose_torch.pipeline import gen_repre, gen_templates

    gen_templates.synthesize_templates(gen_templates.GenTemplatesOpts(
        object_dataset="demo", object_lids=[OBJ_ID], min_num_viewpoints=viewpoints,
        num_inplane_rotations=rotations, depth_range=(400.0, 520.0), crop_size=(420, 420),
        bop_root=os.path.join(workdir, "bop"), output_dir=os.path.join(workdir, "templates"),
        overwrite=True))
    gen_repre.generate_repre_from_list(gen_repre.GenRepreOpts(
        object_dataset="demo", object_lids=[OBJ_ID], extractor_name=EXTRACTOR,
        use_pallas_attention=True, use_fused_block=True, approx_gelu=True, batch_size=32,
        vit_overrides=vit_overrides, templates_dir=os.path.join(workdir, "templates"),
        output_dir=os.path.join(workdir, "repre"), overwrite=True, device=str(device)))
    return os.path.join(workdir, "repre")


def infer_opts(workdir: str, dets: int, batch: int, device, vit_overrides=None):
    """infer's options at lmo.json's switches on the split in `workdir`."""
    from foundpose_torch.pipeline import infer

    return infer.InferOpts(
        object_dataset="demo", object_lids=[OBJ_ID], extractor_name=EXTRACTOR,
        crop_size=(420, 420), use_pallas_attention=True, use_fused_block=True,
        approx_gelu=True, approx_topk=True, compute_dtype="bfloat16",
        vit_overrides={"softmax_stabilizer": "capped", **(vit_overrides or {})},
        batch_size=batch, num_preds_factor=float(dets), dataset_crop_size=(IMG_W, IMG_H),
        bop_root=os.path.join(workdir, "bop"), repre_dir=os.path.join(workdir, "repre"),
        detections_path=os.path.join(workdir, "detections.json"),
        output_dir=os.path.join(workdir, "out"), device=str(device))


def prepare(workdir: str, images: int = 40, dets: int = 4, regen: bool = False, device="cuda",
            vit_overrides=None, viewpoints: int = 57, rotations: int = 14) -> float:
    """Writes the split and builds the representation in `workdir` unless
    its stamp matches; returns the seconds it took (0 when reused)."""
    stamp = os.path.join(workdir, "stamp.json")
    want = {"images": images, "dets": dets, "repre": STAMP_VERSION, "vit": vit_overrides,
            "templates": [viewpoints, rotations]}
    if not regen and os.path.exists(stamp):
        with open(stamp) as f:
            if json.load(f) == want:
                return 0.0
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    build_split(workdir, images, dets)
    build_repre(workdir, device, vit_overrides, viewpoints, rotations)
    with open(stamp, "w") as f:
        json.dump(want, f)
    return time.perf_counter() - t0


def run_once(opts):
    """(wall seconds, crops, estimated-poses records) of one infer() pass."""
    from foundpose_torch.pipeline import infer

    shutil.rmtree(opts.output_dir, ignore_errors=True)
    t0 = time.perf_counter()
    counts = infer.infer(opts)
    wall = time.perf_counter() - t0
    path = os.path.join(opts.output_dir, "demo", "v1", str(OBJ_ID), "estimated-poses.json")
    records = []
    if os.path.exists(path):
        with open(path) as f:
            records = json.load(f)
    return wall, sum(counts.values()), records


def run(images: int = 40, dets: int = 4, batch: int = 64, workdir: Optional[str] = None,
        regen: bool = False, device="cuda", vit_overrides: Optional[Dict[str, Any]] = None,
        viewpoints: int = 57, rotations: int = 14) -> Dict[str, Any]:
    """The measurement as a dict; `vit_overrides`, `viewpoints` and
    `rotations` shrink the ViT and the template set for tests."""
    from foundpose_torch.benchmarks.bench import card, require_device

    device = require_device(device)
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="foundpose_cli_bench_") if own else workdir
    try:
        setup_s = prepare(workdir, images, dets, regen or own, device, vit_overrides,
                          viewpoints, rotations)
        opts = infer_opts(workdir, dets, batch, device, vit_overrides)
        w0, n0, _ = run_once(opts)
        print(f"[cli_throughput] split and representation {setup_s:.1f} s; warm-up pass: {n0} "
              f"crops in {w0:.1f} s", file=sys.stderr)
        wall, n, records = run_once(opts)
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
    stages = {}
    for r in records:
        for k, v in (r.get("time") or {}).items():
            stages.setdefault(k, []).append(float(v))
    return {
        "metric": "cli_crops_per_sec",
        "value": n / wall,
        "unit": "crops/sec (host-inclusive: PNG IO + prep + warp + pipeline + evaluator)",
        "crops": n,
        "success_rate": len(records) / max(n, 1),
        "wall_s": wall,
        "warmup_wall_s": w0,
        "setup_s": setup_s,
        "images": images,
        "batch": batch,
        "stage_median_s": {k: float(np.median(v)) for k, v in sorted(stages.items())},
        "card": card(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=40)
    ap.add_argument("--dets", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--workdir", default=None, help="split directory (default: a temporary one)")
    ap.add_argument("--regen", action="store_true", help="rebuild the split in --workdir")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.images, args.dets, args.batch, args.workdir, args.regen)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
