"""Template synthesis: view-sphere sampling, rasterization through crop
cameras, SSAA downsampling, PNGs and metadata (counterpart of
foundpose_tpu/pipeline/gen_templates.py).

    python -m foundpose_torch.pipeline.gen_templates \\
        --opts-path configs/gen_templates/lmo.json \\
        --set bop_root=... --set output_dir=...

Re-design of the reference template generator (reference:
scripts/gen_templates.py:70-492): the object's 2D box is computed
analytically from the projected mesh vertices, and the template is rendered
directly through the crop camera at SSAA resolution. The crop cameras of
all views come from one batched call of `cameras.calc_crop_box` /
`construct_crop_camera` on CPU tensors in f32. This stage is host work:
views render on the native rasterizer (`native/librasterizer.so`) in a
thread pool, and PNGs are encoded on a second one.

The output (PNG rgb/depth/mask and metadata.json) has the JAX package's
schema, key for key, including its "mask_is_depth_positive" flag, so
templates are interchangeable between the two packages and the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from foundpose_torch import cameras as cam_mod
from foundpose_torch.data import bop
from foundpose_torch.data.ply import Mesh
from foundpose_torch.parallel import host_shard
from foundpose_torch.renderer.base import RendererType, RenderType, build
from foundpose_torch.structs import PinholeCamera
from foundpose_torch.utils import config as config_util
from foundpose_torch.utils.logging_util import Timer, get_logger, log_heading

logger = get_logger()


@dataclasses.dataclass(frozen=True)
class GenTemplatesOpts:
    """(reference: scripts/gen_templates.py:35-67) The JAX package's fields."""

    version: str = "v1"
    object_dataset: str = "lmo"
    object_lids: Optional[List[int]] = None

    num_viewspheres: int = 1
    min_num_viewpoints: int = 57
    num_inplane_rotations: int = 14
    depth_range: Optional[Tuple[float, float]] = None  # mm; None -> from diameter
    # Renders per view (reference: scripts/gen_templates.py:46,241); with this
    # deterministic rasterizer the repeats are identical images.
    images_per_view: int = 1
    # Accepted for schema parity; the reference declares but never reads
    # these, nor background_type and light_type below.
    max_num_triangles: int = 20000
    back_face_culling: bool = False
    texture_size: Tuple[int, int] = (1024, 1024)

    ssaa_factor: float = 4.0
    background_type: str = "black"
    light_type: str = "multi_directional"

    features_patch_size: int = 14
    crop: bool = True
    crop_rel_pad: float = 0.2
    crop_size: Tuple[int, int] = (420, 420)

    # Render/encode worker threads (0 = os.cpu_count()). The rasterizer and
    # cv2's resize and PNG encoder release the GIL; templates are numbered
    # in view order whatever the thread count.
    render_threads: int = 0

    overwrite: bool = False
    # Skip objects whose metadata.json already exists.
    resume: bool = False
    # Host sharding by object; shard_count=0 resolves from torch.distributed.
    shard_index: int = 0
    shard_count: int = 1

    bop_root: str = ""
    output_dir: str = ""


def _camera_json(cam: PinholeCamera) -> dict:
    """Camera -> the reference's to_json schema (reference:
    utils/structs.py:357-371)."""
    t = np.asarray(cam.T_world_from_eye, dtype=np.float64)
    return {
        "ImageSizeX": cam.width,
        "ImageSizeY": cam.height,
        "T_WorldFromCamera": t.tolist(),
        "ModelViewMatrix": np.linalg.inv(t).tolist(),
        "fx": float(cam.f[0]),
        "fy": float(cam.f[1]),
        "cx": float(cam.c[0]),
        "cy": float(cam.c[1]),
    }


def camera_from_json(data: dict) -> PinholeCamera:
    """PinholeCamera (f32 CPU tensors) from the reference's camera JSON."""
    t = np.asarray(data["T_WorldFromCamera"], dtype=np.float32)
    if t.shape == (3, 4):
        t = np.concatenate([t, np.asarray([[0.0, 0.0, 0.0, 1.0]], t.dtype)])
    return PinholeCamera(
        f=torch.tensor([data["fx"], data["fy"]], dtype=torch.float32),
        c=torch.tensor([data["cx"], data["cy"]], dtype=torch.float32),
        T_world_from_eye=torch.from_numpy(t),
        width=int(data["ImageSizeX"]),
        height=int(data["ImageSizeY"]),
    )


def save_depth_png(path: str, depth: np.ndarray) -> None:
    """16-bit PNG depth in 0.1 mm units (BOP convention)."""
    from PIL import Image

    d = np.clip(np.round(depth * 10.0), 0, 65535).astype(np.uint16)
    Image.fromarray(d).save(path)


def load_depth_png(path: str) -> np.ndarray:
    """Depth in mm from a 16-bit PNG in 0.1 mm units."""
    from PIL import Image

    return np.asarray(Image.open(path)).astype(np.float32) / 10.0


def _view_boxes(mesh: Mesh, rs: np.ndarray, ts: np.ndarray, base_f, base_c) -> np.ndarray:
    """Analytic [N, 4] boxes of the projected mesh vertices in the base
    camera, for all views; the [n, V, 3] intermediate is chunked so meshes
    of ~300k vertices stay within a few hundred MB."""
    num_views = len(rs)
    boxes = np.empty((num_views, 4), dtype=np.float32)
    vchunk = max(1, int(2e7) // max(len(mesh.vertices), 1))
    for s in range(0, num_views, vchunk):
        e = min(s + vchunk, num_views)
        vc = np.einsum("nij,vj->nvi", rs[s:e], mesh.vertices) + ts[s:e, None, :]
        proj = vc[:, :, :2] / vc[:, :, 2:3] * np.asarray(base_f) + base_c
        boxes[s:e, 0] = proj[:, :, 0].min(axis=1)
        boxes[s:e, 1] = proj[:, :, 1].min(axis=1)
        boxes[s:e, 2] = proj[:, :, 0].max(axis=1)
        boxes[s:e, 3] = proj[:, :, 1].max(axis=1)
    return boxes


def synthesize_templates_for_object(
    mesh: Mesh,
    model_info: dict,
    opts: GenTemplatesOpts,
    object_lid: int,
    output_dir: str,
) -> List[dict]:
    """Renders the template set of one object; returns the metadata list."""
    import cv2
    import threading
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    for sub in ("rgb", "depth", "mask"):
        os.makedirs(os.path.join(output_dir, sub), exist_ok=True)

    # View-sphere radii from the depth range when given, else from the
    # model diameter (the reference derives them from the test targets'
    # depths, scripts/gen_templates.py:147-154).
    if opts.depth_range is not None:
        radii = cam_mod.view_sphere_radii(opts.depth_range, opts.num_viewspheres)
    else:
        diameter = float(model_info.get("diameter", 200.0))
        radii = cam_mod.view_sphere_radii((4.0 * diameter, 8.0 * diameter), opts.num_viewspheres)

    renderer = build(RendererType.SOFTWARE_RASTERIZER)
    renderer.add_object_model(object_lid, mesh)

    # Base camera for the analytic 2D box only (the crop camera normalizes
    # its scale away).
    base_w, base_h = 640, 480
    base_f = (572.4, 573.6)
    base_c = (base_w / 2 - 0.5, base_h / 2 - 0.5)
    ssaa = float(opts.ssaa_factor)
    crop_w, crop_h = opts.crop_size
    hi_w, hi_h = int(crop_w * ssaa), int(crop_h * ssaa)

    all_views: List[dict] = []
    for radius in radii:
        views = cam_mod.sample_views(opts.min_num_viewpoints, radius=radius)
        all_views.extend(cam_mod.inplane_rotated_views(views, opts.num_inplane_rotations))
    if opts.images_per_view > 1:
        all_views = [v for v in all_views for _ in range(opts.images_per_view)]
    num_views = len(all_views)
    rs = np.stack([v["R"] for v in all_views]).astype(np.float64)  # [N, 3, 3]
    ts = np.stack([np.reshape(v["t"], 3) for v in all_views]).astype(np.float64)
    boxes = _view_boxes(mesh, rs, ts, base_f, base_c)

    # Camera -> world (model frame) per view: inv([R|t]) = [R^T | -R^T t].
    t_c2w = np.zeros((num_views, 4, 4), dtype=np.float32)
    t_c2w[:, :3, :3] = np.transpose(rs, (0, 2, 1))
    t_c2w[:, :3, 3] = -np.einsum("nji,nj->ni", rs, ts)
    t_c2w[:, 3, 3] = 1.0

    # One batched crop-camera construction over all views, f32 on the CPU.
    base_cams = PinholeCamera(
        f=torch.tensor(base_f, dtype=torch.float32).expand(num_views, 2),
        c=torch.tensor(base_c, dtype=torch.float32).expand(num_views, 2),
        T_world_from_eye=torch.from_numpy(t_c2w),
        width=base_w,
        height=base_h,
    )
    crop_boxes = cam_mod.calc_crop_box(torch.from_numpy(boxes), make_square=True)
    crop_cams = cam_mod.construct_crop_camera(
        box=crop_boxes, camera_c2w=base_cams, viewport_size=(crop_w, crop_h),
        viewport_rel_pad=opts.crop_rel_pad,
    )

    def render_view(view_idx):
        crop_cam = crop_cams.index(view_idx)
        # Render directly through the crop camera at SSAA resolution.
        hi_cam = PinholeCamera(
            f=crop_cam.f * ssaa,
            c=(crop_cam.c + 0.5) * ssaa - 0.5,
            T_world_from_eye=crop_cam.T_world_from_eye,
            width=hi_w,
            height=hi_h,
        )
        out = renderer.render_object_model(object_lid, hi_cam)
        mask_hi = np.asarray(out[RenderType.MASK])
        if mask_hi.sum() == 0:
            return None
        # SSAA downsample: area for colour, nearest for depth and mask
        # (reference: scripts/gen_templates.py:372-385).
        color = cv2.resize(np.asarray(out[RenderType.COLOR]), (crop_w, crop_h),
                           interpolation=cv2.INTER_AREA)
        depth = cv2.resize(np.asarray(out[RenderType.DEPTH]), (crop_w, crop_h),
                           interpolation=cv2.INTER_NEAREST)
        mask = cv2.resize(mask_hi, (crop_w, crop_h), interpolation=cv2.INTER_NEAREST)
        return crop_cam, color, depth, mask

    n_workers = opts.render_threads or (os.cpu_count() or 1)
    # Bounded writes: acquiring a slot in the main loop also holds rendering
    # back when encoding or the disk is slower than rendering.
    write_slots = threading.Semaphore(2 * n_workers)

    def write_template(rgb_path, depth_path, mask_path, color, depth, mask):
        try:
            cv2.imwrite(rgb_path, (255.0 * np.clip(color, 0, 1)).astype(np.uint8)[:, :, ::-1])
            save_depth_png(depth_path, depth)
            cv2.imwrite(mask_path, (mask * 255).astype(np.uint8))
        finally:
            write_slots.release()

    metadata_list: List[dict] = []
    template_counter = 0
    timer = Timer(logger=logger)
    timer.start()
    render_pool = ThreadPoolExecutor(n_workers)
    io_pool = ThreadPoolExecutor(n_workers)
    write_futs = []
    pending = deque()
    view_iter = iter(range(num_views))

    def submit_next():
        view_idx = next(view_iter, None)
        if view_idx is not None:
            pending.append((view_idx, render_pool.submit(render_view, view_idx)))

    # At most 2 x workers + 1 views in flight: a full map would hold every
    # rendered frame.
    for _ in range(2 * n_workers + 1):
        submit_next()
    try:
        while pending:
            view_idx, fut = pending.popleft()
            res = fut.result()
            submit_next()
            if res is None:
                logger.info(f"Skipping empty template at view {view_idx}")
                continue
            crop_cam, color, depth, mask = res
            box = boxes[view_idx]
            paths = [os.path.join(output_dir, sub, f"template_{template_counter:04d}.png")
                     for sub in ("rgb", "depth", "mask")]
            write_slots.acquire()
            write_futs.append(io_pool.submit(write_template, *paths, color, depth, mask))
            metadata_list.append(
                {
                    "dataset": opts.object_dataset,
                    "lid": object_lid,
                    "template_id": template_counter,
                    "pose": {"R": np.eye(3).tolist(), "t": np.zeros((3, 1)).tolist()},
                    "boxes_amodal": [[float(box[0]), float(box[1]), float(box[2]),
                                      float(box[3])]],
                    "visibilities": [1.0],
                    "cameras": _camera_json(crop_cam),
                    "rgb_image_path": paths[0],
                    "depth_map_path": paths[1],
                    "binary_mask_path": paths[2],
                    # The mask PNG is exactly (depth > 0): both come from one
                    # rasterization and one nearest-neighbour downsample, so
                    # gen_repre derives the mask from the depth.
                    "mask_is_depth_positive": True,
                }
            )
            template_counter += 1
        for fut in write_futs:
            fut.result()
    finally:
        render_pool.shutdown(wait=False, cancel_futures=True)
        io_pool.shutdown(wait=True, cancel_futures=True)
    timer.elapsed(f"Rendered {template_counter} templates ({n_workers} workers)")

    with open(os.path.join(output_dir, "metadata.json"), "w") as f:
        json.dump(metadata_list, f)
    return metadata_list


def synthesize_templates(opts: GenTemplatesOpts) -> None:
    """Renders the templates of every object of the options (reference:
    scripts/gen_templates.py:70-480)."""
    object_lids = opts.object_lids or bop.OBJECT_IDS.get(opts.object_dataset)
    object_lids = host_shard.shard_keys(object_lids, *host_shard.shard_of(opts))
    models_info = bop.load_models_info(opts.bop_root, opts.object_dataset)
    for lid in object_lids:
        log_heading(logger, f"Object {lid} of {opts.object_dataset}")
        output_dir = os.path.join(opts.output_dir, opts.object_dataset, opts.version, str(lid))
        if os.path.exists(output_dir) and not opts.overwrite:
            if opts.resume and os.path.exists(os.path.join(output_dir, "metadata.json")):
                logger.info(f"Resume: templates exist for object {lid}, skipping.")
                continue
            raise ValueError(f"Output dir exists (overwrite=False): {output_dir}")
        os.makedirs(output_dir, exist_ok=True)
        config_util.save_opts(opts, os.path.join(output_dir, "config.json"))
        mesh = bop.load_object_model(opts.bop_root, opts.object_dataset, lid)
        synthesize_templates_for_object(mesh, models_info.get(lid, {}), opts, lid, output_dir)


def main() -> None:
    synthesize_templates(config_util.load_opts(GenTemplatesOpts))


if __name__ == "__main__":
    main()
