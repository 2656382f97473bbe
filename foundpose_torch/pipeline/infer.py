"""Offline inference CLI: BOP test images -> coarse 6DoF poses -> results
JSON (counterpart of foundpose_tpu/pipeline/infer.py).

    python -m foundpose_torch.pipeline.infer --opts-path configs/infer/lmo.json \\
        --set bop_root=... --set repre_dir=... --set detections_path=... \\
        --set output_dir=...  [--set device=cpu]

Re-design of the reference inference script
(reference: scripts/infer.py:55-827, call stack in SURVEY.md §3.1). The
per-instance Python loop becomes host-side batch assembly plus one call of
the online step per batch:

  host:   detections -> crop boxes -> crop cameras (one batched call on
          CPU tensors per image)
  device: one warp per image (ops/warp), then per batch the online step
          (pipeline/inference.pose_from_crops, or multi_object's)
  host:   EvaluatorPose accumulation -> estimated-poses.json

Instances from many test images batch together, so the device sees a steady
stream of fixed-size batches whatever the detection count of an image. The
step runs on `InferOpts.device` ("cuda" unless the caller asks for "cpu").

With `mesh_shape` the step runs on a device mesh (parallel/sharded_inference),
one process per rank:

    torchrun --nproc-per-node N -m foundpose_torch.pipeline.infer \
        --opts-path configs/infer/lmo.json ... --set mesh_shape=[a,b]

Every rank reads the same images and builds the same batches; global rank 0
alone writes the result files and logs. Not ported: the JAX package's
persistent compile cache, which eager PyTorch has no use for.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from foundpose_torch.cameras import build_crop_cameras
from foundpose_torch.data import bop, detections as det_mod
from foundpose_torch.eval.evaluator import EvaluatorPose
from foundpose_torch.models import weights as weights_mod
from foundpose_torch.ops.warp import make_single_image_warp
from foundpose_torch.parallel import host_shard
from foundpose_torch.parallel import mesh as mesh_mod
from foundpose_torch.parallel import sharded_inference
from foundpose_torch.pipeline import inference
from foundpose_torch.pipeline import multi_object as mo
from foundpose_torch.repre import ObjectRepre, load_repre, stack_repres
from foundpose_torch.structs import PinholeCamera, to_device
from foundpose_torch.utils import config as config_util
from foundpose_torch.utils.logging_util import get_logger, log_heading

logger = get_logger()

# draws_fn(batch_seq) -> RANSAC draws [B, top_n, H, 6] for that batch.
DrawsFn = Callable[[int], Any]


@dataclasses.dataclass(frozen=True)
class InferOpts:
    """(reference: scripts/infer.py:55-100 + configs/infer/lmo.json). The
    JAX package's fields, plus `device`."""

    version: str = "v1"
    repre_version: str = "v1"
    object_dataset: str = "lmo"
    object_lids: Optional[List[int]] = None
    max_sym_disc_step: float = 0.01

    crop: bool = True
    crop_rel_pad: float = 0.2
    crop_size: Tuple[int, int] = (420, 420)

    use_detections: bool = True
    num_preds_factor: float = 1.0
    min_visibility: float = 0.1

    extractor_name: str = (
        "dinov2_version=vits14-reg_stride=14_facet=token_layer=9_norm=1"
    )
    grid_cell_size: float = 14.0
    max_num_queries: int = 1000000
    weights_path: Optional[str] = None

    match_template_type: str = "tfidf"
    match_top_n_templates: int = 5
    match_feat_matching_type: str = "cyclic_buddies"
    match_top_k_buddies: int = 300

    pnp_type: str = "ransac_dlt"
    pnp_ransac_iter: int = 200
    # > 0: template selection at this hypothesis budget, the full
    # pnp_ransac_iter on the winner only (inference.full_budget_winner).
    pnp_select_iter: int = 0
    pnp_required_ransac_conf: float = 0.99
    pnp_inlier_thresh: float = 10.0
    pnp_refine_lm: bool = True
    pnp_lo_iters: int = 2
    refine_featuremetric: bool = False

    final_pose_type: str = "best_coarse"

    # Accepted so the JAX package's configs load; no effect: the unfused
    # block always runs its attention through ops/attention
    # (inference.vit_config_from_opts).
    use_pallas_attention: bool = False
    use_fused_block: bool = False
    approx_gelu: bool = False
    approx_topk: bool = False
    compute_dtype: str = "float32"
    # Mixed-object batching through one stacked repre (pipeline/multi_object).
    multi_object: bool = False

    batch_size: int = 16
    save_estimates: bool = True
    vis_results: bool = False
    vis_count: int = 10
    vis_corresp_top_n: int = 100
    vis_feat_map: bool = True
    vis_for_paper: bool = True
    # Skip objects whose estimated-poses.json already exists.
    resume: bool = False
    debug: bool = False

    # Host-level dataset sharding (parallel/host_shard.py): this process
    # handles every shard_count-th (scene, image) key and writes
    # shard-suffixed artifacts, which prepare_bop_submission merges.
    # shard_count=0 resolves from torch.distributed (to (0, 1) under a
    # mesh: see shard_of).
    shard_index: int = 0
    shard_count: int = 1

    # Device mesh (data, bank) or (data, bank, model) of the initialized
    # process group (parallel/mesh.py); None runs on one device.
    mesh_shape: Optional[Tuple[int, ...]] = None

    # `vit_overrides` patches fields of the parsed DinoV2Config (e.g. a tiny
    # test ViT); `dataset_crop_size` overrides the dataset's center crop.
    vit_overrides: Optional[Dict[str, Any]] = None
    dataset_crop_size: Optional[Tuple[int, int]] = None

    bop_root: str = ""
    repre_dir: str = ""
    detections_path: str = ""
    output_dir: str = ""

    # "cuda" or "cpu": where the ViT, the representations and the step run.
    device: str = "cuda"


@dataclasses.dataclass
class PendingInstance:
    """Host-side record for one detection crop awaiting the batched step."""

    scene_id: int
    im_id: int
    inst_id: int
    obj_id: int
    det_score: float
    det_time: float
    orig_camera: PinholeCamera
    crop_camera: PinholeCamera
    crop_image: np.ndarray
    crop_mask: np.ndarray
    gt: Optional[bop.GtAnnotation]
    times: Dict[str, float]
    # Detection-vs-GT visible-mask IoU in the original image.
    mask_iou: Optional[float] = None


def prepare_instance_crops(
    sample: bop.Sample,
    instances: List[det_mod.Detection],
    opts: InferOpts,
    warp_batch,
) -> List[PendingInstance]:
    """Builds crop cameras + warped crops for all detections of one image.

    The crop cameras come from one batched build_crop_cameras call on CPU
    tensors; the image is warped into all of them at once on opts.device and
    the uint8 crops and masks come back to the host. The JAX package pads
    the detection count to a multiple of 8 to bound its jit compiles; eager
    PyTorch compiles nothing, so nothing is padded here."""
    if not instances:
        return []
    h, w = sample.image.shape[:2]
    # uint8 end to end: the warp re-quantizes its f32 result to uint8 (as
    # the reference's cv2.remap on uint8) and the step normalizes on device.
    if sample.image.dtype == np.uint8:
        # torch takes writable memory only (a decoded PNG's array is not).
        image = sample.image if sample.image.flags.writeable else sample.image.copy()
    else:
        # Float images in [0, 1] or [0, 255], rounded as the warp rounds.
        imf = np.asarray(sample.image, dtype=np.float32)
        if imf.size and float(imf.max()) > 1.0:
            imf = imf / 255.0
        image = np.clip(np.round(imf * 255.0), 0, 255).astype(np.uint8)

    t0 = time.perf_counter()
    half_image = 0.5 * h * w
    # Skip degenerate detections covering more than half of the image
    # (reference: scripts/infer.py:389-393).
    kept = [d for d in instances if d.mask is None or d.mask.sum() <= half_image]
    if not kept:
        return []
    orig_cam = PinholeCamera.from_intrinsic_matrix(sample.K, width=w, height=h)
    cams = build_crop_cameras(
        orig_cam,
        torch.as_tensor(np.stack([d.box_xyxy for d in kept]), dtype=torch.float32),
        viewport_size=opts.crop_size,
        viewport_rel_pad=opts.crop_rel_pad,
    )
    masks = np.stack([
        (d.mask > 0).astype(np.uint8) if d.mask is not None else np.ones((h, w), np.uint8)
        for d in kept
    ])
    dev = torch.device(opts.device)
    crops, crop_masks = warp_batch(
        torch.from_numpy(image).to(dev), torch.from_numpy(masks).to(dev),
        orig_cam.to(dev), cams.to(dev),
    )
    crop_images = crops.cpu().numpy()
    crop_masks = crop_masks.cpu().numpy()
    prep_time = (time.perf_counter() - t0) / len(kept)

    out = []
    for i, det in enumerate(kept):
        gt = None
        mask_iou = None
        if sample.gt:
            matching = [g for g in sample.gt if g.obj_id == det.obj_id]
            idx = det_mod.associate_gt_by_iou(det.box_xyxy, [g.box_amodal for g in matching])
            if idx >= 0:
                gt = matching[idx]
                if det.mask is not None and gt.mask_visib is not None:
                    m1 = det.mask > 0
                    m2 = gt.mask_visib > 0
                    union = np.logical_or(m1, m2).sum()
                    if union > 0:
                        mask_iou = float(np.logical_and(m1, m2).sum() / union)
        out.append(
            PendingInstance(
                scene_id=sample.scene_id,
                im_id=sample.im_id,
                inst_id=i,
                obj_id=det.obj_id,
                det_score=det.score,
                det_time=det.time,
                orig_camera=orig_cam,
                crop_camera=cams.index(i),
                crop_image=crop_images[i],
                crop_mask=crop_masks[i],
                gt=gt,
                times={"prep": prep_time},
                mask_iou=mask_iou,
            )
        )
    return out


def stack_batch(padded: List[PendingInstance], device) -> Tuple[torch.Tensor, torch.Tensor,
                                                                PinholeCamera]:
    """Crops [B, h, w, 3], masks [B, h, w] and crop cameras [B] of a padded
    batch, stacked on the host and copied to `device` (structs.to_device:
    on the card without a host sync)."""
    dev = torch.device(device)
    cams = [p.crop_camera for p in padded]
    return (
        to_device(np.stack([p.crop_image for p in padded]), dev),
        to_device(np.stack([p.crop_mask for p in padded]), dev),
        PinholeCamera(
            f=to_device(torch.stack([c.f for c in cams]), dev),
            c=to_device(torch.stack([c.c for c in cams]), dev),
            T_world_from_eye=to_device(torch.stack([c.T_world_from_eye for c in cams]), dev),
            width=cams[0].width, height=cams[0].height,
        ),
    )


def dispatch_batch(
    model: torch.nn.Module,
    repre: ObjectRepre,
    config: inference.InferenceConfig,
    padded: List[PendingInstance],
    seq: int,
    device,
    draws_fn: Optional[DrawsFn] = None,
    obj_to_idx: Optional[Dict[int, int]] = None,
    mesh_step=None,
) -> inference.PoseOutputs:
    """Issues the online step on one padded batch without waiting for the
    device. Batch `seq` draws its RANSAC hypotheses from
    torch.Generator(device).manual_seed(seq) (the JAX package's
    PRNGKey(seq)), or takes them from draws_fn(seq). With obj_to_idx,
    `repre` is the stacked multi-object repre and crop i uses object
    obj_to_idx[obj_id of crop i]. With `mesh_step` (parallel/
    sharded_inference), the batch goes through it and `model` is the ViT
    as the mesh step takes it; `repre` is then unused."""
    dev = torch.device(device)
    crops, masks, cams = stack_batch(padded, dev)
    gen = torch.Generator(device=dev).manual_seed(seq)
    draws = None if draws_fn is None else to_device(draws_fn(seq), dev)
    obj_idx = None
    if obj_to_idx is not None:
        obj_idx = to_device(np.asarray([obj_to_idx[p.obj_id] for p in padded], np.int64), dev)
    if mesh_step is not None:
        args = () if obj_idx is None else (obj_idx,)
        return mesh_step(model, crops, masks, cams, *args, generator=gen, draws=draws)
    if obj_to_idx is None:
        return inference.pose_from_crops(
            model, crops, masks, cams, repre, config, generator=gen, draws=draws
        )
    return mo.pose_from_crops_multi(
        model, crops, masks, cams, obj_idx, repre, config, generator=gen, draws=draws
    )


class HostFetch:
    """A batch's PoseOutputs on their way to the host. The copies are issued
    when the batch is dispatched (non_blocking, into pinned memory on the
    card; bf16 fields widened to f32 on the device first) and one event is
    recorded behind them, so wait() synchronizes once per batch and waits
    for this batch's copies only, not for batches dispatched after it."""

    def __init__(self, out: inference.PoseOutputs):
        self._fields = {}
        self._event = None
        for f in dataclasses.fields(out):
            v = getattr(out, f.name)
            if v.is_floating_point() and v.dtype != torch.float32:
                v = v.float()
            self._fields[f.name] = v.to("cpu", non_blocking=True)
            if v.is_cuda and self._event is None:
                self._event = torch.cuda.Event()
                self._stream = torch.cuda.current_stream(v.device)
        if self._event is not None:
            self._event.record(self._stream)

    def wait(self) -> SimpleNamespace:
        """The fields as numpy arrays, by the PoseOutputs field names."""
        if self._event is not None:
            self._event.synchronize()
        return SimpleNamespace(**{k: v.numpy() for k, v in self._fields.items()})


def _unpack_result(out_np, i: int) -> Dict[str, Any]:
    """One instance's result dict from a fetched batch output (shared by the
    single-object and multi-object entry points)."""
    return {
        "success": bool(out_np.success[i]),
        "R_m2w": out_np.R_m2w[i],
        "t_m2w": out_np.t_m2w[i],
        "R_m2c": out_np.R_m2c[i],
        "t_m2c": out_np.t_m2c[i],
        "quality": float(out_np.quality[i]),
        "score": float(out_np.score[i]),
        "best_template": int(out_np.best_template[i]),
        "num_queries": float(out_np.num_queries[i]),
        "template_ids": out_np.template_ids[i],
        "template_scores": out_np.template_scores[i],
        "corresp_2d": out_np.best_corresp_2d[i],
        "corresp_2d_ids": out_np.best_corresp_2d_ids[i],
        "corresp_3d": out_np.best_corresp_3d[i],
        "corresp_conf": out_np.best_corresp_conf[i],
        "corresp_valid": out_np.best_corresp_valid[i],
    }


class BatchRunner:
    """Streaming dispatcher: keeps up to `max_in_flight` dispatched batches
    un-fetched, so the device works on earlier batches while the host
    decodes, warps and stacks later images (CUDA work is queued
    asynchronously). Host memory stays bounded: at most (max_in_flight + 1)
    batches of pendings are alive at once.

    Usage: push(instances) after each image; results() to flush + collect.
    """

    def __init__(self, batch_size: int, dispatch_one, max_in_flight: int = 4):
        self.batch_size = batch_size
        self.dispatch_one = dispatch_one
        self.max_in_flight = max_in_flight
        self._buffer: List[PendingInstance] = []
        self._in_flight: List[Tuple[List[PendingInstance], HostFetch]] = []
        self._results: List[Tuple[PendingInstance, Dict[str, Any]]] = []
        self._seq = 0
        # Wall spent inside dispatch + fetch only (the reference's per-stage
        # semantics, scripts/infer.py:636-645): decode and crop prep are
        # recorded separately as times['prep'].
        self._busy_s = 0.0

    def _fetch_oldest(self) -> None:
        chunk, fetch = self._in_flight.pop(0)
        t0 = time.perf_counter()
        out_np = fetch.wait()
        self._busy_s += time.perf_counter() - t0
        for i, p in enumerate(chunk):
            self._results.append((p, _unpack_result(out_np, i)))

    def _dispatch(self, chunk: List[PendingInstance]) -> None:
        padded = chunk + [chunk[-1]] * (self.batch_size - len(chunk))
        t0 = time.perf_counter()
        fetch = HostFetch(self.dispatch_one(self._seq, padded))
        self._busy_s += time.perf_counter() - t0
        self._in_flight.append((chunk, fetch))
        self._seq += 1
        while len(self._in_flight) > self.max_in_flight:
            self._fetch_oldest()

    def push(self, instances: List[PendingInstance]) -> None:
        self._buffer.extend(instances)
        while len(self._buffer) >= self.batch_size:
            self._dispatch(self._buffer[: self.batch_size])
            self._buffer = self._buffer[self.batch_size :]

    def results(self) -> List[Tuple[PendingInstance, Dict[str, Any]]]:
        """Flushes the remainder batch + all in-flight work and returns every
        (instance, result) pair pushed so far."""
        if self._buffer:
            self._dispatch(self._buffer)
            self._buffer = []
        while self._in_flight:
            self._fetch_oldest()
        # Per-instance share of the dispatch+fetch wall (per-batch timing is
        # meaningless once dispatch is asynchronous).
        if self._results:
            step_time = self._busy_s / len(self._results)
            for p, _ in self._results:
                p.times["pipeline"] = step_time
        return self._results


def _iter_samples_prefetched(image_keys, load_fn, depth: int = 2):
    """Background-thread sample loader: decodes image i+1..i+depth while the
    main thread preps and dispatches image i. `load_fn` must not touch
    CUDA: the main thread alone warps, stacks, copies and dispatches.
    Exceptions in the loader re-raise in the consumer.

    Abandoning the generator (consumer exception, early break, GC) stops the
    worker: the blocking q.put is a bounded-timeout loop on a stop flag, so
    no thread (or the decoded images it holds) outlives the consumer by
    more than the timeout."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for im_key in image_keys:
                if not put((im_key, load_fn(*im_key))):
                    return
        except BaseException as e:
            put((sentinel, e))
            return
        put((sentinel, None))

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            im_key, val = q.get()
            if im_key is sentinel:
                if val is not None:
                    raise val
                return
            yield im_key, val
    finally:
        # Runs on normal exhaustion AND on generator close/abandonment;
        # the worker exits at its next put.
        stop.set()


def save_visualization(
    p: PendingInstance,
    r: Dict[str, Any],
    repre: ObjectRepre,
    renderer,
    obj_id: int,
    out_path: str,
    max_corresp: int = 100,
    inlier_radius: float = 10.0,
) -> None:
    """Saves the per-estimate tile grid (reference: scripts/infer.py:746-802)."""
    from PIL import Image

    from foundpose_torch.eval.evaluator import _project_points
    from foundpose_torch.vis import inference_vis

    est_mask = None
    pose_overlay = None
    if renderer is not None:
        est_mask = inference_vis.render_pose_mask(
            renderer, obj_id, p.crop_camera, r["R_m2c"], r["t_m2c"]
        )
        pose_overlay = inference_vis.render_pose_overlay(
            renderer, obj_id, p.crop_camera, r["R_m2c"], r["t_m2c"], p.crop_image,
        )

    # Template-side 2D points: the matched 3D points projected into the
    # winning template's camera.
    valid = r["corresp_valid"].astype(bool)
    tid = r["best_template"]
    if repre.templates is not None:
        tpl_img = np.transpose(np.asarray(repre.templates[tid]), (1, 2, 0))
    else:
        tpl_img = np.zeros((p.crop_image.shape[0], p.crop_image.shape[1], 3), dtype=np.uint8)
    cam_t = repre.template_cameras.index(tid).to("cpu")
    tpl_2d = cam_t.world_to_window(torch.as_tensor(r["corresp_3d"])).numpy()

    # Inlier/outlier mask of the shown correspondences under the estimated
    # pose, in the crop camera.
    proj = _project_points(
        np.asarray(r["R_m2c"]), np.asarray(r["t_m2c"]),
        np.asarray(r["corresp_3d"], dtype=np.float64),
        p.crop_camera.f.numpy().astype(np.float64),
        p.crop_camera.c.numpy().astype(np.float64),
    )
    dist = np.linalg.norm(proj - np.asarray(r["corresp_2d"]), axis=1)
    inlier_mask = (dist <= inlier_radius)[valid][:max_corresp]

    grid = inference_vis.vis_inference_results(
        p.crop_image,
        p.crop_mask,
        tpl_img,
        r["corresp_2d"][valid][:max_corresp],
        tpl_2d[valid][:max_corresp],
        r["corresp_conf"][valid][:max_corresp],
        est_mask=est_mask,
        caption=f"s{p.scene_id} im{p.im_id} q={r['quality']:.0f} score={r['score']:.2f}",
        max_corresp=max_corresp,
        inlier_mask=inlier_mask,
        pose_overlay=pose_overlay,
    )
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    Image.fromarray(grid).save(out_path)


def finalize_object_results(
    opts: InferOpts,
    lid: int,
    results: List[Tuple[PendingInstance, Dict[str, Any]]],
    repre: ObjectRepre,
    model,
    evaluator: EvaluatorPose,
    pts: np.ndarray,
    sym_r: np.ndarray,
    sym_t: np.ndarray,
    diameter: Optional[float],
) -> None:
    """Visualization, evaluator accumulation, and output files for ONE object,
    shared by the single- and multi-object entry points: tile grids + error PLYs
    + histograms (reference: scripts/infer.py:746-802), evaluator
    accumulation including the retrieved-template orientation error
    (reference: utils/eval_util.py:175-188), estimated-poses.json + metric
    tables + HTML gallery (reference: scripts/infer.py:813-816,
    utils/eval_util.py:400-590)."""
    # Run-level files carry the shard suffix (concurrent shards would
    # clobber them); per-instance tiles are keyed by (scene, image, inst).
    si, sc = shard_of(opts)
    sname = lambda base: host_shard.sharded_name(base, si, sc)

    vis_images = []
    if opts.vis_results:
        from PIL import Image

        from foundpose_torch.renderer.base import RendererType, build as build_renderer
        from foundpose_torch.vis.base import draw_histogram
        from foundpose_torch.vis.inference_vis import vis_pointcloud_error

        renderer = build_renderer(RendererType.SOFTWARE_RASTERIZER)
        renderer.add_object_model(lid, model)
        vis_dir = os.path.join(opts.output_dir, opts.object_dataset, opts.version, str(lid), "vis")
        # Created up front: score_hist.png below writes here even when no
        # tile grid was saved.
        os.makedirs(vis_dir, exist_ok=True)
        for p, r in results[: opts.vis_count]:
            if not r["success"]:
                continue
            path = os.path.join(vis_dir, f"s{p.scene_id}_im{p.im_id}_i{p.inst_id}.png")
            save_visualization(
                p, r, repre, renderer, lid, path,
                max_corresp=opts.vis_corresp_top_n, inlier_radius=opts.pnp_inlier_thresh,
            )
            vis_images.append((r, path))
            if p.gt is not None:
                # GT-vs-estimate vertex point cloud in the original camera
                # frame (reference: utils/vis_util.py:78-124).
                t_w2oc = np.linalg.inv(p.orig_camera.T_world_from_eye.numpy())
                m2w = np.eye(4)
                m2w[:3, :3] = np.asarray(r["R_m2w"])
                m2w[:3, 3] = np.asarray(r["t_m2w"]).flatten()
                m2oc = t_w2oc @ m2w
                vis_pointcloud_error(
                    pts, m2oc[:3, :3], m2oc[:3, 3], p.gt.R_m2c, p.gt.t_m2c,
                    os.path.join(vis_dir, f"s{p.scene_id}_im{p.im_id}_i{p.inst_id}_error.ply"),
                )
        scores = [r["score"] for _, r in results if r["success"]]
        if scores:
            Image.fromarray(draw_histogram(np.asarray(scores), title="score")).save(
                os.path.join(vis_dir, sname("score_hist.png"))
            )

    cam_t_np = repre.template_cameras.T_world_from_eye.cpu().numpy()
    for p, r in results:
        if not r["success"]:
            continue
        # Orientations (model->camera) of all retrieved templates, for the
        # template-orientation-error accumulator.
        tpl_r_m2c = None
        if p.gt is not None:
            tids = np.asarray(r["template_ids"], dtype=int).reshape(-1)
            tids = tids[(tids >= 0) & (tids < cam_t_np.shape[0])]
            if tids.size:
                tpl_r_m2c = np.stack([np.linalg.inv(cam_t_np[tid])[:3, :3] for tid in tids])
        evaluator.update(
            scene_id=p.scene_id, im_id=p.im_id, inst_id=p.inst_id,
            hypothesis_id=0, obj_id=p.obj_id,
            R_m2w=r["R_m2w"], t_m2w=r["t_m2w"],
            orig_camera_c2w=p.orig_camera,
            score=r["score"],
            time_per_inst=p.times,
            R_gt_m2c=p.gt.R_m2c if p.gt else None,
            t_gt_m2c=p.gt.t_m2c if p.gt else None,
            model_pts=pts if p.gt else None,
            sym_r=sym_r if p.gt else None,
            sym_t=sym_t if p.gt else None,
            K=p.orig_camera.K.numpy() if p.gt else None,
            camera_c2w=p.crop_camera,
            corresp={
                "coord_2d": r["corresp_2d"],
                "coord_2d_ids": r["corresp_2d_ids"],
                "coord_3d": r["corresp_3d"],
                "valid": r["corresp_valid"],
            },
            object_diameter=diameter,
            retrieved_template_R_m2c=tpl_r_m2c,
            mask_iou=p.mask_iou,
            inlier_radius=opts.pnp_inlier_thresh,
        )

    if opts.save_estimates:
        out_dir = os.path.join(opts.output_dir, opts.object_dataset, opts.version, str(lid))
        os.makedirs(out_dir, exist_ok=True)
        name = lambda base: os.path.join(out_dir, sname(base))
        config_util.save_opts(opts, name("config.json"))
        evaluator.save_results_json(name("estimated-poses.json"))
        evaluator.save_metrics_tsv(name("metrics.tsv"))
        # Reference-layout per-object metric table (utils/eval_util.py:400-516).
        evaluator.save_metrics(name("metrics-table.tsv"), inlier_thresh=opts.pnp_inlier_thresh)
        # Best/worst gallery over the visualized estimates
        # (reference: utils/eval_util.py:518-590).
        if vis_images:
            from PIL import Image

            from foundpose_torch.vis.html_report import write_gallery

            recs = [{"score": r["score"], "quality": r["quality"]} for r, _ in vis_images]
            imgs = [np.asarray(Image.open(path)) for _, path in vis_images]
            write_gallery(name("report.html"), recs, imgs, metric_key="score",
                          top_n=min(10, len(recs)))
    logger.info(f"Summary for object {lid}: {evaluator.summary()}")


def shard_of(opts: InferOpts) -> Tuple[int, int]:
    """This process's dataset shard (parallel/host_shard.resolve_shard).
    Under a mesh the whole process group is one mesh, so shard_count=0
    resolves to (0, 1), as the JAX package's single-process mesh does;
    explicit values compose with the mesh, one launch per shard."""
    if opts.mesh_shape and opts.shard_count == 0:
        if opts.shard_index:
            raise ValueError(f"shard_index={opts.shard_index} with shard_count=0 (auto): pass "
                             "an explicit shard_count")
        return 0, 1
    return host_shard.shard_of(opts)


def _build_mesh(opts: InferOpts):
    """The device mesh of opts.mesh_shape over the initialized process
    group; its data axis must divide batch_size."""
    data = opts.mesh_shape[0]
    if opts.batch_size % data:
        raise ValueError(f"the data axis ({data}) of mesh_shape={opts.mesh_shape} must "
                         f"divide batch_size={opts.batch_size}")
    mesh = mesh_mod.make_mesh(opts.mesh_shape)
    if dist.get_rank() != 0:
        logger.setLevel(logging.WARNING)  # rank 0 alone logs
    logger.info(f"Device mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
                f"{dist.get_world_size()} ranks ({dist.get_backend()})")
    return mesh


def _setup(opts: InferOpts):
    """(mesh or None, this process's device, the ViT as the step takes it,
    the step's configuration, whether this process writes the results)."""
    mesh = _build_mesh(opts) if opts.mesh_shape else None
    device = mesh_mod.compute_device(opts.device) if mesh else torch.device(opts.device)
    model, config = load_model(opts, device)
    if mesh is None:
        return None, device, model, config, True
    params = sharded_inference.prepare_mesh_vit_params(mesh, model)
    return mesh, device, params, config, dist.get_rank() == 0


def load_model(opts: InferOpts, device) -> Tuple[torch.nn.Module, inference.InferenceConfig]:
    """The ViT on `device` and the step's configuration, both resolved from
    the options by pipeline/inference (one mapping from options to
    configuration). Without weights_path the ViT gets bench_weights' random
    weights from seed 0, as PoseEngine."""
    o = dataclasses.asdict(opts)
    vit_cfg = inference.vit_config_from_opts(o)
    if not opts.weights_path:
        logger.warning("No ViT weights_path given; using random init.")
    model = weights_mod.load_or_init(vit_cfg, opts.weights_path)
    return model.to(device), inference.inference_config_from_opts(o)


def _object_meta(opts: InferOpts, models_info, lid: int):
    """(mesh, up to 1000 model points, symmetry R [S, 3, 3], symmetry t
    [S, 3], diameter or None) of object `lid`."""
    model = bop.load_object_model(opts.bop_root, opts.object_dataset, lid)
    info = models_info.get(lid, {})
    syms = bop.get_symmetry_transformations(info, opts.max_sym_disc_step)
    pts = model.vertices
    if len(pts) > 1000:
        pts = pts[np.linspace(0, len(pts) - 1, 1000).astype(int)]
    return (
        model, pts,
        np.stack([s["R"] for s in syms]).astype(np.float32),
        np.stack([np.asarray(s["t"]).flatten() for s in syms]).astype(np.float32),
        float(info["diameter"]) if "diameter" in info else None,
    )


def _detections_for(opts: InferOpts, sample, lid: int, dets, evaluator: EvaluatorPose):
    """The detections of object `lid` in one image: the image's CNOS
    detections, or with use_detections=False its GT boxes and masks
    (reference: infer_pose_util.py:140-149)."""
    scene_id, im_id = sample.scene_id, sample.im_id
    if opts.use_detections:
        gt_count = sum(1 for g in sample.gt if g.obj_id == lid)
        max_preds = max(1, int(opts.num_preds_factor * max(gt_count, 1)))
        instances = det_mod.instances_for_pose_estimation(
            dets, max_num_preds=max_preds, crop_offset=sample.crop_offset,
            image_size=(sample.image.shape[1], sample.image.shape[0]),
        )
        for det in instances:
            evaluator.detection_times[(scene_id, im_id)] = det.time
        return instances
    instances = [
        det_mod.Detection(
            scene_id=scene_id, im_id=im_id, obj_id=lid, score=1.0,
            box_xyxy=np.asarray(g.box_amodal), mask=g.mask_visib, time=0.0,
        )
        for g in sample.gt
        if g.obj_id == lid and g.visib_fract >= opts.min_visibility and g.box_amodal is not None
    ]
    return instances


def _repre_dir(opts: InferOpts, lid: int) -> str:
    return os.path.join(opts.repre_dir, opts.object_dataset, opts.repre_version, str(lid))


def _load_cast(opts: InferOpts, lid: int, device, dtype: torch.dtype) -> ObjectRepre:
    """Object `lid`'s representation on `device`, its banks cast to `dtype`."""
    repre = load_repre(_repre_dir(opts, lid), device=device)
    return repre if dtype == torch.float32 else repre.cast_banks(dtype)


def load_stacked(opts: InferOpts, object_lids: List[int], device, dtype: torch.dtype):
    """(the objects' representations stacked (stack_repres), their banks in
    `dtype`; per object what finalize_object_results reads of its own:
    the template cameras and images).

    Each representation is cast as it is loaded, and the per-object banks
    are freed before this returns, so the card holds the stacked banks
    once: ~0.43 GB an LM-O-scale object in bf16, where loading all in f32,
    stacking and then casting held ~2.1 GB an object at its peak. Zero
    padding casts to zero, so the stack equals the cast of the f32 stack
    bit for bit."""
    repres = [_load_cast(opts, lid, device, dtype) for lid in object_lids]
    views = {lid: SimpleNamespace(template_cameras=r.template_cameras, templates=r.templates)
             for lid, r in zip(object_lids, repres)}
    return stack_repres(repres), views


def _sample_loader(opts: InferOpts):
    def load_sample(scene_id, im_id):
        return bop.prepare_sample(
            opts.bop_root, opts.object_dataset, scene_id, im_id,
            load_gt=True, load_masks=not opts.use_detections,
            crop_size=opts.dataset_crop_size,
        )

    return load_sample


def infer(opts: InferOpts, *, draws_fn: Optional[DrawsFn] = None) -> Dict[int, int]:
    """Runs inference object by object; returns {object_lid: instances
    processed} (estimates written may be fewer: only successful solves are
    serialized, reference: scripts/infer.py:813-816). draws_fn(seq), when
    given, supplies batch seq's RANSAC draws [B, top_n, H, 6] (e.g. the JAX
    package's, to compare the two). Under a mesh every rank of the process
    group calls it with the same options."""
    mesh, device, model, config, writer = _setup(opts)
    warp_batch = make_single_image_warp(opts.crop_size)

    all_dets = det_mod.load_detections(opts.detections_path) if opts.use_detections else {}
    models_info = bop.load_models_info(opts.bop_root, opts.object_dataset)
    object_lids = opts.object_lids or bop.OBJECT_IDS.get(opts.object_dataset, [])

    # Host-level dataset sharding: this process handles image_keys[si::sc]
    # and its resume/output files carry the shard suffix.
    si, sc = shard_of(opts)
    if sc > 1:
        logger.info(f"Dataset shard {si}/{sc} (host-level round-robin).")

    counts: Dict[int, int] = {}
    for lid in object_lids:
        log_heading(logger, f"Inference for object {lid} of {opts.object_dataset}")
        out_json = os.path.join(
            opts.output_dir, opts.object_dataset, opts.version, str(lid),
            host_shard.sharded_name(host_shard.POSES_BASENAME, si, sc),
        )
        if opts.resume and os.path.exists(out_json):
            logger.info(f"Resume: results exist for object {lid}, skipping.")
            continue
        repre = _load_cast(opts, lid, device, config.compute_dtype)
        evaluator = EvaluatorPose([lid])
        model_mesh, pts, sym_r, sym_t, diameter = _object_meta(opts, models_info, lid)
        mesh_step = (None if mesh is None
                     else sharded_inference.make_object_mesh_step(mesh, config, repre))

        runner = BatchRunner(
            opts.batch_size,
            lambda s, padded: dispatch_batch(model, repre, config, padded, s, device, draws_fn,
                                             mesh_step=mesh_step),
        )
        # (scene, image) pairs: from detections, or every test image when
        # use_detections=False. The same ordered list on every host, so the
        # round-robin shard is consistent across processes.
        if opts.use_detections:
            image_keys = [(s, i) for s, i, _ in sorted(k for k in all_dets if k[2] == lid)]
        else:
            image_keys = [
                (s, i)
                for s in bop.list_scenes(opts.bop_root, opts.object_dataset)
                for i in bop.list_images(opts.bop_root, opts.object_dataset, s)
            ]
        image_keys = host_shard.shard_keys(image_keys, si, sc)
        for (scene_id, im_id), sample in _iter_samples_prefetched(image_keys, _sample_loader(opts)):
            instances = _detections_for(opts, sample, lid, all_dets.get((scene_id, im_id, lid)),
                                        evaluator)
            if not opts.use_detections:
                evaluator.detection_times[(scene_id, im_id)] = 0.0
            # Batches go to the device as they fill; results are fetched
            # only several batches later.
            runner.push(prepare_instance_crops(sample, instances, opts, warp_batch))

        results = runner.results()
        logger.info(f"{len(results)} instances processed for object {lid}")
        counts[lid] = len(results)
        if not results:
            # Unsharded: write nothing (an empty estimated-poses.json would
            # make resume=True treat a failed object as completed). Sharded:
            # an empty shard is a legitimate outcome, marked done by the
            # host_shard sentinel.
            if sc > 1 and opts.save_estimates and writer:
                host_shard.write_empty_shard_sentinel(os.path.dirname(out_json), si, sc)
            continue
        if writer:
            finalize_object_results(
                opts, lid, results, repre, model_mesh, evaluator, pts, sym_r, sym_t, diameter,
            )
    return counts


def infer_multi_object(opts: InferOpts, *, draws_fn: Optional[DrawsFn] = None) -> Dict[int, int]:
    """Mixed-object inference: all objects share batches through one stacked
    multi-object repre (pipeline/multi_object.py). One pass over the test
    images instead of the reference's per-object loop."""
    mesh, device, model, config, writer = _setup(opts)
    warp_batch = make_single_image_warp(opts.crop_size)

    all_dets = det_mod.load_detections(opts.detections_path) if opts.use_detections else {}
    models_info = bop.load_models_info(opts.bop_root, opts.object_dataset)
    object_lids = opts.object_lids or bop.OBJECT_IDS.get(opts.object_dataset, [])

    multi_repre, views = load_stacked(opts, object_lids, device, config.compute_dtype)
    obj_to_idx = {lid: i for i, lid in enumerate(object_lids)}
    evaluators = {lid: EvaluatorPose([lid]) for lid in object_lids}
    obj_meta = {lid: _object_meta(opts, models_info, lid) for lid in object_lids}

    if opts.use_detections:
        image_keys = sorted({(s, i) for (s, i, c) in all_dets if c in obj_to_idx})
    else:
        image_keys = [
            (s, i)
            for s in bop.list_scenes(opts.bop_root, opts.object_dataset)
            for i in bop.list_images(opts.bop_root, opts.object_dataset, s)
        ]
    si, sc = shard_of(opts)
    if sc > 1:
        logger.info(f"Dataset shard {si}/{sc} (host-level round-robin).")
    image_keys = host_shard.shard_keys(image_keys, si, sc)
    mesh_step = None
    if mesh is not None:
        mesh_step, _ = sharded_inference.make_multi_object_mesh_step(mesh, config, multi_repre)

    runner = BatchRunner(
        opts.batch_size,
        lambda s, padded: dispatch_batch(model, multi_repre, config, padded, s, device,
                                         draws_fn, obj_to_idx, mesh_step),
    )
    for (scene_id, im_id), sample in _iter_samples_prefetched(image_keys, _sample_loader(opts)):
        for lid in object_lids:
            if opts.use_detections:
                dets = all_dets.get((scene_id, im_id, lid))
                if not dets:
                    continue
                instances = _detections_for(opts, sample, lid, dets, evaluators[lid])
            else:
                instances = _detections_for(opts, sample, lid, None, evaluators[lid])
                if not instances:
                    continue
                evaluators[lid].detection_times[(scene_id, im_id)] = 0.0
            runner.push(prepare_instance_crops(sample, instances, opts, warp_batch))
    results = runner.results()
    logger.info(f"{len(results)} instances processed over {len(object_lids)} objects")

    results_by_lid: Dict[int, List[Tuple[PendingInstance, Dict[str, Any]]]] = {
        lid: [] for lid in object_lids
    }
    for p, r in results:
        results_by_lid[p.obj_id].append((p, r))
    for lid in object_lids:
        # As the single-object entry point: an object with no instances writes
        # nothing unsharded, and its shard sentinel when sharded.
        if not writer:
            continue
        if not results_by_lid[lid]:
            if sc > 1 and opts.save_estimates:
                host_shard.write_empty_shard_sentinel(
                    os.path.join(opts.output_dir, opts.object_dataset, opts.version, str(lid)),
                    si, sc,
                )
            continue
        model_mesh, pts, sym_r, sym_t, diameter = obj_meta[lid]
        finalize_object_results(
            opts, lid, results_by_lid[lid], views[lid], model_mesh, evaluators[lid],
            pts, sym_r, sym_t, diameter,
        )
    return {lid: len(results_by_lid[lid]) for lid in object_lids}


def main() -> None:
    opts = config_util.load_opts(InferOpts)
    own_group = bool(opts.mesh_shape) and not dist.is_initialized()
    if own_group:
        mesh_mod.init_from_env(opts.device)
    try:
        if opts.multi_object:
            infer_multi_object(opts)
        else:
            infer(opts)
    finally:
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
