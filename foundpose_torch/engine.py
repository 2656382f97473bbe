"""PoseEngine: the in-process serving API (counterpart of
foundpose_tpu/engine.py).

The engine keeps the ViT and any number of object representations on one
device and serves `estimate()` calls: a full image with detection boxes
(and optional masks) in, camera-frame poses out. Each call builds the crop
cameras of its boxes on the host in one batched call, warps the image into
them on the device, runs the online step in chunks padded to `batch_size`
by repeating the last detection, and fetches each chunk's results as one
packed [B, 16] array. `estimate_mixed()` serves detections of different
objects through the stacked multi-object step.

With `mesh_shape` the engine serves from a device mesh
(parallel/sharded_inference): every rank of an initialized process group
of prod(mesh_shape) ranks builds the engine and calls it with the same
arguments, and every rank gets the same results. Not ported: the JAX
engine's single-program fusion and jit caches, which eager PyTorch has no
use for. RANSAC draws come from a torch.Generator seeded from `seed`.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from foundpose_torch.cameras import build_crop_cameras
from foundpose_torch.models import dinov2
from foundpose_torch.models.weights import load_or_init
from foundpose_torch.ops.warp import make_single_image_warp
from foundpose_torch.parallel import mesh as mesh_mod
from foundpose_torch.parallel import sharded_inference
from foundpose_torch.pipeline import inference
from foundpose_torch.pipeline.multi_object import pose_from_crops_multi
from foundpose_torch.repre import ObjectRepre, stack_repres
from foundpose_torch.structs import PinholeCamera


class PoseEngine:
    # Bound on cached per-object mesh steps: each pins its padded bank shard
    # in device memory, so serving that rotates through many objects would
    # otherwise grow without bound.
    max_cached_mesh_steps = 8

    def __init__(
        self,
        extractor_name: str = "dinov2_version=vits14-reg_stride=14_facet=token_layer=9_norm=1",
        weights_path: Optional[str] = None,
        config: Optional[inference.InferenceConfig] = None,
        batch_size: int = 16,
        seed: int = 0,
        extractor_overrides: Optional[Dict[str, Any]] = None,
        mesh_shape: Optional[Tuple[int, ...]] = None,
        device="cuda",
    ):
        """extractor_overrides: DinoV2Config field overrides, e.g.
        {"use_fused_block": True, "approx_gelu": True,
        "softmax_stabilizer": "capped"} with a bf16 config for the fused
        block. Without `weights_path` the ViT gets random weights from
        `seed` (bench_weights.init_params).

        mesh_shape: (data, bank) shards crops over `data` and every
        object's template bank over `bank`; (data, bank, model) also runs
        the ViT tensor-parallel (parallel/tp_vit). The data axis must
        divide batch_size, and a process group of prod(mesh_shape) ranks
        must be initialized (e.g. under torchrun); "cuda" then means this
        rank's card (parallel/mesh.compute_device)."""
        self._mesh = None
        if mesh_shape:
            if batch_size % mesh_shape[0]:
                raise ValueError(f"the data axis ({mesh_shape[0]}) of mesh_shape={mesh_shape} "
                                 f"must divide batch_size={batch_size}")
            self._mesh = mesh_mod.make_mesh(mesh_shape)
            device = mesh_mod.compute_device(device)
        self.device = torch.device(device)
        self.vit_cfg = dinov2.parse_model_name(extractor_name)
        if extractor_overrides:
            self.vit_cfg = dataclasses.replace(self.vit_cfg, **extractor_overrides)
        self.model = load_or_init(self.vit_cfg, weights_path, seed).to(self.device)
        self.config = config or inference.InferenceConfig()
        self.batch_size = batch_size
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._repres: Dict[int, ObjectRepre] = {}
        self._multi_cache = None
        self._mesh_params = None
        self._mesh_steps: "collections.OrderedDict[int, Any]" = collections.OrderedDict()
        self._warp = make_single_image_warp(self.config.crop_size)
        self._counter = 0

    def register_object(self, obj_id: int, repre: ObjectRepre) -> None:
        self._repres[obj_id] = repre.to(self.device).cast_banks(self.config.compute_dtype)
        self._multi_cache = None
        self._mesh_steps.pop(obj_id, None)

    def unregister_object(self, obj_id: int) -> None:
        """Drops an object and its cached mesh step (and the bank shard it
        holds)."""
        self._repres.pop(obj_id, None)
        self._multi_cache = None
        self._mesh_steps.pop(obj_id, None)

    def _get_mesh_params(self):
        """The ViT as the mesh steps take it (this rank's TP shard on a
        `model` axis), prepared once and shared by every object's step."""
        if self._mesh_params is None:
            self._mesh_params = sharded_inference.prepare_mesh_vit_params(self._mesh, self.model)
        return self._mesh_params

    def _mesh_object_step(self, obj_id: int):
        """The mesh step of one object, built at first use and kept in an
        LRU cache of max_cached_mesh_steps entries (at least the current)."""
        steps = self._mesh_steps
        if obj_id in steps:
            steps.move_to_end(obj_id)
        else:
            steps[obj_id] = sharded_inference.make_object_mesh_step(
                self._mesh, self.config, self._repres[obj_id]
            )
            while len(steps) > max(1, self.max_cached_mesh_steps):
                steps.popitem(last=False)
        return steps[obj_id]

    @property
    def object_ids(self) -> List[int]:
        return sorted(self._repres)

    def _draws(self, b: int) -> Optional[torch.Tensor]:
        """RANSAC draws [b, top_n, H, 6] for the next chunk; None lets the
        step draw from `self.generator`. A test may replace this to feed
        another engine's draws."""
        return None

    # -- host preparation -------------------------------------------------------

    def _prepare_cams(self, image: np.ndarray, boxes_xyxy, K):
        """The image on the device as f32 (divided by 255 when its max is
        above 1.5), its camera, and the boxes' crop cameras (host tensors,
        batched and one per box)."""
        h, w = image.shape[:2]
        img = torch.as_tensor(np.asarray(image)).to(self.device).float()
        if np.asarray(image).max() > 1.5:
            img = img / 255.0
        src_cam = PinholeCamera.from_intrinsic_matrix(np.asarray(K, np.float32), w, h)
        cams = build_crop_cameras(
            src_cam,
            torch.as_tensor(np.stack(boxes_xyxy), dtype=torch.float32),
            viewport_size=self.config.crop_size,
            viewport_rel_pad=0.2,
        )
        crop_cams = [cams.index(i) for i in range(len(boxes_xyxy))]
        return img, src_cam.to(self.device), cams, crop_cams

    def _mask_stack(self, masks, h: int, w: int) -> torch.Tensor:
        """Per-detection masks on the device: all-ones built there when no
        detection has a mask; else bool/integer masks ship as uint8 and
        float masks as f32, None standing for all ones."""
        if all(m is None for m in masks):
            return torch.ones(len(masks), h, w, device=self.device)
        arrs = [np.asarray(m) if m is not None else np.ones((h, w), np.uint8) for m in masks]
        if all(a.dtype == np.bool_ or a.dtype.kind in "iu" for a in arrs):
            stack = np.stack([a.astype(np.uint8) for a in arrs])
        else:
            stack = np.stack([a.astype(np.float32) for a in arrs])
        return torch.as_tensor(stack).to(self.device)

    # -- packed outputs ---------------------------------------------------------

    @staticmethod
    def _pack_outputs(out: inference.PoseOutputs) -> torch.Tensor:
        """[B, 16] f32: [0] success, [1] quality, [2] score, [3]
        best_template, [4:13] R_m2w row-major, [13:16] t_m2w."""
        b = out.R_m2w.shape[0]
        return torch.cat(
            [
                out.success.float()[:, None],
                out.quality.float()[:, None],
                out.score.float()[:, None],
                out.best_template.float()[:, None],
                out.R_m2w.float().reshape(b, 9),
                out.t_m2w.float(),
            ],
            dim=1,
        )

    @staticmethod
    def _unpack_row(p: np.ndarray, j: int, crop_cam: PinholeCamera) -> Dict[str, Any]:
        """Row j of a fetched packed array (the image camera is the world,
        so R/t are reported as m2c)."""
        return {
            "success": bool(p[j, 0] > 0.5),
            "R_m2c": p[j, 4:13].reshape(3, 3),
            "t_m2c": p[j, 13:16],
            "quality": float(p[j, 1]),
            "score": float(p[j, 2]),
            "best_template": int(p[j, 3]),
            "crop_camera": crop_cam,
        }

    def _serve(self, image, boxes_xyxy, masks, K, step) -> List[Dict[str, Any]]:
        """Pads index chunks to the batch size, warps and runs every chunk,
        then fetches and unpacks. `step(crops, crop_masks, cams, chunk,
        pad, draws)` runs the online step on one padded chunk."""
        h, w = image.shape[:2]
        n = len(boxes_xyxy)
        img, src_cam, cams, crop_cams = self._prepare_cams(image, boxes_xyxy, K)
        bs = self.batch_size
        packed = []
        for s in range(0, n, bs):
            chunk = list(range(s, min(s + bs, n)))
            pad = bs - len(chunk)
            idx = chunk + [chunk[-1]] * pad
            dst = cams.index(torch.tensor(idx)).to(self.device)
            crops, crop_masks = self._warp(img, self._mask_stack([masks[i] for i in idx], h, w),
                                           src_cam, dst)
            self._counter += 1
            out = step(crops, crop_masks, dst, chunk, pad, self._draws(bs))
            packed.append((chunk, self._pack_outputs(out)))
        results: List[Dict[str, Any]] = []
        for chunk, p in packed:
            p = p.cpu().numpy()  # one transfer per chunk
            results.extend(self._unpack_row(p, j, crop_cams[i]) for j, i in enumerate(chunk))
        return results

    # -- public API ---------------------------------------------------------------

    @torch.no_grad()
    def estimate(
        self,
        obj_id: int,
        image: np.ndarray,
        boxes_xyxy: Sequence[np.ndarray],
        K: np.ndarray,
        masks: Optional[Sequence[Optional[np.ndarray]]] = None,
    ) -> List[Dict[str, Any]]:
        """Poses of all detections of `obj_id` in one image.

        image [H, W, 3] uint8 or float RGB; boxes in image pixels; K the
        image's 3x3 intrinsics; masks optional per-detection [H, W] modal
        masks. Returns one dict per detection: success, R_m2c, t_m2c,
        quality, score, best_template, crop_camera.
        """
        if len(boxes_xyxy) == 0:
            return []
        repre = self._repres[obj_id]
        masks = list(masks) if masks is not None else [None] * len(boxes_xyxy)

        if self._mesh is not None:
            mesh_step, params = self._mesh_object_step(obj_id), self._get_mesh_params()

            def step(crops, crop_masks, cams, chunk, pad, draws):
                return mesh_step(params, crops, crop_masks, cams, generator=self.generator,
                                 draws=draws)
        else:
            def step(crops, crop_masks, cams, chunk, pad, draws):
                return inference.pose_from_crops(
                    self.model, crops, crop_masks, cams, repre, self.config,
                    generator=self.generator, draws=draws,
                )

        return self._serve(image, boxes_xyxy, masks, K, step)

    def _multi(self):
        """(object order, stacked repre, mesh step or None), rebuilt after
        (un)registration; on a mesh the repre is this rank's bank shard."""
        if self._multi_cache is None:
            order = self.object_ids
            multi, step = stack_repres([self._repres[o] for o in order]), None
            if self._mesh is not None:
                step, multi = sharded_inference.make_multi_object_mesh_step(
                    self._mesh, self.config, multi
                )
            self._multi_cache = (order, multi, step)
        return self._multi_cache

    @torch.no_grad()
    def estimate_mixed(
        self, image: np.ndarray, detections: Sequence[Dict[str, Any]], K: np.ndarray
    ) -> List[Dict[str, Any]]:
        """Poses for detections of different objects in one image, sharing
        batches through the stacked multi-object step. detections: dicts
        with "obj_id", "box_xyxy" and optional "mask"."""
        if len(detections) == 0:
            return []
        order, multi, mesh_step = self._multi()
        obj_to_idx = {o: i for i, o in enumerate(order)}

        def step(crops, crop_masks, cams, chunk, pad, draws):
            obj_idx = torch.tensor(
                [obj_to_idx[detections[i]["obj_id"]] for i in chunk] + [0] * pad,
                device=self.device,
            )
            if mesh_step is not None:
                return mesh_step(self._get_mesh_params(), crops, crop_masks, cams, obj_idx,
                                 generator=self.generator, draws=draws)
            return pose_from_crops_multi(
                self.model, crops, crop_masks, cams, obj_idx, multi, self.config,
                generator=self.generator, draws=draws,
            )

        return self._serve(
            image, [d["box_xyxy"] for d in detections], [d.get("mask") for d in detections],
            K, step,
        )
