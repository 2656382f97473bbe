"""Inference result visualization: tile grids per estimate (counterpart of
foundpose_tpu/vis/inference_vis.py; cameras are the port's PinholeCamera).

Re-design of the reference inference visualizer
(reference: utils/vis_util.py:127-687). Produces, per estimate: the input
crop with mask overlay, the estimated-pose contour overlay (rendered with the
native rasterizer), the best-matched template, confidence-colored
correspondence lines, and a PCA RGB rendering of the dense feature map.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from foundpose_torch.vis import base as vb


def _host(x) -> np.ndarray:
    """A float64 host array of a camera field (a tensor on any device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def feature_map_pca_rgb(feature_map_hwc: np.ndarray) -> np.ndarray:
    """Dense feature map -> PCA-to-3 RGB visualization.

    (reference: utils/vis_util.py feature-map PCA vis)
    """
    h, w, d = feature_map_hwc.shape
    flat = feature_map_hwc.reshape(-1, d).astype(np.float64)
    flat = flat - flat.mean(axis=0)
    # Top-3 principal directions via SVD of the (small) covariance.
    cov = flat.T @ flat / max(len(flat) - 1, 1)
    _, vecs = np.linalg.eigh(cov)
    basis = vecs[:, -3:]
    proj = flat @ basis
    lo = np.percentile(proj, 2, axis=0)
    hi = np.percentile(proj, 98, axis=0)
    rgb = (proj - lo) / np.maximum(hi - lo, 1e-9)
    return vb.to_uint8(rgb.reshape(h, w, 3))


def vis_inference_results(
    crop_image: np.ndarray,
    crop_mask: np.ndarray,
    template_image: Optional[np.ndarray],
    corresp_2d: Optional[np.ndarray],
    corresp_template_2d: Optional[np.ndarray],
    corresp_scores: Optional[np.ndarray],
    est_mask: Optional[np.ndarray],
    feature_map: Optional[np.ndarray] = None,
    caption: str = "",
    max_corresp: int = 100,
    inlier_mask: Optional[np.ndarray] = None,
    pose_overlay: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Builds the per-estimate tile grid. (reference: utils/vis_util.py:179-687)"""
    tiles: List[np.ndarray] = []
    base = vb.ensure_rgb(crop_image)
    tiles.append(vb.write_text(vb.overlay_mask(base, crop_mask), caption or "input"))
    if est_mask is not None:
        tiles.append(
            vb.write_text(vb.overlay_contour(base, est_mask), "estimated pose")
        )
    if pose_overlay is not None:
        tiles.append(vb.write_text(pose_overlay, "posed mesh"))
    if inlier_mask is not None and corresp_2d is not None:
        # Inlier/outlier plot of the winning correspondences under the
        # estimated pose (reference: utils/vis_util.py inlier tiles).
        tiles.append(
            vb.write_text(
                vb.draw_inliers(base, corresp_2d, inlier_mask),
                f"inliers {int(np.sum(inlier_mask))}/{len(inlier_mask)}",
            )
        )
    if (
        template_image is not None
        and corresp_2d is not None
        and corresp_template_2d is not None
    ):
        tiles.append(
            vb.write_text(
                vb.draw_matches(
                    base,
                    template_image,
                    corresp_2d,
                    corresp_template_2d,
                    corresp_scores,
                    max_draw=max_corresp,
                ),
                "matches",
            )
        )
    if feature_map is not None:
        import cv2

        fm = feature_map_pca_rgb(np.asarray(feature_map))
        fm = cv2.resize(fm, (base.shape[1], base.shape[0]),
                        interpolation=cv2.INTER_NEAREST)
        tiles.append(vb.write_text(fm, "features (PCA)"))
    return vb.build_grid(tiles, cols=2)


def render_pose_mask(
    renderer, obj_id: int, camera, R_m2c: np.ndarray, t_m2c: np.ndarray
) -> np.ndarray:
    """Renders the estimated pose's mask in the crop camera for overlays.

    (reference posed-mesh overlay: utils/render_vis_util.py:90-252)
    """
    from foundpose_torch.renderer.base import RenderType

    t_m2w = np.eye(4)
    t_m2w[:3, :3] = np.asarray(R_m2c)
    t_m2w[:3, 3] = np.asarray(t_m2c).flatten()
    # The camera pytree may carry world extrinsics; rendering wants the object
    # placed via model->camera, so pass T_model_to_world = T_c2w @ m2c.
    t_c2w = _host(camera.T_world_from_eye)
    out = renderer.render_object_model(
        obj_id, camera, T_model_to_world=t_c2w @ t_m2w
    )
    return np.asarray(out[RenderType.MASK])


def render_pose_overlay(
    renderer,
    obj_id: int,
    camera,
    R_m2c: np.ndarray,
    t_m2c: np.ndarray,
    base_image: np.ndarray,
    alpha: float = 0.55,
    dim_background: float = 0.5,
) -> np.ndarray:
    """Alpha-blends a shaded render of the object at the estimated pose over
    the image: the posed object appears lit on a dimmed background, the
    standard qualitative pose visualization
    (reference: utils/render_vis_util.py:90-180 `vis_posed_meshes_of_objects`).
    """
    from foundpose_torch.renderer.base import RenderType

    t_m2w = np.eye(4)
    t_m2w[:3, :3] = np.asarray(R_m2c)
    t_m2w[:3, 3] = np.asarray(t_m2c).flatten()
    t_c2w = _host(camera.T_world_from_eye)
    out = renderer.render_object_model(
        obj_id, camera, T_model_to_world=t_c2w @ t_m2w,
        render_types=[RenderType.COLOR, RenderType.MASK],
    )
    color = np.asarray(out[RenderType.COLOR]).astype(np.float32)
    if color.max() <= 1.0 + 1e-6:
        color = color * 255.0
    mask = (np.asarray(out[RenderType.MASK]) > 0)[..., None].astype(np.float32)
    base = vb.ensure_rgb(base_image).astype(np.float32) * dim_background
    blended = base * (1.0 - alpha * mask) + color * alpha * mask
    return np.clip(blended, 0, 255).astype(np.uint8)


def vis_pointcloud_error(
    vertices_model: np.ndarray,
    R_est: np.ndarray,
    t_est: np.ndarray,
    R_gt: np.ndarray,
    t_gt: np.ndarray,
    ply_output_path: str,
) -> None:
    """Exports a colored point cloud with the object vertices posed by the GT
    (green) and the estimate (blue), for inspecting pose errors in a 3D viewer
    (reference: utils/vis_util.py:78-124 `vis_pointcloud_error`)."""
    import os

    from foundpose_torch.data.ply import Mesh, save_ply

    pts = np.asarray(vertices_model, dtype=np.float64)
    gt = pts @ np.asarray(R_gt, dtype=np.float64).T + np.asarray(t_gt).flatten()
    est = pts @ np.asarray(R_est, dtype=np.float64).T + np.asarray(t_est).flatten()
    verts = np.concatenate([gt, est], axis=0).astype(np.float32)
    colors = np.concatenate(
        [
            np.tile(np.asarray([[0, 255, 0]], np.uint8), (len(gt), 1)),
            np.tile(np.asarray([[0, 0, 255]], np.uint8), (len(est), 1)),
        ],
        axis=0,
    )
    os.makedirs(os.path.dirname(ply_output_path) or ".", exist_ok=True)
    save_ply(ply_output_path, Mesh(vertices=verts, faces=None, colors=colors))
