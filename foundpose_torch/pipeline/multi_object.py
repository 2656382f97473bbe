"""Mixed-object batches: one step over crops of MANY objects (counterpart of
foundpose_tpu/pipeline/multi_object.py).

The object representations are stacked into one padded repre
(repre.stack_repres) and every crop carries its object index. Where the JAX
package vmaps a per-crop function that gathers its object's tables, each
table here is gathered once for the whole batch ([B, ...] word centroids,
idfs, template descriptors, PCA projectors) or indexed by (object,
template) inside the correspondence search and the featuremetric winner
bank, and the solve is inference.solve_batch: the RANSAC draws of crop i
are the same in the single- and multi-object steps. The steps open the
same spans (utils/profiling) as the single-object step's.
"""

from __future__ import annotations

from typing import Optional

import torch

from foundpose_torch.models import dinov2
from foundpose_torch.ops import sampling
from foundpose_torch.ops.pca import pca_transform_gathered
from foundpose_torch.ops.tfidf import tfidf_retrieve
from foundpose_torch.pipeline import inference
from foundpose_torch.pose import corresp as corresp_mod
from foundpose_torch.repre import ObjectRepre
from foundpose_torch.structs import PinholeCamera
from foundpose_torch.utils import profiling


@torch.no_grad()
def pose_from_features_multi(
    feature_maps: torch.Tensor,
    masks: torch.Tensor,
    cameras: PinholeCamera,
    obj_idx: torch.Tensor,
    multi_repre: ObjectRepre,
    config: inference.InferenceConfig,
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
) -> inference.PoseOutputs:
    """inference.pose_from_features where crop i uses object obj_idx[i] of
    the stacked `multi_repre`."""
    oi = obj_idx.long().to(feature_maps.device)
    with profiling.span("retrieval"):
        points, feats, valid = inference.query_features_from_map(
            feature_maps, masks, config.crop_size, config.grid_cell_size
        )
        if config.max_num_queries < points.shape[0]:
            valid = sampling.subsample_points(valid, config.max_num_queries, generator)
        if multi_repre.raw_projector is not None:
            feats = pca_transform_gathered(multi_repre.raw_projector, oi, feats)
        feats = feats.to(config.compute_dtype)
        tmask = multi_repre.template_mask
        template_ids, template_scores = tfidf_retrieve(
            feats,
            multi_repre.word_centroids[oi],
            multi_repre.word_idfs[oi],
            multi_repre.template_descs[oi],
            top_n=config.top_n_templates,
            config=multi_repre.tfidf_config,
            query_mask=valid,
            template_mask=None if tmask is None else tmask[oi],
        )
    with profiling.span("match"):
        cors = corresp_mod.establish_correspondences_batch(
            points,
            feats,
            valid,
            template_ids,
            template_scores,
            multi_repre.bank_feats.to(config.compute_dtype),
            multi_repre.bank_vertices,
            multi_repre.bank_mask,
            top_k=config.top_k_buddies,
            approx_topk=config.approx_topk,
            obj_idx=oi,
        )
    with profiling.span("solve"):
        return inference.solve_batch(
            feature_maps, valid, template_ids, template_scores, cors, cameras, multi_repre, config,
            draws, generator, obj_idx=oi,
        )


@torch.no_grad()
def pose_from_crops_multi(
    vit: dinov2.DinoV2,
    crops: torch.Tensor,
    masks: torch.Tensor,
    cameras: PinholeCamera,
    obj_idx: torch.Tensor,
    multi_repre: ObjectRepre,
    config: inference.InferenceConfig,
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
) -> inference.PoseOutputs:
    """inference.pose_from_crops over a mixed-object batch."""
    with profiling.span("step"):
        with profiling.span("vit"):
            images = inference.preprocess_crops(crops, config)
            feature_maps = dinov2.extract_facet(vit, images)["feature_maps"].float()
        return pose_from_features_multi(
            feature_maps, masks.float(), cameras, obj_idx, multi_repre, config, generator,
            draws,
        )
