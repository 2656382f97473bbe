"""The online coarse-pose step (counterpart of
foundpose_tpu/pipeline/inference.py).

    DINOv2 features -> masked query grid -> PCA -> tf-idf retrieval ->
    cyclic-buddy matching -> RANSAC-PnP -> best-template selection ->
    LO + LM (+ featuremetric) on the winner -> world-frame poses

Each stage is a plain function over the whole crop batch. On a GPU the
kernels of the configured path run (ops/vit_block or ops/attention,
ops/buddies_kernel on the approx-top-k path, pose/pnp.score_hypotheses); on
a CPU their twins do. The tensors' device decides.

Spans (utils/profiling, recorded only while a recording is open):
`pose_from_crops` opens "step" and in it "vit"; `pose_from_features` opens
"retrieval", "match" and "solve" (`solve_batch`). In the solve,
`solve_batch` opens "ransac" (the RANSAC over every set, the pick of each
crop's winner and the two-phase second pass) and `refine_winner` opens
"refine" (with "lo_lm", one `pnp.refine_lo_lm` call, and "featuremetric"
as configured); the selection, `estimate_score` and the world frame are the
solve's self time.

Randomness: RANSAC draws come from `draws` [B, top_n, H, 6] when given,
else from `generator`. The JAX package derives them from one PRNG key; the
tests pass its draws here to compare the two packages pose for pose.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from foundpose_torch import geometry
from foundpose_torch.models import dinov2
from foundpose_torch.ops import sampling
from foundpose_torch.ops.pca import pca_transform, pca_transform_gathered
from foundpose_torch.ops.tfidf import tfidf_retrieve
from foundpose_torch.pose import corresp as corresp_mod
from foundpose_torch.pose import pnp as pnp_mod
from foundpose_torch.pose.featuremetric import refine_pose_featuremetric
from foundpose_torch.repre import ObjectRepre
from foundpose_torch.structs import PinholeCamera
from foundpose_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Static pipeline options (defaults follow the JAX package)."""

    crop_size: Tuple[int, int] = (420, 420)
    grid_cell_size: float = 14.0
    max_num_queries: int = 1000000
    top_n_templates: int = 5
    top_k_buddies: int = 300
    approx_topk: bool = False
    pnp_ransac_iter: int = 200
    pnp_select_iter: int = 0
    pnp_inlier_thresh: float = 10.0
    pnp_refine_lm: bool = True
    lm_iters: int = 10
    pnp_lo_iters: int = 2
    refine_featuremetric: bool = False
    featuremetric_iters: int = 8
    compute_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.pnp_select_iter and not 0 < self.pnp_select_iter < self.pnp_ransac_iter:
            raise ValueError(
                f"pnp_select_iter={self.pnp_select_iter} must be 0 (single-pass) "
                f"or in (0, pnp_ransac_iter={self.pnp_ransac_iter})"
            )


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inference_config_from_opts(opts: Dict[str, Any]) -> InferenceConfig:
    """InferenceConfig from an `infer_opts` dict (or the envelope holding
    it), with the JAX CLI's field mapping and defaults."""
    o = opts.get("infer_opts", opts)
    return InferenceConfig(
        crop_size=tuple(o.get("crop_size", (420, 420))),
        grid_cell_size=float(o.get("grid_cell_size", 14.0)),
        max_num_queries=int(o.get("max_num_queries", 1000000)),
        top_n_templates=int(o.get("match_top_n_templates", 5)),
        top_k_buddies=int(o.get("match_top_k_buddies", 300)),
        approx_topk=bool(o.get("approx_topk", False)),
        pnp_ransac_iter=int(o.get("pnp_ransac_iter", 200)),
        pnp_select_iter=int(o.get("pnp_select_iter", 0)),
        pnp_inlier_thresh=float(o.get("pnp_inlier_thresh", 10.0)),
        pnp_refine_lm=bool(o.get("pnp_refine_lm", True)),
        pnp_lo_iters=int(o.get("pnp_lo_iters", 2)),
        refine_featuremetric=bool(o.get("refine_featuremetric", False)),
        featuremetric_iters=int(o.get("featuremetric_iters", 8)),
        compute_dtype=_DTYPES[o.get("compute_dtype", "float32")],
    )


def vit_config_from_opts(opts: Dict[str, Any]) -> dinov2.DinoV2Config:
    """DinoV2Config from an `infer_opts` dict: the extractor name, the GELU
    form, `use_fused_block` (JAX default False) and `vit_overrides`.
    `use_pallas_attention` has no counterpart: the unfused block always
    runs its attention through ops/attention. The fused block's CUDA kernel
    takes bf16 only, so a fused f32 configuration raises on the GPU."""
    o = opts.get("infer_opts", opts)
    cfg = dataclasses.replace(
        dinov2.parse_model_name(o["extractor_name"]),
        approx_gelu=bool(o.get("approx_gelu", False)),
        use_fused_block=bool(o.get("use_fused_block", False)),
    )
    return dataclasses.replace(cfg, **(o.get("vit_overrides") or {}))


@dataclasses.dataclass
class PoseOutputs:
    """Batched pose estimates (leading axis = crops)."""

    success: torch.Tensor  # [B] bool
    R_m2c: torch.Tensor  # [B, 3, 3]
    t_m2c: torch.Tensor  # [B, 3]
    R_m2w: torch.Tensor  # [B, 3, 3]
    t_m2w: torch.Tensor  # [B, 3]
    quality: torch.Tensor  # [B]
    score: torch.Tensor  # [B]
    template_ids: torch.Tensor  # [B, top_n]
    template_scores: torch.Tensor  # [B, top_n]
    best_template: torch.Tensor  # [B]
    per_template_quality: torch.Tensor  # [B, top_n]
    num_queries: torch.Tensor  # [B]
    best_corresp_2d: torch.Tensor  # [B, K, 2]
    best_corresp_2d_ids: torch.Tensor  # [B, K]
    best_corresp_3d: torch.Tensor  # [B, K, 3]
    best_corresp_conf: torch.Tensor  # [B, K]
    best_corresp_valid: torch.Tensor  # [B, K]


def estimate_score(
    r, t, coord_2d, coord_2d_ids, coord_3d, valid, cam_f, cam_c,
    num_query_points: int, inlier_radius: float = 10.0,
) -> torch.Tensor:
    """Many-to-many-aware inlier ratio per crop [B]: the fraction of unique
    query points with at least one correspondence reprojecting within
    `inlier_radius` (segment max over query ids, clamped at 0)."""
    cam = torch.einsum("bij,bnj->bni", r, coord_3d) + t[:, None]
    z = cam[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    proj = cam[..., :2] / z * cam_f[:, None] + cam_c[:, None]
    diff = proj - coord_2d
    err = torch.sqrt(torch.sum(diff * diff, dim=-1))
    inlier = ((err <= inlier_radius) & valid).float()
    present = valid.float()
    ids = coord_2d_ids.long()
    zeros = torch.zeros(r.shape[0], num_query_points, device=r.device)
    has_inlier = zeros.scatter_reduce(1, ids, inlier, reduce="amax")
    is_present = zeros.scatter_reduce(1, ids, present, reduce="amax")
    return torch.sum(has_inlier * is_present, dim=-1) / torch.clamp_min(
        torch.sum(is_present, dim=-1), 1.0
    )


def query_features_from_map(feature_maps, masks, crop_size, grid_cell_size):
    """Grid points [Q, 2], sampled features [B, Q, D] and validity [B, Q]."""
    points = sampling.grid_points(crop_size, grid_cell_size, device=feature_maps.device)
    valid = sampling.points_in_mask(points, masks)
    feats = sampling.sample_grid_features(feature_maps, points, crop_size, grid_cell_size)
    return points, feats, valid


def retrieve_batch(
    feature_maps: torch.Tensor,
    masks: torch.Tensor,
    repre: ObjectRepre,
    config: InferenceConfig,
    generator: Optional[torch.Generator] = None,
):
    """Stage A: query features + PCA + tf-idf retrieval. Returns (feats
    [B, Q, D] in the compute dtype, valid [B, Q], template_ids [B, N],
    template_scores [B, N])."""
    points, feats, valid = query_features_from_map(
        feature_maps, masks, config.crop_size, config.grid_cell_size
    )
    if config.max_num_queries < points.shape[0]:
        valid = sampling.subsample_points(valid, config.max_num_queries, generator)
    if repre.raw_projector is not None:
        feats = pca_transform(repre.raw_projector, feats)
    feats = feats.to(config.compute_dtype)
    template_ids, template_scores = tfidf_retrieve(
        feats,
        repre.word_centroids,
        repre.word_idfs,
        repre.template_descs,
        top_n=config.top_n_templates,
        config=repre.tfidf_config,
        query_mask=valid,
        template_mask=repre.template_mask,
    )
    return feats, valid, template_ids, template_scores


def match_batch(feats_b, valid_b, template_ids_b, template_scores_b, repre, config):
    """Stage B: cyclic-buddy matching against the retrieved templates."""
    grid_pts = sampling.grid_points(
        config.crop_size, config.grid_cell_size, device=feats_b.device
    )
    return corresp_mod.establish_correspondences_batch(
        grid_pts,
        feats_b,
        valid_b,
        template_ids_b,
        template_scores_b,
        repre.bank_feats.to(config.compute_dtype),
        repre.bank_vertices,
        repre.bank_mask,
        top_k=config.top_k_buddies,
        approx_topk=config.approx_topk,
    )


def full_budget_winner(
    r_best, t_best, inliers_best, quality_best, c2d, c3d, cvalid, cam_f, cam_c,
    config: InferenceConfig, generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
):
    """Second phase of the two-phase solve (no-op when single-pass): RANSAC
    at the full budget on each crop's winning set, kept where it does not
    lose inliers. Its draws [B, H, 6] are `draws`, else from `generator`."""
    if not config.pnp_select_iter:
        return r_best, t_best, inliers_best, quality_best
    full = pnp_mod.ransac_pnp(
        c2d, c3d, cvalid, cam_f, cam_c,
        num_hypotheses=config.pnp_ransac_iter,
        inlier_thresh=config.pnp_inlier_thresh,
        refine_lm=False, lm_iters=config.lm_iters, lo_iters=0, draws=draws,
        generator=generator,
    )
    better = full.quality >= quality_best
    return (
        torch.where(better[:, None, None], full.R, r_best),
        torch.where(better[:, None], full.t, t_best),
        torch.where(better[:, None], full.inliers, inliers_best),
        torch.where(better, full.quality, quality_best),
    )


def refine_winner(r_best, t_best, inliers_best, count_best, c2d, c3d, cvalid,
                  cam_f, cam_c, config: InferenceConfig, fmap=None, project=None,
                  winner_bank=None):
    """Winner-only LO-RANSAC, then LM kept where finite (both in one
    `pnp.refine_lo_lm` call), then (when configured) featuremetric
    refinement. Returns (R, t, count) with the post-LO base-threshold
    inlier count, so success and quality describe the emitted pose.

    fmap [B, Hf, Wf, D_raw]: the crops' raw f32 feature maps; project: the
    PCA projection for them, or None; winner_bank: () -> (vertices, feats,
    mask) of each crop's winning template. The three are used only by the
    featuremetric stage, which refines every crop, failed ones included."""
    with profiling.span("refine"):
        c2d = c2d.float()
        c3d = c3d.float()
        if config.pnp_lo_iters > 0 or config.pnp_refine_lm:
            with profiling.span("lo_lm"):
                r_best, t_best, inliers_best, count_best = pnp_mod.refine_lo_lm(
                    r_best, t_best, c2d, c3d, cvalid, cam_f, cam_c, inliers_best, count_best,
                    config.pnp_inlier_thresh, config.pnp_lo_iters,
                    config.lm_iters if config.pnp_refine_lm else 0,
                )
        if config.refine_featuremetric:
            with profiling.span("featuremetric"):
                r_best, t_best = featuremetric_winner(
                    r_best, t_best, cam_f, cam_c, config, fmap, project, winner_bank
                )
        return r_best, t_best, count_best


def featuremetric_winner(r_best, t_best, cam_f, cam_c, config: InferenceConfig, fmap,
                         project=None, winner_bank=None):
    """The featuremetric stage of refine_winner: the raw maps projected
    (when `project` is given), maps and bank descriptors cast to the
    compute dtype, config.featuremetric_iters LM steps. Returns (R, t)."""
    cdt = config.compute_dtype
    fmap_proj = fmap if project is None else project(fmap)
    verts, feats, mask = winner_bank()
    r_best, t_best, _ = refine_pose_featuremetric(
        r_best, t_best, fmap_proj.to(cdt), cam_f, cam_c, verts, feats.to(cdt), mask,
        crop_size=config.crop_size, iters=config.featuremetric_iters,
    )
    return r_best, t_best


def solve_batch(
    feature_maps: torch.Tensor,
    valid_b: torch.Tensor,
    template_ids_b: torch.Tensor,
    template_scores_b: torch.Tensor,
    cors_b: corresp_mod.Correspondences,
    cameras: PinholeCamera,
    repre: ObjectRepre,
    config: InferenceConfig,
    draws: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    obj_idx: Optional[torch.Tensor] = None,
    full_draws: Optional[torch.Tensor] = None,
    fetched_banks: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> PoseOutputs:
    """Stage C: RANSAC-PnP over every (crop, template) set in one batch,
    best-by-inlier-count selection, winner refinement, world frame.

    feature_maps [B, Hf, Wf, D_raw] and the repre's projector and banks
    feed featuremetric refinement only. With obj_idx [B], `repre` is a
    stacked multi-object repre and crop i uses object obj_idx[i].
    full_draws [B, H, 6]: the two-phase second pass's draws (else from
    `generator`). fetched_banks: the retrieved templates' (feats, vertices,
    mask) [B, T', F, ...] when the repre holds one bank shard only (the
    multi-device step); the winner's bank is then taken from them.

    Selection compares inlier counts where RANSAC succeeded (-1 elsewhere)
    and takes the first maximum. The two-phase second pass keeps the full
    pass where full.quality >= the winner's without masking on its success,
    as the JAX package does (ROADMAP.md Queue 3, fault (a))."""
    b, n = template_ids_b.shape
    dev = valid_b.device
    cam_f = cameras.f.float()
    cam_c = cameras.c.float()

    def flat(a):
        return a.reshape(b * n, *a.shape[2:])

    with profiling.span("ransac"):
        res = pnp_mod.ransac_pnp(
            flat(cors_b.coord_2d), flat(cors_b.coord_3d), flat(cors_b.valid),
            cam_f[:, None].expand(b, n, 2).reshape(b * n, 2),
            cam_c[:, None].expand(b, n, 2).reshape(b * n, 2),
            num_hypotheses=config.pnp_select_iter or config.pnp_ransac_iter,
            inlier_thresh=config.pnp_inlier_thresh,
            refine_lm=False, lm_iters=config.lm_iters, lo_iters=0,
            draws=None if draws is None else flat(draws),
            generator=generator,
        )
        per_tpl_quality = res.quality.reshape(b, n)
        quality = torch.where(res.success.reshape(b, n), per_tpl_quality, -1.0)
        best = torch.argmax(quality, dim=-1)  # first maximum
        ar = torch.arange(b, device=dev)

        def pick(a):
            return a.reshape(b, n, *a.shape[1:])[ar, best]

        c2d, c3d = cors_b.coord_2d[ar, best], cors_b.coord_3d[ar, best]
        cvalid, c2d_ids = cors_b.valid[ar, best], cors_b.coord_2d_ids[ar, best]
        r_best, t_best, inliers_best, quality_best = full_budget_winner(
            pick(res.R), pick(res.t), pick(res.inliers), pick(res.quality),
            c2d, c3d, cvalid, cam_f, cam_c, config, generator, full_draws,
        )
    best_tid = template_ids_b[ar, best]
    proj = repre.raw_projector
    if obj_idx is None:
        tpl = (best_tid,)
        project = None if proj is None else (lambda x: pca_transform(proj, x))
    else:
        tpl = (obj_idx, best_tid)
        project = None if proj is None else (lambda x: pca_transform_gathered(proj, obj_idx, x))
    if fetched_banks is None:
        def winner_bank():
            return repre.bank_vertices[tpl], repre.bank_feats[tpl], repre.bank_mask[tpl]
    else:
        def winner_bank():
            feats, verts, mask = fetched_banks
            return verts[ar, best], feats[ar, best], mask[ar, best]
    r_best, t_best, count_best = refine_winner(
        r_best, t_best, inliers_best, quality_best, c2d, c3d, cvalid, cam_f, cam_c, config,
        fmap=feature_maps, project=project, winner_bank=winner_bank,
    )
    num_grid = int(config.crop_size[0] / config.grid_cell_size) * int(
        config.crop_size[1] / config.grid_cell_size
    )
    score = estimate_score(
        r_best, t_best, c2d.float(), c2d_ids, c3d.float(), cvalid, cam_f, cam_c,
        num_query_points=num_grid, inlier_radius=config.pnp_inlier_thresh,
    )
    success = count_best >= 6.0
    m2w = cameras.T_world_from_eye.float() @ geometry.as_4x4_rt(r_best, t_best)
    return PoseOutputs(
        success=success,
        R_m2c=r_best,
        t_m2c=t_best,
        R_m2w=m2w[..., :3, :3],
        t_m2w=m2w[..., :3, 3],
        quality=torch.where(success, count_best, -1.0),
        score=score,
        template_ids=template_ids_b,
        template_scores=template_scores_b,
        best_template=best_tid,
        per_template_quality=per_tpl_quality,
        num_queries=valid_b.float().sum(-1),
        best_corresp_2d=c2d,
        best_corresp_2d_ids=c2d_ids,
        best_corresp_3d=c3d,
        best_corresp_conf=cors_b.coord_conf[ar, best],
        best_corresp_valid=cvalid,
    )


@torch.no_grad()
def pose_from_features(
    feature_maps: torch.Tensor,
    masks: torch.Tensor,
    cameras: PinholeCamera,
    repre: ObjectRepre,
    config: InferenceConfig,
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
    full_draws: Optional[torch.Tensor] = None,
) -> PoseOutputs:
    """Retrieval + matching + PnP for a batch of crop feature maps.

    feature_maps [B, Hf, Wf, D_raw]; masks [B, H, W] in crop space; cameras
    batched crop cameras; draws optional [B, top_n, H, 6]; full_draws
    optional [B, H, 6], the two-phase solve's second pass (solve_batch).
    """
    with profiling.span("retrieval"):
        feats_b, valid_b, tids_b, tscores_b = retrieve_batch(
            feature_maps, masks, repre, config, generator
        )
    with profiling.span("match"):
        cors_b = match_batch(feats_b, valid_b, tids_b, tscores_b, repre, config)
    with profiling.span("solve"):
        return solve_batch(
            feature_maps, valid_b, tids_b, tscores_b, cors_b, cameras, repre, config, draws,
            generator, full_draws=full_draws,
        )


def preprocess_crops(crops: torch.Tensor, config: InferenceConfig) -> torch.Tensor:
    """uint8 or [0, 1] float RGB crops [B, H, W, 3] -> normalized images in
    the compute dtype."""
    if crops.dtype == torch.uint8:
        crops = crops.float() / 255.0
    return dinov2.normalize_images(crops).to(config.compute_dtype)


@torch.no_grad()
def pose_from_crops(
    vit: dinov2.DinoV2,
    crops: torch.Tensor,
    masks: torch.Tensor,
    cameras: PinholeCamera,
    repre: ObjectRepre,
    config: InferenceConfig,
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
) -> PoseOutputs:
    """The full online step: crops [B, H, W, 3] (uint8 or float in [0, 1])
    already warped to the crop cameras, masks [B, H, W] (nonzero = valid)
    -> world-frame poses."""
    with profiling.span("step"):
        with profiling.span("vit"):
            images = preprocess_crops(crops, config)
            feature_maps = dinov2.extract_facet(vit, images)["feature_maps"].float()
        return pose_from_features(
            feature_maps, masks.float(), cameras, repre, config, generator, draws
        )
