"""The multi-device online step: crops data-parallel, template banks sharded
(counterpart of foundpose_tpu/parallel/sharded_inference.py).

Every rank receives the global batch (every rank reads the same image) and
keeps its `data` rows. On those rows it runs the ViT (the fused block, or
the tensor-parallel blocks of parallel/tp_vit over a `model` axis), the
query grid and PCA, then:

- tf-idf retrieval against its `bank` shard of the template descriptors:
  local cosine scores and a local top-n, merged over `bank` by an
  _all_gather of the (score, global id) lists (a few KB);
- a fetch of the retrieved templates' banks: the owner shard contributes
  them, every other shard zeros, and a _psum over `bank` gives every rank
  the same bit-exact banks;
- matching (pose/corresp.correspondences_from_banks, the buddies kernel on
  the card), the solve and winner refinement (pipeline/inference.solve_batch)
  and the world frame on the fetched banks.

The outputs are gathered over `data`, so every rank returns the global
PoseOutputs. RANSAC draws (and any query subsampling noise) are made at the
GLOBAL shape, from the injected draws or from a generator every rank seeds
alike, and each rank keeps its rows: the step draws the same hypotheses as
the single-device step (pipeline/inference.pose_from_crops).

It is not bit-equal to that step. Batched products over a rank's rows
(the query features' PCA, the tf-idf scores, the LO refits' batched
solves) may pick other GEMM kernels than over the whole batch and round
differently in the last bit: an H100 measured one bf16 step in some query
features, scores up to 4.2e-7 apart with every id equal, and poses within
3e-8 with every decision equal (chip_smoke.py phase 11). Near-tied
templates (scores within f32 rounding) may thus swap places in the merged
list; tests keep their worlds' scores apart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from foundpose_torch import models
from foundpose_torch.models import dinov2
from foundpose_torch.ops import sampling
from foundpose_torch.ops.pca import pca_transform, pca_transform_gathered
from foundpose_torch.ops.tfidf import tfidf_retrieve
from foundpose_torch.parallel import mesh as mesh_mod
from foundpose_torch.parallel import tp_vit
from foundpose_torch.parallel.mesh import BANK_AXIS, DATA_AXIS, MODEL_AXIS
from foundpose_torch.pipeline import inference
from foundpose_torch.pose import corresp as corresp_mod
from foundpose_torch.repre import ObjectRepre, pad_templates
from foundpose_torch.structs import PinholeCamera


def _retrieve_sharded(feats, valid, word_centroids, word_idfs, template_descs_local, top_n,
                      tfidf_config, mesh, template_mask_local=None):
    """tf-idf retrieval with the descriptor bank sharded over `bank`.

    feats [B, Q, D], valid [B, Q]; the tables may carry the crops' leading
    axis (mixed-object batches). Returns global (template_ids [B, top_n],
    scores [B, top_n]) by descending score, ties to the lower template id,
    as ops/tfidf.tfidf_retrieve on the whole bank."""
    t_local = template_descs_local.shape[-2]
    ids, scores = tfidf_retrieve(
        feats, word_centroids, word_idfs, template_descs_local, top_n=min(top_n, t_local),
        config=tfidf_config, query_mask=valid, template_mask=template_mask_local,
    )
    ids = ids + mesh.get_local_rank(BANK_AXIS) * t_local
    # [n, B, k] in shard order -> [B, n * k]: shard-major, so a stable sort
    # keeps equal scores in global id order.
    all_scores = mesh_mod._all_gather(scores, mesh, BANK_AXIS).permute(1, 0, 2).flatten(1)
    all_ids = mesh_mod._all_gather(ids, mesh, BANK_AXIS).permute(1, 0, 2).flatten(1)
    scores, order = torch.sort(all_scores, dim=-1, descending=True, stable=True)
    return torch.gather(all_ids, -1, order[:, :top_n]), scores[:, :top_n]


def _fetch_banks(template_ids, bank_feats_local, bank_vertices_local, bank_mask_local, mesh,
                 obj_idx=None):
    """The retrieved templates' banks [B, T', F, ...] from the bank shards
    (banks [T_local, F, ...], or [O, T_local, F, ...] with obj_idx [B]).

    The owner shard contributes its rows, the others zeros; a _psum over
    `bank` of the bit patterns gives every rank the owner's values exactly."""
    t_local = bank_feats_local.shape[-3]
    tids = template_ids.long()
    mine = (tids // t_local) == mesh.get_local_rank(BANK_AXIS)
    local = tids % t_local
    sel = local if obj_idx is None else (obj_idx.long()[:, None], local)

    def fetch(bank):
        bits = mesh_mod._to_bits(bank[sel])
        bits = torch.where(mine.reshape(*mine.shape, *[1] * (bits.dim() - 2)), bits, 0)
        return mesh_mod._from_bits(mesh_mod._psum(bits, mesh, BANK_AXIS), bank.dtype)

    return fetch(bank_feats_local), fetch(bank_vertices_local), fetch(bank_mask_local)


def _global_rows(shape, rows, generator, device, high=None):
    """Uniform floats (or integers in [0, high)) at the global `shape`,
    rows `rows` of the leading axis kept: every rank draws the whole batch
    from its identically seeded generator, as the single-device step does."""
    if generator is None:
        raise ValueError("the multi-device step draws from `generator`, seeded alike on every "
                         "rank (or takes injected draws)")
    if high is None:
        return torch.rand(shape, generator=generator, device=device)[rows]
    return torch.randint(0, high, shape, generator=generator, device=device)[rows]


def _make_step(mesh, config: inference.InferenceConfig, repre: ObjectRepre, multi: bool):
    """The step over this rank's bank shard `repre` (see the module
    docstring); tensor-parallel when the mesh has a `model` axis."""
    tp = MODEL_AXIS in mesh.mesh_dim_names
    has_pca = repre.raw_projector is not None
    tmask = repre.template_mask

    @torch.no_grad()
    def step(vit, crops, masks, cameras: PinholeCamera, obj_idx=None,
             generator: Optional[torch.Generator] = None, draws: Optional[torch.Tensor] = None):
        b_global = crops.shape[0]
        rows = mesh_mod.data_slice(mesh, b_global)
        dev = crops.device
        images = inference.preprocess_crops(crops[rows], config)
        if tp:
            fmaps = tp_vit.tp_extract_local(vit, images, mesh)["feature_maps"].float()
        else:
            fmaps = dinov2.extract_facet(vit, images)["feature_maps"].float()
        points, feats, valid = inference.query_features_from_map(
            fmaps, masks[rows].float(), config.crop_size, config.grid_cell_size
        )
        if config.max_num_queries < points.shape[0]:
            noise = _global_rows((b_global, points.shape[0]), rows, generator, dev)
            valid = sampling.subsample_points(valid, config.max_num_queries, noise=noise)
        oi = None if obj_idx is None else obj_idx[rows].long().to(dev)
        if has_pca:
            feats = (pca_transform(repre.raw_projector, feats) if oi is None
                     else pca_transform_gathered(repre.raw_projector, oi, feats))
        feats = feats.to(config.compute_dtype)
        tables = (repre.word_centroids, repre.word_idfs, repre.template_descs, tmask)
        if oi is not None:
            tables = tuple(a[oi] for a in tables)
        tids, tscores = _retrieve_sharded(
            feats, valid, *tables[:3], config.top_n_templates, repre.tfidf_config, mesh,
            template_mask_local=tables[3],
        )
        sel_feats, sel_verts, sel_mask = _fetch_banks(
            tids, repre.bank_feats, repre.bank_vertices, repre.bank_mask, mesh, oi
        )
        sel_feats = sel_feats.to(config.compute_dtype)
        cors = corresp_mod.correspondences_from_banks(
            points, feats, valid, tids, tscores, sel_feats, sel_verts, sel_mask,
            top_k=config.top_k_buddies, approx_topk=config.approx_topk,
        )
        k = cors.coord_2d.shape[-2]
        n = config.top_n_templates
        h = config.pnp_select_iter or config.pnp_ransac_iter
        if draws is None:
            draws = _global_rows((b_global * n, h, 6), slice(None), generator, dev, k)
            draws = draws.reshape(b_global, n, h, 6)
        full_draws = None
        if config.pnp_select_iter:
            full_draws = _global_rows((b_global, config.pnp_ransac_iter, 6), rows, generator,
                                      dev, k)
        out = inference.solve_batch(
            fmaps, valid, tids, tscores, cors, cameras.index(rows), repre, config,
            draws=draws[rows], obj_idx=oi, full_draws=full_draws,
            fetched_banks=(sel_feats, sel_verts, sel_mask),
        )
        return inference.PoseOutputs(**{
            f.name: mesh_mod._all_gather(getattr(out, f.name), mesh, DATA_AXIS).flatten(0, 1)
            for f in dataclasses.fields(out)
        })

    if multi:
        return step

    def single(vit, crops, masks, cameras, generator=None, draws=None):
        return step(vit, crops, masks, cameras, None, generator, draws)

    return single


def make_sharded_step(mesh, config: inference.InferenceConfig, repre_local: ObjectRepre):
    """The step for one object's bank shard (mesh.shard_repre):
    step(vit, crops, masks, cameras, generator=None, draws=None) ->
    PoseOutputs of the global batch on every rank.

    crops [B, H, W, 3] and masks [B, H, W] are the global batch (the data
    axis must divide B), cameras its crop cameras; draws [B, top_n, H, 6]
    global, or made from `generator`. `vit` is the DinoV2 on this rank's
    device, or with a `model` axis this rank's tp_vit.TPParams
    (prepare_mesh_vit_params); the ViT module carries its configuration."""
    return _make_step(mesh, config, repre_local, multi=False)


def make_sharded_step_multi(mesh, config: inference.InferenceConfig, multi_local: ObjectRepre):
    """make_sharded_step over a mixed-object batch and the bank shard of a
    stacked repre (mesh.shard_repre_multi): step(vit, crops, masks,
    cameras, obj_idx, generator=None, draws=None), obj_idx [B] global."""
    return _make_step(mesh, config, multi_local, multi=True)


def make_object_mesh_step(mesh, config: inference.InferenceConfig, repre: ObjectRepre):
    """Pads one object's whole repre to the bank axis, keeps this rank's
    shard and returns its step: the single entry point of the CLI and the
    engine, so padding, sharding and TP cannot drift between them."""
    bank = mesh_mod.axis_size(mesh, BANK_AXIS)
    return make_sharded_step(mesh, config, mesh_mod.shard_repre(pad_templates(repre, bank), mesh))


def make_multi_object_mesh_step(mesh, config: inference.InferenceConfig,
                                multi_repre: ObjectRepre):
    """make_object_mesh_step for a stacked multi-object repre: returns
    (step, this rank's shard)."""
    bank = mesh_mod.axis_size(mesh, BANK_AXIS)
    local = mesh_mod.shard_repre_multi(pad_templates(multi_repre, bank), mesh)
    return make_sharded_step_multi(mesh, config, local), local


def prepare_mesh_vit_params(mesh, model: dinov2.DinoV2):
    """The ViT as the mesh step takes it: with a `model` axis this rank's
    head and hidden shard (tp_vit.prepare_tp_params), else the model. The
    mesh steps run DINOv2 only."""
    if models.backbone_of(model) is not dinov2:
        raise ValueError(f"the multi-device layer runs DINOv2 only, not {model.cfg.family}")
    if MODEL_AXIS not in mesh.mesh_dim_names:
        return model
    return tp_vit.prepare_tp_params(
        model, mesh_mod.axis_size(mesh, MODEL_AXIS), mesh.get_local_rank(MODEL_AXIS)
    )
