"""The reference step over a batch of crops.

`analyse` computes what the judge reads: the query features, their
validity and every template's tf-idf similarity. `outputs` puts the
reference in the program's place: the top templates, the first one's
cyclic buddies and a DLT pose, fields named as the judge reads the
program's. The backbone comes as `vit(images, prec)`: a family's reference
`feature_maps` bound to its weights and shape, taking images [B, H, W, 3]
in [0, 1] to patch features [B, gh, gw, D]. Run with
`Precision(lowp=True)` that is the control (with a subset of its stages,
the control of those stages alone).
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import pose, retrieval
from perfbench.reference.precision import Precision, exact_f32


@torch.no_grad()
def features(vit, pca, crops, masks, cell: float, prec: Precision) -> Dict[str, torch.Tensor]:
    """Query points [Q, 2], PCA features [B, Q, D] and validity [B, Q] of
    crops [B, H, W, 3] (uint8, or float in [0, 1]) with masks [B, H, W]."""
    with exact_f32():
        images = crops.float() / 255.0 if crops.dtype == torch.uint8 else crops.float()
        fmap = vit(images, prec)
        h, w = crops.shape[1:3]
        points = retrieval.grid_points((w, h), cell, crops.device)
        if fmap.shape[1] * fmap.shape[2] != points.shape[0]:
            raise ValueError("the reference takes one grid cell per patch")
        return {"points": points, "q": retrieval.project(fmap, pca, prec),
                "valid": retrieval.query_valid(points, masks)}


@torch.no_grad()
def analyse(vit, world, crops, masks, cell: float, prec: Precision) -> Dict[str, torch.Tensor]:
    """`features` and the similarities [B, T] to every template."""
    ana = features(vit, world["pca"], crops, masks, cell, prec)
    with exact_f32():
        ana["sims"] = retrieval.template_similarity(ana["q"], ana["valid"], world, prec)
    return ana


@torch.no_grad()
def outputs(ana, world, f, c, top_n: int, top_k: int, prec: Precision) -> Dict[str, torch.Tensor]:
    """The reference's answers for the analysed crops with crop intrinsics
    f, c [B, 2]: template ids and scores [B, top_n], best template [B],
    buddies of the best (query ids, 3D points, validity [B, top_k]) and the
    pose R [B, 3, 3], t [B, 3] in the crop camera."""
    with exact_f32():
        scores, ids = torch.sort(ana["sims"], dim=1, descending=True, stable=True)
        best = ids[:, 0]
        q_ids, o_ids, ok = retrieval.cyclic_buddies(
            ana["points"], ana["q"], ana["valid"], world["bank_feats"][best],
            world["bank_mask"][best], top_k, prec)
        c3d = torch.gather(world["bank_vertices"][best], 1, o_ids[..., None].expand(-1, -1, 3))
        r, t = pose.dlt_pose(ana["points"][q_ids], c3d, ok, f, c, prec)
    return {"template_ids": ids[:, :top_n], "template_scores": scores[:, :top_n],
            "best_template": best, "success": ok.sum(1) >= 6, "corr_q": q_ids,
            "corr_3d": c3d, "corr_valid": ok, "R": r, "t": t}
