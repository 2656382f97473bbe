"""Cyclic-buddy 2D-3D correspondence search (counterpart of
foundpose_tpu/pose/corresp.py).

The approx_topk path (every shipped configuration) takes its cycle
distances from ops/buddies_kernel.cycle_distances: the CUDA kernel on a
GPU, its twin on a CPU, chosen by the tensors' device. The exact path uses
argmin and a stable sort in plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from foundpose_torch.ops.buddies_kernel import cycle_distances
from foundpose_torch.ops.knn import pairwise_sqdist
from foundpose_torch.ops.selection import INVALID_SENTINEL, compact_smallest_k


@dataclasses.dataclass
class Correspondences:
    """Fixed-size correspondence sets; fields carry leading [B, T'] axes."""

    coord_2d: torch.Tensor  # [..., K, 2] query-image coordinates
    coord_2d_ids: torch.Tensor  # [..., K] indices into the query grid
    coord_3d: torch.Tensor  # [..., K, 3] model-space points
    coord_conf: torch.Tensor  # [..., K] buddy scores in [0, 1]
    nn_vertex_ids: torch.Tensor  # [..., K] indices into the template bank
    cycle_dists: torch.Tensor  # [..., K]
    valid: torch.Tensor  # [..., K] bool
    template_id: torch.Tensor  # [...]
    template_score: torch.Tensor  # [...]


def _gather_last(a: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """a[..., ids] along the last axis, batched."""
    return torch.gather(a, -1, ids)


def _gather_rows(a: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """a [..., F, C] rows at ids [..., K] -> [..., K, C]."""
    return torch.gather(a, -2, ids[..., None].expand(*ids.shape, a.shape[-1]))


def _scores(bb_dists: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    d_max = torch.amax(torch.where(valid, bb_dists, -torch.inf), dim=-1, keepdim=True)
    return torch.where(
        valid, 1.0 - bb_dists / torch.clamp_min(d_max, 1e-12), torch.zeros_like(bb_dists)
    )


def _compact_buddies(query_points, cycle_dists, q2o, verts, top_k):
    """Top-k buddies of the approx path, slots ordered by query index.

    cycle_dists [..., Q] (invalid >= INVALID_SENTINEL), q2o [..., Q],
    verts [..., F, 3]. Returns (coord_2d, q_ids, coord_3d, scores, dists,
    valid, o_ids) with [..., K] leading shapes.
    """
    q_ids = compact_smallest_k(cycle_dists, top_k)
    bb = _gather_last(cycle_dists, q_ids)
    o_ids = _gather_last(q2o.long(), q_ids)
    coord_2d = query_points[q_ids]
    valid = bb < INVALID_SENTINEL * 0.5
    coord_3d = _gather_rows(verts.float(), o_ids)
    scores = _scores(bb, valid)
    return coord_2d, q_ids, coord_3d, scores, torch.where(valid, bb, 0.0), valid, o_ids


def establish_correspondences_batch(
    query_points: torch.Tensor,
    query_feats: torch.Tensor,
    query_mask: torch.Tensor,
    template_ids: torch.Tensor,
    template_scores: torch.Tensor,
    bank_feats: torch.Tensor,
    bank_vertices: torch.Tensor,
    bank_mask: torch.Tensor,
    top_k: int,
    approx_topk: bool = False,
    obj_idx: Optional[torch.Tensor] = None,
) -> Correspondences:
    """Buddy correspondences for all crops x retrieved templates.

    Args:
        query_points: [Q, 2] shared grid.
        query_feats: [B, Q, D]; query_mask: [B, Q] bool.
        template_ids/scores: [B, T'].
        bank_feats/vertices/mask: [T, F, ...] per-template banks, or
            [O, T, F, ...] stacked per object with `obj_idx` [B] giving
            each crop's object.
    """
    tids = template_ids.long()
    sel = tids if obj_idx is None else (obj_idx.long()[:, None], tids)
    sel_feats = bank_feats[sel]  # [B, T', F, D]
    sel_verts = bank_vertices[sel]
    sel_mask = bank_mask[sel]
    qpts = query_points.float()

    if approx_topk:
        cdm, q2o = cycle_distances(query_feats, query_mask, qpts, sel_feats, sel_mask)
        c2d, q_ids, c3d, scores, bb, valid, o_ids = _compact_buddies(
            qpts, cdm, q2o, sel_verts, top_k
        )
    else:
        d = pairwise_sqdist(query_feats[:, None], sel_feats)  # [B, T', Q, F]
        d = torch.where(query_mask[:, None, :, None], d, torch.inf)
        d = torch.where(sel_mask[:, :, None, :], d, torch.inf)
        q2o = torch.argmin(d, dim=-1)
        o2q = torch.argmin(d, dim=-2)
        diff = qpts - qpts[_gather_last(o2q, q2o)]
        cd = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
        cd = torch.where(query_mask[:, None, :], cd, torch.inf)
        # lax.top_k order: ascending distance, ties to the lower index.
        q_ids = torch.sort(cd, dim=-1, stable=True).indices[..., :top_k]
        bb = _gather_last(cd, q_ids)
        valid = torch.isfinite(bb)
        scores = _scores(bb, valid)
        o_ids = _gather_last(q2o, q_ids)
        c2d = qpts[q_ids]
        c3d = _gather_rows(sel_verts.float(), o_ids)
        bb = torch.where(valid, bb, 0.0)

    return Correspondences(
        coord_2d=c2d,
        coord_2d_ids=q_ids,
        coord_3d=c3d,
        coord_conf=scores,
        nn_vertex_ids=o_ids,
        cycle_dists=bb,
        valid=valid,
        template_id=template_ids,
        template_score=template_scores,
    )
