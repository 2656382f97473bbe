"""FoundPose's retrieval and matching (Ornek et al., ECCV 2024), plain.

Query points are the centres of a grid of 14 px cells over the crop, kept
where the mask covers the cell's centre pixel; their features are the
facet's patch tokens (one cell per patch), projected by PCA. Templates are
ranked by the cosine of tf-idf descriptors over visual words (each feature
votes for its 3 nearest words with equal weight). Correspondences are
cyclic buddies: query q, its nearest template feature o, that feature's
nearest query q'; the `top_k` queries whose cycle |q - q'| is shortest.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from perfbench.reference.precision import Precision

KNN_K = 3


def grid_points(crop_px: Tuple[int, int], cell: float, device) -> torch.Tensor:
    """[(H / cell) * (W / cell), 2] (x, y) cell centres, row by row."""
    w, h = crop_px
    xs = torch.linspace(cell / 2, w - cell / 2, int(w / cell), device=device)
    ys = torch.linspace(cell / 2, h - cell / 2, int(h / cell), device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def query_valid(points: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """[B, Q]: the cell centre's pixel (rounded half up) lies strictly
    inside the crop and on its mask."""
    h, w = masks.shape[-2:]
    pi = torch.floor(points + 0.5).long()
    x, y = pi[:, 0], pi[:, 1]
    inside = (x > 0) & (x < w) & (y > 0) & (y < h)
    return inside & (masks[:, y.clamp(0, h - 1), x.clamp(0, w - 1)] > 0)


def project(fmap: torch.Tensor, pca: Dict[str, torch.Tensor], prec: Precision) -> torch.Tensor:
    """Patch features [B, gh, gw, Draw] -> PCA features [B, Q, D]."""
    x = fmap.reshape(fmap.shape[0], -1, fmap.shape[-1]).float() - pca["mean"]
    return prec.mm(x, pca["components"].t())


def sqdist(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Squared L2 distances [..., N, M] of rows a [..., N, D], b [..., M, D]."""
    a2 = (a.float() ** 2).sum(-1)[..., :, None]
    b2 = (b.float() ** 2).sum(-1)[..., None, :]
    return (a2 + b2 - 2.0 * prec.mm(a, b.transpose(-1, -2))).clamp_min(0.0)


def nearest_words(feats: torch.Tensor, words: torch.Tensor, prec: Precision, rows: int = 65536):
    """The KNN_K nearest words of each feature [N, D]: ids [N, k]."""
    ids = [torch.topk(sqdist(feats[r : r + rows], words, prec), KNN_K, largest=False).indices
           for r in range(0, feats.shape[0], rows)]
    return torch.cat(ids)


def tfidf(word_ids: torch.Tensor, valid: torch.Tensor, idfs: torch.Tensor) -> torch.Tensor:
    """Descriptors [S, W] of S feature sets: word_ids [S, N, k], valid [S, N]."""
    s, n, k = word_ids.shape
    v = valid.float()
    tf = (v / v.sum(-1, keepdim=True).clamp_min(1.0))[..., None] / k ** 0.5
    contrib = tf.expand(s, n, k) * idfs[word_ids]
    out = torch.zeros(s, idfs.shape[0], device=idfs.device)
    return out.scatter_add_(1, word_ids.reshape(s, n * k), contrib.reshape(s, n * k))


def template_tables(bank_feats, bank_mask, words, prec: Precision):
    """(idfs [W], descriptors [T, W]) of template banks [T, F, D]: idf_w =
    log(T / templates whose features have w nearest), log(T) for unused
    words."""
    t, f, d = bank_feats.shape
    ids = nearest_words(bank_feats.reshape(-1, d), words, prec).reshape(t, f, KNN_K)
    seen = torch.zeros(t, words.shape[0], device=words.device)
    seen.scatter_add_(1, torch.where(bank_mask, ids[..., 0], 0), bank_mask.float())
    idfs = torch.log(t / (seen > 0).float().sum(0).clamp_min(1.0))
    return idfs, tfidf(ids, bank_mask, idfs)


def template_similarity(qfeats, valid, world, prec: Precision) -> torch.Tensor:
    """Cosine similarity [B, T] of each crop's query descriptor to every
    template's."""
    b, q, d = qfeats.shape
    ids = nearest_words(qfeats.reshape(-1, d), world["words"], prec).reshape(b, q, KNN_K)
    qd = tfidf(ids, valid, world["idfs"])
    qd = qd / qd.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    td = world["descs"] / world["descs"].norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return prec.mm(qd, td.t())


def cyclic_buddies(points, qfeats, qvalid, bank_feats, bank_mask, top_k: int, prec: Precision):
    """Exact cyclic buddies of each crop with one template each: qfeats
    [B, Q, D], qvalid [B, Q], bank_feats [B, F, D], bank_mask [B, F]. Returns
    query ids, bank ids and validity, each [B, k], queries ordered by cycle
    length (ties to the lower id)."""
    d = sqdist(qfeats, bank_feats, prec)
    d = torch.where(qvalid[:, :, None] & bank_mask[:, None, :], d, torch.inf)
    q2o = d.argmin(2)
    o2q = d.argmin(1)
    back = torch.gather(o2q, 1, q2o)
    cycle = (points[None] - points[back]).norm(dim=-1)
    cycle = torch.where(qvalid, cycle, torch.inf)
    q_ids = torch.sort(cycle, dim=1, stable=True).indices[:, :top_k]
    return q_ids, torch.gather(q2o, 1, q_ids), torch.isfinite(torch.gather(cycle, 1, q_ids))
