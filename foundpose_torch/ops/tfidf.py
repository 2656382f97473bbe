"""Bag-of-visual-words tf-idf descriptors and template retrieval
(counterpart of foundpose_tpu/ops/tfidf.py).

All functions take a leading batch of query sets where the JAX package
vmaps over crops. Arithmetic runs in f32 whatever the stored dtype (see
ops/knn.py for why).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from foundpose_torch.ops.knn import knn_search

_ASSIGN_CHUNK = 65536


class TfidfConfig(NamedTuple):
    """Template-descriptor options."""

    knn_k: int = 3
    metric: str = "l2"
    soft_assign: bool = False
    soft_sigma_squared: float = 10.0


def _feature_weights(word_dists, soft_assign, soft_sigma_squared):
    if soft_assign:
        weights = torch.exp(-torch.square(word_dists) / (2.0 * soft_sigma_squared))
    else:
        weights = torch.ones_like(word_dists)
    norm = torch.sqrt(torch.sum(weights * weights, dim=-1, keepdim=True))
    return weights / torch.clamp_min(norm, 1e-12)


def calc_tfidf(
    word_ids: torch.Tensor,
    word_dists: torch.Tensor,
    word_idfs: torch.Tensor,
    soft_assign: bool = False,
    soft_sigma_squared: float = 10.0,
    feature_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tf-idf descriptors [..., W] from word assignments [..., N, k].

    Masked features contribute nothing and do not count toward the tf
    normalizer; non-finite idfs count as 0.
    """
    n, k = word_ids.shape[-2:]
    weights = _feature_weights(word_dists.float(), soft_assign, soft_sigma_squared)
    if feature_mask is not None:
        fm = feature_mask.float()
        weights = weights * fm[..., None]
        num_feats = torch.clamp_min(torch.sum(fm, dim=-1), 1.0)
    else:
        num_feats = torch.full(weights.shape[:-2], float(n), device=weights.device)
    tf = (weights / num_feats[..., None, None]).reshape(*weights.shape[:-2], n * k)
    ids = word_ids.reshape(*word_ids.shape[:-2], n * k).long()
    idfs = word_idfs.float()
    safe_idfs = torch.where(torch.isfinite(idfs), idfs, torch.zeros_like(idfs))
    contrib = tf * torch.gather(safe_idfs.expand(*ids.shape[:-1], -1), -1, ids)
    out = torch.zeros(*tf.shape[:-1], idfs.shape[-1], device=tf.device)
    return out.scatter_add_(-1, ids, contrib)


def calc_word_idfs(
    feat_to_word_ids: torch.Tensor,
    feat_to_template_ids: torch.Tensor,
    num_words: int,
    num_templates: int,
    feature_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """idf_w = log(T / #templates containing word w); unused words get the
    largest finite idf, log(T)."""
    ones = torch.ones(feat_to_word_ids.shape[0], device=feat_to_word_ids.device)
    if feature_mask is not None:
        ones = ones * feature_mask.float()
    cell = feat_to_template_ids.long() * num_words + feat_to_word_ids.long()
    presence = torch.zeros(num_templates * num_words, device=ones.device)
    presence = presence.scatter_reduce(0, cell, ones, reduce="amax")
    occurrences = presence.view(num_templates, num_words).sum(0)
    return torch.log(float(num_templates) / torch.clamp_min(occurrences, 1.0))


def assign_words(
    features: torch.Tensor,
    word_centroids: torch.Tensor,
    knn_k: int,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest visual words per feature: (ids [..., N, k], dists [..., N, k]),
    with L2 (not squared) distances for the "l2" metric."""
    d2, ids = knn_search(features, word_centroids, k=knn_k, metric=metric)
    dists = torch.sqrt(torch.clamp_min(d2, 0.0)) if metric == "l2" else d2
    return ids, dists


def calc_template_tfidf_descriptors(
    feat_vectors: torch.Tensor,
    feat_to_template_ids: torch.Tensor,
    word_centroids: torch.Tensor,
    num_templates: int,
    config: TfidfConfig,
    feature_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-template tf-idf descriptor bank [T, W] plus word idfs [W]. Words
    are assigned in chunks so the [chunk, W] distance block stays bounded
    (LM-O: ~400k bank features x 2048 words)."""
    num_words = word_centroids.shape[0]
    ids_l, dists_l = [], []
    for s in range(0, feat_vectors.shape[0], _ASSIGN_CHUNK):
        i, d = assign_words(
            feat_vectors[s : s + _ASSIGN_CHUNK], word_centroids, config.knn_k, config.metric
        )
        ids_l.append(i)
        dists_l.append(d)
    word_ids = torch.cat(ids_l)
    word_dists = torch.cat(dists_l)
    idfs = calc_word_idfs(
        word_ids[:, 0], feat_to_template_ids, num_words, num_templates, feature_mask
    )
    n, k = word_ids.shape
    weights = _feature_weights(word_dists, config.soft_assign, config.soft_sigma_squared)
    fmask = (
        feature_mask.float()
        if feature_mask is not None
        else torch.ones(n, device=weights.device)
    )
    weights = weights * fmask[:, None]
    tpl = feat_to_template_ids.long()
    counts = torch.zeros(num_templates, device=weights.device).index_add_(0, tpl, fmask)
    tf = weights / torch.clamp_min(counts[tpl], 1.0)[:, None]
    contrib = torch.where(tf > 0, tf * idfs[word_ids], torch.zeros_like(tf))
    cells = (tpl[:, None] * num_words + word_ids).reshape(-1)
    descs = torch.zeros(num_templates * num_words, device=weights.device)
    descs.index_add_(0, cells, contrib.reshape(-1))
    return descs.view(num_templates, num_words), idfs


def tfidf_retrieve(
    query_features: torch.Tensor,
    word_centroids: torch.Tensor,
    word_idfs: torch.Tensor,
    template_descs: torch.Tensor,
    top_n: int,
    config: TfidfConfig,
    query_mask: Optional[torch.Tensor] = None,
    template_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-N templates for each query set [..., Q, D].

    The tables (words [W, D], idfs [W], descriptors [T, W], mask [T]) may
    carry the query sets' leading axes, one table per set (mixed-object
    batches). Returns (template_ids [..., top_n], scores [..., top_n]) by
    descending cosine similarity; equal similarities (masked templates at
    -inf included) keep the lower template index first, as lax.top_k does.
    """
    word_ids, word_dists = assign_words(
        query_features, word_centroids, config.knn_k, config.metric
    )
    q = calc_tfidf(
        word_ids,
        word_dists,
        word_idfs,
        soft_assign=config.soft_assign,
        soft_sigma_squared=config.soft_sigma_squared,
        feature_mask=query_mask,
    )
    qn = q / torch.clamp_min(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)), 1e-12)
    descs = template_descs.float()
    tn = descs / torch.clamp_min(
        torch.sqrt(torch.sum(descs * descs, dim=-1, keepdim=True)), 1e-12
    )
    sims = torch.einsum("...w,...tw->...t", qn, tn)
    if template_mask is not None:
        sims = torch.where(template_mask, sims, -torch.inf)
    scores, ids = torch.sort(sims, dim=-1, descending=True, stable=True)
    return ids[..., :top_n], scores[..., :top_n]
