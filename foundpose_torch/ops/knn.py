"""Brute-force k-nearest-neighbour search (counterpart of
foundpose_tpu/ops/knn.py).

Distances are computed in f32 from the stored values whatever their dtype:
the JAX package evaluates bf16 inputs in bf16 and rounds the distances to
bf16, which makes ties common and their order device-dependent. At f32
inputs the two agree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def pairwise_sqdist(queries: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [..., Q, N] between [..., Q, D] and [..., N, D]."""
    q = queries.float()
    b = bank.float()
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    bn = torch.sum(b * b, dim=-1)[..., None, :]
    cross = torch.einsum("...qd,...nd->...qn", q, b)
    return torch.clamp_min(qn + bn - 2.0 * cross, 0.0)


def cosine_sim(queries: torch.Tensor, bank: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Cosine similarity [..., Q, N] between [..., Q, D] and [..., N, D]."""
    q = queries.float()
    b = bank.float()
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), eps)
    b = b / torch.clamp_min(torch.linalg.vector_norm(b, dim=-1, keepdim=True), eps)
    return torch.einsum("...qd,...nd->...qn", q, b)


def knn_search(
    queries: torch.Tensor,
    bank: torch.Tensor,
    k: int,
    metric: str = "l2",
    bank_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN; returns (dists [..., Q, k], ids [..., Q, k]) ascending.

    "l2" gives squared L2 distances, "cosine" gives 1 - cosine similarity.
    Bank rows where `bank_mask` [..., N] is False are never returned.
    """
    if metric == "l2":
        d = pairwise_sqdist(queries, bank)
    elif metric == "cosine":
        d = 1.0 - cosine_sim(queries, bank)
    else:
        raise ValueError(f"unknown metric: {metric}")
    if bank_mask is not None:
        d = torch.where(bank_mask[..., None, :], d, torch.inf)
    dists, ids = torch.topk(d, k, dim=-1, largest=False, sorted=True)
    return dists, ids


def knn_search_tiled(
    queries: torch.Tensor,
    bank: torch.Tensor,
    k: int,
    tile: int = 2048,
    bank_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN of [Q, D] queries over a large [N, D] bank (squared L2), tile by
    tile with a running top-k merge, so the live distance block stays
    [Q, tile + k]. Equal to `knn_search`."""
    nq, dev = queries.shape[0], queries.device
    best_d = torch.full((nq, k), torch.inf, device=dev)
    best_i = torch.zeros((nq, k), dtype=torch.long, device=dev)
    for s in range(0, bank.shape[0], tile):
        dist = pairwise_sqdist(queries, bank[s : s + tile])
        if bank_mask is not None:
            dist = torch.where(bank_mask[s : s + tile][None, :], dist, torch.inf)
        ids = torch.arange(s, s + dist.shape[1], device=dev).expand(nq, -1)
        best_d, sel = torch.topk(torch.cat([best_d, dist], dim=-1), k, dim=-1, largest=False,
                                 sorted=True)
        best_i = torch.gather(torch.cat([best_i, ids], dim=-1), -1, sel)
    return best_d, best_i


def radius_search(
    queries: torch.Tensor,
    bank: torch.Tensor,
    radius: float,
    max_neighbors: int,
    metric: str = "l2",
    bank_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to `max_neighbors` bank rows within `radius` (squared L2 for "l2",
    faiss range-search semantics): (dists [..., Q, M], ids [..., Q, M],
    valid [..., Q, M]); slots past the in-radius count are invalid, their
    distance 0. (reference: utils/knn_util.py:85-89)"""
    dists, ids = knn_search(queries, bank, k=max_neighbors, metric=metric, bank_mask=bank_mask)
    valid = dists <= radius
    return torch.where(valid, dists, 0.0), ids, valid


def argmin_dist(
    queries: torch.Tensor, bank: torch.Tensor, bank_mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN: (least squared L2 distance, its index) per query; the first
    index on ties, as jnp.argmin."""
    d = pairwise_sqdist(queries, bank)
    if bank_mask is not None:
        d = torch.where(bank_mask[..., None, :], d, torch.inf)
    idx = torch.argmin(d, dim=-1)
    return torch.gather(d, -1, idx[..., None])[..., 0], idx
