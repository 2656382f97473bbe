"""Brute-force k-nearest-neighbour search (counterpart of
foundpose_tpu/ops/knn.py).

Distances are computed in f32 from the stored values whatever their dtype:
the JAX package evaluates bf16 inputs in bf16 and rounds the distances to
bf16, which makes ties common and their order device-dependent. At f32
inputs the two agree.
"""

from __future__ import annotations

from typing import Tuple

import torch


def pairwise_sqdist(queries: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [..., Q, N] between [..., Q, D] and [..., N, D]."""
    q = queries.float()
    b = bank.float()
    qn = torch.sum(q * q, dim=-1, keepdim=True)
    bn = torch.sum(b * b, dim=-1)[..., None, :]
    cross = torch.einsum("...qd,...nd->...qn", q, b)
    return torch.clamp_min(qn + bn - 2.0 * cross, 0.0)


def knn_search(
    queries: torch.Tensor,
    bank: torch.Tensor,
    k: int,
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN; returns (dists [..., Q, k], ids [..., Q, k]) ascending.

    "l2" gives squared L2 distances, "cosine" gives 1 - cosine similarity.
    """
    if metric == "l2":
        d = pairwise_sqdist(queries, bank)
    elif metric == "cosine":
        q = queries.float()
        b = bank.float()
        q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)
        b = b / torch.clamp_min(torch.linalg.vector_norm(b, dim=-1, keepdim=True), 1e-12)
        d = 1.0 - torch.einsum("...qd,...nd->...qn", q, b)
    else:
        raise ValueError(f"unknown metric: {metric}")
    dists, ids = torch.topk(d, k, dim=-1, largest=False, sorted=True)
    return dists, ids
