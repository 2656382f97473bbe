"""Lloyd k-means with k-means++ seeding (counterpart of
foundpose_tpu/ops/kmeans.py), for the representation builder's visual
words.

Three parts, as in the JAX package: `_kmeanspp_init` (K sequential draws,
each with probability proportional to the squared distance to the nearest
centre drawn so far), `_assign` (nearest centroid per row) and `_lloyd`
(a fixed number of steps; a cluster left empty keeps its centroid). Every
step stays on the tensors' device with no host sync: the draws and the
sums and counts of each step never leave it.

At LM-O scale (718,200 rows x 2048 words x 256 dims) the [N, K] distance
block would be 5.9 GB in f32, so `_assign` computes it in row chunks; the
chunks do not change the assignments. Distances are ||x||^2 + ||c||^2 -
2 x.c, as the JAX package's `pairwise_sqdist`, with the rows' norms computed
once: the init reads the bank once per draw and never forms x - c.

The draws differ from the JAX package's (`jax.random.choice` and a
`torch.Generator` are different streams, and torch's CPU and CUDA
generators differ too), so the init is held to its law, and the Lloyd
loop to the JAX package's from the JAX init (`_lloyd`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

_ASSIGN_CHUNK = 65536


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # [K, D]
    assignments: torch.Tensor  # [N]
    distances: torch.Tensor  # [N] squared L2 to the assigned centroid (0 on masked rows)


def _draw(weights: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One index [1] with probability proportional to the non-negative
    `weights` [N]. This is torch.multinomial(weights, 1)'s own draw (the
    exponential race, argmax of w / E with E ~ Exp(1)) without its input
    check, which reads a value back to the host on the card."""
    e = torch.empty_like(weights).exponential_(1.0, generator=generator)
    return torch.argmax(weights / e).reshape(1)


def _kmeanspp_init(
    samples: torch.Tensor,
    num_clusters: int,
    generator: torch.Generator,
    sample_mask: torch.Tensor,
    sample_norms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """k-means++ seeding over the valid rows of [N, D] f32 samples: the row
    ids [K] of the centres. The first is uniform over the valid rows; each
    next one has probability proportional to the squared distance to the
    nearest centre so far (a drawn row's own distance is set to exactly 0,
    so no row is drawn twice while another valid row is left)."""
    n = samples.shape[0]
    valid = sample_mask.float()
    xn = torch.sum(samples * samples, dim=-1) if sample_norms is None else sample_norms
    ids = torch.empty(num_clusters, dtype=torch.long, device=samples.device)
    last = _draw(valid, generator)
    ids[0:1] = last
    min_d2 = torch.full((n,), torch.inf, device=samples.device)
    for i in range(1, num_clusters):
        c = torch.index_select(samples, 0, last)[0]
        d2 = torch.clamp_min(xn - 2.0 * (samples @ c) + torch.dot(c, c), 0.0)
        min_d2 = torch.minimum(min_d2, d2).index_fill_(0, last, 0.0)
        probs = min_d2 * valid
        # Fewer distinct valid rows than clusters: draw among the valid rows.
        probs = torch.where(torch.sum(probs) > 0, probs, valid)
        last = _draw(probs, generator)
        ids[i : i + 1] = last
    return ids


def _assign(
    samples: torch.Tensor,
    centroids: torch.Tensor,
    sample_mask: torch.Tensor,
    sample_norms: Optional[torch.Tensor] = None,
    chunk: int = _ASSIGN_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid of every row (the first on ties, as jnp.argmin) and
    its squared distance, 0 on masked rows; [chunk, K] blocks at a time."""
    n = samples.shape[0]
    xn = torch.sum(samples * samples, dim=-1) if sample_norms is None else sample_norms
    cn = torch.sum(centroids * centroids, dim=-1)[None, :]
    assign = torch.empty(n, dtype=torch.long, device=samples.device)
    mind = torch.empty(n, device=samples.device)
    for s in range(0, n, chunk):
        x = samples[s : s + chunk]
        d = torch.clamp_min(xn[s : s + chunk, None] + cn - 2.0 * (x @ centroids.T), 0.0)
        a = torch.argmin(d, dim=-1)
        assign[s : s + chunk] = a
        mind[s : s + chunk] = torch.gather(d, -1, a[:, None])[:, 0]
    return assign, torch.where(sample_mask, mind, 0.0)


def _lloyd(
    samples: torch.Tensor,
    init_centroids: torch.Tensor,
    sample_mask: torch.Tensor,
    num_iters: int,
    sample_norms: Optional[torch.Tensor] = None,
) -> KMeansResult:
    """`num_iters` Lloyd steps from `init_centroids` [K, D], then the final
    assignment. Masked rows count in no cluster."""
    samples = samples.float()
    k, d = init_centroids.shape
    xn = torch.sum(samples * samples, dim=-1) if sample_norms is None else sample_norms
    ones = torch.ones(samples.shape[0], device=samples.device)
    centroids = init_centroids.float()
    for _ in range(num_iters):
        assign, _ = _assign(samples, centroids, sample_mask, xn)
        # Masked rows go to a sink row K, dropped after the sums.
        sink = torch.where(sample_mask, assign, k)
        sums = torch.zeros(k + 1, d, device=samples.device).index_add_(0, sink, samples)[:k]
        counts = torch.zeros(k + 1, device=samples.device).index_add_(0, sink, ones)[:k]
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        # An empty cluster keeps its previous centroid.
        centroids = torch.where((counts > 0)[:, None], new, centroids)
    assign, mind = _assign(samples, centroids, sample_mask, xn)
    return KMeansResult(centroids=centroids, assignments=assign, distances=mind)


def kmeans(
    samples: torch.Tensor,
    num_clusters: int,
    generator: torch.Generator,
    num_iters: int = 50,
    sample_mask: Optional[torch.Tensor] = None,
) -> KMeansResult:
    """k-means++ seeding, then `num_iters` Lloyd steps (reference default
    50, utils/cluster_util.py:40).

    Args:
        samples: [N, D] features (rows may be padding, see sample_mask).
        num_clusters: K.
        generator: a torch.Generator on the samples' device, for the seeding.
        sample_mask: optional [N] bool marking the valid rows.
    """
    samples = samples.float()
    if sample_mask is None:
        sample_mask = torch.ones(samples.shape[0], dtype=torch.bool, device=samples.device)
    xn = torch.sum(samples * samples, dim=-1)
    ids = _kmeanspp_init(samples, num_clusters, generator, sample_mask, xn)
    return _lloyd(samples, samples[ids], sample_mask, num_iters, xn)
