"""numpy stand-ins for the scikit-learn pieces the reference replicas call
(`reference_baseline`, `reference_offline_baseline`), for hosts without
scikit-learn. The replicas' nearest-neighbour searches use
`cross_parity.knn` (exact brute force, float64 distances).

- `PCA(n_components)`: `fit` is the SVD of the centred data, as
  scikit-learn's full solver computes it (`mean_`, `components_` with its
  sign rule, `explained_variance_` over n - 1); `transform` is
  `(x - mean_) @ components_.T`.
- `kmeans_lloyd(x, k, iters, init, seed)`: random rows as the initial
  centres (scikit-learn's `init="random"`, and faiss's), or `init`; then
  Lloyd steps, each an assignment by blocks of BLAS distances and a mean
  per cluster, stopping early when the labels repeat, and a last
  assignment to the final centres, as scikit-learn's `KMeans(
  algorithm="lloyd", tol=0)` does. An empty cluster keeps its centre
  (scikit-learn moves it to a far point).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Rows of a k-means distance block (x 2,048 centres: 32 MB of float32).
ASSIGN_CHUNK = 4096


class PCA:
    def __init__(self, n_components: int):
        self.n_components = n_components

    def fit(self, x) -> "PCA":
        x = np.asarray(x)
        self.mean_ = x.mean(axis=0)
        u, s, vt = np.linalg.svd(x - self.mean_, full_matrices=False)
        # scikit-learn's svd_flip(u_based_decision=False): the largest
        # entry of each component, by magnitude, is positive.
        signs = np.sign(vt[np.arange(len(vt)), np.abs(vt).argmax(axis=1)])
        signs[signs == 0] = 1
        self.components_ = (vt * signs[:, None])[: self.n_components]
        self.explained_variance_ = (s**2 / (len(x) - 1))[: self.n_components]
        return self

    def transform(self, x) -> np.ndarray:
        return (np.asarray(x) - self.mean_) @ self.components_.T


def assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Index of each row's nearest centre (squared Euclidean distance; ties
    to the lower index), by blocks of ASSIGN_CHUNK rows."""
    cc = np.einsum("ij,ij->i", centers, centers)
    labels = np.empty(len(x), np.int64)
    for s in range(0, len(x), ASSIGN_CHUNK):
        d2 = x[s : s + ASSIGN_CHUNK] @ centers.T
        d2 *= -2.0
        d2 += cc[None]
        labels[s : s + ASSIGN_CHUNK] = d2.argmin(axis=1)  # |x|^2 is the same for every centre
    return labels


def kmeans_lloyd(x, k: int, iters: int, init: Optional[np.ndarray] = None,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray, int]:
    """(centres [k, D], labels [N], Lloyd steps run) of `x` [N, D]."""
    x = np.asarray(x, np.float32)
    if init is None:
        init = x[np.random.default_rng(seed).choice(len(x), size=k, replace=False)]
    centers = np.array(init, np.float32)
    labels, steps = None, 0
    for steps in range(1, iters + 1):
        new = assign(x, centers)
        counts = np.bincount(new, minlength=k)
        full = counts > 0
        # Each non-empty cluster's rows are one run of the label-sorted rows.
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])[full]
        sums = np.add.reduceat(x[np.argsort(new, kind="stable")], starts, axis=0)
        centers[full] = sums / counts[full, None]
        if labels is not None and np.array_equal(new, labels):
            return centers, new, steps
        labels = new
    return centers, assign(x, centers), steps
