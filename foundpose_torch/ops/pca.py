"""PCA fit and projection (counterpart of foundpose_tpu/ops/pca.py)."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class PCA:
    """Fitted PCA parameters (sklearn layout: components are rows)."""

    mean: torch.Tensor  # [D]
    components: torch.Tensor  # [C, D]
    explained_variance: torch.Tensor  # [C]
    whiten: bool = False

    def to(self, device) -> "PCA":
        return dataclasses.replace(
            self,
            mean=self.mean.to(device),
            components=self.components.to(device),
            explained_variance=self.explained_variance.to(device),
        )


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 products without TF32 inside the block, whatever the process set
    (the JAX package asks for Precision.HIGHEST)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def fit_pca(
    samples: torch.Tensor,
    num_components: int,
    whiten: bool = False,
    sample_mask: Optional[torch.Tensor] = None,
) -> PCA:
    """PCA of [N, D] samples (rows where `sample_mask` [N] is False left
    out), with sklearn's semantics: mean-centred, eigenvectors of the
    unbiased covariance, components sorted by decreasing variance. Mean and
    covariance in f32 without TF32; component signs are arbitrary, as in
    sklearn and the JAX package."""
    n = samples.shape[0]
    x = samples.float()
    with _full_f32_matmul():
        if sample_mask is None:
            count = torch.tensor(float(n), device=x.device)
            mean = torch.mean(x, dim=0)
            xc = x - mean
        else:
            w = sample_mask.float()
            count = torch.sum(w)
            mean = torch.sum(x * w[:, None], dim=0) / count
            xc = (x - mean) * w[:, None]
        cov = (xc.T @ xc) / torch.clamp_min(count - 1.0, 1.0)
    eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
    eigvals = torch.flip(eigvals, dims=(0,))[:num_components]
    components = torch.flip(eigvecs, dims=(1,))[:, :num_components].T.contiguous()
    return PCA(
        mean=mean,
        components=components,
        explained_variance=torch.clamp_min(eigvals, 0.0),
        whiten=whiten,
    )


def pca_transform(pca: PCA, x: torch.Tensor) -> torch.Tensor:
    """Projects [..., D] features to [..., C] in f32."""
    out = torch.einsum("...d,cd->...c", x - pca.mean, pca.components)
    if pca.whiten:
        out = out / torch.sqrt(torch.clamp_min(pca.explained_variance, 1e-12))
    return out


def pca_transform_gathered(pca: PCA, idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Projects x [B, ..., D], item i by projector idx[i] of a stacked PCA
    (mean [O, D], components [O, C, D]) -> [B, ..., C] in f32."""
    flat = x.reshape(x.shape[0], -1, x.shape[-1])
    out = torch.einsum("bqd,bcd->bqc", flat - pca.mean[idx][:, None], pca.components[idx])
    if pca.whiten:
        out = out / torch.sqrt(torch.clamp_min(pca.explained_variance[idx], 1e-12))[:, None]
    return out.reshape(*x.shape[:-1], out.shape[-1])


def pca_inverse_transform(pca: PCA, y: torch.Tensor) -> torch.Tensor:
    """Maps [..., C] projections back to the original [..., D] space."""
    if pca.whiten:
        y = y * torch.sqrt(torch.clamp_min(pca.explained_variance, 1e-12))
    return torch.einsum("...c,cd->...d", y, pca.components) + pca.mean
