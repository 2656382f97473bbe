"""PCA projection (counterpart of foundpose_tpu/ops/pca.py)."""

from __future__ import annotations

import dataclasses

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
