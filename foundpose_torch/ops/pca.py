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
