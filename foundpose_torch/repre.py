"""Feature-based object representation (counterpart of
foundpose_tpu/repre.py).

The serialized form is the JAX package's own: `repre.npz` plus
`repre_meta.json` as `foundpose_tpu.repre.save_repre` writes them, read here
unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from foundpose_torch.ops.pca import PCA
from foundpose_torch.ops.tfidf import TfidfConfig
from foundpose_torch.structs import PinholeCamera


@dataclasses.dataclass
class ObjectRepre:
    """Visual object features registered in 3D, plus retrieval structures."""

    vertices: torch.Tensor  # [F, 3]
    feat_vectors: torch.Tensor  # [F, D]
    feat_to_template_ids: torch.Tensor  # [F]
    feat_mask: torch.Tensor  # [F] bool
    word_centroids: torch.Tensor  # [W, D]
    word_idfs: torch.Tensor  # [W]
    template_descs: torch.Tensor  # [T, W]
    bank_feats: torch.Tensor  # [T, Fmax, D]
    bank_vertices: torch.Tensor  # [T, Fmax, 3]
    bank_mask: torch.Tensor  # [T, Fmax] bool
    template_cameras: PinholeCamera
    raw_projector: Optional[PCA] = None
    template_mask: Optional[torch.Tensor] = None  # [T] bool
    tfidf_config: TfidfConfig = TfidfConfig()
    extractor_name: str = ""

    @property
    def num_templates(self) -> int:
        return self.template_descs.shape[0]

    def cast_banks(self, dtype: torch.dtype) -> "ObjectRepre":
        """Casts the feature banks, codebook and template descriptors to
        `dtype` (e.g. bfloat16) at rest; geometry and the projector stay."""
        return dataclasses.replace(
            self,
            feat_vectors=self.feat_vectors.to(dtype),
            word_centroids=self.word_centroids.to(dtype),
            template_descs=self.template_descs.to(dtype),
            bank_feats=self.bank_feats.to(dtype),
        )

    def to(self, device) -> "ObjectRepre":
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(
            self,
            **moved,
            template_cameras=self.template_cameras.to(device),
            raw_projector=(
                self.raw_projector.to(device) if self.raw_projector is not None else None
            ),
        )


def build_padded_banks(
    feat_vectors: np.ndarray,
    vertices: np.ndarray,
    feat_to_template_ids: np.ndarray,
    num_templates: int,
    max_feats_per_template: Optional[int] = None,
    pad_multiple: int = 128,
):
    """Reorganizes flat feature arrays into padded [T, Fmax, ...] banks,
    Fmax rounded up to `pad_multiple`."""
    counts = np.bincount(feat_to_template_ids, minlength=num_templates)
    fmax = int(counts.max()) if max_feats_per_template is None else max_feats_per_template
    fmax = max(-(-fmax // pad_multiple) * pad_multiple, pad_multiple)
    d = feat_vectors.shape[1]
    bank_feats = np.zeros((num_templates, fmax, d), dtype=feat_vectors.dtype)
    bank_vertices = np.zeros((num_templates, fmax, 3), dtype=vertices.dtype)
    bank_mask = np.zeros((num_templates, fmax), dtype=bool)
    for t in range(num_templates):
        sel = np.nonzero(feat_to_template_ids == t)[0][:fmax]
        k = len(sel)
        bank_feats[t, :k] = feat_vectors[sel]
        bank_vertices[t, :k] = vertices[sel]
        bank_mask[t, :k] = True
    return bank_feats, bank_vertices, bank_mask


def make_repre(
    feat_vectors: np.ndarray,
    vertices: np.ndarray,
    feat_to_template_ids: np.ndarray,
    word_centroids: np.ndarray,
    word_idfs: np.ndarray,
    template_descs: np.ndarray,
    template_cameras: PinholeCamera,
    raw_projector: Optional[PCA] = None,
    tfidf_config: TfidfConfig = TfidfConfig(),
    extractor_name: str = "",
    feat_mask: Optional[np.ndarray] = None,
    device="cpu",
) -> ObjectRepre:
    """ObjectRepre on `device` from flat host arrays (banks built here)."""
    num_templates = template_descs.shape[0]
    bank_feats, bank_vertices, bank_mask = build_padded_banks(
        feat_vectors, vertices, feat_to_template_ids, num_templates
    )
    if feat_mask is None:
        feat_mask = np.ones(len(feat_vectors), dtype=bool)

    def place(a):
        return torch.as_tensor(np.asarray(a), device=device)

    return ObjectRepre(
        vertices=place(vertices),
        feat_vectors=place(feat_vectors),
        feat_to_template_ids=place(feat_to_template_ids),
        feat_mask=place(feat_mask),
        word_centroids=place(word_centroids),
        word_idfs=place(word_idfs),
        template_descs=place(template_descs),
        bank_feats=place(bank_feats),
        bank_vertices=place(bank_vertices),
        bank_mask=place(bank_mask),
        template_cameras=template_cameras.to(device),
        raw_projector=raw_projector.to(device) if raw_projector is not None else None,
        tfidf_config=tfidf_config,
        extractor_name=extractor_name,
    )


def load_repre(repre_dir: str, device="cpu") -> ObjectRepre:
    """Reads `<dir>/repre.npz` + `<dir>/repre_meta.json` written by the JAX
    package's `save_repre`."""
    with np.load(os.path.join(repre_dir, "repre.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(repre_dir, "repre_meta.json")) as f:
        meta = json.load(f)
    cameras = PinholeCamera(
        f=torch.as_tensor(arrays["cam_f"]),
        c=torch.as_tensor(arrays["cam_c"]),
        T_world_from_eye=torch.as_tensor(arrays["cam_T"]),
        width=int(meta["cam_width"]),
        height=int(meta["cam_height"]),
    )
    projector = None
    if "pca_mean" in arrays:
        projector = PCA(
            mean=torch.as_tensor(arrays["pca_mean"]),
            components=torch.as_tensor(arrays["pca_components"]),
            explained_variance=torch.as_tensor(arrays["pca_variance"]),
            whiten=bool(meta.get("pca_whiten")),
        )
    return make_repre(
        feat_vectors=arrays["feat_vectors"],
        vertices=arrays["vertices"],
        feat_to_template_ids=arrays["feat_to_template_ids"],
        word_centroids=arrays["word_centroids"],
        word_idfs=arrays["word_idfs"],
        template_descs=arrays["template_descs"],
        template_cameras=cameras,
        raw_projector=projector,
        tfidf_config=TfidfConfig(**meta["tfidf_config"]),
        extractor_name=meta.get("extractor_name", ""),
        feat_mask=arrays["feat_mask"],
        device=device,
    )
