"""Synthetic object representation at the published LM-O scale
(counterpart of `_realistic_repre` in the repository's __graft_entry__.py).

798 templates, up to 512 features per template, 256-dim PCA features of
384-dim DINOv2 ViT-S tokens and 2048 visual words (configs/gen_repre/
lmo.json). The world is structured, not noise: templates are overlapping
subsets of one object point cloud with per-view descriptor perturbation,
visual words are perturbed object descriptors, and idfs and template
descriptors are computed from the banks with the port's tf-idf ops. Every
tensor is generated on `device` from a seeded generator.
"""

from __future__ import annotations

import torch

from foundpose_torch.ops import tfidf as tfidf_mod
from foundpose_torch.ops.pca import PCA
from foundpose_torch.repre import ObjectRepre
from foundpose_torch.structs import PinholeCamera


def realistic_repre(
    seed: int,
    device="cpu",
    num_templates: int = 798,
    fmax: int = 512,
    feat_dim: int = 256,
    num_words: int = 2048,
    raw_dim: int = 384,
    n_points: int = 4096,
) -> ObjectRepre:
    g = torch.Generator(device=device).manual_seed(seed)
    t = num_templates

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    def uniform(*shape):
        return torch.rand(shape, generator=g, device=device)

    obj_points = uniform(n_points, 3) * 0.1 - 0.05
    obj_feats = normal(n_points, feat_dim) * 3.0
    # Per-template point subsets without replacement.
    sel = torch.argsort(uniform(t, n_points), dim=-1)[:, :fmax]
    bank_feats = obj_feats[sel] + 0.3 * normal(t, fmax, feat_dim)
    bank_vertices = obj_points[sel]
    half = uniform(t, fmax // 2) > 0.3
    bank_mask = torch.cat(
        [torch.ones(t, fmax - fmax // 2, dtype=torch.bool, device=device), half], dim=1
    )
    wsel = torch.randperm(n_points, generator=g, device=device)[:num_words]
    words = obj_feats[wsel] + 0.01 * normal(num_words, feat_dim)
    pca = PCA(
        mean=normal(raw_dim),
        components=normal(feat_dim, raw_dim) / 20.0,
        explained_variance=torch.ones(feat_dim, device=device),
        whiten=False,
    )
    cfg = tfidf_mod.TfidfConfig()
    flat_ids = torch.arange(t, device=device).repeat_interleave(fmax)
    descs, idfs = tfidf_mod.calc_template_tfidf_descriptors(
        bank_feats.reshape(-1, feat_dim), flat_ids, words, t, cfg,
        feature_mask=bank_mask.reshape(-1),
    )
    cameras = PinholeCamera(
        f=torch.tensor([[600.0, 600.0]], device=device).expand(t, 2).contiguous(),
        c=torch.tensor([[209.5, 209.5]], device=device).expand(t, 2).contiguous(),
        T_world_from_eye=torch.eye(4, device=device).expand(t, 4, 4).contiguous(),
        width=420,
        height=420,
    )
    return ObjectRepre(
        vertices=bank_vertices.reshape(-1, 3),
        feat_vectors=bank_feats.reshape(-1, feat_dim),
        feat_to_template_ids=flat_ids,
        feat_mask=bank_mask.reshape(-1),
        word_centroids=words,
        word_idfs=idfs,
        template_descs=descs,
        bank_feats=bank_feats,
        bank_vertices=bank_vertices,
        bank_mask=bank_mask,
        template_cameras=cameras,
        raw_projector=pca,
        tfidf_config=cfg,
        extractor_name="dinov2_vits14-reg",
    )
