"""The object representation the cells run against, made from the seed.

A synthetic object at LM-O scale (configs/gen_repre/lmo.json: 798
templates of up to 512 features, PCA from the ViT's width to 256 dims,
2,048 visual words), made as the program's `synthetic.realistic_repre`
makes it: templates are overlapping subsets of one point cloud with
per-view noise on its descriptors, words are perturbed object
descriptors. Then, as the bring-up smoke's crop world does, the first
templates are replaced by the solvable crops themselves: each crop's PCA
features at its masked grid cells (from the reference ViT in float32),
lifted to 3D along the cell's ray in its crop camera at depths 0.4-0.6 m
and expressed in an object frame of its own (a random rotation about the
points' centroid), so that the crop's true pose is that rotation and the
centroid; the words are redrawn from those features and every template's
tf-idf descriptor and the idfs are computed again. A solvable crop thus
retrieves its own template and solves to a known pose.
Everything here is the benchmark's own code: the program gets the result
as an `ObjectRepre`.
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import pipeline, retrieval
from perfbench.reference.precision import Precision, exact_f32


def base(seed: int, device, num_templates: int, fmax: int, feat_dim: int, num_words: int,
         raw_dim: int, n_points: int = 4096) -> Dict[str, torch.Tensor]:
    """The synthetic object before the crops are put in (float32)."""
    g = torch.Generator(device=device).manual_seed(seed)
    t = num_templates
    obj_points = torch.rand(n_points, 3, generator=g, device=device) * 0.1 - 0.05
    obj_feats = torch.randn(n_points, feat_dim, generator=g, device=device) * 3.0
    sel = torch.argsort(torch.rand(t, n_points, generator=g, device=device), dim=-1)[:, :fmax]
    bank_feats = obj_feats[sel] + 0.3 * torch.randn(t, fmax, feat_dim, generator=g, device=device)
    half = torch.rand(t, fmax // 2, generator=g, device=device) > 0.3
    bank_mask = torch.cat([torch.ones(t, fmax - fmax // 2, dtype=torch.bool, device=device),
                           half], dim=1)
    wsel = torch.randperm(n_points, generator=g, device=device)[:num_words]
    words = obj_feats[wsel] + 0.01 * torch.randn(num_words, feat_dim, generator=g, device=device)
    pca = {"mean": torch.randn(raw_dim, generator=g, device=device),
           "components": torch.randn(feat_dim, raw_dim, generator=g, device=device) / 20.0}
    return {"pca": pca, "words": words, "bank_feats": bank_feats,
            "bank_vertices": obj_points[sel], "bank_mask": bank_mask}


@torch.no_grad()
def put_crops(world, vit, crops, masks, f, c, cell: float, seed: int, rows: int = 16):
    """Makes templates 0..n-1 of `world` out of the n crops ([n, H, W, 3],
    uint8 or float in [0, 1]; masks [n, H, W], crop intrinsics f, c [n, 2])
    with the reference backbone `vit` (see `pipeline.features`), redraws
    the words and computes the tf-idf tables. Modifies and returns
    `world`."""
    device = crops.device
    g = torch.Generator(device=device).manual_seed(seed)
    prec = Precision()
    fmax = world["bank_feats"].shape[1]
    picked, poses_r, poses_t = [], [], []
    for r in range(0, crops.shape[0], rows):
        ana = pipeline.features(vit, world["pca"], crops[r : r + rows], masks[r : r + rows],
                                cell, prec)
        pts = ana["points"]
        rays = torch.cat([(pts[None] - c[r : r + rows, None]) / f[r : r + rows, None],
                          torch.ones(len(ana["q"]), pts.shape[0], 1, device=device)], dim=-1)
        depth = 0.4 + 0.2 * torch.rand(len(ana["q"]), pts.shape[0], 1, generator=g, device=device)
        for i in range(len(ana["q"])):
            k = r + i
            keep = ana["valid"][i]
            feats, cam = ana["q"][i][keep][:fmax], (rays[i] * depth[i])[keep][:fmax]
            # Object frame: x_cam = R @ x_obj + t.
            rot, t = random_rotation(g, device), cam.mean(0)
            verts = (cam - t) @ rot
            poses_r.append(rot)
            poses_t.append(t)
            world["bank_mask"][k] = False
            world["bank_mask"][k, : len(feats)] = True
            world["bank_feats"][k, : len(feats)] = feats
            world["bank_vertices"][k, : len(feats)] = verts
            picked.append(feats)
    world["pose_R"], world["pose_t"] = torch.stack(poses_r), torch.stack(poses_t)
    pool = torch.cat(picked)
    take = torch.randperm(len(pool), generator=g, device=device)[: len(world["words"])]
    world["words"][: len(take)] = pool[take] + 0.01 * torch.randn(
        len(take), pool.shape[1], generator=g, device=device)
    with exact_f32():
        world["idfs"], world["descs"] = retrieval.template_tables(
            world["bank_feats"], world["bank_mask"], world["words"], prec)
    return world


def random_rotation(g, device) -> torch.Tensor:
    """A rotation [3, 3] from a uniformly random unit quaternion."""
    w, x, y, z = torch.nn.functional.normalize(torch.randn(4, generator=g, device=device), dim=0)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)])])


def program_repre(world, extractor_name: str):
    """The world as the program's ObjectRepre (float32; the program casts
    its banks to its compute dtype itself). Template cameras are unused by
    the coarse step and get the crop cameras' identity extrinsics."""
    from foundpose_torch.ops.pca import PCA
    from foundpose_torch.ops.tfidf import TfidfConfig
    from foundpose_torch.repre import ObjectRepre
    from foundpose_torch.structs import PinholeCamera

    t, fmax, d = world["bank_feats"].shape
    device = world["bank_feats"].device
    return ObjectRepre(
        vertices=world["bank_vertices"].reshape(-1, 3).clone(),
        feat_vectors=world["bank_feats"].reshape(-1, d).clone(),
        feat_to_template_ids=torch.arange(t, device=device).repeat_interleave(fmax),
        feat_mask=world["bank_mask"].reshape(-1).clone(),
        word_centroids=world["words"].clone(),
        word_idfs=world["idfs"].clone(),
        template_descs=world["descs"].clone(),
        bank_feats=world["bank_feats"].clone(),
        bank_vertices=world["bank_vertices"].clone(),
        bank_mask=world["bank_mask"].clone(),
        template_cameras=PinholeCamera(
            f=torch.full((t, 2), 600.0, device=device), c=torch.full((t, 2), 209.5, device=device),
            T_world_from_eye=torch.eye(4, device=device).expand(t, 4, 4).contiguous(),
            width=420, height=420),
        raw_projector=PCA(mean=world["pca"]["mean"].clone(),
                          components=world["pca"]["components"].clone(),
                          explained_variance=torch.ones(d, device=device), whiten=False),
        tfidf_config=TfidfConfig(knn_k=retrieval.KNN_K, metric="l2"),
        extractor_name=extractor_name,
    )
