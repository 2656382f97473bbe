"""Pose-level cross-implementation parity on one NVIDIA GPU: an independent
reference-style replica against the port (counterpart of
benchmarks/cross_parity.py, without sklearn and without transformers).

    python -m foundpose_torch.benchmarks.cross_parity [--crops 100] [--templates 798] [--skip-vit]
    python -m foundpose_torch.benchmarks.cross_parity --featuremetric [--crops 100]

The replica (`ReferenceReplica`) re-implements the reference's per-crop
online chain (reference: scripts/infer.py:368-733, utils/template_util.py:
31-202, utils/corresp_util.py:34-170, utils/pnp_util.py:40-79) on the host
in numpy and cv2, one crop at a time: exact brute-force kNN
(`knn`, float64 distances; the JAX script's sklearn `NearestNeighbors`
is not on the card machine), tf-idf retrieval, cyclic buddies, then
`cv2.solvePnPRansac` and `cv2.solvePnPRefineLM`. It calls nothing of
`foundpose_torch.ops`, so its agreement with the port is evidence about
both. On the structured synthetic world at LM-O scale (798 templates,
2,048 words, 256-d features, 400 features a template) two legs compare:

  1. Offline tf-idf: the replica's word idfs and template descriptors,
     recomputed from the raw banks, against the port-built representation.
  2. Online pose: per-crop rotation/translation deltas and the AR delta
     between the replica and the port's `pose_from_features` on `device`,
     exact f32 (plain matching, then kernel 2) and the benched bf16
     approximate top-k path (kernel 3, then kernel 2), with the same draws
     for both legs (a seeded torch.Generator on the device, or `draws`).

Beside the JAX script's keys (`ar_port_*` in place of `ar_jax_*`) the
report has the offline tf-idf's seconds, the host threads the replica's
crops ran on (`replica_sec_per_crop` is their wall over the crops; the JAX
script's ran one at a time), each leg's wall between
`torch.cuda.synchronize()` calls and its hypotheses, scorer, buddies and
refinement launches counted from zero. Unless `--skip-vit`, the third leg (`vit_parity_leg`)
adds `vit_feature_max_delta_native` (518 px) and
`vit_feature_max_delta_420_interp` (420 px, not a gate: the position
embeddings' two interpolation recipes disagree there), the port's ViT
against `hf_dinov2`, the stand-in for `transformers`' DINOv2.
`--featuremetric` runs only the refinement leg (`featuremetric_leg`).
Prints one JSON line; exits nonzero when an AR delta exceeds 1 point.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from foundpose_torch.benchmarks import bench

CROP = 420
CELL = 14.0
GRID = 30
# The crops' (and templates') pinhole camera.
K = np.array([[600.0, 0, 209.5], [0, 600.0, 209.5], [0, 0, 1]], np.float32)
# Rows of a kNN distance block (x 2,048 words: 67 MB of float64).
KNN_CHUNK = 4096


# ---------------------------------------------------------------------------
# World generation: an object point cloud with unique descriptors, templates
# seeing subsets of it, queries of projected descriptors with noise/clutter
# ---------------------------------------------------------------------------

def make_world(rng, num_templates=798, pts_per_template=400, feat_dim=256, num_words=2048,
               n_points=4000, device="cuda"):
    """(repre on `device`, obj_points, obj_feats, tpl_point_ids), drawing
    from `rng` in the JAX script's order; tf-idf by the port's ops/tfidf on
    `device`."""
    from foundpose_torch.ops import tfidf
    from foundpose_torch.repre import make_repre
    from foundpose_torch.structs import PinholeCamera

    obj_points = rng.uniform(-0.08, 0.08, size=(n_points, 3)).astype(np.float32)
    obj_feats = rng.normal(size=(n_points, feat_dim)).astype(np.float32) * 3.0
    tpl_point_ids = [rng.choice(n_points, size=pts_per_template, replace=False)
                     for _ in range(num_templates)]
    feat_vectors = np.concatenate([obj_feats[s] for s in tpl_point_ids])
    vertices = np.concatenate([obj_points[s] for s in tpl_point_ids])
    tpl_ids = np.repeat(np.arange(num_templates), pts_per_template).astype(np.int32)
    words = obj_feats[rng.choice(n_points, size=num_words, replace=False)]
    words = (words + 0.01 * rng.normal(size=words.shape)).astype(np.float32)

    cfg = tfidf.TfidfConfig(knn_k=3)
    descs, idfs = tfidf.calc_template_tfidf_descriptors(
        torch.as_tensor(feat_vectors, device=device), torch.as_tensor(tpl_ids, device=device),
        torch.as_tensor(words, device=device), num_templates, cfg,
    )
    cams = PinholeCamera(
        f=torch.full((num_templates, 2), 600.0), c=torch.full((num_templates, 2), 209.5),
        T_world_from_eye=torch.eye(4).expand(num_templates, 4, 4).contiguous(),
        width=CROP, height=CROP,
    )
    repre = make_repre(feat_vectors, vertices, tpl_ids, words, idfs.cpu().numpy(),
                       descs.cpu().numpy(), cams, tfidf_config=cfg, device=device)
    return repre, obj_points, obj_feats, tpl_point_ids


def _gt_pose(pose_seed):
    from scipy.spatial.transform import Rotation

    pr = np.random.default_rng(pose_seed)
    r_gt = Rotation.from_rotvec(pr.uniform(-0.3, 0.3, 3)).as_matrix().astype(np.float32)
    t_gt = np.array([pr.uniform(-0.02, 0.02), pr.uniform(-0.02, 0.02), pr.uniform(0.45, 0.6)],
                    dtype=np.float32)
    return r_gt, t_gt


def _project(obj_points, r_gt, t_gt):
    cam = obj_points @ r_gt.T + t_gt
    return cam[:, :2] / cam[:, 2:3] * K[0, 0] + K[0, 2]


def render_query(rng, obj_points, obj_feats, tpl_point_ids, target_tpl, pose_seed,
                 feat_noise=0.3, clutter_cells=40):
    """A crop viewing template `target_tpl`'s points under a random GT pose
    from `pose_seed`, with descriptor noise and clutter cells. Returns
    (fmap [GRID, GRID, D], mask [CROP, CROP], R_gt, t_gt)."""
    r_gt, t_gt = _gt_pose(pose_seed)
    proj = _project(obj_points[tpl_point_ids[target_tpl]], r_gt, t_gt)
    feats = obj_feats[tpl_point_ids[target_tpl]]
    d = obj_feats.shape[1]
    fmap = rng.normal(size=(GRID, GRID, d)).astype(np.float32) * 0.05
    mask = np.zeros((CROP, CROP), dtype=np.float32)
    c = int(CELL)
    for p, f in zip(proj, feats):
        cx, cy = int(p[0] // CELL), int(p[1] // CELL)
        if 0 <= cx < GRID and 0 <= cy < GRID:
            fmap[cy, cx] = f + feat_noise * rng.normal(size=d).astype(np.float32)
            mask[cy * c : (cy + 1) * c, cx * c : (cx + 1) * c] = 1.0
    for _ in range(clutter_cells):
        cx, cy = rng.integers(0, GRID), rng.integers(0, GRID)
        fmap[cy, cx] = rng.normal(size=d).astype(np.float32) * 3.0
        mask[cy * c : (cy + 1) * c, cx * c : (cx + 1) * c] = 1.0
    return fmap, mask, r_gt, t_gt


def render_query_smooth(rng, obj_points, obj_feats, tpl_point_ids, target_tpl, pose_seed,
                        feat_noise=0.1):
    """A crop whose feature field carries sub-cell position signal: each
    point's descriptor, with noise, is splatted bilinearly into the 4 cells
    around its true projection (pixel p -> map coordinate p / CELL - 0.5,
    ops/sampling's convention), the field class featuremetric refinement
    exists for. Returns (fmap, mask, R_gt, t_gt) as `render_query`."""
    r_gt, t_gt = _gt_pose(pose_seed)
    proj = _project(obj_points[tpl_point_ids[target_tpl]], r_gt, t_gt)
    feats = obj_feats[tpl_point_ids[target_tpl]]
    d = obj_feats.shape[1]
    acc = np.zeros((GRID, GRID, d), dtype=np.float64)
    wsum = np.zeros((GRID, GRID), dtype=np.float64)
    for p, f in zip(proj, feats):
        fn = f + feat_noise * rng.normal(size=d)
        u, v = p[0] / CELL - 0.5, p[1] / CELL - 0.5
        x0, y0 = int(np.floor(u)), int(np.floor(v))
        fx, fy = u - x0, v - y0
        for xi, yi, w in ((x0, y0, (1 - fx) * (1 - fy)), (x0 + 1, y0, fx * (1 - fy)),
                          (x0, y0 + 1, (1 - fx) * fy), (x0 + 1, y0 + 1, fx * fy)):
            if 0 <= xi < GRID and 0 <= yi < GRID:
                acc[yi, xi] += w * fn
                wsum[yi, xi] += w
    fmap = rng.normal(size=(GRID, GRID, d)).astype(np.float32) * 0.05
    mask = np.zeros((CROP, CROP), dtype=np.float32)
    covered = wsum > 0.05
    fmap[covered] = (acc[covered] / wsum[covered, None]).astype(np.float32)
    c = int(CELL)
    for cy, cx in zip(*np.nonzero(covered)):
        mask[cy * c : (cy + 1) * c, cx * c : (cx + 1) * c] = 1.0
    return fmap, mask, r_gt, t_gt


def render_queries(rng, world, n_crops, pose_seed_base, render=render_query):
    """`n_crops` queries of `world` (make_world's tuple), crop i on template
    i mod T: (fmaps [B, GRID, GRID, D], masks [B, CROP, CROP], R_gt list,
    t_gt list)."""
    _, obj_points, obj_feats, tpl_point_ids = world
    out = [render(rng, obj_points, obj_feats, tpl_point_ids, target_tpl=i % len(tpl_point_ids),
                  pose_seed=pose_seed_base + i) for i in range(n_crops)]
    fmaps, masks, rs_gt, ts_gt = zip(*out)
    return np.stack(fmaps), np.stack(masks), list(rs_gt), list(ts_gt)


# ---------------------------------------------------------------------------
# Reference-style replica (numpy and cv2, one instance at a time)
# ---------------------------------------------------------------------------

def knn(queries, points, k, chunk=KNN_CHUNK):
    """Exact brute-force k nearest neighbours of each query row among
    `points` by Euclidean distance: (distances [N, k], ids [N, k]), nearest
    first, ties by the lower index. Squared distances in float64, a block
    of `chunk` query rows at a time."""
    x = np.asarray(points, np.float64)
    xx = np.einsum("ij,ij->i", x, x)
    dists, ids = [], []
    for s in range(0, len(queries), chunk):
        q = np.asarray(queries[s : s + chunk], np.float64)
        d2 = q @ x.T
        d2 *= -2.0
        d2 += np.einsum("ij,ij->i", q, q)[:, None]
        d2 += xx[None]
        np.maximum(d2, 0.0, out=d2)
        if k == 1:
            part = d2.argmin(1)[:, None]
        else:
            part = np.argpartition(d2, k - 1, axis=1)[:, :k]
            order = np.lexsort((part, np.take_along_axis(d2, part, 1)), axis=1)
            part = np.take_along_axis(part, order, 1)
        ids.append(part)
        dists.append(np.sqrt(np.take_along_axis(d2, part, 1)))
    return np.concatenate(dists), np.concatenate(ids)


class ReferenceReplica:
    """Independent per-instance implementation of the reference online
    chain (the JAX script's replica with `knn` in place of sklearn's
    brute-force `NearestNeighbors`). Nothing here calls the port's ops."""

    def __init__(self, bank_feats_by_tpl, bank_verts_by_tpl, words, tfidf_knn_k=3,
                 soft_assign=False, soft_sigma_squared=10.0, top_n_templates=5,
                 top_k_buddies=300, pnp_ransac_iter=400, pnp_inlier_thresh=10.0,
                 pnp_refine_lm=True):
        self.tpl_feats = bank_feats_by_tpl
        self.tpl_verts = bank_verts_by_tpl
        self.words = words
        self.knn_k = tfidf_knn_k
        self.soft_assign = soft_assign
        self.soft_sigma_squared = soft_sigma_squared
        self.top_n = top_n_templates
        self.top_k = top_k_buddies
        self.ransac_iter = pnp_ransac_iter
        self.inlier_thresh = pnp_inlier_thresh
        self.refine_lm = pnp_refine_lm
        self.num_templates = len(bank_feats_by_tpl)
        t0 = time.perf_counter()
        self.word_idfs, self.template_descs = self._offline_tfidf()
        self.offline_seconds = time.perf_counter() - t0

    # -- offline (reference: template_util.py:74-124) ----------------------

    def _offline_tfidf(self):
        """idf = log(T / occurrences); desc_t = tfidf of template t's feats.

        Occurrences count the NEAREST word only (the reference's
        feat_to_cluster_ids is k-means membership, scripts/gen_repre.py:
        293-332); descriptors use all knn_k assignments
        (template_util.py:107-121). One kNN over every template's features
        (LM-O: 319,200 x 2,048 words)."""
        dists, ids = knn(np.concatenate(self.tpl_feats), self.words, self.knn_k)
        bounds = np.cumsum([0] + [len(f) for f in self.tpl_feats])
        occurrences = np.zeros(len(self.words), dtype=np.int64)
        for a, b in zip(bounds[:-1], bounds[1:]):
            occurrences[np.unique(ids[a:b, 0])] += 1
        with np.errstate(divide="ignore"):
            idfs = np.log(float(self.num_templates) / occurrences)
        descs = np.stack([self._calc_tfidf(ids[a:b], dists[a:b], idfs)
                          for a, b in zip(bounds[:-1], bounds[1:])])
        return idfs, descs

    def _calc_tfidf(self, word_ids, word_dists, idfs):
        """reference template_util.py:31-71 (Torii et al.): per-feature
        weights L2-normalized over the k assignments, tf divided by the
        feature count, scatter-added into a [W] descriptor."""
        n, _ = word_ids.shape
        if self.soft_assign:
            w = np.exp(-np.square(word_dists) / (2.0 * self.soft_sigma_squared))
        else:
            w = np.ones_like(word_dists)
        w = w / np.maximum(np.linalg.norm(w, axis=1, keepdims=True), 1e-12)
        tf = (w / n).reshape(-1)
        ids = word_ids.reshape(-1)
        tfidf = tf * np.where(np.isfinite(idfs[ids]), idfs[ids], 0.0)
        desc = np.zeros(len(self.words), np.float64)
        np.add.at(desc, ids, tfidf)
        return desc.astype(np.float32)

    # -- online, one crop (reference: infer.py:368-733) --------------------

    def infer_one(self, fmap, mask, k_mat=K):
        import cv2

        # Query features at masked grid-cell centers (reference:
        # feature_util.py:100-131 grid_sample; exact here because the world's
        # descriptors are cell-aligned).
        c = int(CELL)
        cell_mask = mask[c // 2 :: c, c // 2 :: c] > 0.5  # [GRID, GRID]
        cys, cxs = np.nonzero(cell_mask)
        if len(cys) < 6:
            return {"success": False}
        q_feats = fmap[cys, cxs].astype(np.float32)
        q_points = np.stack([(cxs + 0.5) * CELL, (cys + 0.5) * CELL], axis=1).astype(np.float32)

        # tf-idf retrieval (reference: template_util.py:126-176).
        w_dists, w_ids = knn(q_feats, self.words, self.knn_k)
        q_desc = self._calc_tfidf(w_ids, w_dists, self.word_idfs)
        descs = self.template_descs
        sims = (descs @ q_desc) / np.maximum(
            np.linalg.norm(descs, axis=1) * np.linalg.norm(q_desc), 1e-12
        )
        top_ids = np.argsort(-sims)[: self.top_n]

        # Cyclic buddies per retrieved template (corresp_util.py:34-132).
        best = None
        for tid in top_ids:
            q2o = knn(q_feats, self.tpl_feats[tid], 1)[1][:, 0]
            o2q = knn(self.tpl_feats[tid], q_feats, 1)[1][:, 0]
            cycle_ids = o2q[q2o]
            cycle_dists = np.linalg.norm(q_points - q_points[cycle_ids], axis=1)
            top_k = min(self.top_k, len(q_points))
            bb_q = np.argsort(cycle_dists, kind="stable")[:top_k]
            bb_o = q2o[bb_q]
            obj_pts = self.tpl_verts[tid][bb_o].astype(np.float64)
            img_pts = q_points[bb_q].astype(np.float64)

            # PnP-RANSAC + optional LM on inliers (pnp_util.py:40-79),
            # best template by inlier count (infer.py:567-602).
            try:
                ok, rvec, tvec, inliers = cv2.solvePnPRansac(
                    objectPoints=obj_pts.reshape(-1, 1, 3),
                    imagePoints=img_pts.reshape(-1, 1, 2),
                    cameraMatrix=k_mat.astype(np.float64),
                    distCoeffs=None,
                    iterationsCount=self.ransac_iter,
                    reprojectionError=self.inlier_thresh,
                    confidence=0.99,
                    flags=cv2.SOLVEPNP_ITERATIVE,
                )
            except cv2.error:
                continue
            if not ok or inliers is None or len(inliers) < 6:
                continue
            if self.refine_lm:
                rvec, tvec = cv2.solvePnPRefineLM(
                    objectPoints=obj_pts[inliers[:, 0]].reshape(-1, 1, 3),
                    imagePoints=img_pts[inliers[:, 0]].reshape(-1, 1, 2),
                    cameraMatrix=k_mat.astype(np.float64),
                    distCoeffs=None,
                    rvec=rvec, tvec=tvec,
                )
            n_inl = len(inliers)
            if best is None or n_inl > best["quality"]:
                best = {
                    "success": True,
                    "R": cv2.Rodrigues(rvec)[0],
                    "t": tvec.reshape(3),
                    "quality": n_inl,
                    "template": int(tid),
                }
        return best or {"success": False}


def replica_for(world, **kw) -> ReferenceReplica:
    """The replica on `world`'s RAW data (per-template banks and the word
    centroids), not on the port-derived tf-idf artifacts."""
    repre, obj_points, obj_feats, tpl_point_ids = world
    return ReferenceReplica(
        [np.asarray(obj_feats[ids], np.float32) for ids in tpl_point_ids],
        [np.asarray(obj_points[ids], np.float32) for ids in tpl_point_ids],
        repre.word_centroids.cpu().numpy(), **kw,
    )


def host_threads() -> int:
    """The replica's threads: one a core of this process. On the card
    machine (8 cores, cv2 4.13) a crop took 0.79-1.0 s alone, 0.33-0.40 s
    over 8 threads and 0.35-0.44 s over 16."""
    return len(os.sched_getaffinity(0))


def replica_poses(replica, fmaps, masks, threads=None):
    """(outputs, R list, t list, success list, wall seconds) of the replica
    on every crop. The crops run on `threads` threads (host_threads() by
    default): each is independent, and cv2 and numpy release the
    interpreter lock while they compute, so the outputs are a serial
    loop's."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads or host_threads()) as pool:
        out = list(pool.map(replica.infer_one, fmaps, masks))
    seconds = time.perf_counter() - t0
    return (out, [o.get("R", np.eye(3)) for o in out], [o.get("t", np.zeros(3)) for o in out],
            [o["success"] for o in out], seconds)


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

def rot_err_deg(r1, r2):
    cosv = (np.trace(r1 @ r2.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cosv, -1.0, 1.0))))


def ar_recall(rs, ts, succ, rs_gt, ts_gt, rot_thresh=5.0, t_thresh=0.015):
    ok = []
    for i in range(len(rs_gt)):
        ok.append(
            bool(succ[i])
            and rot_err_deg(np.asarray(rs[i]), rs_gt[i]) < rot_thresh
            and float(np.linalg.norm(np.asarray(ts[i]) - ts_gt[i])) < t_thresh
        )
    return float(np.mean(ok)), ok


def bop_ar_score(rs, ts, succ, rs_gt, ts_gt, model_points, k_mat, image_width):
    """Scores poses through the BOP19 protocol layer (the port's
    eval/bop_ar): each crop is one single-instance image; AR = mean(AR_MSSD,
    AR_MSPD). Model points subsampled to ~400 (both sides see the same)."""
    from foundpose_torch.eval import bop_ar

    pts = np.asarray(model_points[:: max(1, len(model_points) // 400)])
    dia = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    gts, ests, intr = [], [], {}
    for i in range(len(rs_gt)):
        gts.append(bop_ar.GroundTruth(1, i, 7, np.asarray(rs_gt[i]), np.asarray(ts_gt[i])))
        intr[(1, i)] = np.asarray(k_mat, np.float64)
        if bool(succ[i]):
            ests.append(bop_ar.Estimate(1, i, 7, 1.0, np.asarray(rs[i]), np.asarray(ts[i])))
    out = bop_ar.evaluate_ar(ests, gts, {7: pts}, {7: dia}, {7: [(np.eye(3), np.zeros(3))]},
                             intr, image_width=image_width)
    return out["bop_ar"]


# ---------------------------------------------------------------------------
# The port's step, timed and counted
# ---------------------------------------------------------------------------

COUNTED = ("buddies", "ransac_dlt", "ransac_score", "refine")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_poses(fmaps, masks, repre, config, device, seed=0, draws=None, full_draws=None):
    """The port's `pose_from_features` on every crop at once on `device`,
    its draws from a torch.Generator seeded `seed` (or `draws`
    [B, top_n, H, 6] and, for the two-phase solve, `full_draws` [B, H, 6]).
    Returns (R [B, 3, 3], t [B, 3], success [B], best_template [B] as numpy,
    wall seconds between synchronizes, {kernel: launches from zero})."""
    from foundpose_torch.pipeline import inference
    from foundpose_torch.structs import PinholeCamera

    counters = {name: fn for name, fn in bench.kernel_counters().items() if name in COUNTED}
    fm = torch.as_tensor(fmaps, device=device)
    mk = torch.as_tensor(masks, device=device)
    n = len(fmaps)
    cams = PinholeCamera(
        f=torch.full((n, 2), 600.0, device=device), c=torch.full((n, 2), 209.5, device=device),
        T_world_from_eye=torch.eye(4, device=device).expand(n, 4, 4).contiguous(),
        width=CROP, height=CROP,
    )
    gen = torch.Generator(device=device).manual_seed(seed)
    to_dev = (lambda a: None if a is None else torch.as_tensor(a, device=device))
    _sync(device)
    before = {name: fn.launches for name, fn in counters.items()}
    t0 = time.perf_counter()
    out = inference.pose_from_features(fm, mk, cams, repre, config, generator=gen,
                                       draws=to_dev(draws), full_draws=to_dev(full_draws))
    _sync(device)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches - before[name] for name, fn in counters.items()}
    return (out.R_m2c.cpu().numpy(), out.t_m2c.cpu().numpy(), out.success.cpu().numpy(),
            out.best_template.cpu().numpy(), wall, launches)


def run_parity(num_templates=798, pts_per_template=400, feat_dim=256, num_words=2048,
               n_points=4000, n_crops=100, seed=0, top_n_templates=5, top_k_buddies=300,
               pnp_ransac_iter=400, device="cuda", draws=None, verbose=True):
    """The parity report (see the module docstring) as a dict."""
    from foundpose_torch.pipeline import inference

    device = bench.require_device(device)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    world = make_world(rng, num_templates, pts_per_template, feat_dim, num_words, n_points,
                       device=device)
    repre, obj_points = world[0], world[1]
    if verbose:
        print(f"[parity] world built in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    replica = replica_for(world, top_n_templates=top_n_templates,
                          top_k_buddies=top_k_buddies, pnp_ransac_iter=pnp_ransac_iter)

    # Leg 1: offline tf-idf artifacts agree.
    idf_port = repre.word_idfs.cpu().numpy()
    finite = np.isfinite(replica.word_idfs) & np.isfinite(idf_port)
    idf_delta = float(np.abs(replica.word_idfs[finite] - idf_port[finite]).max())
    descs_port = repre.template_descs.cpu().numpy()
    desc_cos = np.sum(replica.template_descs * descs_port, axis=1) / np.maximum(
        np.linalg.norm(replica.template_descs, axis=1) * np.linalg.norm(descs_port, axis=1),
        1e-12,
    )
    desc_cos_min = float(desc_cos.min())
    if verbose:
        print(f"[parity] replica offline tf-idf {replica.offline_seconds:.1f}s; idf "
              f"max|delta|={idf_delta:.2e}; template-desc cosine min={desc_cos_min:.6f}",
              file=sys.stderr)

    fmaps, masks, rs_gt, ts_gt = render_queries(rng, world, n_crops, 1000)
    rep_out, rep_rs, rep_ts, rep_succ, rep_s = replica_poses(replica, fmaps, masks)

    base = dict(top_n_templates=top_n_templates, top_k_buddies=top_k_buddies,
                pnp_ransac_iter=pnp_ransac_iter)
    legs = {
        "exact": inference.InferenceConfig(**base),
        "fast": inference.InferenceConfig(**base, compute_dtype=torch.bfloat16,
                                          approx_topk=True),
    }
    report = {"metric": "cross_implementation_parity", "device": bench.card(device),
              "n_crops": n_crops, "num_templates": num_templates, "num_words": num_words,
              "idf_max_delta": idf_delta, "template_desc_cosine_min": desc_cos_min,
              "replica_offline_tfidf_s": round(replica.offline_seconds, 3),
              "replica_threads": host_threads(),
              "replica_sec_per_crop": round(rep_s / n_crops, 4)}
    ar_rep, ok_rep = ar_recall(rep_rs, rep_ts, rep_succ, rs_gt, ts_gt)
    report["ar_replica"] = ar_rep
    report["bop_ar_replica"] = round(
        bop_ar_score(rep_rs, rep_ts, rep_succ, rs_gt, ts_gt, obj_points, K, CROP), 4)
    for name, config in legs.items():
        rs, ts, succ, best_tpl, wall, launches = port_poses(
            fmaps, masks, repre, config, device, seed=seed, draws=draws)
        ar, ok = ar_recall(rs, ts, succ, rs_gt, ts_gt)
        # Pose deltas on crops where BOTH implementations succeeded (two
        # correct poses can sit on opposite sides of GT, so deltas up to 2x
        # the success thresholds are expected).
        both = [i for i in range(n_crops) if ok[i] and ok_rep[i]]
        drots = [rot_err_deg(rs[i], rep_rs[i]) for i in both]
        dts = [float(np.linalg.norm(ts[i] - rep_ts[i])) for i in both]
        tpl_agree = [int(best_tpl[i]) == rep_out[i]["template"] for i in both]
        report[f"ar_port_{name}"] = ar
        report[f"ar_delta_{name}"] = round(abs(ar - ar_rep), 4)
        report[f"bop_ar_port_{name}"] = round(
            bop_ar_score(rs, ts, succ, rs_gt, ts_gt, obj_points, K, CROP), 4)
        report[f"bop_ar_delta_{name}"] = round(
            abs(report[f"bop_ar_port_{name}"] - report["bop_ar_replica"]), 4)
        report[f"median_rot_delta_deg_{name}"] = (
            round(float(np.median(drots)), 3) if drots else None)
        report[f"median_t_delta_mm_{name}"] = (
            round(float(np.median(dts)) * 1000, 2) if dts else None)
        report[f"template_agreement_{name}"] = (
            round(float(np.mean(tpl_agree)), 3) if tpl_agree else None)
        report[f"both_succeeded_{name}"] = len(both)
        report[f"port_wall_s_{name}"] = wall
        report[f"launches_{name}"] = launches
    return report


def featuremetric_leg(n_crops=100, num_templates=96, pts_per_template=200, feat_dim=64,
                      num_words=512, n_points=2000, seed=0, refine_iters=8, device="cuda",
                      draws=None, verbose=True):
    """Accuracy of featuremetric refinement (the paper stage absent from the
    reference OSS, reference README.md:34): the port's exact pipeline with
    `refine_featuremetric` off vs on, the same draws, on the splatted-feature
    world; recall, median rotation and translation error against GT, BOP AR."""
    from foundpose_torch.pipeline import inference

    device = bench.require_device(device)
    rng = np.random.default_rng(seed)
    world = make_world(rng, num_templates, pts_per_template, feat_dim, num_words, n_points,
                       device=device)
    fmaps, masks, rs_gt, ts_gt = render_queries(rng, world, n_crops, 2000, render_query_smooth)
    base = inference.InferenceConfig(top_n_templates=5, top_k_buddies=300, pnp_ransac_iter=200)
    report = {"metric": "featuremetric_refinement", "device": bench.card(device),
              "n_crops": n_crops, "num_templates": num_templates, "refine_iters": refine_iters}
    for name, config in (
        ("off", base),
        ("on", dataclasses.replace(base, refine_featuremetric=True,
                                   featuremetric_iters=refine_iters)),
    ):
        rs, ts, succ, _, wall, _ = port_poses(fmaps, masks, world[0], config, device, seed=seed,
                                              draws=draws)
        ar, _ = ar_recall(rs, ts, succ, rs_gt, ts_gt)
        rot_errs = [rot_err_deg(rs[i], rs_gt[i]) for i in range(n_crops) if succ[i]]
        t_errs = [float(np.linalg.norm(ts[i] - ts_gt[i])) * 1000.0
                  for i in range(n_crops) if succ[i]]
        report[f"recall_{name}"] = ar
        report[f"bop_ar_{name}"] = round(
            bop_ar_score(rs, ts, succ, rs_gt, ts_gt, world[1], K, CROP), 4)
        report[f"median_rot_err_deg_{name}"] = round(float(np.median(rot_errs)), 3)
        report[f"median_t_err_mm_{name}"] = round(float(np.median(t_errs)), 3)
        report[f"n_success_{name}"] = int(np.sum(succ))
        report[f"port_wall_s_{name}"] = wall
        if verbose:
            print(f"[featuremetric] {name}: recall={ar:.3f} bop_ar={report[f'bop_ar_{name}']:.4f} "
                  f"median rot={report[f'median_rot_err_deg_{name}']} deg "
                  f"t={report[f'median_t_err_mm_{name}']} mm", file=sys.stderr)
    report["rot_err_improvement_deg"] = round(
        report["median_rot_err_deg_off"] - report["median_rot_err_deg_on"], 3)
    report["t_err_improvement_mm"] = round(
        report["median_t_err_mm_off"] - report["median_t_err_mm_on"], 3)
    return report


def vit_parity_leg(n_crops=2, size=None, params_np=None, device="cuda"):
    """Shared-weights ViT check: the port's `extract_facet` (ViT-S/14-reg,
    layer-9 token facet, final norm; unfused f32, so the attention kernel
    on the card) against the independent `hf_dinov2.Dinov2WithRegistersModel`
    on the same weights, loaded through `to_hf_state_dict`: the replica's
    `hidden_states[layer + 1]` through its `layernorm`, class and register
    tokens dropped. The weights are `params_np` (a numpy tree in the JAX
    layout) where given, else `bench_weights.realistic_params(0, cfg)`.
    Images are `np.random.default_rng(3)` uniform, NHWC, `size` px (None:
    the native `pos_grid * patch`, 518 px, where neither side interpolates
    the position embeddings; elsewhere the official recipe and the
    registers model's antialiased one disagree by design). Returns the
    max abs feature delta."""
    from foundpose_torch.benchmarks import hf_dinov2
    from foundpose_torch.models import bench_weights, dinov2, weights

    device = bench.require_device(device)
    cfg = dinov2.parse_model_name(bench.DEFAULT_EXTRACTOR)
    if size is None:
        size = cfg.pos_grid * cfg.patch_size
    if params_np is None:
        params_np = bench_weights.realistic_params(0, cfg)
    model = weights.module_from_jax_params(params_np, cfg, device)
    replica = hf_dinov2.Dinov2WithRegistersModel(hf_dinov2.Dinov2Config(
        hidden_size=cfg.embed_dim, num_hidden_layers=cfg.depth,
        num_attention_heads=cfg.num_heads, mlp_ratio=int(cfg.mlp_ratio),
        layer_norm_eps=cfg.layer_norm_eps, image_size=cfg.pos_grid * cfg.patch_size,
        patch_size=cfg.patch_size, use_swiglu_ffn=cfg.swiglu,
        num_register_tokens=cfg.num_register_tokens))
    hf_dinov2.load_hf_state_dict(replica, weights.to_hf_state_dict(params_np, cfg))
    replica = replica.to(device)

    images = np.random.default_rng(3).uniform(size=(n_crops, size, size, 3)).astype(np.float32)
    x = torch.from_numpy(images).to(device)
    with torch.no_grad():
        ours = dinov2.extract_facet(model, x)["feature_maps"]
        hs = replica(x.permute(0, 3, 1, 2), output_hidden_states=True).hidden_states
        theirs = replica.layernorm(hs[cfg.layer + 1])[:, 1 + cfg.num_register_tokens :]
    g = size // cfg.patch_size
    theirs = theirs.reshape(n_crops, g, g, cfg.embed_dim)
    return float((ours - theirs).abs().max())


def ar_gate_failed(report) -> bool:
    """The JAX script's exit gate: an AR delta above 1 point."""
    return report["ar_delta_fast"] > 0.01 + 1e-9 or report["ar_delta_exact"] > 0.01 + 1e-9


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--crops", type=int, default=100)
    ap.add_argument("--templates", type=int, default=798)
    ap.add_argument("--skip-vit", action="store_true")
    ap.add_argument("--featuremetric", action="store_true",
                    help="run ONLY the featuremetric refine-on/off leg")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.featuremetric:
        print(json.dumps(featuremetric_leg(n_crops=args.crops, device=args.device)))
        return 0
    report = run_parity(num_templates=args.templates, n_crops=args.crops, device=args.device)
    if not args.skip_vit:
        t0 = time.perf_counter()
        report["vit_feature_max_delta_native"] = vit_parity_leg(device=args.device)
        report["vit_feature_max_delta_420_interp"] = vit_parity_leg(size=CROP, device=args.device)
        print(f"[parity] vit legs {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    print(json.dumps(report))
    if ar_gate_failed(report):
        print("[parity] FAIL: AR delta exceeds 1 pt", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
