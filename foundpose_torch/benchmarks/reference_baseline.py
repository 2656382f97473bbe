"""The reference pipeline's per-crop loop, measured on the card's own
machine (counterpart of benchmarks/reference_baseline.py).

    python -m foundpose_torch.benchmarks.reference_baseline [--crops 6] [--templates 798] \\
        [--words 2048] [--pca-dim 256] [--buddies 300] [--device cuda]

The reference (facebookresearch/foundpose) processes one detection at a time
through a chain of libraries with a round trip at every stage (reference:
scripts/infer.py:368-733). This replica keeps the JAX script's stages, sizes
and placement, at batch 1:

  warp: a backward map and cv2.remap x2 (image, mask)    misc.py:458-519
  vit: DINOv2 ViT-S/14 forward, hidden state 9            dinov2_utils.py:115-158
  grid_sample at the masked grid points                   feature_util.py:100-131
  pca: 384 -> 256 on the host                             projector_util.py:66-69
  words: visual-word kNN, k = 3, on the host              knn_util.py:49-51,74-79
  tfidf_retrieval: tf-idf and cosine top-5                template_util.py:126-176
  buddies: 5x cyclic buddies (two kNN searches each)      corresp_util.py:34-70
  pnp: 5x cv2.solvePnPRansac (400 iterations) + LM        pnp_util.py:46-74

with three changes. The ViT is `hf_dinov2.Dinov2Model` (12 layers, 384
wide, 6 heads, no registers, `image_size` 518, so 420 px crops interpolate
the position embeddings) in f32 on `device`, its stage clock stopped after
a `torch.cuda.synchronize()`; `grid_sample` runs on `device` too and the
features come back to the host before the PCA, as the reference's
projector round trip does; numpy stand-ins take scikit-learn's place
(`host_standins.PCA`, `cross_parity.knn` for every `NearestNeighbors`
search). One untimed forward warms the ViT up with the object's set-up. The
data are synthetic at the published LM-O scale (configs/infer/lmo.json),
drawn from `np.random.default_rng(0)` in the JAX script's order.

Prints one JSON line with the JAX script's keys (`stage_seconds_per_crop`'s
`vit` now measured on the card; `adjusted_reference_estimate` keeps the JAX
formula, 8 ms of granted ViT plus the other stages over 8 cores), plus
`adjusted_with_measured_vit` (the measured ViT plus the other stages over
8), `card` (nvidia-smi's name and power limit) and `cpu_count` (the host's
cores). The port's bench divides by the JAX script's 18.85 crops/s
(`bench.REFERENCE_CROPS_PER_SEC`), which a CPU host measured; these figures
are the same replica's on the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from foundpose_torch.benchmarks import bench, hf_dinov2, host_standins
from foundpose_torch.benchmarks.cross_parity import knn

RAW_DIM = 384
TOP_N_TEMPLATES = 5
RANSAC_ITERS = 400
GRID = 30  # 420/14 patches per side
CROP = 420
FEATS_PER_TEMPLATE = 400  # valid features of an LM-O template bank
FACET_HIDDEN_STATE = 9  # the reference's hook on block 9

# The JAX script's adjustments in the reference's favour: a ViT-S forward
# granted at 8 ms on a datacenter GPU, and every other stage over an
# 8-core workstation with perfect scaling.
ADJ_VIT_S = 0.008
ADJ_CPU_SCALE = 1.0 / 8.0
STAGES = ("warp", "vit", "grid_sample", "pca", "words", "tfidf_retrieval", "buddies", "pnp")


def vit_config(**overrides) -> hf_dinov2.Dinov2Config:
    """The JAX script's transformers Dinov2Config: ViT-S/14 at 518 px."""
    return hf_dinov2.Dinov2Config(**{
        **dict(hidden_size=RAW_DIM, num_hidden_layers=12, num_attention_heads=6, patch_size=14,
               image_size=518), **overrides})


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(n_crops: int = 6, num_templates: int = 798, num_words: int = 2048, pca_dim: int = 256,
        num_buddies: int = 300, device="cuda",
        vit_overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The report (see the module docstring); `vit_overrides` shrink the
    ViT for tests."""
    import cv2
    import torch.nn.functional as F

    device = bench.require_device(device)
    rng = np.random.default_rng(0)
    model = hf_dinov2.Dinov2Model(vit_config(**(vit_overrides or {}))).to(device).eval()
    raw_dim = model.config.hidden_size

    # --- per-object set-up (not in the per-crop figures, as in the
    # reference's own stage timers) ---
    word_centroids = rng.standard_normal((num_words, pca_dim)).astype(np.float32)
    word_idfs = np.abs(rng.standard_normal(num_words)).astype(np.float32)
    template_descs = np.abs(rng.standard_normal((num_templates, num_words))).astype(np.float32)
    template_descs /= np.linalg.norm(template_descs, axis=1, keepdims=True)
    tpl_feats = [rng.standard_normal((FEATS_PER_TEMPLATE, pca_dim)).astype(np.float32)
                 for _ in range(num_templates)]
    tpl_vertices = [rng.uniform(-0.05, 0.05, (FEATS_PER_TEMPLATE, 3)).astype(np.float32)
                    for _ in range(num_templates)]
    pca = host_standins.PCA(n_components=pca_dim)
    pca.fit(rng.standard_normal((4096, raw_dim)).astype(np.float32))

    full_img = rng.integers(0, 255, (476, 630, 3), dtype=np.uint8)
    k_mat = np.array([[600.0, 0, 315], [0, 600.0, 238], [0, 0, 1]], np.float64)
    with torch.no_grad():
        model(torch.zeros(1, 3, CROP, CROP, device=device), output_hidden_states=True)
    sync(device)

    stages = {k: 0.0 for k in STAGES}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        stages[name] += time.perf_counter() - t0
        return out

    t_total0 = time.perf_counter()
    for _ in range(n_crops):
        def do_warp():
            map_x, map_y = np.meshgrid(np.linspace(100, 500, CROP, dtype=np.float32),
                                       np.linspace(30, 430, CROP, dtype=np.float32))
            crop = cv2.remap(full_img, map_x, map_y, cv2.INTER_LINEAR)
            mask = cv2.remap((full_img[..., 0] > 64).astype(np.uint8), map_x, map_y,
                             cv2.INTER_NEAREST)
            return crop, mask

        crop, mask = timed("warp", do_warp)

        def do_vit():
            x = torch.from_numpy(crop.astype(np.float32).transpose(2, 0, 1)[None] / 255.0)
            with torch.no_grad():
                out = model(x.to(device), output_hidden_states=True)
            tokens = out.hidden_states[FACET_HIDDEN_STATE][:, 1:, :]
            sync(device)
            return tokens

        tokens = timed("vit", do_vit)
        fmap = tokens.reshape(1, GRID, GRID, raw_dim).permute(0, 3, 1, 2)

        def do_gs():
            pts = torch.from_numpy(rng.uniform(-1, 1, (1, 1, 420, 2)).astype(np.float32))
            return F.grid_sample(fmap, pts.to(device), align_corners=False)[0, :, 0].T.cpu()

        q_raw = timed("grid_sample", do_gs).numpy()
        q = timed("pca", lambda: pca.transform(q_raw).astype(np.float32))
        _, w_ids = timed("words", lambda: knn(q, word_centroids, 3))

        def do_tfidf():
            hist = np.zeros(num_words, np.float32)
            np.add.at(hist, w_ids.ravel(), 1.0)
            desc = hist * word_idfs
            desc /= max(np.linalg.norm(desc), 1e-9)
            sims = template_descs @ desc
            return np.argsort(-sims)[:TOP_N_TEMPLATES]

        top_ids = timed("tfidf_retrieval", do_tfidf)

        def do_buddies():
            out = []
            for tid in top_ids:
                _, i1 = knn(q, tpl_feats[tid], 1)  # query -> template
                _, i2 = knn(tpl_feats[tid][i1[:, 0]], q, 1)  # back
                u = rng.uniform(0, CROP, (len(q), 2))
                cyc = np.linalg.norm(u - u[i2[:, 0]], axis=1)
                sel = np.argsort(cyc)[:num_buddies]
                out.append((tid, sel, i1[sel, 0]))
            return out

        corresp = timed("buddies", do_buddies)

        def do_pnp():
            best = None
            for tid, sel, tidx in corresp:
                obj = tpl_vertices[tid][tidx].astype(np.float64)
                img_pts = rng.uniform(0, CROP, (len(sel), 2)).astype(np.float64)
                ok, rvec, tvec, inl = cv2.solvePnPRansac(
                    obj, img_pts, k_mat, None, iterationsCount=RANSAC_ITERS,
                    reprojectionError=10.0, confidence=0.99, flags=cv2.SOLVEPNP_ITERATIVE)
                if ok and inl is not None and len(inl) >= 6:
                    rvec, tvec = cv2.solvePnPRefineLM(obj[inl[:, 0]], img_pts[inl[:, 0]], k_mat,
                                                      None, rvec, tvec)
                    if best is None or len(inl) > best[0]:
                        best = (len(inl), rvec, tvec)
            return best

        timed("pnp", do_pnp)

    total = time.perf_counter() - t_total0
    per_crop = {k: v / n_crops for k, v in stages.items()}
    cpu_stages = sum(v for k, v in per_crop.items() if k != "vit")
    card = bench.card(device)
    return {
        "metric": "reference_replica_crops_per_sec",
        "measured_this_host": n_crops / total,
        "host": f"{os.cpu_count()}-core host, ViT and grid_sample on {card}",
        "stage_seconds_per_crop": per_crop,
        "adjusted_reference_estimate": 1.0 / (ADJ_VIT_S + cpu_stages * ADJ_CPU_SCALE),
        "adjustment": {"vit_gpu_seconds": ADJ_VIT_S, "cpu_scale": ADJ_CPU_SCALE},
        "n_crops": n_crops,
        "adjusted_with_measured_vit": 1.0 / (per_crop["vit"] + cpu_stages * ADJ_CPU_SCALE),
        "card": card,
        "cpu_count": os.cpu_count(),
    }


def main(argv=None, vit_overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--crops", type=int, default=6)
    ap.add_argument("--templates", type=int, default=798)
    ap.add_argument("--words", type=int, default=2048)
    ap.add_argument("--pca-dim", type=int, default=256)
    ap.add_argument("--buddies", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(n_crops=args.crops, num_templates=args.templates, num_words=args.words,
                 pca_dim=args.pca_dim, num_buddies=args.buddies, device=args.device,
                 vit_overrides=vit_overrides)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
