"""The reference pipeline's offline per-object cost, measured on the card's
own machine (counterpart of benchmarks/reference_offline_baseline.py).

    python -m foundpose_torch.benchmarks.reference_offline_baseline [--views 4] [--reps 3] \\
        [--templates 798] [--device cuda]

The reference runs two offline stages once per object, whose hot loops are
one render and one ViT forward per template (798 templates an LM-O object):

gen_templates (reference: scripts/gen_templates.py:237-474), per view: the
  render at SSAA resolution (GL, granted at 5 ms a view as in the JAX
  script), a backward map over every pixel of the 1,680 px crop and
  cv2.remap x3 (image, mask, depth, misc.py:458-556), SSAA downsampling by
  cv2.resize, three PNG encodes.
gen_repre (reference: scripts/gen_repre.py:107-217, 272-346): per template,
  three PNG decodes, a 5x5 erosion, the grid and depth lifting on the host,
  the ViT forward at batch 1 and grid_sample, both on `device` here (each
  stage's clock stopped after a `torch.cuda.synchronize()`); then the PCA
  fit at the real cap (100,000 x 384) and the transform of the whole bank
  on the host (`host_standins.PCA`); k-means with 2,048 words
  (`host_standins.kmeans_lloyd`, random-row init as scikit-learn's
  `init="random"` and faiss) for 3 Lloyd steps on a 16,384-row subsample,
  extrapolated linearly to the bank and to 50 steps as the JAX script does;
  the per-template word search (`cross_parity.knn`, k = 3) over 8
  templates, extrapolated to all.

The per-template loops are measured over `reps` iterations after one
warm-up and extrapolated linearly. The adjustments in the reference's
favour are the JAX script's (a GL render at 5 ms, a ViT at 8 ms, k-means on
a GPU at 100x this host, every other stage over 8 cores). The ViT is
`hf_dinov2.Dinov2Model` (ViT-S/14, no registers, 518 px pretraining grid)
in f32. Prints one JSON line with the JAX script's keys plus `card`
(nvidia-smi's name and power limit) and `cpu_count` (the host's cores);
`gen_repre.per_template_s.vit_s` is measured on the card. The port's
`builder_full_scale` divides by the JAX script's 30.1 s and 11.3 s, which
a CPU host measured; these figures are the same replica's on the card's
machine.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from foundpose_torch.benchmarks import bench, hf_dinov2, host_standins
from foundpose_torch.benchmarks.cross_parity import knn
from foundpose_torch.benchmarks.reference_baseline import (FACET_HIDDEN_STATE,
                                                           FEATS_PER_TEMPLATE, sync, vit_config)

CROP = 420
SSAA = 4
RENDER_W, RENDER_H = 2520, 1904  # the dataset camera (630 x 476) x SSAA
KMEANS_ITERS = 50  # the reference's faiss.Kmeans
KMEANS_SUB_ITERS = 3  # Lloyd steps measured on the subsample

ADJ_RENDER_S = 0.005  # granted GL render a view
ADJ_VIT_S = 0.008  # granted GPU ViT forward a template
ADJ_CPU_SCALE = 1.0 / 8.0
ADJ_KMEANS_GPU_SPEEDUP = 100.0  # granted faiss-gpu against one host core


def measure_gen_templates_view(rng, cv2):
    """One view of the gen_templates loop without the granted render: the
    stage seconds, and the three PNGs under "_pngs"."""
    big = CROP * SSAA  # 1680
    color = rng.integers(0, 255, (RENDER_H, RENDER_W, 3), dtype=np.uint8)
    depth = rng.uniform(500, 1500, (RENDER_H, RENDER_W)).astype(np.float32)
    mask = (depth > 900).astype(np.uint8) * 255
    stages = {}

    t0 = time.perf_counter()
    # The backward map by camera math over every crop pixel (misc.py:458-519:
    # unproject the crop grid, rotate, project into the render camera).
    ys, xs = np.meshgrid(np.arange(big, dtype=np.float32), np.arange(big, dtype=np.float32),
                         indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(big * big, np.float32)], 1)
    k_dst_inv = np.array([[1 / 2400.0, 0, -0.35], [0, 1 / 2400.0, -0.35], [0, 0, 1]], np.float32)
    rays = pts @ k_dst_inv.T
    r_rel = np.array([[0.999, -0.02, 0.01], [0.02, 0.999, -0.03], [-0.01, 0.03, 0.999]],
                     np.float32)
    rays = rays @ r_rel.T
    k_src = np.array([[600.0 * SSAA, 0, RENDER_W / 2], [0, 600.0 * SSAA, RENDER_H / 2],
                      [0, 0, 1]], np.float32)
    proj = rays @ k_src.T
    map_x = (proj[:, 0] / proj[:, 2]).reshape(big, big).astype(np.float32)
    map_y = (proj[:, 1] / proj[:, 2]).reshape(big, big).astype(np.float32)
    stages["warp_map_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    color_w = cv2.remap(color, map_x, map_y, cv2.INTER_LINEAR)
    mask_w = cv2.remap(mask, map_x, map_y, cv2.INTER_NEAREST)
    # warp_depth_image also rescales depth along the new rays (misc.py:522-556).
    depth_w = cv2.remap(depth, map_x, map_y, cv2.INTER_NEAREST)
    norm = np.linalg.norm(rays, axis=1).reshape(big, big)
    depth_w = depth_w * (norm / np.maximum(rays[:, 2].reshape(big, big), 1e-6))
    stages["remap_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    color_s = cv2.resize(color_w, (CROP, CROP), interpolation=cv2.INTER_AREA)
    depth_s = cv2.resize(depth_w, (CROP, CROP), interpolation=cv2.INTER_NEAREST)
    mask_s = cv2.resize(mask_w, (CROP, CROP), interpolation=cv2.INTER_NEAREST)
    stages["resize_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ok1, rgb_png = cv2.imencode(".png", color_s)
    ok2, depth_png = cv2.imencode(".png", depth_s.astype(np.uint16))
    ok3, mask_png = cv2.imencode(".png", mask_s)
    if not (ok1 and ok2 and ok3):
        raise RuntimeError("cv2.imencode failed")
    stages["png_s"] = time.perf_counter() - t0
    stages["_pngs"] = (rgb_png, depth_png, mask_png)
    return stages


def run(num_templates: int = 798, n_views: int = 4, n_reps: int = 3, pca_cap: int = 100_000,
        pca_dim: int = 256, num_words: int = 2048, kmeans_rows: int = 16_384,
        tfidf_reps: int = 8, device="cuda",
        vit_overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The report (see the module docstring); the sizes and `vit_overrides`
    shrink it for tests."""
    import cv2
    import torch.nn.functional as F

    device = bench.require_device(device)
    rng = np.random.default_rng(0)
    card = bench.card(device)
    report = {"metric": "reference_offline_baseline",
              "host": f"{os.cpu_count()}-core host, ViT and grid_sample on {card}"}

    # ---- gen_templates ----------------------------------------------------
    tpl_stages, pngs = None, None
    for i in range(n_views + 1):
        s = measure_gen_templates_view(rng, cv2)
        pngs = s.pop("_pngs")
        if i == 0:
            continue  # warm-up (allocator, cv2's thread pool)
        tpl_stages = s if tpl_stages is None else {k: tpl_stages[k] + v for k, v in s.items()}
    tpl_stages = {k: v / n_views for k, v in tpl_stages.items()}
    per_view_cpu = sum(tpl_stages.values())
    gen_templates_meas = num_templates * per_view_cpu  # and the render, granted
    gen_templates_adj = num_templates * (ADJ_RENDER_S + per_view_cpu * ADJ_CPU_SCALE)
    report["gen_templates"] = {
        "per_view_cpu_s": tpl_stages,
        "measured_cpu_s_per_object_excl_render": gen_templates_meas,
        "adjusted_s_per_object": gen_templates_adj,
        "adjusted_templates_per_s": num_templates / gen_templates_adj,
    }
    print(f"[offline] gen_templates: {report['gen_templates']}", file=sys.stderr)

    # ---- gen_repre: the per-template registration loop --------------------
    model = hf_dinov2.Dinov2Model(vit_config(**(vit_overrides or {}))).to(device).eval()
    raw_dim = model.config.hidden_size
    grid = CROP // 14
    reg = {"load_s": 0.0, "erode_grid_lift_s": 0.0, "vit_s": 0.0, "grid_sample_s": 0.0}
    for i in range(n_reps + 1):
        t0 = time.perf_counter()
        color = cv2.imdecode(pngs[0], cv2.IMREAD_COLOR)
        depth = cv2.imdecode(pngs[1], cv2.IMREAD_ANYDEPTH).astype(np.float32)
        mask = cv2.imdecode(pngs[2], cv2.IMREAD_GRAYSCALE)
        t1 = time.perf_counter()
        mask_e = cv2.erode(mask, np.ones((5, 5), np.uint8))
        gy, gx = np.meshgrid(np.arange(7, CROP, 14, dtype=np.float32),
                             np.arange(7, CROP, 14, dtype=np.float32), indexing="ij")
        pts = np.stack([gx.ravel(), gy.ravel()], 1)
        valid = mask_e[pts[:, 1].astype(int), pts[:, 0].astype(int)] > 0
        pts_v = pts[valid]
        z = depth[pts_v[:, 1].astype(int), pts_v[:, 0].astype(int)]
        xyz = np.stack([(pts_v[:, 0] - 210.0) * z / 600.0, (pts_v[:, 1] - 210.0) * z / 600.0, z],
                       1)
        _ = xyz @ np.eye(3, dtype=np.float32).T + np.array([0, 0, -900.0], np.float32)
        t2 = time.perf_counter()
        x = torch.from_numpy(color.astype(np.float32).transpose(2, 0, 1)[None] / 255.0)
        with torch.no_grad():
            out = model(x.to(device), output_hidden_states=True)
        tokens = out.hidden_states[FACET_HIDDEN_STATE][:, 1:, :]
        sync(device)
        t3 = time.perf_counter()
        fmap = tokens.reshape(1, grid, grid, raw_dim).permute(0, 3, 1, 2)
        grid_pts = torch.from_numpy((pts_v / (CROP / 2.0) - 1.0).astype(np.float32))[None, None]
        _ = F.grid_sample(fmap, grid_pts.to(device), align_corners=False).cpu()
        t4 = time.perf_counter()
        if i == 0:
            continue  # warm-up
        reg["load_s"] += t1 - t0
        reg["erode_grid_lift_s"] += t2 - t1
        reg["vit_s"] += t3 - t2
        reg["grid_sample_s"] += t4 - t3
    reg = {k: v / n_reps for k, v in reg.items()}
    reg_cpu = sum(v for k, v in reg.items() if k != "vit_s")
    registration_meas = num_templates * (reg_cpu + reg["vit_s"])
    registration_adj = num_templates * (ADJ_VIT_S + reg_cpu * ADJ_CPU_SCALE)
    print(f"[offline] registration per template: {reg}", file=sys.stderr)

    # ---- gen_repre: the PCA fit at the real cap, the bank's transform -----
    n_feats = num_templates * FEATS_PER_TEMPLATE
    raw = rng.standard_normal((min(pca_cap, n_feats), raw_dim)).astype(np.float32)
    t0 = time.perf_counter()
    pca = host_standins.PCA(n_components=pca_dim).fit(raw)
    pca_s = time.perf_counter() - t0
    full = rng.standard_normal((n_feats, raw_dim)).astype(np.float32)
    t0 = time.perf_counter()
    feats = pca.transform(full).astype(np.float32)
    pca_s += time.perf_counter() - t0
    print(f"[offline] pca fit+transform: {pca_s:.1f}s", file=sys.stderr)

    # ---- gen_repre: k-means, extrapolated from a subsample ----------------
    t0 = time.perf_counter()
    centers, _, iters_run = host_standins.kmeans_lloyd(feats[:kmeans_rows], num_words,
                                                       KMEANS_SUB_ITERS, seed=0)
    km_sub_s = time.perf_counter() - t0
    kmeans_meas = km_sub_s * (n_feats / kmeans_rows) * (KMEANS_ITERS / max(iters_run, 1))
    print(f"[offline] kmeans subsample {kmeans_rows}x{iters_run} iters: {km_sub_s:.1f}s -> "
          f"extrapolated {kmeans_meas:.1f}s", file=sys.stderr)

    # ---- gen_repre: the per-template word search --------------------------
    t0 = time.perf_counter()
    for t in range(tfidf_reps):
        knn(feats[t * FEATS_PER_TEMPLATE : (t + 1) * FEATS_PER_TEMPLATE], centers, 3)
    tfidf_meas = (time.perf_counter() - t0) / tfidf_reps * num_templates
    print(f"[offline] tfidf word search: {tfidf_meas:.1f}s/object", file=sys.stderr)

    repre_meas = registration_meas + pca_s + kmeans_meas + tfidf_meas
    repre_adj = (registration_adj + pca_s * ADJ_CPU_SCALE
                 + kmeans_meas / ADJ_KMEANS_GPU_SPEEDUP + tfidf_meas * ADJ_CPU_SCALE)
    report["gen_repre"] = {
        "per_template_s": reg,
        "pca_s": pca_s,
        "kmeans_s_extrapolated": kmeans_meas,
        "tfidf_s": tfidf_meas,
        "measured_s_per_object": repre_meas,
        "adjusted_s_per_object": repre_adj,
        "adjusted_templates_per_s": num_templates / repre_adj,
    }
    report["adjustment"] = {"render_gl_s_per_view": ADJ_RENDER_S, "vit_gpu_s": ADJ_VIT_S,
                            "cpu_scale": ADJ_CPU_SCALE,
                            "kmeans_gpu_speedup": ADJ_KMEANS_GPU_SPEEDUP}
    report["adjusted_total_s_per_object"] = gen_templates_adj + repre_adj
    report["card"] = card
    report["cpu_count"] = os.cpu_count()
    return report


def main(argv=None, vit_overrides: Optional[Dict[str, Any]] = None, **sizes) -> Dict[str, Any]:
    """Parses `argv` (the views, reps, templates and device; `sizes` sets
    run()'s other sizes), prints the report as one JSON line and returns it."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--templates", type=int, default=798)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = run(num_templates=args.templates, n_views=args.views, n_reps=args.reps,
                 device=args.device, vit_overrides=vit_overrides, **sizes)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
