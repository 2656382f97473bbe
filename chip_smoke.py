#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (foundpose_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py              # one GPU

Phases (each prints one line and raises on failure):
  0  card: name, power limit, device count; TF32 switched off.
  1  build: compiles csrc/*.cu with nvcc (sm_90a), one process per source,
     all started together, into foundpose_torch/_build.
  2  kernels vs their plain PyTorch twins at their paths' shapes: the ViT
     block per layer (whole output and the residual branches alone) and
     over all layers, the buddies cycle distances, the RANSAC scorer from
     its raw operands at lmo.json's 200 and lmo_exact.json's 400
     hypotheses (counts bit-equal to the twin's; the kernel's device time
     under torch.profiler beside the CUDA-event time of the wrapper call);
     attention at f32 and bf16 (the unfused path's layer-0 q, k, v); both
     GEMMs of the int8/bf16 probe; the LO/LM refinement (csrc/refine.cu)
     on the winners pose_from_crops passes it for a request of 16 crops
     and a batch of 128 at lmo.json, each on a world whose first templates
     are its own crops (batch_world_repre), so that the winners pose
     (counts and inlier masks equal to the twin's in every set, R within
     1e-4 and t within 5e-5 m in the sets with at least 12 inliers after
     LO, at least half the sets; the twin's device kernels a call); RANSAC's
     samples and minimal solves (csrc/hypotheses.cu) on every set
     pose_from_crops passes them there (kernel 2's counts of its poses and
     of the twin's equal on at least 90% of the hypotheses, each posed
     set's first maximum equal; of the candidates, the hypotheses the twin
     in float64 poses, as large a share within 1e-2 (R) and 2e-3 m (t) of
     it as the float32 twin's, less 1%; the twin's device kernels a
     call). Errors against stated tolerances;
     CUDA-event times of kernel, twin and, where one PyTorch call computes
     the same function, that call; the least time the card could take
     (bound). The block's seven launches (LN1, qkv,
     attention, proj, LN2, fc1, fc2) are timed one by one under
     torch.profiler (foundpose_torch/benchmarks/block_split.py), beside
     F.linear and scaled_dot_product_attention at the same shapes; a split
     of which torch.profiler lost device kernels on every try is reported
     as not measured, never from a part.
  3  main path: DINOv2 ViT-S/14-reg (calibrated random weights), an LM-O
     scale synthetic representation and configs/infer/lmo.json, serving
     batches of 420 px crops through pipeline.inference.pose_from_crops until
     the latency settles, then 30 timed requests; latency quartiles, crops/s,
     a per-stage split, peak memory, proof that all three kernels launched,
     and torch.profiler over one request (device busy share, top kernels).
  4  pose correctness on a structured world with known poses: the card
     (kernels) against the CPU (twins), and the card against ground truth,
     under lmo.json (bf16, approx top-k) and lmo_exact.json (f32, exact).
  5  serving path: foundpose_torch.engine.PoseEngine at
     configs/infer/lmo_exact.json (unfused f32 ViT on the attention kernel,
     exact top-k, 400 hypotheses) with two LM-O scale objects, one 480x640
     image and 16 boxes: estimate() until the latency settles, then 30
     timed calls; estimate_mixed() over both objects; proof that attention
     launched 10 times a request and the block and buddies kernels never;
     one estimate() up to its one device-to-host fetch under the CUDA sync
     debug mode "error" (a host sync raises), at lmo_exact.json (launches
     from zero: attention 10, hypotheses 1, scorer 1, refinement 1, nothing
     else) and with lmo.json's
     switches (fused bf16 ViT on the block kernel, approximate top-k;
     block 10, buddies 1, hypotheses 1, scorer 1, refinement 1, nothing
     else); cuDNN's TF32 switch does not change the results; card vs CPU
     on one request with the same draws.
  6  the int8/bf16 GEMM probe through its entry point
     (foundpose_torch.benchmarks.micro_int8.run).
  7  the main path at configs/infer/lmo_refine.json (lmo.json plus
     featuremetric refinement, 8 LM steps on each crop's winner): phase 3's
     requests, timing and checks, with the refinement split out of the
     solve stage; torch.profiler over one request beside phase 3's, and
     over the refinement alone (its device time, ops and host launch
     calls); no host sync inside the refinement (CUDA sync debug mode).
  8  lmo_refine.json on a world whose feature maps carry sub-cell signal
     (descriptors splatted bilinearly around their true projections): card
     against CPU (template ids, success, R and t), refined against coarse
     error on the card, both scored by the port's BOP19 AR (MSSD, MSPD).
  9  the offline CLI at configs/infer/lmo.json (options through
     utils/config.load_opts): a synthetic LM-O-like split in a temporary
     directory (12 PNGs of 640x480 with LM-O's camera, objects 1 and 5 with
     LM-O's diameters, 8 detections each per image: 96 crops per object),
     an LM-O-scale representation per object whose first 96 templates are
     that object's crops (written by repre.save_repre); pipeline.infer.infer
     over both objects and infer_multi_object over the same split (crops/s
     by host clock, the runner's per-instance prep and pipeline times, the
     finalize walls, proof that kernels 1-3 launched), the output files,
     prepare_bop_submission and eval_ar (AR finite; with random weights its
     value means nothing), no host sync inside one dispatch, the card
     against the CPU on image 0's first 4 detections with the same draws
     (on a 5-template world of their own crops whose retrieval scores
     stand apart), and torch.profiler over one object's infer().

  10 the offline builder (leg a): one LM-O-sized object, a textured
     icosphere of 5,120 faces with LM-O object 1's diameter, through
     pipeline.gen_templates at configs/gen_templates/lmo.json (798
     templates of 420 px, SSAA 4; templates/s) and pipeline.gen_repre at
     configs/gen_repre/lmo.json (ViT-S/14-reg layer 9 unfused f32 on the
     attention kernel, PCA 384 -> 256, 2048 words): Timer's stage times
     with k-means split into init and Lloyd, templates/s, peak memory,
     proof that attention launched 500 times (50 chunks x 10 layers) and
     the block and buddies kernels never, the representation's shapes and
     finiteness, no host sync in one registration chunk (CUDA sync debug
     mode), torch.profiler over one gen_repre call; then infer() at
     configs/infer/lmo.json on 4 images rendered from the same mesh at
     template views (LM-O camera), the submission and eval_ar, the median
     pose errors. Leg (b):
     the world of tests/test_integration.py (36 templates of 140 px, a
     2-block ViT with 64-wide heads) built by gen_repre on the card and on
     the CPU with the same k-means init (features, vertices, ids, validity,
     PCA reconstruction, tf-idf descriptors against stated tolerances),
     then infer() on the card with the card-built representation against
     the GT pose (< 15 deg, < 30 mm).
  11 the multi-device layer (foundpose_torch/parallel) on one world: the 16
     crops of object 1 in a 2-image split written as phase 9's, with its
     LM-O-scale crop-world representation (798 templates), and injected
     draws. (a) NCCL, world 1, mesh (1, 1), in this process: the step at
     lmo.json against the single-device pose_from_crops. (b) 4 gloo ranks
     sharing the card (foundpose_torch.parallel.launch; NCCL refuses two
     ranks on one device): the (2, 2) step at lmo.json (fused block) and
     the (1, 2, 2) tensor-parallel step at lmo_exact.json (its ViT
     unfused in f32 on the attention kernel, 3 heads a rank) against the
     single-device step at the same configuration; PoseEngine(mesh_shape=
     (2, 2)) at lmo_exact.json, estimate() and estimate_mixed() with phase
     5's objects, image and boxes, then estimate() of the split's object
     on its image 0 (whose crops are templates of the crop-world
     representation, so rows solve), against the single-device engine of
     the same seed; the infer CLI at mesh_shape=[2, 2] against the single-
     device CLI on the split. Template ids, best template and success
     equal for every crop, R within 1e-4 and t within 1e-5 m (over every
     crop for the data-parallel steps, over the crops both solved
     elsewhere); launches per rank counted from zero around one request
     (block 10 a rank on the (2, 2) step, attention 10 a rank under TP);
     the median of 10 timed requests per mesh, labelled "gloo, 4 ranks on
     one card: not a multi-card figure". Each rank of the (2, 2) step
     also runs every stage on its rows from the single-device chain's
     inputs (ViT, query features and PCA, tf-idf retrieval, bank fetch,
     matching, solve) against the single-device stage on all 16 crops,
     and reports each stage's largest difference (the fetch must be
     bit-equal). A rank's failure fails the run.
  12 (run between phases 10 and 11; its part (e) after phase 16)
     DINOv2 ViT-G/14-reg (SwiGLU MLP, 1536 wide, 24 heads, hidden 4096, 40
     blocks to layer 39, 1.1B parameters) at configs/infer/lmo.json with the
     extractor replaced (the CLI's --set extractor_name=...), calibrated
     random weights from seed 0. (a) realistic_params' seconds, the module
     built on the card block by block, the attention logit maximum at 420
     px over 40 layers (< 99, the capped window; computed in torch on the
     card). (b) the block kernel's SwiGLU body against its twin at [16, 905,
     1536] bf16 through all 40 layers, as phase 2 (per-layer output and
     branch rel. L2, feature-map cosine, the column stabilizer once), with
     CUDA-event times of kernel, twin and the PyTorch calls of one layer's
     shapes together, the bound from utils/flops and the seven launches.
     (c) pose_from_crops at batch 16 on an LM-O-scale synthetic
     representation with PCA 1536 -> 256, as phase 3 (warm-up windows, 30
     timed requests, stage split, peak memory, torch.profiler), and the
     launches from zero over one request (block 40, buddies 1, hypotheses 1, scorer 1,
     refinement 1).
     (d) one registration chunk (16 templates) of configs/gen_repre/lmo.json
     with the ViT-G extractor, unfused f32: attention exactly 40 launches,
     finite features; the 798-template build is not run. (e), after phase
     16, from the first two blocks' weights kept on the host: phase 11's TP
     leg at ViT-G width: the (1, 2, 2) step at lmo_exact.json (unfused f32,
     12 heads and 2,048 hidden units a rank) on 4 gloo ranks sharing the
     card, cut to the first 2 blocks (layer 1), against the single-device
     step: decisions equal, R within 1e-4, t within 1e-5 m.

  13 (run after phase 10, before phases 12 and 11)
     configs/infer/lmo_vitl.json: DINOv2 ViT-L/14 (no registers, 901
     tokens, 1024 wide, 16 heads of 64, GELU MLP 4096) to layer 18's key
     facet (18 fused blocks, then layer 18's qkv as a plain F.linear),
     calibrated random weights from seed 0 built on the card block by
     block, the attention logit maximum at 420 px (< 99). (a) the block
     kernel's GELU body against its twin at [16, 901, 1024] bf16 through
     the 18 layers, as phase 2 (per-layer output and branch rel. L2, the
     key facet's feature-map cosine, the column stabilizer once, times of
     kernel, twin and the PyTorch calls of one layer's shapes, the bound
     from utils/flops, the seven launches). (b) pose_from_crops at batch 16
     on an LM-O-scale synthetic representation with PCA 1024 -> 256, as
     phase 3, and the launches from zero over one request (block 18,
     buddies 1, hypotheses 1, scorer 1, refinement 1).
  14 (after phase 12, before phase 15) the bench layer's entry points in
     this process:
     foundpose_torch.benchmarks.bench at batch 128 with the stage split
     for ViT-S/14-reg and for ViT-L/14 (crops/s, MFU against the card's
     bf16 peak, attention logit max < 99, one step under the CUDA sync
     debug mode). On each bench's own set-up, before it is timed, kernels
     1-3 against their twins with phase 2's gates: the block through the
     facet's layers at [128, 905, 384] and [128, 901, 1024] on the step's
     crops, the buddies and the scorer on the operands one step passes
     them (128 crops x 5 templates); then the launches from zero over one
     step (block 10 or 18, buddies 1, hypotheses 1, scorer 1, refinement 1, nothing
     else).
     Then benchmarks.latency with LAT_REPS = 20 (PoseEngine at
     batch 1, 8, 16) and benchmarks.featuremetric_bench (refinement off
     and on at batch 64 and 128, peak memory): every key of each report,
     every time finite, 0 < MFU <= 1.
  15 (after phase 14) BASELINE.json config 5, the multi-dataset sweep:
     synthetic TUD-L, YCB-V (640x480 under test/) and T-LESS (720x540
     under test_primesense/, center-cropped to 630x532) splits, 2 images
     each with 2 detections of every object of the dataset (3, 21, 30),
     each dataset's own camera kind; 3 distinct LM-O-scale crop-world
     representations, every object's directory a link to one of them
     (round-robin), each object still loaded as its own copy. (a)
     pipeline.sweep over the three datasets as the JAX package defines it
     (InferOpts' defaults: unfused f32 ViT on the attention kernel, exact
     top-k, RANSAC 200): per dataset crops/s by host clock, each object's
     load seconds (load_repre and the copy to the card), peak memory,
     launches from zero (attention 10, hypotheses 1, scorer 1, refinement 1 a batch,
     block and buddies 0), one BOP19 CSV whose rows are the detections
     that solved.
     (b) infer at configs/infer/tudl.json and ycbv.json, infer_multi_object
     at configs/infer/tless.json over all 30 objects (batches mixing
     objects; kernel 3 reads banks indexed by object and template): the
     same figures, the mixed load's peak memory before the first batch
     (< 30 GB), launches (block 10, buddies 1, hypotheses 1, scorer 1, refinement 1 a
     batch); the card
     against the CPU through infer_multi_object at tless.json on image 0's
     first 4 detections with the same draws (phase 9's bounds).
  16 (after phase 15, before phase 11) the micro-benches in this process:
     foundpose_torch.benchmarks.micro_pnp, micro_buddies and
     micro_retrieval at their own sizes (each substage's CUDA-event ms,
     device ms under torch.profiler or "not measured", host launch calls,
     and the kernel launches of one call: hypotheses and scorer once in both RANSAC
     substages, the refinement once in ransac_full(+lm), the buddies
     kernel once in real_match_batch),
     vit_stage_bench at batch 64 (block 10 launches a call) and
     cli_throughput on 8 images (its split, gen_templates and gen_repre
     build, two infer passes at batch 64): every key, every time finite.
  17 (after phase 16, before phase 12 (e) and phase 11) the cross-parity
     oracle and the solve sweeps (foundpose_torch/benchmarks/cross_parity,
     ransac_sweep, lm_iters_sweep, select_iter_sweep) at the JAX scripts'
     defaults. (d) first: kernels 3 and 2 against their twins (phase 2's
     gates) on the operands one fast-leg call passes them on (a)'s world
     and queries, the scorer at 400 and at 100 hypotheses, each call's
     launches counted from zero (buddies 1, hypotheses 1, scorer 1, refinement 1). (a)
     run_parity:
     798 templates of 400 features, 256 dims, 2,048 words, 4,000 points, 100
     crops, top-5 / 300 buddies / 400 hypotheses; the host replica (numpy
     kNN, cv2 RANSAC and LM) against the port's exact f32 and fast bf16
     legs on the card: AR deltas <= 0.01, idf max |delta| < 1e-5,
     descriptor cosine > 0.999; the replica's seconds a crop, each leg's
     wall, launches from zero (exact: hypotheses 1, scorer 1, refinement 1; fast: buddies
     1, hypotheses 1, scorer 1, refinement 1).
     (b) featuremetric_leg at 100 crops: refinement off vs on, the rules of
     tests/test_cross_parity.py (>= 20 coarse successes, recall within one
     crop, median rotation and translation errors not worse). (c) the three
     sweeps at their JAX defaults but for the crops, cut from 200 to
     SWEEP_CROPS = 100 (ransac at 798 templates, 6 cells; lm and select on
     2 seeds of 96 templates, 4 cells each; select's oracle comes from the
     harness's memo of lm's: both score the same worlds): each one's JSON
     line, every cell's AR, wall ms and
     launches (buddies 1, refinement 1, hypotheses and scorer 1, or 2 for a two-phase
     cell); every AR
     finite, each oracle AR >= 0.9; the pick is reported, not gated.
  18 (after phase 17, before phase 12 (e) and phase 11) the ViT parity leg
     and the reference replicas (foundpose_torch/benchmarks/hf_dinov2,
     host_standins, reference_baseline, reference_offline_baseline,
     cross_parity.vit_parity_leg). (a) vit_parity_leg at 518 px, 2 crops:
     the port's ViT-S/14-reg to layer 9 (unfused f32, calibrated weights)
     against the independent hf_dinov2 model on the same weights, max
     |delta| <= 2e-4, kernel 4 launched exactly 10 times from zero; kernel 4
     on the leg's layer-0 q, k, v [2, 6, 1374, 64] f32 against its twin (rel.
     L2 <= 1e-5), timed beside the twin and scaled_dot_product_attention;
     the 420 px delta printed, not gated (the two recipes for interpolating
     position embeddings differ). (b) reference_baseline at its defaults (6
     crops at LM-O scale, the ViT at batch 1 on the card, cv2 and numpy on
     the host; no kernel of the port launched): measured crops/s, both
     adjusted estimates, and phase 14's ViT-S bench crops/s over each. (c)
     reference_offline_baseline at its defaults: seconds an object measured
     and adjusted, each over phase 10's build of one object. Every figure
     finite and positive; the ratios are findings.

  19 (after phase 13, before phase 12) kernel 1 at DINOv3 ViT-7B/16 on
     what pose_from_crops gives it in the benchmark's cell
     dinov3vit7b16_offline_b32 (perfbench/configs/lmo_dinov3vit7b16.json:
     32 crops of 480 px, 905 tokens, width 4,096, 32 heads of 128, SwiGLU
     8,192, axial RoPE on the 900 patch tokens; the cell's calibrated
     weights from perfbench/models/dinov3 on the card). (a) the block with
     RoPE against its twin through the 31 layers, as phase 2 (per-layer
     output and branch rel. L2, the token facet's feature-map cosine, the
     column stabilizer once, times of kernel, twin and the PyTorch calls
     of one layer's shapes with the rotation, the bound, the seven
     launches). (b) layer 0 without RoPE (EPI_QKV at heads of 128): branch
     rel. L2 and time. (c) the kernel with RoPE against the twin with no
     rotation, the opposite angle and the grid's axes swapped: each must
     fail the branch gate. (d) LayerNorm at 4,096, the qkv GEMM with RoPE
     and attention at heads of 128: device ms of each launch, CUDA-event
     ms of the twin's code for it and of F.layer_norm, F.linear with the
     rotation, and scaled_dot_product_attention, each one's bound. (e)
     launches from zero over one batch of 32 (block 31, of them 31 with
     RoPE, buddies 1, hypotheses 1, scorer 1, refinement 1; the RoPE tables cached).

The second-to-last line of stdout is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. Without CUDA the script exits non-zero and
prints no result. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
LMO_CONFIG = os.path.join(ROOT, "configs", "infer", "lmo.json")
LMO_EXACT_CONFIG = os.path.join(ROOT, "configs", "infer", "lmo_exact.json")
LMO_REFINE_CONFIG = os.path.join(ROOT, "configs", "infer", "lmo_refine.json")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
# LM-O's camera (BOP lmo camera.json), for the serving phase's 640x480 image.
LMO_K = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899], [0.0, 0.0, 1.0]])
# Each dataset's test images: (width, height) and a pinhole camera of its
# sensor's kind (BOP's camera files: TUD-L's 640x480 camera, YCB-V's
# camera_uw, T-LESS's Primesense at 720x540).
DATASET_CAMERAS = {
    "lmo": ((640, 480), LMO_K),
    "tudl": ((640, 480), np.array([[515.0, 0.0, 321.566], [0.0, 515.0, 214.08], [0, 0, 1.0]])),
    "ycbv": ((640, 480), np.array([[1066.778, 0.0, 312.9869], [0.0, 1067.487, 241.3109],
                                   [0, 0, 1.0]])),
    "tless": ((720, 540), np.array([[1075.65091572, 0.0, 360.0], [0.0, 1073.90347929, 270.0],
                                    [0, 0, 1.0]])),
}

# H100 SXM data-sheet peaks for the bounds (at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"bf16": 989e12, "f32": 67e12}

# Tolerances of the kernel-vs-twin comparisons (bf16 on the card).
BLOCK_REL_L2 = 1e-2  # per layer, relative L2 of the block output
# Per layer, relative L2 of the residual branches alone (out - x): the
# unchanged x dominates the output's norm at layer scale 0.1 and would hide
# a wrong attention or MLP branch.
BRANCH_REL_L2 = 1e-2
FMAP_COS_MEDIAN, FMAP_COS_MIN = 0.999, 0.99  # per-token cosine after all layers
# Phase 19 (31 layers of width 4,096): the kernel chain's and the bf16
# twin chain's feature maps are each compared with the f32 chain's; the
# kernel's 1 - cosine (median, and at the worst token) may be at most this
# multiple of the twin's, so the kernel rounds no worse than bf16 at the
# twin's rounding points.
FMAP_F32_RATIO = 2.0
BUDDIES_Q2O_AGREE = 0.99  # share of valid queries with equal q2o
BUDDIES_CD_ATOL = 1e-4
# Attention kernel vs twin, relative L2: f32 differs in summation order
# and divides by the sum after the value product (the same rounding-order
# change, since the f32 weights are never cast); bf16 casts p / sum before
# the value product as the twin does, so only a weight whose f32 value
# differs near a rounding boundary can round to another bf16.
ATTN_REL_L2 = {"f32": 1e-5, "bf16": 1e-3}
PROBE_BF16_REL_L2 = 1e-5  # int8 must be exact
# Phase 8, card against CPU under lmo_refine.json: the refined poses differ
# by the f32 rounding of the normal equations (summed in another order on
# the card), carried through 8 LM steps; measured 2.4e-7 in R and 6e-8 m in
# t on an H100 80GB HBM3 (700 W). A step accepted on one side and not the
# other would differ by far more than these bounds.
REFINE_WORLD_R_ATOL, REFINE_WORLD_T_ATOL = 1e-4, 1e-5

# Phases 3 and 5 warm up as the bench does (benchmarks/bench.settle: windows
# of requests until two window medians in a row agree; the first requests
# of a process run slower), then time TIMED_REQUESTS requests.
TIMED_REQUESTS = 30

# Phase 9's split: LM-O's objects 1 (ape) and 5 (can) with their diameters
# in mm (BOP LM-O models_info.json), CLI_DETS detections of each in each of
# CLI_IMAGES images.
CLI_LIDS = (1, 5)
LMO_DIAMETERS = {1: 102.09865663, 5: 201.40358597}
CLI_IMAGES, CLI_DETS = 12, 8
# Phases 4 and 8's structured worlds (cross_parity.make_world's sizes):
# tests/test_pipeline.py's, with as many visual words as points, and
# tests/test_cross_parity.py's featuremetric world.
PHASE4_WORLD = dict(num_templates=8, pts_per_template=64, feat_dim=32, num_words=200,
                    n_points=200)
PHASE8_WORLD = dict(num_templates=24, pts_per_template=120, feat_dim=48, num_words=256,
                    n_points=800)
# The shares of the other crops' cells in each template of the card-vs-CPU
# world (crop_world_repre's `mix`).
CMP_MIX = (0.9, 0.5, 0.1)

# Phase 10: the builder's configs; leg (a)'s object is LM-O object 1 as a
# subdivided icosahedron (20 * 4**BUILD_SUBDIV faces) of its diameter,
# seen at four template views: views BUILD_VIEWS of the 57-view sphere at
# in-plane steps BUILD_STEPS (of 14). With random weights a crop between
# template views may match too few cells to solve (one of four did not on
# one card); at a template view each solve has a template to match. Leg
# (b) is the world of tests/test_integration.py with a ViT whose heads
# are 64 wide (the attention kernel's width) at 2 blocks.
GT_CONFIG = os.path.join(ROOT, "configs", "gen_templates", "lmo.json")
GR_CONFIG = os.path.join(ROOT, "configs", "gen_repre", "lmo.json")
BUILD_LID, BUILD_SUBDIV = 1, 4
BUILD_VIEWS, BUILD_STEPS = (5, 17, 30, 44), (0, 2, 5, 9)
SMALL_EXTRACTOR = "dinov2_version=vits14-reg_stride=14_facet=token_layer=1_norm=1"
SMALL_VIT = {"embed_dim": 128, "depth": 2, "num_heads": 2, "pos_grid": 10}
# Leg (b), card against CPU: registration features (f32; cuBLAS and the
# attention kernel against MKL and the twin) by relative L2; vertices in mm;
# the PCA projectors (cuSOLVER against LAPACK, signs free) by the relative
# L2 of their reconstructions; the tf-idf descriptors from the same init.
BUILD_FEAT_REL_L2, BUILD_VERT_ATOL, BUILD_PCA_REL_L2, BUILD_DESC_ATOL = 1e-4, 1e-3, 1e-3, 1e-4

KERNEL_SOURCES = {
    "vit_block": ("foundpose_torch/csrc/vit_block.cu", "foundpose_tpu/ops/vit_block.py:126"),
    "buddies": ("foundpose_torch/csrc/buddies.cu", "foundpose_tpu/ops/buddies_kernel.py:46"),
    "ransac_score": ("foundpose_torch/csrc/score.cu", "foundpose_tpu/pose/pnp.py:35"),
    "attention": ("foundpose_torch/csrc/attention.cu", "foundpose_tpu/ops/attention.py:31"),
    "micro_mm": ("foundpose_torch/csrc/micro_mm.cu", "benchmarks/micro_int8.py:58"),
    "refine": ("foundpose_torch/csrc/refine.cu",
               "none: foundpose_tpu/pose/pnp.py:554 lo_refine and :623 refine_pose_lm run "
               "under XLA"),
    "ransac_dlt": ("foundpose_torch/csrc/hypotheses.cu",
                   "none: foundpose_tpu/pose/pnp.py:456 ransac_pnp's sampling and :242 "
                   "_dlt_pose_many run under XLA"),
}


def log(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def reset_counts():
    from foundpose_torch.benchmarks.bench import kernel_counters

    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    """Every kernel's launch count, by kernel name."""
    from foundpose_torch.benchmarks.bench import kernel_counters

    return {name: fn.launches for name, fn in kernel_counters().items()}


def bound(flops, nbytes, peak):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of bytes over the memory rate and operations over `peak`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOP_PER_S[peak]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_ms(torch, fn, reps=20, warm=3):
    """Mean milliseconds per call of `fn` by CUDA events, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def check_launches(launches, expect, what):
    """Launches from zero (read_counts) must be `expect`, kernel name ->
    count, and 0 for every kernel it does not name."""
    want = {name: expect.get(name, 0) for name in launches}
    check(launches == want, f"{what} launched {launches}, expected {want}")


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    info = {
        "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    log(0, f"card {info['kind']!r} x{info['count']} | nvidia-smi: {smi} | torch "
           f"{info['torch']} cuda {info['cuda']} | TF32 off (matmul and cuDNN)")
    return info


def phase_build():
    from foundpose_torch import _kernels

    _kernels.library()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "build_log.txt"), "w") as f:
        f.write(_kernels.build_log)
    usage = [ln.strip() for ln in _kernels.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(1, f"built in {_kernels.build_seconds:.2f} s; ptxas: " + " | ".join(usage[:12]))
    return {"build_seconds": _kernels.build_seconds, "ptxas": usage}


def phase_kernels(torch, model, vit_cfg, repre, config, device):
    from foundpose_torch.benchmarks import bench
    from foundpose_torch.models import dinov2
    from foundpose_torch.ops import sampling
    from foundpose_torch.pipeline.inference import (inference_config_from_opts, pose_from_crops,
                                                    preprocess_crops)

    gen = torch.Generator(device=device).manual_seed(11)
    b = 16
    result = {}
    bf16 = torch.bfloat16

    # --- ViT block: real activations of random crops through all layers.
    crops = torch.rand(b, 420, 420, 3, generator=gen, device=device)
    x0, _ = dinov2.embed_tokens(model, preprocess_crops(crops, config))
    result["vit_block"] = block_vs_twin(torch, model, vit_cfg, x0, 2)

    # --- Buddies: queries drawn from a retrieved template's bank plus noise.
    tn, q = config.top_n_templates, 900
    tids = torch.randint(0, repre.num_templates, (b, tn), generator=gen, device=device)
    sel_feats = repre.bank_feats[tids].to(bf16).contiguous()
    sel_mask = repre.bank_mask[tids]
    f = sel_feats.shape[2]
    rows = torch.randint(0, f, (b, q), generator=gen, device=device)
    qf = sel_feats[:, 0].float().gather(1, rows[..., None].expand(b, q, sel_feats.shape[3]))
    qf = (qf + 0.3 * torch.randn(qf.shape, generator=gen, device=device)).to(bf16)
    grid = sampling.grid_points(config.crop_size, config.grid_cell_size, device=device)
    qmask = sampling.points_in_mask(grid, bench.crop_masks(gen, b, device))
    result["buddies"] = buddies_vs_twin(torch, qf, qmask, grid, sel_feats, sel_mask, 2)

    # --- RANSAC scorer at both configurations' hypothesis counts.
    with open(LMO_EXACT_CONFIG) as f:
        exact_iter = inference_config_from_opts(json.load(f)).pnp_ransac_iter
    result["ransac_score"] = {
        **scorer_vs_twin(torch, b * tn, config.top_k_buddies, config.pnp_ransac_iter),
        "lmo_exact": scorer_vs_twin(torch, b * tn, config.top_k_buddies, exact_iter),
    }
    result["attention"] = attention_vs_twin(torch, model, vit_cfg, crops)
    result["micro_mm"] = probe_vs_twin(torch, device)

    # --- LO/LM refinement and RANSAC's hypotheses: the winners of a
    # lmo.json request of 16 crops and of a batch of 128 (an offline
    # step's), each crop's best of its top-5 sets of 300 correspondences,
    # and the samples and minimal solves of all those sets, on a world whose
    # first templates are those crops, so that the winners pose (with random
    # crops and the synthetic world, a winner has 2-4 inliers and no pose to
    # compare).
    refine, dlt = {}, {}
    for n_crops in (b, 128):
        crops, masks, cams = main_path_inputs(torch, device, n_crops)
        world = batch_world_repre(
            torch, model, config, ((crops[i : i + b], masks[i : i + b], cams.index(slice(i, i + b)))
                                   for i in range(0, n_crops, b)), 5, device)
        world = world.cast_banks(config.compute_dtype)
        args = captured_operands(lambda: pose_from_crops(
            model, crops, masks, cams, world, config,
            generator=torch.Generator(device=device).manual_seed(1)))
        refine[n_crops] = refine_check(
            torch, args["refine"], 2, f"(the winners of {n_crops} crops at lmo.json)")
        dlt[n_crops] = dlt_check(
            torch, args["ransac_dlt"], 2, f"(the sets of {n_crops} crops at lmo.json)")
        del world, args
    result["refine"] = dict(refine[b], b128=refine[128])
    result["ransac_dlt"] = dict(dlt[b], b128=dlt[128])
    return result


def block_vs_twin(torch, model, vit_cfg, x0, phase, split=True, rope=None, f32_chain=False):
    """The block kernel against its twin on activations x0 [B, T, D] (bf16)
    carried through the blocks extract_facet runs whole: relative L2 of
    each layer's output and of its residual branches (out - x), the facet's
    feature maps' cosine after all layers, the "column" stabilizer on layer 0; CUDA-event times of
    one capped layer (kernel, twin, and the PyTorch calls of its shapes
    together), its bound from utils/flops, and with `split` its seven
    launches one by one (benchmarks/block_split). `rope` (DINOv3): the
    rotary tables and prefix every layer takes, and the library's calls
    then rotate q and k too (`library_rotation`). With `f32_chain` the
    feature maps of both chains are held to those of the twin's chain in
    f32 instead of to each other (FMAP_F32_RATIO)."""
    from foundpose_torch.benchmarks import block_split
    from foundpose_torch.models import dinov2, dinov3
    from foundpose_torch.ops.vit_block import fused_vit_block, fused_vit_block_plain
    from foundpose_torch.utils import flops

    bf16 = torch.bfloat16
    b, t, d = x0.shape
    kw = dict(seq_len=t, num_heads=vit_cfg.num_heads, head_dim=vit_cfg.head_dim,
              eps=vit_cfg.layer_norm_eps, approx_gelu=vit_cfg.approx_gelu, rope=rope)

    def rel_l2(got, ref):
        return float(torch.linalg.vector_norm((got - ref).float())
                     / torch.linalg.vector_norm(ref.float()))

    xk, xp, rel, branch = x0, x0, [], []
    for blk in list(model.blocks)[: dinov2.facet_depth(vit_cfg)]:
        p = blk.kernel_params(bf16)
        yk = fused_vit_block(xk, p, softmax_stabilizer=vit_cfg.softmax_stabilizer, **kw)
        ytwin = fused_vit_block_plain(xk, p, softmax_stabilizer=vit_cfg.softmax_stabilizer, **kw)
        rel.append(rel_l2(yk, ytwin))
        branch.append(rel_l2(yk.float() - xk.float(), ytwin.float() - xk.float()))
        xp = fused_vit_block_plain(xp, p, softmax_stabilizer=vit_cfg.softmax_stabilizer, **kw)
        if len(rel) == 1:
            block_err = float((yk.float() - ytwin.float()).abs().max())
        xk = yk

    side = int(round((t - 1 - vit_cfg.num_register_tokens) ** 0.5))

    def fmap(x):  # the facet's feature map (a q/k/v facet adds its layer's plain qkv)
        tokens = (dinov2.facet_tokens(model, x) if rope is None
                  else dinov3.facet_tokens(model, x, rope))
        return dinov2.facet_outputs(model, tokens, (side, side))["feature_maps"].flatten(
            1, 2).float()

    def cosines(a, b):
        c = torch.nn.functional.cosine_similarity(fmap(a), fmap(b), dim=-1).flatten()
        return float(c.median()), float(c.min())

    cos_med, cos_min = cosines(xk, xp)
    to_f32 = None
    if f32_chain:
        xf = x0.float()
        for blk in list(model.blocks)[: dinov2.facet_depth(vit_cfg)]:
            xf = fused_vit_block_plain(xf, blk.kernel_params(torch.float32),
                                       softmax_stabilizer=vit_cfg.softmax_stabilizer, **kw)
        to_f32 = dict(kernel=cosines(xk, xf), twin=cosines(xp, xf))
        del xf
    p0 = model.blocks[0].kernel_params(bf16)
    col_k = fused_vit_block(x0, p0, softmax_stabilizer="column", **kw)
    col_p = fused_vit_block_plain(x0, p0, softmax_stabilizer="column", **kw)
    col_rel = rel_l2(col_k, col_p)
    col_branch = rel_l2(col_k.float() - x0.float(), col_p.float() - x0.float())
    ms_k = cuda_ms(torch, lambda: fused_vit_block(x0, p0, softmax_stabilizer="capped", **kw))
    ms_p = cuda_ms(torch, lambda: fused_vit_block_plain(x0, p0, softmax_stabilizer="capped", **kw))
    calls = [block_split.library_composite(x0, p0, vit_cfg.num_heads, vit_cfg.head_dim)]
    if rope is not None:
        calls.append(library_rotation(torch, x0, rope, vit_cfg.num_heads, vit_cfg.head_dim))
    ms_lib = cuda_ms(torch, lambda: [call() for call in calls])
    block_flops = b * flops.vit_layer_flops(vit_cfg, t)
    bms, by = bound(block_flops, 2 * nbytes(x0) + nbytes(*p0.values()), "bf16")
    res = dict(
        shape=list(x0.shape), mlp="swiglu" if vit_cfg.swiglu else "gelu",
        rel_l2_per_layer=rel, branch_rel_l2_per_layer=branch,
        column_rel_l2=col_rel, column_branch_rel_l2=col_branch,
        fmap_cos_median=cos_med, fmap_cos_min=cos_min, fmap_cos_to_f32=to_f32,
        max_abs_err=block_err,
        ms=ms_k, plain_ms=ms_p, bound_ms=bms, bound_by=by, library_ms=None,
        library_composite_ms=ms_lib, gflop=block_flops / 1e9,
    )
    log(phase, f"vit_block x{list(x0.shape)} bf16 ({res['mlp']} MLP, {len(rel)} layers): rel L2/"
               f"layer max {max(rel):.2e} (tol {BLOCK_REL_L2}), branches (out - x) max "
               f"{max(branch):.2e} (tol {BRANCH_REL_L2}), column {col_rel:.2e} / branches "
               f"{col_branch:.2e}, fmap cos median {cos_med:.6f} min {cos_min:.6f} ("
               + ("gated against the f32 chain" if f32_chain
                  else f"tol {FMAP_COS_MEDIAN}/{FMAP_COS_MIN}")
               + f"); kernel {ms_k:.3f} ms vs twin {ms_p:.3f} ms "
               f"vs the PyTorch calls of its shapes together (F.linear x4, SDPA"
               f"{', F.silu(a) * b' if vit_cfg.swiglu else ''}"
               f"{', the rotation of q and k' if rope is not None else ''}) {ms_lib:.3f} ms per "
               f"layer; bound "
               f"{bms:.4f} ms ({by}, {block_flops / 1e9:.1f} GFLOP), {100 * bms / ms_k:.1f}%")
    check(max(rel) <= BLOCK_REL_L2 and col_rel <= BLOCK_REL_L2, f"block rel L2 {rel} {col_rel}")
    check(max(branch) <= BRANCH_REL_L2 and col_branch <= BRANCH_REL_L2,
          f"block branch rel L2 {branch} {col_branch}")
    if to_f32 is None:
        check(cos_med >= FMAP_COS_MEDIAN and cos_min >= FMAP_COS_MIN,
              f"fmap cosine {cos_med} {cos_min}")
    else:
        (k_med, k_min), (t_med, t_min) = to_f32["kernel"], to_f32["twin"]
        log(phase, f"fmap cosine to the f32 chain: kernel median {k_med:.6f} min {k_min:.6f}, "
                   f"twin median {t_med:.6f} min {t_min:.6f} (the kernel's 1 - cosine at most "
                   f"{FMAP_F32_RATIO}x the twin's)")
        check(1 - k_med <= FMAP_F32_RATIO * (1 - t_med)
              and 1 - k_min <= FMAP_F32_RATIO * (1 - t_min), f"fmap cosine to f32 {to_f32}")
    if not split:
        return res
    # The seven launches of one capped layer, and the PyTorch calls of the
    # same shapes as yardsticks (the port never calls them).
    # A split torch.profiler could not see whole is not measured; the
    # kernel's checks above and the launch counts do not depend on it.
    try:
        split = block_split.launch_split(fused_vit_block, x0, p0, softmax_stabilizer="capped",
                                         **kw)
        shown = ", ".join(f"{r['launch']} {r['ms']:.4f}" for r in split)
    except block_split.ProfilerLostKernels as e:
        split = dict(not_measured="torch.profiler lost device kernels on every try",
                     kernels_seen=e.seen, kernels_launched=e.want)
        shown = f"not measured (torch.profiler kept {e.seen} of {e.want} kernels on every try)"
    yard = block_split.yardsticks(x0, p0, vit_cfg.num_heads, vit_cfg.head_dim)
    res.update(split=split, yardsticks_ms=yard)
    log(phase, "vit_block launches (device ms, torch.profiler, mean of 5 calls): " + shown
               + "; yardsticks ms: " + ", ".join(f"{k} {v:.4f}" for k, v in yard.items()))
    return res


def buddies_vs_twin(torch, qf, qmask, grid, sel_feats, sel_mask, phase):
    """The buddies kernel against its twin on the operands of
    cycle_distances: q2o must agree on BUDDIES_Q2O_AGREE of the valid
    queries, and the cycle distances within BUDDIES_CD_ATOL where it does
    (bit-equal where masked); CUDA-event times and the bound of the
    distances this data needs."""
    from foundpose_torch.ops.buddies_kernel import cycle_distances, cycle_distances_plain

    cd_k, q2o_k = cycle_distances(qf, qmask, grid, sel_feats, sel_mask)
    cd_p, q2o_p = cycle_distances_plain(qf, qmask, grid, sel_feats, sel_mask)
    valid = qmask[:, None, :].expand_as(cd_k)
    same = (q2o_k == q2o_p) & valid
    q2o_agree = float(same.sum() / valid.sum())
    dcd = (cd_k - cd_p).abs()
    cd_agree = float(((dcd <= BUDDIES_CD_ATOL) & same).sum() / same.sum())
    masked_ok = bool((cd_k[~valid] == cd_p[~valid]).all())
    ms_k = cuda_ms(torch, lambda: cycle_distances(qf, qmask, grid, sel_feats, sel_mask))
    ms_p = cuda_ms(torch, lambda: cycle_distances_plain(qf, qmask, grid, sel_feats, sel_mask))
    # The distances this run's data needs: valid queries x valid bank rows.
    pairs = float((qmask.sum(-1).float() * sel_mask.sum((1, 2)).float()).sum())
    bms, by = bound(2.0 * sel_feats.shape[3] * pairs,
                    nbytes(qf, qmask, grid, sel_feats, sel_mask, cd_k, q2o_k), "bf16")
    log(phase, f"buddies {list(qf.shape)} x {list(sel_feats.shape)}: {int(qmask.sum())} valid "
               f"queries, q2o agree {q2o_agree:.5f} (tol {BUDDIES_Q2O_AGREE}), cd within "
               f"{BUDDIES_CD_ATOL} where q2o agrees {cd_agree:.5f}, masked entries equal "
               f"{masked_ok}; kernel {ms_k:.3f} ms vs twin {ms_p:.3f} ms; bound {bms:.4f} ms ({by})")
    check(q2o_agree >= BUDDIES_Q2O_AGREE and cd_agree >= BUDDIES_Q2O_AGREE and masked_ok,
          "buddies kernel disagrees with its twin")
    return dict(
        shape=[list(qf.shape), list(sel_feats.shape)], valid_queries=int(qmask.sum()),
        q2o_agree=q2o_agree, cd_agree_where_q2o_agrees=cd_agree,
        max_abs_err=float(dcd[same].max()), ms=ms_k, plain_ms=ms_p,
        bound_ms=bms, bound_by=by, library_ms=None, valid_pairs=pairs,
    )


def scorer_vs_twin(torch, s, n, h):
    """scorer_check on s sets x n points x h hypotheses near the truth
    (foundpose_torch/benchmarks/score_time.py)."""
    from foundpose_torch.benchmarks import score_time

    return scorer_check(torch, score_time.score_operands(s, n, h), score_time.THRESH, 2,
                        "(raw operands)")


def scorer_check(torch, ops, thr, phase, what):
    """The scorer on the raw operands `ops` (a dict of score_hypotheses'
    arguments) at inlier threshold `thr`: counts against the twin's, which
    must be equal bit for bit; the kernel's device time under
    torch.profiler (mean of 20 launches), the CUDA-event time of whole
    wrapper calls and the twin's."""
    from foundpose_torch.benchmarks import block_split, score_time
    from foundpose_torch.pose import pnp

    s, n, h = ops["rs"].shape[0], ops["pts3d"].shape[1], ops["rs"].shape[1]
    cnt_k = pnp.score_hypotheses(**ops, inlier_thresh=thr)
    cnt_p = pnp.score_hypotheses_plain(**ops, inlier_thresh=thr)
    diff = (cnt_k - cnt_p).abs()
    agree = float((diff == 0).float().mean())
    call = lambda: pnp.score_hypotheses(**ops, inlier_thresh=thr)
    try:
        dev_ms = score_time.device_ms(call)
    except block_split.ProfilerLostKernels:
        # Phase 2's time is the kernels line's; a later check's device time
        # is a figure beside its gate, which does not depend on it.
        if phase == 2:
            raise
        dev_ms = "not measured"
    event_ms = cuda_ms(torch, call)
    plain_ms = cuda_ms(torch, lambda: pnp.score_hypotheses_plain(**ops, inlier_thresh=thr))
    # 30 f32 operations a point test (three 4-term dots, the two error
    # terms, both squared norms, the count) for every valid point of every
    # set: a point outside the mask needs no test. The folding is a few
    # more per hypothesis and per point, noise beside it.
    valid_points = float(ops["validf"].sum())
    bms, by = bound(30.0 * valid_points * h, nbytes(*ops.values(), cnt_k), "f32")
    log(phase, f"ransac_score {s} sets x {n} pts x {h} hyps {what}: counts equal "
               f"{agree:.5f} (tol 1.0), max diff {float(diff.max())} (tol 0; mean count "
               f"{float(cnt_p.mean()):.1f}); kernel device {fmt_ms(dev_ms, 4)} ms (torch.profiler, 20 "
               f"launches), wrapper {event_ms:.4f} ms (CUDA events), twin {plain_ms:.3f} ms; "
               f"bound {bms:.5f} ms ({by}, {int(valid_points)} valid points); no single PyTorch "
               "call computes the count")
    check(agree == 1.0 and float(diff.max()) == 0.0, f"scorer disagrees at H {h} {what}")
    return dict(shape=[s, n, h], valid_points=valid_points, agree=agree,
                max_abs_err=float(diff.max()), mean_count=float(cnt_p.mean()), ms=dev_ms,
                event_ms=event_ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)


# The LO/LM kernel against its twin (`refine_check`): counts and inlier
# masks equal in every set; R and t (metres in the main path's worlds)
# within these bounds in the sets the refinement can pose, those with at
# least REFINE_POSED_INLIERS inliers after LO (the sums run in another
# order, and the 12x12 refits of fewer points amplify float32 rounding),
# which must be at least half the sets.
REFINE_R_ATOL, REFINE_T_ATOL = 1e-4, 5e-5
REFINE_POSED_INLIERS = 12
# f32 operations a point on each pass over a set's points: the 40 DLT
# feature sums (two each) and the point's projection, or LM's 28 sums with
# its Jacobian. Passes: the Hartley mean and spread, two for each LO refit
# (its sums, its count), the final inliers with LM's first sums, one for
# each LM step.
REFINE_FLOPS_PER_POINT_PASS = 120


def refine_check(torch, args, phase, what):
    """refine_lo_lm (csrc/refine.cu) against refine_lo_lm_plain on the
    arguments `args` one call received: counts and inlier masks equal in
    every set, R and t within REFINE_R_ATOL and REFINE_T_ATOL in the posed
    sets; the kernel's device time under torch.profiler (mean of 20
    launches), the CUDA-event time of whole wrapper calls and the twin's,
    the device kernels of one twin call, and the bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from foundpose_torch.benchmarks import block_split, score_time
    from foundpose_torch.pose import pnp

    s, n = args["pts2d"].shape[:2]
    lo, lm = args["lo_iters"], args["lm_iters"]
    got = pnp.refine_lo_lm(**args)
    ref = pnp.refine_lo_lm_plain(**args)
    counts_equal = bool(torch.equal(got[3], ref[3]))
    masks_equal = bool(torch.equal(got[2], ref[2]))
    posed = ref[3] >= REFINE_POSED_INLIERS
    r_err = (got[0] - ref[0]).abs().amax((1, 2))
    t_err = (got[1] - ref[1]).abs().amax(1)
    r_max = float(r_err[posed].max()) if bool(posed.any()) else 0.0
    t_max = float(t_err[posed].max()) if bool(posed.any()) else 0.0
    call = lambda: pnp.refine_lo_lm(**args)
    twin = lambda: pnp.refine_lo_lm_plain(**args)
    try:
        dev_ms = score_time.device_ms(call, kernel="refine_kernel")
    except block_split.ProfilerLostKernels:
        if phase == 2:
            raise
        dev_ms = "not measured"
    event_ms = cuda_ms(torch, call)
    plain_ms = cuda_ms(torch, twin, reps=5, warm=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        twin()
        torch.cuda.synchronize()
    twin_kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    passes = (2 + 2 * lo if lo else 0) + 1 + lm
    inputs = [args[k] for k in ("r", "t", "pts2d", "pts3d", "valid", "k_f", "k_c", "inliers",
                                "count")]
    bms, by = bound(REFINE_FLOPS_PER_POINT_PASS * s * n * passes, nbytes(*inputs, *got), "f32")
    log(phase, f"refine {s} sets x {n} pts, LO {lo} LM {lm} {what}: counts equal {counts_equal}, "
               f"masks equal {masks_equal}; {int(posed.sum())} sets with >= "
               f"{REFINE_POSED_INLIERS} inliers (post-LO inliers median "
               f"{float(ref[3].median()):.0f}, max {float(ref[3].max()):.0f}): R max abs "
               f"{r_max:.2e} (tol {REFINE_R_ATOL}), t {t_max:.2e} (tol {REFINE_T_ATOL}); over "
               f"every set R {float(r_err.max()):.2e}, t {float(t_err.max()):.2e}; kernel device "
               f"{fmt_ms(dev_ms, 4)} ms (torch.profiler, 20 launches), wrapper {event_ms:.4f} ms "
               f"(CUDA events), twin {plain_ms:.3f} ms ({twin_kernels} device kernels a call); "
               f"bound {bms:.5f} ms ({by})")
    check(counts_equal and masks_equal and r_max <= REFINE_R_ATOL and t_max <= REFINE_T_ATOL,
          f"refine kernel disagrees with its twin {what}")
    check(int(posed.sum()) >= s // 2, f"refine {what}: fewer than half the sets pose")
    return dict(shape=[s, n], lo_iters=lo, lm_iters=lm, counts_equal=counts_equal,
                masks_equal=masks_equal, posed_sets=int(posed.sum()), max_abs_err=r_max,
                t_max_abs_err=t_max, r_max_abs_err_all_sets=float(r_err.max()),
                t_max_abs_err_all_sets=float(t_err.max()), ms=dev_ms, event_ms=event_ms,
                plain_ms=plain_ms, twin_kernels=twin_kernels, bound_ms=bms, bound_by=by,
                library_ms=None)



# The hypotheses kernel against its twin (`dlt_check`). What RANSAC uses
# of it: kernel 2's counts of the two outputs equal on at least
# DLT_COUNTS_EQUAL of the hypotheses, and the first maximum equal on every
# posed set (its twin's best counts at least half its valid points; the
# other sets match other templates' points, and their best poses are
# rounding noise on both sides). The poses: the minimal DLT solves 12x12
# normal equations in float32, whose smallest pivots sit at the level of
# float32 rounding, so any float32 solve of it loses some samples that the
# float64 twin solves (a non-positive pivot floored at 1e-30 turns the
# inverse iteration elsewhere; on phase 2's operands ~1.5% of them, on
# other hypotheses in the kernel and in the twin); so among the candidates,
# the hypotheses whose pose in the float64 twin counts at least half its
# set's valid points, the kernel must put as large a share within
# DLT_R_ATOL and DLT_T_ATOL (metres) of the float64 twin as the float32
# twin does, less DLT_SOLVED_SLACK.
DLT_R_ATOL, DLT_T_ATOL, DLT_COUNTS_EQUAL, DLT_SOLVED_SLACK = 1e-2, 2e-3, 0.9, 0.01
# f32 operations of one hypothesis: six points' 40 feature sums, the 12x12
# system's build and Cholesky, four inverse-iteration solves, the sign and
# scale, eight Newton polar steps.
DLT_FLOPS_PER_HYPOTHESIS = 3000


def dlt_check(torch, args, phase, what):
    """dlt_hypotheses (csrc/hypotheses.cu) against dlt_hypotheses_plain and
    the twin in float64 on the arguments `args` one call received, by the
    rules above; the kernel's device time under torch.profiler (mean of 20
    launches), the CUDA-event time of whole wrapper calls and the twin's,
    the device kernels of one twin call, and the bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from foundpose_torch.benchmarks import score_time
    from foundpose_torch.pose import pnp

    s, n = args["pts2d"].shape[:2]
    h = args["draws"].shape[1]
    rs, ts = pnp.dlt_hypotheses(**args)
    r32, t32 = pnp.dlt_hypotheses_plain(**args)
    rays = (args["pts2d"].double() - args["k_c"].double()[:, None]) / args["k_f"].double()[:, None]
    r64, t64 = pnp._dlt_pose_many(args["pts3d"].double(), rays, args["valid"].double(),
                                  pnp.sample_counts(args["valid"], args["draws"]).double())

    def err(r, t):
        return (r.double() - r64).abs().amax((-1, -2)), (t.double() - t64).abs().amax(-1)

    vf = args["valid"].float()
    eye = torch.eye(3, dtype=torch.float64, device=r64.device)
    fin64 = torch.isfinite(r64).all(-1).all(-1) & torch.isfinite(t64).all(-1)
    poses = ((rs, ts), (r32, t32), (torch.where(fin64[..., None, None], r64, eye).float(),
                                     torch.where(fin64[..., None], t64, eye[2]).float()))
    counts = [pnp.score_hypotheses(args["pts2d"], args["pts3d"], vf, r, t, args["k_f"],
                                   args["k_c"], 10.0) for r, t in poses]
    agree = float((counts[0] == counts[1]).float().mean())
    best = [c.max(-1).values for c in counts[:2]]
    half = 0.5 * vf.sum(-1, keepdim=True)
    posed = best[1] >= half[:, 0]
    best_equal = bool(torch.equal(best[0][posed], best[1][posed]))
    cand = counts[2] >= half
    (er, et), (er32, et32) = err(rs, ts), err(r32, t32)
    ok = [(e_r <= DLT_R_ATOL) & (e_t <= DLT_T_ATOL) for e_r, e_t in ((er, et), (er32, et32))]
    solved = [float(o[cand].float().mean()) for o in ok]
    both = cand & ok[0] & ok[1]
    r_max = float(er[both].max()) if bool(both.any()) else 0.0
    call = lambda: pnp.dlt_hypotheses(**args)
    twin = lambda: pnp.dlt_hypotheses_plain(**args)
    dev_ms = score_time.device_ms(call, kernel="hypotheses_kernel")
    event_ms = cuda_ms(torch, call)
    plain_ms = cuda_ms(torch, twin, reps=5, warm=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        twin()
        torch.cuda.synchronize()
    twin_kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    inputs = [args[k] for k in ("pts2d", "pts3d", "valid", "k_f", "k_c", "draws")]
    bms, by = bound(DLT_FLOPS_PER_HYPOTHESIS * s * h, nbytes(*inputs, rs, ts), "f32")
    log(phase, f"dlt_hypotheses {s} sets x {n} pts x {h} hyps {what}: kernel 2's counts equal "
               f"{agree:.5f} (tol {DLT_COUNTS_EQUAL}), first maximum equal on the "
               f"{int(posed.sum())} posed sets {best_equal}; of the {int(cand.sum())} candidates "
               f"within {DLT_R_ATOL} (R) and {DLT_T_ATOL} m (t) of the float64 twin: kernel "
               f"{solved[0]:.5f}, float32 twin {solved[1]:.5f} (slack {DLT_SOLVED_SLACK}), R max "
               f"abs {r_max:.2e} where both are; kernel device {fmt_ms(dev_ms, 4)} ms "
               f"(torch.profiler, 20 launches), wrapper {event_ms:.4f} ms (CUDA events), twin "
               f"{plain_ms:.3f} ms ({twin_kernels} device kernels a call); bound {bms:.5f} ms "
               f"({by})")
    check(agree >= DLT_COUNTS_EQUAL and best_equal and solved[0] >= solved[1] - DLT_SOLVED_SLACK,
          f"hypotheses kernel disagrees with its twin {what}")
    return dict(shape=[s, n, h], counts_equal=agree, posed_sets=int(posed.sum()),
                first_max_equal=best_equal, candidates=int(cand.sum()), solved=solved[0],
                twin_solved=solved[1], max_abs_err=r_max, ms=dev_ms, event_ms=event_ms,
                plain_ms=plain_ms, twin_kernels=twin_kernels, bound_ms=bms, bound_by=by,
                library_ms=None)


def attention_vs_twin(torch, model, vit_cfg, crops):
    """The attention kernel on the unfused f32 path's layer-0 q, k, v
    [16, 6, 905, 64] of the same crops, at f32 (the path) and bf16."""
    import torch.nn.functional as F

    from foundpose_torch.models import dinov2
    from foundpose_torch.ops.vit_block import layer_norm

    x, _ = dinov2.embed_tokens(model, dinov2.normalize_images(crops))
    b, t, _ = x.shape
    p = model.blocks[0].kernel_params(torch.float32)
    xn = layer_norm(x, p["norm1_scale"], p["norm1_bias"], vit_cfg.layer_norm_eps)
    qkv = F.linear(xn, p["qkv_weight"], p["qkv_bias"]).reshape(
        b, t, 3, vit_cfg.num_heads, vit_cfg.head_dim).permute(2, 0, 3, 1, 4).contiguous()
    res = {name: attention_pair(torch, *(qkv[i].to(dt).contiguous() for i in range(3)), name, 2)
           for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    return {**res["f32"], "bf16": res["bf16"]}


def attention_pair(torch, q, k, v, name, phase):
    """The attention kernel against its twin on q, k, v [B, H, T, 64] of
    dtype `name` ("f32" or "bf16"): rel. L2 within ATTN_REL_L2, CUDA-event
    times of kernel, twin and scaled_dot_product_attention, the bound."""
    import torch.nn.functional as F

    from foundpose_torch.ops.attention import attention_plain, fused_attention_bhtd

    b, h, t, dh = q.shape
    flops = 4.0 * b * h * t * t * dh
    got = fused_attention_bhtd(q, k, v)
    ref = attention_plain(q, k, v)
    rel = float(torch.linalg.vector_norm((got - ref).float()) / torch.linalg.vector_norm(ref.float()))
    err = float((got.float() - ref.float()).abs().max())
    bms, by = bound(flops, 4 * nbytes(q), name)
    r = dict(
        rel_l2=rel, max_abs_err=err, bound_ms=bms, bound_by=by,
        ms=cuda_ms(torch, lambda: fused_attention_bhtd(q, k, v)),
        plain_ms=cuda_ms(torch, lambda: attention_plain(q, k, v)),
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v)),
        shape=list(q.shape), gflop=flops / 1e9,
    )
    log(phase, f"attention {list(q.shape)} {name}: rel L2 {rel:.2e} (tol {ATTN_REL_L2[name]}), "
               f"max abs {err:.2e}; kernel {r['ms']:.3f} ms vs twin {r['plain_ms']:.3f} ms vs "
               f"scaled_dot_product_attention {r['library_ms']:.3f} ms; bound {bms:.4f} ms ({by})")
    check(rel <= ATTN_REL_L2[name], f"attention {name} {list(q.shape)} rel L2 {rel}")
    return r


def probe_vs_twin(torch, device):
    """Both probe GEMMs at the TPU probe's shapes against their twins:
    int8 -> int32 exact, bf16 -> f32 within PROBE_BF16_REL_L2."""
    from foundpose_torch.benchmarks import micro_int8

    b, t, d, h = micro_int8.SHAPE
    res = {}
    for dt, (a, w) in micro_int8.probe_inputs(device).items():
        int8 = dt == torch.int8
        fn = micro_int8.mm_int8 if int8 else micro_int8.mm_bf16
        got, ref = fn(a, w), micro_int8.mm_plain(a, w)
        err = float((got - ref).abs().max())
        rel = float(torch.linalg.vector_norm((got - ref).float()) / torch.linalg.vector_norm(ref.float()))
        if int8:
            library = lambda: torch._int_mm(a.view(b * t, d), w)
        else:  # f32 output, as the kernel writes
            library = lambda: torch.mm(a.view(b * t, d), w, out_dtype=torch.float32)
        bms, by = micro_int8.bound_ms(b * t, d, h, dt)
        name = "int8" if int8 else "bf16"
        res[name] = dict(
            rel_l2=rel, max_abs_err=err, bound_ms=bms, bound_by=by,
            ms=cuda_ms(torch, lambda: fn(a, w)),
            plain_ms=cuda_ms(torch, lambda: micro_int8.mm_plain(a, w), reps=5),
            library_ms=cuda_ms(torch, library),
        )
        r = res[name]
        log(2, f"probe GEMM {name} [{b}, {t}, {d}] x [{d}, {h}]: max abs err {err:.3g}, rel L2 "
               f"{rel:.2e}; kernel {r['ms']:.4f} ms vs twin {r['plain_ms']:.3f} ms vs "
               f"{'torch._int_mm' if int8 else 'torch.mm (f32 out)'} {r['library_ms']:.4f} ms; "
               f"bound {bms:.4f} ms ({by})")
        del got, ref
    check(res["int8"]["max_abs_err"] == 0.0, "int8 probe GEMM is not exact")
    check(res["bf16"]["rel_l2"] <= PROBE_BF16_REL_L2, f"bf16 probe GEMM rel L2 {res['bf16']['rel_l2']}")
    return {**res["int8"], "shape": [b, t, d, h], "bf16": res["bf16"]}


def main_path_inputs(torch, device, b=16):
    """A request of b random 420 px crops with the bench's masks and
    identity-extrinsics crop cameras (benchmarks/bench.bench_inputs)."""
    from foundpose_torch.benchmarks import bench

    return bench.bench_inputs(b, device)


STAGES = ("vit", "retrieval", "buddies", "solve", "refine")


def stage_split(torch, model, repre, config, crops, masks, cams, gen):
    """Milliseconds of the stages of one request, by CUDA events: the four
    of the coarse step, then, under a refining configuration, the
    featuremetric refinement on its own after the solve without it."""
    from foundpose_torch.models import dinov2
    from foundpose_torch.pipeline import inference

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    images = inference.preprocess_crops(crops, config)
    fm = dinov2.extract_facet(model, images)["feature_maps"].float()
    ev[1].record()
    feats, valid, tids, tsc = inference.retrieve_batch(fm, masks, repre, config)
    ev[2].record()
    cors = inference.match_batch(feats, valid, tids, tsc, repre, config)
    ev[3].record()
    coarse = dataclasses.replace(config, refine_featuremetric=False)
    out = inference.solve_batch(fm, valid, tids, tsc, cors, cams, repre, coarse, generator=gen)
    ev[4].record()
    if config.refine_featuremetric:
        refine_stage(repre, config, fm, cams, out)()
    ev[5].record()
    ev[5].synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(5 if config.refine_featuremetric else 4)]


def refine_stage(repre, config, fm, cams, coarse_out):
    """The featuremetric stage of a request as a call: the winners of the
    coarse step `coarse_out` refined against the feature maps `fm`."""
    from foundpose_torch.ops.pca import pca_transform
    from foundpose_torch.pipeline import inference

    best = coarse_out.best_template
    return lambda: inference.featuremetric_winner(
        coarse_out.R_m2c, coarse_out.t_m2c, cams.f.float(), cams.c.float(), config, fm,
        lambda x: pca_transform(repre.raw_projector, x),
        lambda: (repre.bank_vertices[best], repre.bank_feats[best], repre.bank_mask[best]),
    )


def phase_main_path(torch, model, repre, config, device, phase=3, label="lmo.json",
                    table="profile.txt"):
    """Serves requests until they settle (benchmarks/bench.settle), then
    times TIMED_REQUESTS requests."""
    from foundpose_torch.benchmarks import bench
    from foundpose_torch.pipeline import inference

    b = 16
    crops, masks, cams = main_path_inputs(torch, device, b)
    rgen = torch.Generator(device=device).manual_seed(1)
    outs = None

    def request():
        nonlocal outs
        outs = inference.pose_from_crops(model, crops, masks, cams, repre, config, generator=rgen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    first, warm_medians, settled = bench.settle(request, device)
    lat = [bench.wall_seconds(request, device) for _ in range(TIMED_REQUESTS)]
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()

    for name, v in dataclasses.asdict(outs).items():
        check(v.shape[0] == b, f"{name} has batch {v.shape[0]}")
        check(bool(torch.isfinite(v.float()).all()), f"{name} not finite")
    check(tuple(outs.R_m2w.shape) == (b, 3, 3) and tuple(outs.template_ids.shape)
          == (b, config.top_n_templates), "output shapes")
    check(all(launches[k] > 0 for k in ("vit_block", "buddies", "ransac_score", "refine"))
          and launches["refine"] == launches["ransac_score"] == launches["ransac_dlt"],
          f"kernels not launched: {launches}")

    splits = np.array([stage_split(torch, model, repre, config, crops, masks, cams, rgen)
                       for _ in range(5)])
    stages = dict(zip(STAGES, np.median(splits, axis=0).tolist()))
    q1, med, q3 = (float(v) for v in np.percentile(lat, [25, 50, 75]))
    res = dict(
        batch=b, timed_requests=TIMED_REQUESTS, latency_s=lat, first_request_s=first,
        warmup_window_medians_s=warm_medians, settled=settled,
        latency_q1_s=q1, median_latency_s=med, latency_q3_s=q3, crops_per_s=b / med,
        stage_ms_median_of_5=stages, stage_ms_runs=splits.tolist(), peak_mem_bytes=peak,
        launches=launches, success_rate=float(outs.success.float().mean()),
    )
    log(phase, f"pose_from_crops batch {b} {label}: first request {first:.2f} s, warm-up "
           f"window medians ms " + ", ".join(f"{x * 1e3:.2f}" for x in warm_medians)
           + f" (settled within {bench.WARM_SETTLE:.0%}: {settled}); {TIMED_REQUESTS} timed requests "
           f"ms median "
           f"{med * 1e3:.2f} (quartiles {q1 * 1e3:.2f} / {q3 * 1e3:.2f}, min "
           f"{min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}), {b / med:.1f} crops/s, "
           "stages ms (median of 5) "
           + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
           + f", peak {peak / 2**20:.0f} MiB, launches {launches}")
    res["profile"] = profile_call(torch, lambda: inference.pose_from_crops(
        model, crops, masks, cams, repre, config, generator=rgen), phase, table)
    return res


def profile_call(torch, fn, phase, table_name, what="one request"):
    """torch.profiler over one steady call `fn()` (`what` names it): device
    busy share and the kernels that take the device time (the full table
    goes to OUT_DIR)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # Device-side events only: an aten op's "self device time" repeats the
    # time of the kernels it launched.
    dev_us = [(e.key, e.self_device_time_total, e.count) for e in events
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    dev_us.sort(key=lambda x: -x[1])
    busy_s = sum(x[1] for x in dev_us) / 1e6
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, table_name), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    # The host side of every kernel launch is one runtime launch call.
    launch_calls = sum(e.count for e in events if e.device_type == DeviceType.CPU
                       and e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    res = dict(wall_s=wall, device_busy_s=busy_s, device_busy_share=busy_s / wall,
               device_ops=sum(x[2] for x in dev_us), host_launch_calls=launch_calls,
               top=dev_us[:12])
    log(phase, f"{what} under torch.profiler: wall {wall * 1e3:.1f} ms, device busy "
           f"{busy_s * 1e3:.1f} ms ({100 * busy_s / wall:.1f}%), {res['device_ops']} "
           f"device ops, {launch_calls} host launch calls; top: " + "; ".join(f"{k[:40]} {t / 1e3:.2f} ms x{c}"
                                           for k, t, c in dev_us[:6]))
    return res


def render_query(torch, rng, obj_points, obj_feats, tpl_point_ids, target, r_gt, t_gt):
    """Feature map + mask of a crop seeing template `target` under (r_gt, t_gt)."""
    pts = obj_points[tpl_point_ids[target]]
    feats = obj_feats[tpl_point_ids[target]]
    cam = pts @ r_gt.T + t_gt
    proj = cam[:, :2] / cam[:, 2:3] * 600.0 + 209.5
    fmap = rng.normal(size=(30, 30, obj_feats.shape[1])).astype(np.float32) * 0.05
    mask = np.zeros((420, 420), dtype=np.float32)
    for p, f in zip(proj, feats):
        cx, cy = int(p[0] // 14.0), int(p[1] // 14.0)
        if 0 <= cx < 30 and 0 <= cy < 30:
            fmap[cy, cx] = f
            mask[cy * 14 : (cy + 1) * 14, cx * 14 : (cx + 1) * 14] = 1.0
    return fmap, mask


def phase_world(torch, base_config, device):
    """The structured world under `base_config`'s dtype and top-k path,
    with 3 templates, 60 buddies and 200 hypotheses."""
    from foundpose_torch import geometry
    from foundpose_torch.benchmarks import cross_parity
    from foundpose_torch.pipeline import inference
    from foundpose_torch.structs import PinholeCamera

    rng = np.random.default_rng(0)
    repre, obj_points, obj_feats, tpl_point_ids = cross_parity.make_world(
        rng, device="cpu", **PHASE4_WORLD)
    r_gt = geometry.rodrigues(torch.tensor([0.1, -0.2, 0.15])).numpy()
    t_gt = np.array([0.0, 0.0, 0.5], np.float32)
    targets = [2, 5, 0, 7]
    fm, mk = zip(*(render_query(torch, rng, obj_points, obj_feats, tpl_point_ids, t, r_gt, t_gt)
                   for t in targets))
    b = len(targets)
    config = dataclasses.replace(
        base_config, top_n_templates=3, top_k_buddies=60, pnp_ransac_iter=200
    )
    draws = torch.as_tensor(rng.integers(0, 60, size=(b, 3, 200, 6)))
    cams = PinholeCamera(
        f=torch.full((b, 2), 600.0), c=torch.full((b, 2), 209.5),
        T_world_from_eye=torch.eye(4).expand(b, 4, 4).contiguous(), width=420, height=420,
    )
    repre = repre.cast_banks(config.compute_dtype)
    args = (torch.as_tensor(np.stack(fm)), torch.as_tensor(np.stack(mk)), cams, repre)

    def run(dev):
        moved = [a.to(dev) for a in args]
        out = inference.pose_from_features(*moved, config, draws=draws.to(dev))
        return {k: v.cpu() for k, v in dataclasses.asdict(out).items()}

    gpu, cpu = run(device), run("cpu")
    same_ids = bool((gpu["template_ids"] == cpu["template_ids"]).all())
    same_success = bool((gpu["success"] == cpu["success"]).all())
    dr = float((gpu["R_m2c"] - cpu["R_m2c"]).abs().max())
    dt = float((gpu["t_m2c"] - cpu["t_m2c"]).abs().max())
    rot_err = geometry.rotation_error_deg(gpu["R_m2c"], torch.as_tensor(r_gt)[None]).tolist()
    t_err = (gpu["t_m2c"] - torch.as_tensor(t_gt)).abs().amax(-1).tolist()
    res = dict(
        crops=b, targets=targets, template_ids=gpu["template_ids"].tolist(),
        same_template_ids=same_ids, same_success=same_success,
        success=gpu["success"].tolist(), max_abs_R_gpu_vs_cpu=dr, max_abs_t_gpu_vs_cpu=dt,
        rot_err_deg=rot_err, t_err_max_m=t_err,
    )
    path = (f"{str(config.compute_dtype).split('.')[-1]} + "
            f"{'approx' if config.approx_topk else 'exact'} top-k")
    log(4, f"structured world, {b} crops, {path}: template_ids equal "
           f"{same_ids}, success equal {same_success}, |R| gpu-cpu {dr:.2e}, |t| {dt:.2e}; "
           f"gpu vs truth rot {max(rot_err):.3f} deg (tol 6), t {max(t_err) * 100:.3f} cm "
           f"(tol 2)")
    check(same_ids and same_success, "card and CPU disagree on templates or success")
    check(all(gpu["success"].tolist()), "a crop failed on the card")
    check(max(rot_err) < 6.0 and max(t_err) <= 0.02, "card pose off the ground truth")
    return res


def phase_refine(torch, model, repre, config, device, lmo):
    """The main path at lmo_refine.json (phase 3's requests and checks),
    then the refinement alone on one request's coarse winners: device time
    under torch.profiler, CUDA-event time, and no host sync inside it."""
    import warnings

    from foundpose_torch.models import dinov2
    from foundpose_torch.pipeline import inference

    res = phase_main_path(torch, model, repre, config, device, 7, "lmo_refine.json",
                          "profile_refine.txt")
    crops, masks, cams = main_path_inputs(torch, device)
    fm = dinov2.extract_facet(model, inference.preprocess_crops(crops, config))["feature_maps"].float()
    feats, valid, tids, tsc = inference.retrieve_batch(fm, masks, repre, config)
    cors = inference.match_batch(feats, valid, tids, tsc, repre, config)
    coarse = inference.solve_batch(
        fm, valid, tids, tsc, cors, cams, repre,
        dataclasses.replace(config, refine_featuremetric=False),
        generator=torch.Generator(device=device).manual_seed(1))
    stage = refine_stage(repre, config, fm, cams, coarse)
    r, t = stage()
    check(bool(torch.isfinite(r).all() and torch.isfinite(t).all()), "refined pose not finite")
    moved = int(((r != coarse.R_m2c).flatten(1).any(1) | (t != coarse.t_m2c).any(1)).sum())
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            stage()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # The mode's own notice ("a prototype feature ...") is not a sync.
    syncs = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
    res["refine_stage_ms"] = cuda_ms(torch, stage, reps=10)
    res["refine_stage_profile"] = profile_call(torch, stage, 7, "profile_refine_stage.txt")
    res["refine_host_syncs"] = len(syncs)
    res["refine_crops_moved"] = moved
    p, q = res["profile"], lmo["profile"]
    rp = res["refine_stage_profile"]
    log(7, f"one request lmo_refine.json vs lmo.json (torch.profiler): device busy "
           f"{p['device_busy_s'] * 1e3:.3f} vs {q['device_busy_s'] * 1e3:.3f} ms, device ops "
           f"{p['device_ops']} vs {q['device_ops']}, host launch calls {p['host_launch_calls']} vs "
           f"{q['host_launch_calls']}; refinement alone ({config.featuremetric_iters} LM steps, "
           f"{len(fm)} crops): device {rp['device_busy_s'] * 1e3:.3f} ms, {rp['device_ops']} device "
           f"ops, {rp['host_launch_calls']} host launch calls, {res['refine_stage_ms']:.2f} ms by "
           f"CUDA events; host syncs inside it {len(syncs)} (tol 0); the refinement moved "
           f"{moved} of {len(fm)} coarse winners")
    check(not syncs, f"the refinement synchronised with the host: {syncs[:3]}")
    return res


def phase_world_refine(torch, config, device):
    """lmo_refine.json on the splatted world: 30 crops of a 24-template
    object at random poses, the same draws on the card with refinement on
    and off and on the CPU with it on."""
    from foundpose_torch import geometry
    from foundpose_torch.benchmarks import cross_parity
    from foundpose_torch.eval import bop_ar
    from foundpose_torch.pipeline import inference
    from foundpose_torch.structs import PinholeCamera

    rng = np.random.default_rng(0)
    n_tpl, b = PHASE8_WORLD["num_templates"], 30
    repre, obj_points, obj_feats, tpl_point_ids = cross_parity.make_world(
        rng, device="cpu", **PHASE8_WORLD)
    fm, mk, rs_gt, ts_gt = zip(*(cross_parity.render_query_smooth(
        rng, obj_points, obj_feats, tpl_point_ids, i % n_tpl, 2000 + i) for i in range(b)))
    draws = torch.as_tensor(rng.integers(
        0, config.top_k_buddies, size=(b, config.top_n_templates, config.pnp_ransac_iter, 6)))
    cams = PinholeCamera(
        f=torch.full((b, 2), 600.0), c=torch.full((b, 2), 209.5),
        T_world_from_eye=torch.eye(4).expand(b, 4, 4).contiguous(), width=420, height=420,
    )
    args = (torch.as_tensor(np.stack(fm)), torch.as_tensor(np.stack(mk)), cams,
            repre.cast_banks(config.compute_dtype))

    def run(dev, cfg):
        moved = [a.to(dev) for a in args]
        out = inference.pose_from_features(*moved, cfg, draws=draws.to(dev))
        return {k: v.cpu() for k, v in dataclasses.asdict(out).items()}

    on = run(device, config)
    off = run(device, dataclasses.replace(config, refine_featuremetric=False))
    cpu = run("cpu", config)
    same_ids = bool((on["template_ids"] == cpu["template_ids"]).all())
    same_success = bool((on["success"] == cpu["success"]).all())
    dr = float((on["R_m2c"] - cpu["R_m2c"]).abs().max())
    dt = float((on["t_m2c"] - cpu["t_m2c"]).abs().max())
    r_gt, t_gt = torch.as_tensor(np.stack(rs_gt)), torch.as_tensor(np.stack(ts_gt))
    k = np.array([[600.0, 0, 209.5], [0, 600.0, 209.5], [0, 0, 1]])
    pts = obj_points[:: max(1, len(obj_points) // 400)].astype(np.float64)
    dia = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    gts = [bop_ar.GroundTruth(1, i, 7, rs_gt[i].astype(np.float64), ts_gt[i].astype(np.float64))
           for i in range(b)]
    res = dict(crops=b, templates=n_tpl, same_template_ids=same_ids, same_success=same_success,
               max_abs_R_gpu_vs_cpu=dr, max_abs_t_gpu_vs_cpu=dt)
    for name, out in (("on", on), ("off", off)):
        succ = out["success"]
        rot = geometry.rotation_error_deg(out["R_m2c"], r_gt)[succ]
        terr = torch.linalg.vector_norm(out["t_m2c"] - t_gt, dim=-1)[succ] * 1000.0
        ests = [bop_ar.Estimate(1, i, 7, 1.0, out["R_m2c"][i].double().numpy(),
                                out["t_m2c"][i].double().numpy()) for i in range(b) if succ[i]]
        ar = bop_ar.evaluate_ar(ests, gts, {7: pts}, {7: dia}, {7: [(np.eye(3), np.zeros(3))]},
                                {(1, i): k for i in range(b)}, image_width=420)
        res[name] = dict(successes=int(succ.sum()), median_rot_err_deg=float(rot.median()),
                         median_t_err_mm=float(terr.median()), **ar)
    on_, off_ = res["on"], res["off"]
    log(8, f"splatted world, {b} crops, lmo_refine.json: card vs CPU template ids equal {same_ids}, "
           f"success equal {same_success}, |R| {dr:.2e} (tol {REFINE_WORLD_R_ATOL}), |t| {dt:.2e} "
           f"(tol {REFINE_WORLD_T_ATOL}); on the card, refinement off -> on: successes "
           f"{off_['successes']} -> {on_['successes']}, median rot {off_['median_rot_err_deg']:.3f} -> "
           f"{on_['median_rot_err_deg']:.3f} deg, median t {off_['median_t_err_mm']:.2f} -> "
           f"{on_['median_t_err_mm']:.2f} mm; BOP19 AR (eval.bop_ar, MSSD/MSPD) "
           f"{off_['bop_ar']:.4f} -> {on_['bop_ar']:.4f} (AR_MSSD {off_['ar_mssd']:.4f} -> "
           f"{on_['ar_mssd']:.4f}, AR_MSPD {off_['ar_mspd']:.4f} -> {on_['ar_mspd']:.4f})")
    check(same_ids and same_success, "card and CPU disagree on templates or success")
    check(dr <= REFINE_WORLD_R_ATOL and dt <= REFINE_WORLD_T_ATOL, "card and CPU refined poses differ")
    check(off_["successes"] >= 20, f"only {off_['successes']} coarse successes of {b}")
    check(on_["median_rot_err_deg"] <= off_["median_rot_err_deg"]
          and on_["median_t_err_mm"] <= off_["median_t_err_mm"], "refinement made the poses worse")
    return res


def serving_request(n=16, seed=3):
    """One 480x640 uint8 image and n detection boxes (60-200 px, aspect
    0.7-1.4, inside the image), from a seed."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    boxes = []
    for _ in range(n):
        w = rng.uniform(60, 200)
        h = float(np.clip(w * rng.uniform(0.7, 1.4), 40, 300))
        x = rng.uniform(0, 640 - w)
        y = rng.uniform(0, 480 - h)
        boxes.append(np.array([x, y, x + w, y + h], np.float32))
    return image, boxes


def serving_engine_kw(torch, params):
    """PoseEngine's arguments at lmo_exact.json: the calibrated weights
    written as an official-name .pth into foundpose_torch/_build, the
    configuration and the ViT overrides. Returns (kw, config, vit_cfg)."""
    from foundpose_torch.models import dinov2
    from foundpose_torch.models.weights import state_dict_from_jax_params
    from foundpose_torch.pipeline import inference

    with open(LMO_EXACT_CONFIG) as f:
        opts = json.load(f)
    o = opts["infer_opts"]
    config = inference.inference_config_from_opts(opts)
    vit_cfg = inference.vit_config_from_opts(opts)
    weights = os.path.join(ROOT, "foundpose_torch", "_build", "bench_vits14_reg.pth")
    os.makedirs(os.path.dirname(weights), exist_ok=True)
    torch.save(state_dict_from_jax_params(params, vit_cfg), weights)
    named = dinov2.parse_model_name(o["extractor_name"])
    kw = dict(
        extractor_name=o["extractor_name"], weights_path=weights, config=config,
        batch_size=o["batch_size"], seed=0,
        extractor_overrides={f.name: getattr(vit_cfg, f.name) for f in dataclasses.fields(vit_cfg)
                             if getattr(vit_cfg, f.name) != getattr(named, f.name)},
    )
    return kw, config, vit_cfg


def phase_serving(torch, params, device):
    """PoseEngine at lmo_exact.json on the card (see the module docstring)."""
    from foundpose_torch.benchmarks import bench
    from foundpose_torch.engine import PoseEngine
    from foundpose_torch.pipeline import inference
    from foundpose_torch.synthetic import realistic_repre

    kw, config, vit_cfg = serving_engine_kw(torch, params)
    engine = PoseEngine(**kw, device=device)
    check(not engine.vit_cfg.use_fused_block and config.compute_dtype == torch.float32,
          "lmo_exact.json did not resolve to the unfused f32 path")
    t0 = time.perf_counter()
    repres = {1: realistic_repre(0, device), 2: realistic_repre(1, device)}
    for obj_id, r in repres.items():
        engine.register_object(obj_id, r)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    image, boxes = serving_request()
    n = len(boxes)
    out = None

    def request():
        nonlocal out
        out = engine.estimate(1, image, boxes, LMO_K)  # ends in one device->host fetch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    first, warm_medians, settled = bench.settle(request, device)
    lat = [bench.wall_seconds(request, device) for _ in range(TIMED_REQUESTS)]
    dets = [{"obj_id": 1 + i % 2, "box_xyxy": bx} for i, bx in enumerate(boxes)]
    t0 = time.perf_counter()
    mixed = engine.estimate_mixed(image, dets, LMO_K)
    mixed_s = time.perf_counter() - t0
    requests = 2 + bench.WARM_WINDOW * len(warm_medians) + TIMED_REQUESTS
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for res in (out, mixed):
        check(len(res) == n, f"{len(res)} results for {n} detections")
        check(all(np.isfinite(r["R_m2c"]).all() and np.isfinite(r["t_m2c"]).all() for r in res),
              "non-finite pose")
    per_request = launches["attention"] / requests
    check(launches["attention"] == requests * (vit_cfg.layer + 1),
          f"attention launched {launches['attention']} times in {requests} requests")
    check(launches["vit_block"] == 0 and launches["buddies"] == 0 and launches["ransac_score"] > 0
          and launches["refine"] == launches["ransac_score"] == launches["ransac_dlt"],
          f"launches on the serving path: {launches}")
    q1, med, q3 = (float(v) for v in np.percentile(lat, [25, 50, 75]))
    res = dict(
        config="configs/infer/lmo_exact.json", detections=n, requests=requests,
        repre_setup_s=setup_s, first_request_s=first, warmup_window_medians_s=warm_medians,
        settled=settled, latency_s=lat, latency_q1_s=q1, median_latency_s=med,
        latency_q3_s=q3, detections_per_s=n / med, estimate_mixed_s=mixed_s,
        peak_mem_bytes=peak, launches=launches, attention_launches_per_request=per_request,
        success_rate=float(np.mean([r["success"] for r in out])),
        mixed_success_rate=float(np.mean([r["success"] for r in mixed])),
    )
    log(5, f"PoseEngine lmo_exact.json, {n} boxes on a 480x640 image: first call {first:.2f} s, "
           f"warm-up window medians ms " + ", ".join(f"{x * 1e3:.2f}" for x in warm_medians)
           + f" (settled within {bench.WARM_SETTLE:.0%}: {settled}); {TIMED_REQUESTS} timed estimate() "
           f"ms median {med * 1e3:.2f} (quartiles {q1 * 1e3:.2f} / {q3 * 1e3:.2f}, min "
           f"{min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}), {n / med:.1f} detections/s; "
           f"estimate_mixed() over 2 objects {mixed_s * 1e3:.2f} ms; peak {peak / 2**20:.0f} MiB; "
           f"launches {launches} over {requests} requests")
    res["profile"] = profile_call(torch, lambda: engine.estimate(1, image, boxes, LMO_K), 5,
                                  "profile_serving.txt")
    # Stage split of one request's device work by CUDA events: the warp,
    # then the four stages of the step as in phase 3.
    img, src_cam, cams, _ = engine._prepare_cams(image, boxes, LMO_K)
    dst = cams.index(torch.arange(n)).to(device)
    masks = engine._mask_stack([None] * n, *image.shape[:2])
    res["warp_ms"] = cuda_ms(torch, lambda: engine._warp(img, masks, src_cam, dst), reps=5)
    crops, crop_masks = engine._warp(img, masks, src_cam, dst)
    splits = np.array([stage_split(torch, engine.model, engine._repres[1], config, crops,
                                   crop_masks.float(), dst, engine.generator) for _ in range(5)])
    res["stage_ms_median_of_5"] = dict(zip(STAGES, np.median(splits, axis=0).tolist()))
    log(5, f"stages ms (median of 5): warp {res['warp_ms']:.2f}, "
           + ", ".join(f"{k} {v:.2f}" for k, v in res["stage_ms_median_of_5"].items()))

    # No host sync before the fetch: at lmo_exact.json, then with lmo.json's
    # switches (fused bf16 ViT, approximate top-k) on the same weights.
    fast_vit, fast_config = bench.bench_configs()
    fast = PoseEngine(extractor_name=kw["extractor_name"], weights_path=kw["weights_path"],
                      config=fast_config, batch_size=n, extractor_overrides=bench.FAST_SWITCHES,
                      device=device)
    check(fast.vit_cfg == fast_vit, f"lmo.json's switches resolved to {fast.vit_cfg}")
    fast.register_object(1, repres[1])
    from foundpose_torch.models import dinov2

    res["host_syncs_before_fetch"] = {
        "lmo_exact.json": dispatch_sync_check(
            torch, engine, image, boxes,
            dict(attention=dinov2.facet_depth(vit_cfg), ransac_dlt=1, ransac_score=1, refine=1)),
        "lmo.json switches": dispatch_sync_check(
            torch, fast, image, boxes,
            dict(vit_block=dinov2.facet_depth(fast_vit), buddies=1, ransac_dlt=1, ransac_score=1,
                 refine=1)),
    }
    del fast
    log(5, "one estimate() up to its fetch under the CUDA sync debug mode \"error\": 0 host "
           "syncs at lmo_exact.json and at lmo.json's switches (launches "
           + "; ".join(f"{k}: {v['launches']}" for k, v in res["host_syncs_before_fetch"].items())
           + ")")

    # Same draws for every run below: cuDNN's TF32 switch on and off, then
    # the card against the CPU, template ids captured from the step.
    draws = torch.randint(0, config.top_k_buddies,
                          (engine.batch_size, config.top_n_templates, config.pnp_ransac_iter, 6),
                          generator=torch.Generator().manual_seed(9))
    engine._draws = lambda b: draws
    captured = []
    step = inference.pose_from_crops

    def capture(*args, **kwargs):
        outs = step(*args, **kwargs)
        captured.append(outs.template_ids.cpu())
        return outs

    inference.pose_from_crops = capture
    by_flag = {}
    for flag in (False, True):
        torch.backends.cudnn.allow_tf32 = flag
        by_flag[flag] = engine.estimate(1, image, boxes, LMO_K)
    torch.backends.cudnn.allow_tf32 = False
    same_tf32 = all(
        np.array_equal(a[k], b[k]) for a, b in zip(by_flag[False], by_flag[True])
        for k in ("success", "R_m2c", "t_m2c", "quality", "best_template")
    )
    cpu = PoseEngine(**kw, device="cpu")
    for obj_id, r in repres.items():
        cpu.register_object(obj_id, r)
    cpu._draws = lambda b: draws
    t0 = time.perf_counter()
    on_cpu = cpu.estimate(1, image, boxes, LMO_K)
    cpu_s = time.perf_counter() - t0
    inference.pose_from_crops = step
    gpu_ids, cpu_ids = captured[0], captured[-1]
    same_ids = bool((gpu_ids == cpu_ids).all())
    same_success = [a["success"] for a in by_flag[False]] == [c["success"] for c in on_cpu]
    same_best = [a["best_template"] for a in by_flag[False]] == [c["best_template"] for c in on_cpu]
    both = [(a, c) for a, c in zip(by_flag[False], on_cpu) if a["success"] and c["success"]]
    d_r = max([float(np.abs(a["R_m2c"] - c["R_m2c"]).max()) for a, c in both], default=0.0)
    d_t = max([float(np.abs(a["t_m2c"] - c["t_m2c"]).max()) for a, c in both], default=0.0)
    res.update(tf32_switch_changes_nothing=same_tf32, cpu_request_s=cpu_s,
               same_template_ids=same_ids, same_success=same_success,
               same_best_template=same_best, max_abs_R_gpu_vs_cpu=d_r,
               max_abs_t_gpu_vs_cpu=d_t, successes=sum(a["success"] for a in on_cpu))
    log(5, f"cudnn.allow_tf32 on vs off: results identical {same_tf32}; card vs CPU ({cpu_s:.1f} s "
           f"on the CPU), same draws: template ids equal {same_ids}, success equal "
           f"{same_success}, best template equal {same_best}, {res['successes']} of {n} "
           f"succeeded, |R| {d_r:.2e}, |t| {d_t:.2e} where both succeeded")
    check(same_tf32, "cuDNN's TF32 switch changed the serving results")
    check(same_ids and same_success, "card and CPU disagree on template ids or success")
    return res


def dispatch_sync_check(torch, engine, image, boxes, expect):
    """One estimate() of object 1 up to its device-to-host fetch
    (engine._dispatch) under the CUDA sync debug mode "error", which raises
    at the first host sync; then the fetch, whose rows must be finite. The
    launches from zero must be `expect` (kernel name -> count; 0 for every
    kernel it does not name); they are returned."""
    from foundpose_torch.utils.profiling import no_host_sync

    engine.estimate(1, image, boxes, LMO_K)  # warm
    torch.cuda.synchronize()
    reset_counts()
    with no_host_sync(engine.device):
        _, packed = engine._dispatch(image, boxes, [None] * len(boxes), LMO_K,
                                     engine._object_step(1))
    launches = read_counts()
    rows = np.concatenate([p.cpu().numpy() for _, p in packed])
    check(rows.shape == (len(boxes), 16) and np.isfinite(rows).all(), "dispatched rows")
    check_launches(launches, expect, "one estimate()")
    return dict(host_syncs=0, launches=launches)  # a sync would have raised


def rle_counts(mask):
    """COCO uncompressed RLE counts of a bool mask (column-major runs,
    starting with zeros)."""
    flat = mask.T.ravel().astype(np.int8)
    bounds = np.concatenate([[0], np.flatnonzero(np.diff(flat)) + 1, [flat.size]])
    counts = np.diff(bounds).tolist()
    return [0] + counts if flat[0] else counts


def write_split(torch, root, seed=0, n_images=CLI_IMAGES, dataset="lmo", lids=CLI_LIDS,
                dets=CLI_DETS, det_path=None):
    """A synthetic BOP split of `dataset` under `root`/bop: one test scene
    of n_images PNGs of that dataset's test images' size and camera kind
    (DATASET_CAMERAS) in its test split's directory (data/bop.TEST_SPLITS),
    objects `lids` with an octahedron PLY each (LM-O's diameters for lmo),
    and per object per image `dets` GT instances and CNOS detections (box,
    rectangular mask, score). Returns the detections file's path
    (`det_path`, or root/detections.json)."""
    from PIL import Image

    from foundpose_torch.data import bop
    from foundpose_torch.data.ply import Mesh, save_ply
    from foundpose_torch.geometry import rodrigues

    rng = np.random.default_rng(seed)
    (width, height), cam_k = DATASET_CAMERAS[dataset]
    scene = os.path.join(bop.split_dir(os.path.join(root, "bop"), dataset), "000001")
    models = os.path.join(root, "bop", dataset, "models")
    os.makedirs(os.path.join(scene, "rgb"))
    os.makedirs(models)
    diameters = {lid: LMO_DIAMETERS[lid] if dataset == "lmo" else 100.0 + 4.0 * lid
                 for lid in lids}
    cams, gts, infos, all_dets = {}, {}, {}, []
    for im_id in range(n_images):
        Image.fromarray(rng.integers(0, 256, (height, width, 3), dtype=np.uint8)).save(
            os.path.join(scene, "rgb", f"{im_id:06d}.png"))
        cams[str(im_id)] = {"cam_K": cam_k.flatten().tolist(), "depth_scale": 1.0}
        gts[str(im_id)], infos[str(im_id)] = [], []
        for lid in lids:
            for _ in range(dets):
                w = float(rng.uniform(60, 200))
                h = float(np.clip(w * rng.uniform(0.7, 1.4), 40, 300))
                x, y = float(rng.uniform(0, width - w)), float(rng.uniform(0, height - h))
                mask = np.zeros((height, width), bool)
                mask[int(y + 0.1 * h) : int(y + 0.9 * h), int(x + 0.1 * w) : int(x + 0.9 * w)] = True
                all_dets.append({"scene_id": 1, "image_id": im_id, "category_id": lid,
                                 "score": float(rng.uniform(0.3, 1.0)), "bbox": [x, y, w, h],
                                 "time": 0.05, "segmentation": {"counts": rle_counts(mask),
                                                                "size": [height, width]}})
                r = rodrigues(torch.as_tensor(rng.uniform(-1.0, 1.0, 3), dtype=torch.float32))
                gts[str(im_id)].append({"obj_id": lid, "cam_R_m2c": r.flatten().tolist(),
                                        "cam_t_m2c": rng.uniform([-100, -100, 600],
                                                                 [100, 100, 1000]).tolist()})
                infos[str(im_id)].append({"bbox_obj": [x, y, w, h], "bbox_visib": [x, y, w, h],
                                          "visib_fract": 1.0})
    for name, data in (("scene_camera.json", cams), ("scene_gt.json", gts),
                       ("scene_gt_info.json", infos)):
        with open(os.path.join(scene, name), "w") as f:
            json.dump(data, f)
    octa = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                    np.float32)
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5],
                      [3, 1, 5], [0, 3, 5]], np.int32)
    for lid in lids:
        save_ply(os.path.join(models, f"obj_{lid:06d}.ply"),
                 Mesh(vertices=octa * (diameters[lid] / 2), faces=faces))
    with open(os.path.join(models, "models_info.json"), "w") as f:
        json.dump({str(lid): {"diameter": diameters[lid]} for lid in lids}, f)
    det_path = det_path or os.path.join(root, "detections.json")
    os.makedirs(os.path.dirname(det_path), exist_ok=True)
    with open(det_path, "w") as f:
        json.dump(all_dets, f)
    return det_path


def object_crops(opts, lid, image_keys):
    """The pending crops of object `lid`'s detections in `image_keys`,
    through the CLI's own host path (decode, detection selection, crop
    cameras, warp on opts.device)."""
    from foundpose_torch.data import bop, detections as det_mod
    from foundpose_torch.eval.evaluator import EvaluatorPose
    from foundpose_torch.ops.warp import make_single_image_warp
    from foundpose_torch.pipeline import infer

    all_dets = det_mod.load_detections(opts.detections_path)
    warp = make_single_image_warp(opts.crop_size)
    out = []
    for scene_id, im_id in image_keys:
        sample = bop.prepare_sample(opts.bop_root, opts.object_dataset, scene_id, im_id,
                                    crop_size=opts.dataset_crop_size)
        dets = infer._detections_for(opts, sample, lid, all_dets[(scene_id, im_id, lid)],
                                     EvaluatorPose([lid]))
        out += infer.prepare_instance_crops(sample, dets, opts, warp)
    return out


def crop_world_repre(torch, model, config, pendings, seed, device, num_templates=798, mix=(),
                     knn_k=None):
    """batch_world_repre over the pending crops (pipeline/infer's), 16 a
    batch."""
    from foundpose_torch.pipeline import infer

    batches = (infer.stack_batch(pendings[s : s + 16], device) for s in range(0, len(pendings), 16))
    return batch_world_repre(torch, model, config, batches, seed, device, num_templates, mix, knn_k)


def batch_world_repre(torch, model, config, batches, seed, device, num_templates=798, mix=(),
                      knn_k=None):
    """`synthetic.realistic_repre(seed, num_templates=...)` (LM-O scale by
    default) whose first templates are the crops of `batches`, an iterable
    of (crops, masks, crop cameras), in order: each
    crop's PCA-projected ViT features at the grid cells on its mask,
    lifted to 3D in its crop camera at depths 0.4-0.6, with the visual
    words drawn from those features (all of them where the codebook has
    room) and the tf-idf descriptors recomputed.
    Those crops then retrieve their own template first and their poses can
    succeed. With mix = (f1, f2, ...), template k also holds the first
    share f_i of crop (k + i) mod n's cells, which spaces every crop's
    retrieval scores apart: own template, then crops k - 1, k - 2, ...;
    knn_k, when given, replaces the tf-idf word votes per feature (1: each
    feature votes for its own word only)."""
    from foundpose_torch.models import dinov2
    from foundpose_torch.ops import sampling, tfidf
    from foundpose_torch.ops.pca import pca_transform
    from foundpose_torch.pipeline import inference
    from foundpose_torch.synthetic import realistic_repre

    base = realistic_repre(seed, device, num_templates=num_templates,
                           raw_dim=model.cfg.embed_dim)
    g = torch.Generator(device=device).manual_seed(seed + 100)
    t, fmax, d = base.bank_feats.shape
    pts = sampling.grid_points(config.crop_size, config.grid_cell_size, device=device)
    cells = []  # (features [m, d], vertices [m, 3]) of each crop's cells on its mask
    for crops, masks, cams in batches:
        b = crops.shape[0]
        fm = dinov2.extract_facet(model, inference.preprocess_crops(crops, config))[
            "feature_maps"].float()
        feats = pca_transform(base.raw_projector,
                              sampling.sample_grid_features(fm, pts, config.crop_size,
                                                            config.grid_cell_size))
        valid = sampling.points_in_mask(pts, masks.float())
        rays = torch.cat([(pts - cams.c[:, None]) / cams.f[:, None],
                          torch.ones_like(pts[..., :1]).expand(b, -1, 1)], dim=-1)
        depth = 0.4 + 0.2 * torch.rand(b, pts.shape[0], 1, generator=g, device=device)
        cells += [(feats[i, valid[i]], (rays[i] * depth[i])[valid[i]]) for i in range(b)]
    bank_feats, bank_verts = base.bank_feats.clone(), base.bank_vertices.clone()
    bank_mask = base.bank_mask.clone()
    n = len(cells)
    for k in range(n):
        parts = [cells[k]] + [
            tuple(a[: int(frac * len(a))] for a in cells[(k + i + 1) % n])
            for i, frac in enumerate(mix)]
        f = torch.cat([p[0] for p in parts])[:fmax]
        v = torch.cat([p[1] for p in parts])[:fmax]
        bank_mask[k] = False
        bank_mask[k, : len(f)] = True
        bank_feats[k, : len(f)] = f
        bank_verts[k, : len(f)] = v
    flat_mask = bank_mask.reshape(-1)
    crop_feats = torch.cat([c[0] for c in cells])
    pick = torch.randperm(len(crop_feats), generator=g, device=device)[: len(base.word_centroids)]
    words = base.word_centroids.clone()
    words[: len(pick)] = crop_feats[pick] + 0.01 * torch.randn(len(pick), d, generator=g,
                                                               device=device)
    flat_ids = torch.arange(t, device=device).repeat_interleave(fmax)
    cfg = base.tfidf_config if knn_k is None else base.tfidf_config._replace(knn_k=knn_k)
    descs, idfs = tfidf.calc_template_tfidf_descriptors(
        bank_feats.reshape(-1, d), flat_ids, words, t, cfg, feature_mask=flat_mask)
    return dataclasses.replace(
        base, tfidf_config=cfg, vertices=bank_verts.reshape(-1, 3), feat_vectors=bank_feats.reshape(-1, d),
        feat_mask=flat_mask, word_centroids=words, word_idfs=idfs, template_descs=descs,
        bank_feats=bank_feats, bank_vertices=bank_verts, bank_mask=bank_mask)


class CapturedRuns:
    """Wraps pipeline.infer.finalize_object_results while active: records
    each object's (instance, result) pairs and the wall of each finalize."""

    def __init__(self):
        from foundpose_torch.pipeline import infer

        self.mod, self.results, self.finalize_s = infer, {}, {}

    def __enter__(self):
        orig = self.orig = self.mod.finalize_object_results

        def wrapped(opts, lid, results, *args, **kwargs):
            t0 = time.perf_counter()
            orig(opts, lid, results, *args, **kwargs)
            self.results[lid], self.finalize_s[lid] = results, time.perf_counter() - t0

        self.mod.finalize_object_results = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.finalize_object_results = self.orig


def host_split(captured):
    """Per-instance prep and pipeline seconds the runner recorded (mean
    over all instances), the finalize walls and the success count."""
    pairs = [pr for res in captured.results.values() for pr in res]
    return dict(
        instances=len(pairs), successes=sum(r["success"] for _, r in pairs),
        prep_s_per_instance=float(np.mean([p.times["prep"] for p, _ in pairs])),
        pipeline_s_per_instance=float(np.mean([p.times["pipeline"] for p, _ in pairs])),
        finalize_s={str(k): v for k, v in captured.finalize_s.items()},
    )


def results_card_vs_cpu(gpu, cpu, phase, what):
    """The CLI's per-instance results on the card (`gpu`) against the CPU's
    with the same draws: template ids, best template and success equal,
    R within REFINE_WORLD_R_ATOL and t within REFINE_WORLD_T_ATOL m where
    both solved (at least one must); logged and checked."""
    same_ids = all(np.array_equal(a["template_ids"], b["template_ids"]) for a, b in zip(gpu, cpu))
    same_best = [a["best_template"] for a in gpu] == [b["best_template"] for b in cpu]
    same_success = [a["success"] for a in gpu] == [b["success"] for b in cpu]
    both = [(a, b) for a, b in zip(gpu, cpu) if a["success"] and b["success"]]
    d_r = max([float(np.abs(a["R_m2c"] - b["R_m2c"]).max()) for a, b in both], default=0.0)
    d_t = max([float(np.abs(a["t_m2c"] - b["t_m2c"]).max()) for a, b in both], default=0.0)
    log(phase, f"card vs CPU, {what}: template ids equal {same_ids}, best template equal "
               f"{same_best}, success equal {same_success}, {len(both)} succeeded on both, |R| "
               f"{d_r:.2e} (tol {REFINE_WORLD_R_ATOL}), |t| {d_t:.2e} m (tol "
               f"{REFINE_WORLD_T_ATOL})")
    check(len(gpu) == len(cpu) == 4, "card vs CPU instance count")
    check(same_ids and same_best and same_success,
          "card and CPU disagree on template ids, best template or success")
    check(both and d_r <= REFINE_WORLD_R_ATOL and d_t <= REFINE_WORLD_T_ATOL,
          "card and CPU poses differ (or none succeeded on both)")
    return dict(crops=len(gpu), same_template_ids=same_ids, same_best_template=same_best,
                same_success=same_success, both_succeeded=len(both), max_abs_R=d_r, max_abs_t=d_t)


def phase_cli(torch, params, vit_cfg, device, lmo_median_s):
    """The offline CLI at configs/infer/lmo.json on a synthetic LM-O-like
    split (see the module docstring)."""
    import tempfile
    import warnings

    from foundpose_torch.models.weights import state_dict_from_jax_params
    from foundpose_torch.pipeline import eval_ar, infer, inference
    from foundpose_torch.pipeline import prepare_bop_submission as sub
    from foundpose_torch.repre import load_repre, save_repre
    from foundpose_torch.utils import config as config_util

    res = {}
    with tempfile.TemporaryDirectory(prefix="foundpose_split_") as root:
        t0 = time.perf_counter()
        det_path = write_split(torch, root)
        weights = os.path.join(root, "vits14_reg.pth")
        torch.save(state_dict_from_jax_params(params, vit_cfg), weights)
        out = os.path.join(root, "out")
        opts = config_util.load_opts(infer.InferOpts, [
            "--opts-path", LMO_CONFIG, "--set", f"bop_root={root}/bop",
            "--set", f"repre_dir={root}/repre", "--set", f"detections_path={det_path}",
            "--set", f"output_dir={out}", "--set", f"weights_path={weights}",
            "--set", f"object_lids={list(CLI_LIDS)}", "--set", "dataset_crop_size=[640, 480]",
        ])
        check(opts.device == "cuda" and opts.batch_size == 16, f"options {opts}")
        model, config = infer.load_model(opts, device)
        with open(LMO_CONFIG) as f:
            check(config == inference.inference_config_from_opts(json.load(f)),
                  "the CLI resolved another configuration than lmo.json")
        keys = [(1, i) for i in range(CLI_IMAGES)]
        for seed, lid in enumerate(CLI_LIDS):
            crops = object_crops(opts, lid, keys)
            save_repre(crop_world_repre(torch, model, config, crops, seed, device),
                       os.path.join(root, "repre", "lmo", "v1", str(lid)))
        del crops
        torch.cuda.synchronize()
        res["split_setup_s"] = time.perf_counter() - t0
        n_crops = CLI_IMAGES * CLI_DETS * len(CLI_LIDS)

        # infer over both objects, then infer_multi_object over the same split.
        for name, fn, sub_out in (("infer", infer.infer, out),
                                  ("infer_multi_object", infer.infer_multi_object, out + "_mo")):
            run_opts = dataclasses.replace(opts, output_dir=sub_out)
            reset_counts()
            with CapturedRuns() as cap:
                t0 = time.perf_counter()
                counts = fn(run_opts)
                wall = time.perf_counter() - t0
            launches = read_counts()
            check(counts == {lid: CLI_IMAGES * CLI_DETS for lid in CLI_LIDS}, f"{name} counts {counts}")
            check(all(launches[k] > 0 for k in ("vit_block", "buddies", "ransac_score", "refine")),
                  f"{name}: kernels not launched: {launches}")
            res[name] = dict(wall_s=wall, crops=n_crops, crops_per_s=n_crops / wall,
                             launches=launches, **host_split(cap))
            r = res[name]
            log(9, f"{name} over {len(CLI_LIDS)} objects, {n_crops} crops (batch 16): wall "
                   f"{wall:.2f} s -> {r['crops_per_s']:.1f} crops/s (host clock, whole call: model "
                   f"and repre loads, decode, warp, step, finalize); per instance prep "
                   f"{r['prep_s_per_instance'] * 1e3:.2f} ms, pipeline "
                   f"{r['pipeline_s_per_instance'] * 1e3:.2f} ms; finalize s "
                   + ", ".join(f"{k}: {v:.2f}" for k, v in r["finalize_s"].items())
                   + f"; {r['successes']} of {r['instances']} succeeded; launches {launches}; "
                   f"phase 3 for comparison: 16 / median {16 / lmo_median_s:.1f} crops/s")

        # Output files, the submission and its AR.
        records = 0
        for lid in CLI_LIDS:
            d = os.path.join(out, "lmo", "v1", str(lid))
            for f in ("estimated-poses.json", "metrics.tsv", "metrics-table.tsv"):
                check(os.path.exists(os.path.join(d, f)), f"missing {d}/{f}")
            with open(os.path.join(d, "estimated-poses.json")) as f:
                records += len(json.load(f))
        check(records == res["infer"]["successes"] > 0, f"{records} records for "
              f"{res['infer']['successes']} successes")
        csv = sub.prepare(sub.PrepareBopSubmissionOpts(object_dataset="lmo", results_dir=out))
        with open(csv) as f:
            rows = f.read().strip().split("\n")[1:]
        ar = eval_ar.evaluate(eval_ar.EvalArOpts(object_dataset="lmo", submission_path=csv,
                                                 bop_root=os.path.join(root, "bop")))
        res.update(csv_rows=len(rows), estimate_records=records, ar=ar)
        log(9, f"submission: {len(rows)} CSV rows for {records} successful estimates; eval_ar "
               f"(random weights, synthetic GT: the value means nothing) "
               + ", ".join(f"{k} {v:.4f}" for k, v in ar.items()))
        check(len(rows) == records, "CSV rows differ from the successful estimates")
        check(all(np.isfinite(v) for v in ar.values()), f"AR not finite: {ar}")

        # No host sync inside a dispatch.
        pend = object_crops(opts, CLI_LIDS[0], keys[:2])[:16]
        repre = load_repre(os.path.join(root, "repre", "lmo", "v1", str(CLI_LIDS[0])),
                                 device=device).cast_banks(config.compute_dtype)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fetch = infer.HostFetch(infer.dispatch_batch(model, repre, config, pend, 0, device))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
        check(fetch.wait().R_m2w.shape == (16, 3, 3), "dispatch output shape")
        res["dispatch_host_syncs"] = len(syncs)
        log(9, f"one dispatch (stack, pinned copies, pose_from_crops, host copies issued) under "
               f"the CUDA sync debug mode: {len(syncs)} host syncs (tol 0)")
        check(not syncs, f"a dispatch synchronised with the host: {syncs[:3]}")
        del repre, fetch

        # Card against CPU: image 0's first 4 detections of the first object,
        # on a 5-template world of their own crops, mixed (CMP_MIX) and with
        # one word vote per feature, so that each crop's 5 retrieval scores
        # stand well apart: near-tied
        # templates could swap places under the bf16 ViT's rounding on one
        # side and not the other, which would say nothing about the port.
        with open(det_path) as f:
            first = [d for d in json.load(f) if d["image_id"] == 0
                     and d["category_id"] == CLI_LIDS[0]][:4]
        cmp_path = os.path.join(root, "detections_cmp.json")
        with open(cmp_path, "w") as f:
            json.dump(first, f)
        cmp_opts = dataclasses.replace(opts, detections_path=cmp_path, object_lids=[CLI_LIDS[0]],
                                       batch_size=4, repre_dir=os.path.join(root, "repre_cmp"))
        save_repre(crop_world_repre(torch, model, config, object_crops(cmp_opts, CLI_LIDS[0], keys[:1]),
                                    7, device, num_templates=5, mix=CMP_MIX, knn_k=1),
                   os.path.join(root, "repre_cmp", "lmo", "v1", str(CLI_LIDS[0])))
        h, k = config.pnp_ransac_iter, config.top_k_buddies
        draws = lambda s: np.random.default_rng(1000 + s).integers(
            0, k, (4, config.top_n_templates, h, 6))
        by_dev = {}
        for dev in ("cuda", "cpu"):
            dev_opts = dataclasses.replace(cmp_opts, output_dir=f"{out}_{dev}", device=dev)
            with CapturedRuns() as cap:
                t0 = time.perf_counter()
                infer.infer(dev_opts, draws_fn=draws)
                by_dev[dev] = ([r for _, r in cap.results[CLI_LIDS[0]]], time.perf_counter() - t0)
        (gpu, gpu_s), (cpu, cpu_s) = by_dev["cuda"], by_dev["cpu"]
        scores = np.array([a["template_scores"] for a in gpu])
        res["card_vs_cpu"] = dict(
            results_card_vs_cpu(gpu, cpu, 9, f"infer() on image 0's {len(gpu)} detections (batch "
                                             f"4, same draws; {gpu_s:.1f} s / {cpu_s:.1f} s)"),
            min_score_gap=float(np.diff(-scores, axis=1).min()), card_s=gpu_s, cpu_s=cpu_s,
            template_ids=[a["template_ids"].tolist() for a in gpu],
            cpu_template_ids=[b["template_ids"].tolist() for b in cpu])

        # Device busy share over one object's infer() call.
        one = dataclasses.replace(opts, object_lids=[CLI_LIDS[0]], output_dir=out + "_prof")
        res["profile"] = profile_call(torch, lambda: infer.infer(one), 9, "profile_cli.txt",
                                      what=f"infer() of one object ({CLI_IMAGES * CLI_DETS} crops)")
    return res


def icosphere(subdiv, radius, seed):
    """A subdivided icosahedron of `radius` mm (20 * 4**subdiv faces) with
    random vertex colours."""
    from foundpose_torch.data.ply import Mesh

    phi = (1 + 5 ** 0.5) / 2
    verts = [np.array(p, float) for p in (
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0], [0, -1, phi], [0, 1, phi],
        [0, -1, -phi], [0, 1, -phi], [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1])]
    verts = [v / np.linalg.norm(v) for v in verts]
    faces = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
             [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
             [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(subdiv):
        mids, finer = {}, []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mids[key] = len(verts) - 1
            return mids[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            finer += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = finer
    colors = np.random.default_rng(seed).integers(40, 255, (len(verts), 3)).astype(np.uint8)
    return Mesh(vertices=np.asarray(verts, np.float32) * radius,
                faces=np.asarray(faces, np.int32), colors=colors)


def write_rendered_split(torch, root, mesh, lid, diameter, poses, K, size):
    """A BOP split under `root`/bop/lmo whose one test scene holds one
    rendered image per GT pose (R_m2c, t_m2c in mm) of the object `lid`
    with camera K and (width, height) `size`, a CNOS detection per image
    from the rendered mask, and the object's PLY and models_info.json.
    Returns the detections file's path."""
    from PIL import Image

    from foundpose_torch.data.ply import save_ply
    from foundpose_torch.renderer.base import RendererType, RenderType, build
    from foundpose_torch.structs import PinholeCamera

    scene = os.path.join(root, "bop", "lmo", "test", "000001")
    models = os.path.join(root, "bop", "lmo", "models")
    os.makedirs(os.path.join(scene, "rgb"))
    os.makedirs(models)
    save_ply(os.path.join(models, f"obj_{lid:06d}.ply"), mesh)
    with open(os.path.join(models, "models_info.json"), "w") as f:
        json.dump({str(lid): {"diameter": diameter}}, f)
    renderer = build(RendererType.SOFTWARE_RASTERIZER)
    renderer.add_object_model(lid, mesh)
    w, h = size
    cams, gts, infos, dets = {}, {}, {}, []
    for im_id, (r, t) in enumerate(poses):
        t_m2c = np.eye(4)
        t_m2c[:3, :3], t_m2c[:3, 3] = r, t
        cam = PinholeCamera.from_intrinsic_matrix(
            K, w, h, T_world_from_eye=torch.as_tensor(np.linalg.inv(t_m2c), dtype=torch.float32))
        out = renderer.render_object_model(lid, cam)
        mask = np.asarray(out[RenderType.MASK]) > 0
        check(mask.sum() > 100, f"image {im_id}: the object is not in view")
        rgb = (255 * np.clip(np.asarray(out[RenderType.COLOR]), 0, 1)).astype(np.uint8)
        Image.fromarray(rgb).save(os.path.join(scene, "rgb", f"{im_id:06d}.png"))
        ys, xs = np.nonzero(mask)
        box = [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
               int(ys.max() - ys.min() + 1)]
        cams[str(im_id)] = {"cam_K": np.asarray(K).flatten().tolist(), "depth_scale": 0.1}
        gts[str(im_id)] = [{"obj_id": lid, "cam_R_m2c": np.asarray(r).flatten().tolist(),
                            "cam_t_m2c": np.asarray(t).tolist()}]
        infos[str(im_id)] = [{"bbox_obj": box, "bbox_visib": box, "visib_fract": 1.0}]
        dets.append({"scene_id": 1, "image_id": im_id, "category_id": lid, "score": 0.99,
                     "bbox": box, "time": 0.1,
                     "segmentation": {"counts": rle_counts(mask), "size": [h, w]}})
    for name, data in (("scene_camera.json", cams), ("scene_gt.json", gts),
                       ("scene_gt_info.json", infos)):
        with open(os.path.join(scene, name), "w") as f:
            json.dump(data, f)
    det_path = os.path.join(root, "detections.json")
    with open(det_path, "w") as f:
        json.dump(dets, f)
    return det_path


def view_poses(n_views, radius, picks, inplane_deg):
    """GT poses (R_m2c, t_m2c) from the template generator's view sphere:
    view i of sample_views(n_views, radius), turned `inplane_deg` about the
    optical axis."""
    from foundpose_torch import cameras as cam_mod

    views = cam_mod.sample_views(n_views, radius=radius)
    poses = []
    for i, ang in zip(picks, inplane_deg):
        a = np.radians(ang)
        rz = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0, 0, 1.0]])
        poses.append((rz @ views[i]["R"], (rz @ views[i]["t"]).flatten()))
    return poses


def pose_errors(out_dir, lid, poses):
    """(rotation errors in degrees, translation errors in mm) of each
    estimate in `out_dir`'s estimated-poses.json against its image's GT."""
    with open(os.path.join(out_dir, "lmo", "v1", str(lid), "estimated-poses.json")) as f:
        est = json.load(f)
    r_err, t_err = [], []
    for e in est:
        r_gt, t_gt = poses[int(e["img_id"])]
        r = np.asarray(e["R"], float)
        r_err.append(float(np.degrees(np.arccos(np.clip((np.trace(r @ r_gt.T) - 1) / 2, -1, 1)))))
        t_err.append(float(np.linalg.norm(np.asarray(e["t"], float).flatten() - t_gt)))
    return r_err, t_err


def builder_lmo(torch, params, vit_cfg, device):
    """Leg (a): one LM-O-sized object through gen_templates and gen_repre at
    their shipped configs on the card, then the port's infer() at
    configs/infer/lmo.json on a split rendered from the same mesh."""
    import tempfile
    import warnings

    from foundpose_torch.benchmarks import builder_full_scale
    from foundpose_torch.models.weights import state_dict_from_jax_params
    from foundpose_torch.ops import kmeans
    from foundpose_torch.pipeline import eval_ar, gen_repre, gen_templates, infer
    from foundpose_torch.pipeline import prepare_bop_submission as sub
    from foundpose_torch.repre import load_repre
    from foundpose_torch.structs import to_device
    from foundpose_torch.utils import config as config_util

    lid, diameter = BUILD_LID, LMO_DIAMETERS[BUILD_LID]
    res = {}
    with tempfile.TemporaryDirectory(prefix="foundpose_build_") as root:
        mesh = icosphere(BUILD_SUBDIV, diameter / 2, seed=lid)
        radius = 6.0 * diameter  # the template generator's sphere: mid of 4-8 diameters
        poses = view_poses(57, radius, BUILD_VIEWS, [k * 360.0 / 14 for k in BUILD_STEPS])
        det_path = write_rendered_split(torch, root, mesh, lid, diameter, poses, LMO_K, (640, 480))
        weights = os.path.join(ROOT, "foundpose_torch", "_build", "bench_vits14_reg.pth")
        os.makedirs(os.path.dirname(weights), exist_ok=True)
        torch.save(state_dict_from_jax_params(params, vit_cfg), weights)

        # gen_templates at configs/gen_templates/lmo.json, on the native
        # rasterizer (built from native/ at first use; its numpy fallback is
        # ~47x slower).
        from foundpose_torch.renderer import rasterizer

        t0 = time.perf_counter()
        native = rasterizer._get_native() is not None
        res["rasterizer_load_s"] = time.perf_counter() - t0
        log(10, f"native rasterizer loaded {native} ({res['rasterizer_load_s']:.2f} s, build "
                "included when the checkout had none)")
        check(native, "native/librasterizer.so could not be built or loaded")
        tpl_opts = config_util.load_opts(gen_templates.GenTemplatesOpts, [
            "--opts-path", GT_CONFIG, "--set", f"bop_root={root}/bop",
            "--set", f"output_dir={root}/templates", "--set", f"object_lids=[{lid}]"])
        # gen_repre at configs/gen_repre/lmo.json: the main path of this slice.
        opts = config_util.load_opts(gen_repre.GenRepreOpts, [
            "--opts-path", GR_CONFIG, "--set", f"templates_dir={root}/templates",
            "--set", f"output_dir={root}/repre", "--set", f"weights_path={weights}",
            "--set", f"object_lids=[{lid}]"])
        check(opts.device == "cuda" and not opts.use_fused_block and opts.cluster_num == 2048
              and opts.pca_components == 256, f"options {opts}")
        model = gen_repre.load_model(opts, device)
        # Both stages through benchmarks/builder_full_scale (gen_templates
        # is host work: the launches and the peak are gen_repre's).
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        built = builder_full_scale.build_object(tpl_opts, opts, model=model)
        launches = read_counts()
        num_t, tpl_s = built["num_templates"], built["gen_templates_s_per_object"]
        repre_s, stages = built["repre_build_s_per_object"], built["gen_repre_stage_s"]
        threads = os.cpu_count()
        log(10, f"gen_templates {os.path.relpath(GT_CONFIG, ROOT)}: {len(mesh.faces)}-face mesh of "
                f"{diameter:.1f} mm, {num_t} templates of {tpl_opts.crop_size[0]} px (SSAA "
                f"{tpl_opts.ssaa_factor:g}, {threads} render threads) in {tpl_s:.2f} s -> "
                f"{num_t / tpl_s:.1f} templates/s (host work)")
        check(num_t == 798, f"{num_t} templates, want 57 x 14 = 798")
        peak = torch.cuda.max_memory_allocated()
        repre = load_repre(os.path.join(root, "repre", "lmo", "v1", str(lid)), device=device)
        n_feats = int(repre.feat_vectors.shape[0])
        res.update(templates=num_t, gen_templates_s=tpl_s, render_threads=threads,
                   gen_templates_per_s=num_t / tpl_s, gen_repre_s=repre_s,
                   gen_repre_templates_per_s=num_t / repre_s, stages_s=stages,
                   builder_full_scale=built,
                   launches=launches, peak_mem_bytes=peak, features=n_feats,
                   registration_bytes=num_t * 900 * 384 * 4, pca_bank_bytes=num_t * 900 * 256 * 4)
        log(10, f"gen_repre {os.path.relpath(GR_CONFIG, ROOT)} (ViT-S/14-reg layer 9, unfused f32, "
                f"PCA 384 -> 256 from 100,000 rows, 2048 words, 50 Lloyd steps): {repre_s:.2f} s "
                f"-> {num_t / repre_s:.1f} templates/s; stages s " + ", ".join(
                    f"{k} {v:.3f}" for k, v in stages.items())
                + f"; {n_feats} valid features; peak {peak / 2**30:.2f} GiB (registration "
                f"outputs {res['registration_bytes'] / 1e9:.2f} GB, PCA'd bank "
                f"{res['pca_bank_bytes'] / 1e9:.2f} GB); launches {launches}")
        check(launches["attention"] == 500 and launches["vit_block"] == 0
              and launches["buddies"] == 0,
              f"gen_repre launches {launches}: want attention 500 (50 chunks x 10 layers), "
              "vit_block and buddies 0")
        check(repre.num_templates == 798 and tuple(repre.word_centroids.shape) == (2048, 256)
              and repre.feat_vectors.shape[1] == 256, "representation shapes")
        for name in ("feat_vectors", "vertices", "word_centroids", "word_idfs", "template_descs"):
            check(bool(torch.isfinite(getattr(repre, name)).all()), f"{name} not finite")
        check(bool(repre.bank_mask.any(dim=1).all()), "a template has no valid feature")

        # One registration chunk under the CUDA sync debug mode; the uint16
        # depth's copy to the card and its conversion there.
        u16 = np.array([0, 1, 40000, 65535], np.uint16)
        check(torch.equal(to_device(u16, device).float().cpu(),
                          torch.tensor([0.0, 1.0, 40000.0, 65535.0])), "uint16 on the card")
        with open(os.path.join(root, "templates", "lmo", "v1", str(lid), "metadata.json")) as f:
            chunk_md = json.load(f)[:16]
        images, depths, masks, cam_f, cam_c, cam_t, (w, h) = gen_repre.load_template_arrays(chunk_md)
        cams = [to_device(a, device) for a in (cam_f, cam_c, cam_t)]
        torch.cuda.synchronize()
        bank = repre.feat_vectors
        bank_mask = torch.ones(bank.shape[0], dtype=torch.bool, device=device)

        def sync_count(fn):
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with torch.no_grad():
                        out = fn()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            return out, [str(x.message) for x in caught if "called a synchronizing" in str(x.message)]

        f_chunk, syncs = sync_count(lambda: gen_repre.register_templates(
            model, opts.grid_cell_size, (w, h), to_device(images, device),
            to_device(depths, device), None, *cams)[0])
        ids, init_syncs = sync_count(lambda: kmeans._kmeanspp_init(
            bank, 32, torch.Generator(device).manual_seed(0), bank_mask))
        _, lloyd_syncs = sync_count(lambda: kmeans._lloyd(bank, bank[ids], bank_mask, 2))
        res.update(chunk_host_syncs=len(syncs), init_host_syncs=len(init_syncs),
                   lloyd_host_syncs=len(lloyd_syncs))
        log(10, f"under the CUDA sync debug mode: one registration chunk (16 templates, pinned "
                f"copies, ViT, erosion, grid, lifting) {len(syncs)} host syncs, 32 k-means++ "
                f"draws on the saved bank {len(init_syncs)}, 2 Lloyd steps {len(lloyd_syncs)} "
                f"(tol 0 each); features {tuple(f_chunk.shape)}")
        check(not (syncs or init_syncs or lloyd_syncs),
              f"the builder synchronised with the host: {(syncs + init_syncs + lloyd_syncs)[:3]}")

        # The busy share of one whole gen_repre call.
        prof_opts = dataclasses.replace(opts, output_dir=f"{root}/repre_prof")
        res["profile"] = profile_call(
            torch, lambda: gen_repre.generate_repre_from_list(prof_opts, model=model), 10,
            "profile_builder.txt", what="gen_repre of one LM-O object")
        del model, repre, bank

        # The port's infer() at lmo.json on the rendered split.
        inf_opts = config_util.load_opts(infer.InferOpts, [
            "--opts-path", LMO_CONFIG, "--set", f"bop_root={root}/bop",
            "--set", f"repre_dir={root}/repre", "--set", f"detections_path={det_path}",
            "--set", f"output_dir={root}/out", "--set", f"weights_path={weights}",
            "--set", f"object_lids=[{lid}]", "--set", "dataset_crop_size=[640, 480]"])
        reset_counts()
        t0 = time.perf_counter()
        counts = infer.infer(inf_opts)
        infer_s = time.perf_counter() - t0
        inf_launches = read_counts()
        r_err, t_err = pose_errors(f"{root}/out", lid, poses)
        csv = sub.prepare(sub.PrepareBopSubmissionOpts(object_dataset="lmo",
                                                       results_dir=f"{root}/out"))
        with open(csv) as f:
            rows = f.read().strip().split("\n")[1:]
        ar = eval_ar.evaluate(eval_ar.EvalArOpts(object_dataset="lmo", submission_path=csv,
                                                 bop_root=os.path.join(root, "bop")))
        res["infer"] = dict(wall_s=infer_s, counts=counts, launches=inf_launches,
                            estimates=len(r_err), rot_err_deg=r_err, t_err_mm=t_err,
                            csv_rows=len(rows), ar=ar)
        log(10, f"infer() at lmo.json on {len(poses)} rendered 640x480 images (LM-O camera) "
                f"with the card-built representation: {infer_s:.2f} s, {len(r_err)} of "
                f"{len(poses)} detections estimated, median error {np.median(r_err):.2f} deg / "
                f"{np.median(t_err):.2f} mm (random weights), CSV {len(rows)} rows, AR "
                + ", ".join(f"{k} {v:.4f}" for k, v in ar.items()) + f"; launches {inf_launches}")
        check(counts == {lid: len(poses)} and len(r_err) == len(poses) == len(rows),
              f"infer: {counts}, {len(r_err)} estimates, {len(rows)} CSV rows")
        check(all(np.isfinite(v) for v in ar.values()), f"AR not finite: {ar}")
    return res


def builder_small(torch, device):
    """Leg (b): the integration test's world (tests/test_integration.py)
    built on the card and on the CPU from the same templates, the same
    weights and the same k-means init; then infer() on the card with the
    card-built representation against the GT pose."""
    import tempfile

    from foundpose_torch.ops import kmeans
    from foundpose_torch.ops.pca import pca_inverse_transform, pca_transform
    from foundpose_torch.pipeline import gen_repre, gen_templates, infer
    from foundpose_torch.repre import load_repre

    lid = BUILD_LID
    res = {}
    with tempfile.TemporaryDirectory(prefix="foundpose_build_small_") as root:
        mesh = textured_icosahedron()
        diameter = float(np.linalg.norm(mesh.vertices.max(0) - mesh.vertices.min(0)))
        poses = view_poses(9, 300.0, (3,), (0.0,))
        det_path = write_rendered_split(
            torch, root, mesh, lid, diameter, poses,
            np.array([[300.0, 0, 113.5], [0, 300.0, 113.5], [0, 0, 1.0]]), (228, 228))
        gen_templates.synthesize_templates(gen_templates.GenTemplatesOpts(
            object_lids=[lid], min_num_viewpoints=9, num_inplane_rotations=4,
            depth_range=(300.0, 300.0), ssaa_factor=2.0, crop_size=(140, 140),
            bop_root=f"{root}/bop", output_dir=f"{root}/templates"))
        with open(os.path.join(root, "templates", "lmo", "v1", str(lid), "metadata.json")) as f:
            metadata = json.load(f)
        tpl_dir = os.path.join(root, "templates", "lmo", "v1", str(lid))

        # One k-means init for both devices: the CPU build's draw, replayed.
        init_ids, chunks = [], {}
        orig_init, orig_register = kmeans._kmeanspp_init, gen_repre.register_templates

        def same_init(samples, k, generator, mask, norms=None):
            if not init_ids:
                init_ids.append(orig_init(samples, k, generator, mask, norms).cpu())
            return init_ids[0].to(samples.device)

        built = {}
        for key, dev in (("cpu", "cpu"), ("card", str(device))):
            chunks[key] = []

            def recording(*args, **kwargs):
                out = orig_register(*args, **kwargs)
                chunks[key].append([a.cpu() for a in out])
                return out

            opts = gen_repre.GenRepreOpts(
                object_lids=[lid], extractor_name=SMALL_EXTRACTOR, pca_components=16,
                cluster_num=64, batch_size=8, vit_overrides=SMALL_VIT, device=dev,
                templates_dir=f"{root}/templates", output_dir=f"{root}/repre_{key}")
            kmeans._kmeanspp_init, gen_repre.register_templates = same_init, recording
            try:
                t0 = time.perf_counter()
                gen_repre.generate_repre_from_list(opts)
                built[key] = time.perf_counter() - t0
            finally:
                kmeans._kmeanspp_init, gen_repre.register_templates = orig_init, orig_register
        rc, rg = (load_repre(f"{root}/repre_{k}/lmo/v1/{lid}", device="cpu") for k in ("cpu", "card"))
        fc, fg = (torch.cat([c[0] for c in chunks[k]]) for k in ("cpu", "card"))
        feat_rel = float(torch.linalg.vector_norm(fg - fc) / torch.linalg.vector_norm(fc))
        vert_err = float((rg.vertices - rc.vertices).abs().max())
        same_ids = torch.equal(rg.feat_to_template_ids, rc.feat_to_template_ids)
        same_valid = torch.equal(rg.bank_mask, rc.bank_mask) and all(
            torch.equal(a[2], b[2]) for a, b in zip(chunks["card"], chunks["cpu"]))
        x = fc.reshape(-1, fc.shape[-1])
        rec_c = pca_inverse_transform(rc.raw_projector, pca_transform(rc.raw_projector, x))
        rec_g = pca_inverse_transform(rg.raw_projector, pca_transform(rg.raw_projector, x))
        pca_rel = float(torch.linalg.vector_norm(rec_g - rec_c) / torch.linalg.vector_norm(rec_c))
        desc_err = float((rg.template_descs - rc.template_descs).abs().max())
        res.update(templates=len(metadata), build_s=built, feat_rel_l2=feat_rel,
                   vert_max_abs_mm=vert_err, same_template_ids=same_ids, same_validity=same_valid,
                   pca_reconstruction_rel_l2=pca_rel, desc_max_abs=desc_err)
        log(10, f"card vs CPU, gen_repre on the integration test's world ({len(metadata)} "
                f"templates of 140 px, ViT {SMALL_VIT}, same k-means init; "
                f"{built['card']:.2f} s / {built['cpu']:.2f} s): registration features rel. L2 "
                f"{feat_rel:.2e} (tol {BUILD_FEAT_REL_L2}), vertices {vert_err:.2e} mm (tol "
                f"{BUILD_VERT_ATOL}), template ids equal {same_ids}, validity equal {same_valid}, "
                f"PCA reconstruction rel. L2 {pca_rel:.2e} (tol {BUILD_PCA_REL_L2}), tf-idf "
                f"descriptors {desc_err:.2e} (tol {BUILD_DESC_ATOL})")
        check(feat_rel <= BUILD_FEAT_REL_L2 and vert_err <= BUILD_VERT_ATOL and same_ids
              and same_valid and pca_rel <= BUILD_PCA_REL_L2 and desc_err <= BUILD_DESC_ATOL,
              "the card's and the CPU's builds disagree")

        # The chain: the card-built representation drives infer() on the card.
        out = f"{root}/out"
        infer.infer(infer.InferOpts(
            object_lids=[lid], extractor_name=SMALL_EXTRACTOR, crop_size=(140, 140),
            match_top_n_templates=3, match_top_k_buddies=50, pnp_ransac_iter=200, batch_size=2,
            vit_overrides=SMALL_VIT, dataset_crop_size=(224, 224), bop_root=f"{root}/bop",
            repre_dir=f"{root}/repre_card", detections_path=det_path, output_dir=out,
            device=str(device)))
        r_err, t_err = pose_errors(out, lid, poses)
        res.update(rot_err_deg=r_err, t_err_mm=t_err)
        log(10, f"infer() on the card with the card-built representation: {len(r_err)} estimate, "
                f"error {r_err} deg / {t_err} mm (bounds < 15 deg, < 30 mm: "
                f"tests/test_integration.py)")
        check(len(r_err) == 1 and r_err[0] < 15.0 and t_err[0] < 30.0,
              "the chain did not recover the GT pose")
    return res


def textured_icosahedron(scale=40.0):
    """tests/test_integration.make_textured_icosahedron: an icosahedron of
    `scale` mm with vertex colours from seed 7."""
    from foundpose_torch.data.ply import Mesh

    mesh = icosphere(0, 1.0, seed=0)
    rng = np.random.default_rng(7)
    colors = rng.integers(40, 255, size=(12, 3)).astype(np.uint8)
    return Mesh(vertices=mesh.vertices * scale, faces=mesh.faces, colors=colors)


def phase_builder(torch, params, vit_cfg, device):
    """The offline builder on the card (see the module docstring)."""
    return dict(lmo=builder_lmo(torch, params, vit_cfg, device),
                small=builder_small(torch, device))


def phase_probe(torch):
    """The probe's own entry point, counts from zero."""
    from foundpose_torch.benchmarks import micro_int8

    reset_counts()
    rows = micro_int8.run()
    launches = read_counts()
    check(launches["mm_bf16"] > 0 and launches["mm_int8"] > 0, f"probe launches {launches}")
    for name, r in rows.items():
        log(6, f"probe {name} {list(micro_int8.SHAPE)}: {r['ms']:.4f} ms -> "
               f"{r['rate_T_per_s']:.1f} T(FL)OP/s; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return dict(rows=rows, launches=launches)


# Phase 11: the multi-device layer. The (data, bank) and (data, bank,
# model) meshes run as 4 gloo ranks sharing the one card (NCCL refuses two
# ranks on one device); (1, 1) runs under NCCL in this process. Their times
# are labelled MESH_LABEL wherever they are printed.
MESH_WORLD = 4
MESH_TIMED = 10
MESH_LABEL = "gloo, 4 ranks on one card: not a multi-card figure"
# name -> (mesh shape, config): the (2, 2) step at lmo.json, and the
# tensor-parallel step, whose ViT runs unfused (as the JAX package's TP
# path), at lmo_exact.json's f32 against the single-device unfused f32 ViT.
MESH_STEPS = {"step (2, 2) lmo.json": ((2, 2), LMO_CONFIG),
              "TP step (1, 2, 2) lmo_exact.json": ((1, 2, 2), LMO_EXACT_CONFIG)}
# The engine's id for the split's object (1 and 2 are phase 5's objects).
SPLIT_OBJ = 3


def mesh_world(torch, config_path, device, root, infer_set=None, weights="vits14_reg.pth"):
    """A step's inputs on the split phase 11 (or 12) writes under `root`:
    the 16 crops of object CLI_LIDS[0] in its 2 images, its representation
    (cast to the configuration's dtype), the model `weights` under the
    configuration's ViT, injected draws from a seed. `infer_set` replaces
    entries of the configuration's infer_opts. Returns (model, repre,
    crops, masks, cams, config, draws)."""
    import pickle

    from foundpose_torch.models.weights import load_checkpoint
    from foundpose_torch.pipeline import inference
    from foundpose_torch.repre import load_repre

    with open(config_path) as f:
        opts = json.load(f)
    opts["infer_opts"].update(infer_set or {})
    config = inference.inference_config_from_opts(opts)
    model = load_checkpoint(os.path.join(root, weights),
                            inference.vit_config_from_opts(opts)).to(device)
    repre = load_repre(os.path.join(root, "repre", "lmo", "v1", str(CLI_LIDS[0])), device=device)
    with open(os.path.join(root, "crops.pkl"), "rb") as f:
        crops, masks, cams = (a.to(device) for a in pickle.load(f))  # crops, masks, cameras
    draws = torch.as_tensor(np.random.default_rng(11).integers(
        0, config.top_k_buddies, (16, config.top_n_templates, config.pnp_ransac_iter, 6)),
        device=device)
    return model, repre.cast_banks(config.compute_dtype), crops, masks, cams, config, draws


def outputs_np(out):
    return {f.name: getattr(out, f.name).float().cpu().numpy() for f in dataclasses.fields(out)}


def mesh_requests(torch, call, timed=MESH_TIMED):
    """One request from zero counts (its outputs and launches), then
    `timed` timed requests (host clock to torch.cuda.synchronize())."""
    reset_counts()
    out = call()
    torch.cuda.synchronize()
    launches = read_counts()
    lat = []
    for _ in range(timed):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    return dict(outputs=outputs_np(out), launches=launches, latency_s=lat,
                median_s=float(np.median(lat)))


def compare_poses(got, ref, all_crops):
    """Decisions and pose differences of two outputs (numpy dicts): poses
    over every crop when `all_crops`, else over the crops both solved."""
    both = got["success"].astype(bool) & ref["success"].astype(bool)
    sel = np.ones_like(both) if all_crops else both
    res = dict(
        same_template_ids=bool((got["template_ids"] == ref["template_ids"]).all()),
        same_best_template=bool((got["best_template"] == ref["best_template"]).all()),
        same_success=bool((got["success"] == ref["success"]).all()),
        both_succeeded=int(both.sum()), poses_over="all crops" if all_crops else "both solved",
        max_abs_R=float(np.abs(got["R_m2c"] - ref["R_m2c"])[sel].max(initial=0.0)),
        max_abs_t=float(np.abs(got["t_m2c"] - ref["t_m2c"])[sel].max(initial=0.0)),
    )
    res["ok"] = (res["same_template_ids"] and res["same_best_template"] and res["same_success"]
                 and res["max_abs_R"] <= REFINE_WORLD_R_ATOL
                 and res["max_abs_t"] <= REFINE_WORLD_T_ATOL)
    return res


def split_request(root, det_path):
    """Image 0 of the split phase 11 writes under `root` and the boxes
    (xyxy) of object CLI_LIDS[0]'s detections in it."""
    from PIL import Image

    image = np.asarray(Image.open(os.path.join(root, "bop", "lmo", "test", "000001", "rgb",
                                               "000000.png")).convert("RGB"))
    with open(det_path) as f:
        dets = json.load(f)
    boxes = [np.array([x, y, x + w, y + h], np.float32) for d in dets
             if d["image_id"] == 0 and d["category_id"] == CLI_LIDS[0] for x, y, w, h in [d["bbox"]]]
    return image, boxes


def engine_mesh_calls(engine, image, boxes, split):
    """The compared engine calls: estimate() of object 1, estimate_mixed()
    over objects 1 and 2 (alternating), then estimate() of the split's
    object on its image 0. split = (repre, image, boxes); its repre is
    registered as SPLIT_OBJ after estimate_mixed(), which stacks objects
    1 and 2 only."""
    dets = [{"obj_id": 1 + i % 2, "box_xyxy": bx} for i, bx in enumerate(boxes)]
    calls = [engine.estimate(1, image, boxes, LMO_K), engine.estimate_mixed(image, dets, LMO_K)]
    engine.register_object(SPLIT_OBJ, split[0])
    return calls + [engine.estimate(SPLIT_OBJ, split[1], split[2], LMO_K)]


def engine_rows(calls):
    return [{k: np.asarray(r[k]) for k in ("success", "best_template", "quality", "R_m2c", "t_m2c")}
            for call in calls for r in call]


def mesh_stage_diffs(torch, mesh, model, repre, crops, masks, cams, config, draws):
    """Each stage of the mesh step on this rank's rows, fed the single-
    device chain's inputs (their rows), against the single-device stage on
    the whole batch (its rows kept): {stage: largest absolute difference},
    0.0 when bit-equal, and the retrieval's count of differing ids. The
    first non-zero stage is where the mesh step departs from the
    single-device step; the last entry repeats the single-device step as a
    control of its own run-to-run determinism."""
    from foundpose_torch.models import dinov2
    from foundpose_torch.ops.pca import pca_transform
    from foundpose_torch.ops.tfidf import tfidf_retrieve
    from foundpose_torch.parallel import mesh as mesh_mod
    from foundpose_torch.parallel import sharded_inference as shd
    from foundpose_torch.pipeline import inference
    from foundpose_torch.pose import corresp, pnp
    from foundpose_torch.repre import pad_templates

    def diff(a, b):
        a, b = a.double(), b.double()
        same = (a == b) | (a.isnan() & b.isnan())
        return float(torch.where(same, 0.0, (a - b).abs()).max()) if a.numel() else 0.0

    def take(c, rows):
        return type(c)(**{f.name: getattr(c, f.name)[rows] for f in dataclasses.fields(c)})

    rows = mesh_mod.data_slice(mesh, crops.shape[0])
    shard = mesh_mod.shard_repre(pad_templates(repre, mesh_mod.axis_size(mesh, "bank")), mesh)
    images = inference.preprocess_crops(crops, config)
    fm = dinov2.extract_facet(model, images)["feature_maps"].float()
    res = {"vit": diff(dinov2.extract_facet(model, images[rows])["feature_maps"].float(),
                       fm[rows])}

    def query(fmaps, m):
        points, feats, valid = inference.query_features_from_map(
            fmaps, m.float(), config.crop_size, config.grid_cell_size)
        return points, pca_transform(repre.raw_projector, feats).to(config.compute_dtype), valid

    points, feats, valid = query(fm, masks)
    res["query features + PCA"] = diff(query(fm[rows], masks[rows])[1], feats[rows])
    n = config.top_n_templates
    tids, tscores = tfidf_retrieve(feats, repre.word_centroids, repre.word_idfs,
                                   repre.template_descs, top_n=n, config=repre.tfidf_config,
                                   query_mask=valid, template_mask=repre.template_mask)
    whole_ids, whole_scores = tfidf_retrieve(
        feats[rows], repre.word_centroids, repre.word_idfs, repre.template_descs, top_n=n,
        config=repre.tfidf_config, query_mask=valid[rows], template_mask=repre.template_mask)
    res["retrieval, rows on the whole bank: scores"] = diff(whole_scores, tscores[rows])
    res["retrieval, rows on the whole bank: ids differing"] = int(
        (whole_ids != tids[rows]).sum())
    shard_ids, shard_scores = shd._retrieve_sharded(
        feats[rows], valid[rows], shard.word_centroids, shard.word_idfs, shard.template_descs,
        n, shard.tfidf_config, mesh, template_mask_local=shard.template_mask)
    res["retrieval, sharded: scores"] = diff(shard_scores, tscores[rows])
    res["retrieval, sharded: ids differing"] = int((shard_ids != tids[rows]).sum())
    fetched = shd._fetch_banks(tids[rows], shard.bank_feats, shard.bank_vertices,
                               shard.bank_mask, mesh)
    sel = tids[rows].long()
    res["bank fetch"] = max(diff(f, b[sel]) for f, b in zip(
        fetched, (repre.bank_feats, repre.bank_vertices, repre.bank_mask)))
    cors = inference.match_batch(feats, valid, tids, tscores, repre, config)
    cors_rows = corresp.correspondences_from_banks(
        points, feats[rows], valid[rows], tids[rows], tscores[rows],
        fetched[0].to(config.compute_dtype), fetched[1], fetched[2],
        top_k=config.top_k_buddies, approx_topk=config.approx_topk)
    res["matching"] = max(diff(getattr(cors_rows, f.name), getattr(cors, f.name)[rows])
                          for f in dataclasses.fields(cors))
    # solve_batch's parts: RANSAC (DLT and the scorer), then on each crop's
    # winning set (picked as solve_batch picks) the LO refits and LM, one
    # refine_lo_lm call as refine_winner makes it.
    flat = [a.flatten(0, 1) for a in (cors.coord_2d, cors.coord_3d, cors.valid, draws)]
    cf, cc = (x.float()[:, None].expand(-1, n, 2).flatten(0, 1) for x in (cams.f, cams.c))
    sets = slice(rows.start * n, rows.stop * n)
    hyp = [pnp.ransac_pnp(*(a[s] for a in flat[:3]), cf[s], cc[s],
                          num_hypotheses=config.pnp_select_iter or config.pnp_ransac_iter,
                          inlier_thresh=config.pnp_inlier_thresh, refine_lm=False, lo_iters=0,
                          draws=flat[3][s])
           for s in (slice(None), sets)]
    res["solve: RANSAC hypotheses"] = max(diff(getattr(hyp[1], k), getattr(hyp[0], k)[sets])
                                          for k in ("R", "t", "quality"))
    b_all = crops.shape[0]
    best = torch.argmax(torch.where(hyp[0].success, hyp[0].quality, -1.0).reshape(b_all, n), -1)
    ar = torch.arange(b_all, device=best.device)
    win = [a.reshape(b_all, n, *a.shape[1:])[ar, best] for a in (hyp[0].R, hyp[0].t,
                                                                 hyp[0].inliers, hyp[0].quality)]
    pts = [cors.coord_2d[ar, best].float(), cors.coord_3d[ar, best].float(),
           cors.valid[ar, best]]
    cam = [cams.f.float(), cams.c.float()]
    refined = [pnp.refine_lo_lm(*(a[s] for a in win[:2] + pts + cam + win[2:]),
                                config.pnp_inlier_thresh, config.pnp_lo_iters,
                                config.lm_iters if config.pnp_refine_lm else 0)
               for s in (slice(None), rows)]
    res["solve: LO refits and LM (refine_lo_lm)"] = max(
        diff(a, b[rows]) for a, b in zip(refined[1], refined[0]))
    out = inference.solve_batch(fm, valid, tids, tscores, cors, cams, repre, config, draws=draws)
    out_rows = inference.solve_batch(
        fm[rows], valid[rows], tids[rows], tscores[rows], take(cors, rows), cams.index(rows),
        shard, config, draws=draws[rows], fetched_banks=fetched)
    res["solve: whole (winner refits, LM, score)"] = max(diff(getattr(out_rows, k), getattr(out, k)[rows])
                       for k in ("R_m2c", "t_m2c", "quality"))
    again = inference.pose_from_crops(model, crops, masks, cams, repre, config, draws=draws)
    first = inference.pose_from_crops(model, crops, masks, cams, repre, config, draws=draws)
    res["control: the single-device step twice"] = max(
        diff(getattr(again, k), getattr(first, k)) for k in ("R_m2c", "t_m2c", "quality"))
    return res


def _mesh_rank(rank, world, root):
    """One gloo rank of phase 11 (foundpose_torch.parallel.launch): the
    (2, 2) and TP steps, the mesh engine and the mesh CLI on the shared
    card; writes rank{rank}.pkl under `root`."""
    import pickle

    import torch

    from foundpose_torch.engine import PoseEngine
    from foundpose_torch.parallel import mesh as mesh_mod
    from foundpose_torch.parallel import sharded_inference as shd
    from foundpose_torch.pipeline import infer
    from foundpose_torch.repre import load_repre
    from foundpose_torch.synthetic import realistic_repre
    from foundpose_torch.utils import config as config_util

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = mesh_mod.compute_device("cuda")
    torch.cuda.set_device(device)
    with open(os.path.join(root, "mesh_inputs.pkl"), "rb") as f:
        p = pickle.load(f)
    res = {"device": str(device)}
    with torch.no_grad():
        for name, (shape, config_path) in MESH_STEPS.items():
            model, repre, crops, masks, cams, config, draws = mesh_world(
                torch, config_path, device, root)
            mesh = mesh_mod.make_mesh(shape)
            step = shd.make_object_mesh_step(mesh, config, repre)
            params = shd.prepare_mesh_vit_params(mesh, model)
            res[name] = mesh_requests(
                torch, lambda: step(params, crops, masks, cams, draws=draws))
            res[name]["coords"] = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
            if not name.startswith("TP"):
                res[name]["stages"] = mesh_stage_diffs(torch, mesh, model, repre, crops, masks,
                                                       cams, config, draws)
            del model, repre, step, params

        engine = PoseEngine(mesh_shape=(2, 2), device="cuda", **p["engine_kw"])
        for obj_id, seed in ((1, 0), (2, 1)):
            engine.register_object(obj_id, realistic_repre(seed, device))
        image, boxes = serving_request()
        split = (load_repre(os.path.join(root, "repre", "lmo", "v1", str(CLI_LIDS[0])),
                            device=device), *split_request(root, p["det_path"]))
        reset_counts()
        calls = engine_mesh_calls(engine, image, boxes, split)
        launches = read_counts()
        lat = []
        for _ in range(MESH_TIMED):
            t0 = time.perf_counter()
            engine.estimate(1, image, boxes, LMO_K)
            lat.append(time.perf_counter() - t0)
        res["engine"] = dict(rows=engine_rows(calls), launches=launches, latency_s=lat,
                             median_s=float(np.median(lat)))
        del engine

    opts = config_util.load_opts(infer.InferOpts, p["cli_args"] + ["--set", "mesh_shape=[2, 2]"])
    reset_counts()
    with CapturedRuns() as cap:
        t0 = time.perf_counter()
        counts = infer.infer(opts)
        wall = time.perf_counter() - t0
    res["cli"] = dict(counts=counts, wall_s=wall, launches=read_counts(),
                      finalized=sorted(cap.results), rows=cli_rows(cap))
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def cli_rows(cap):
    """Per instance of the captured runs: ids, decisions and poses."""
    return [dict(key=(p.scene_id, p.im_id, p.inst_id),
                 **{k: np.asarray(r[k]) for k in ("template_ids", "best_template", "success",
                                                  "R_m2c", "t_m2c")})
            for res in cap.results.values() for p, r in res]


def phase_mesh(torch, params, vit_cfg, device):
    """The multi-device layer on the card (see the module docstring)."""
    import pickle
    import tempfile

    import torch.distributed as dist

    from foundpose_torch.engine import PoseEngine
    from foundpose_torch.models.weights import state_dict_from_jax_params
    from foundpose_torch.parallel import launch
    from foundpose_torch.parallel import mesh as mesh_mod
    from foundpose_torch.parallel import sharded_inference as shd
    from foundpose_torch.pipeline import infer, inference
    from foundpose_torch.repre import load_repre, save_repre
    from foundpose_torch.synthetic import realistic_repre
    from foundpose_torch.utils import config as config_util

    res = {"label": MESH_LABEL}
    with tempfile.TemporaryDirectory(prefix="foundpose_mesh_") as root:
        # The split (object 1, 2 images, 16 crops), its crop-world
        # representation, the single-device CLI's run.
        t0 = time.perf_counter()
        det_path = write_split(torch, root, n_images=2)
        torch.save(state_dict_from_jax_params(params, vit_cfg), os.path.join(root, "vits14_reg.pth"))
        cli_args = [
            "--opts-path", LMO_CONFIG, "--set", f"bop_root={root}/bop",
            "--set", f"repre_dir={root}/repre", "--set", f"detections_path={det_path}",
            "--set", f"weights_path={root}/vits14_reg.pth",
            "--set", f"object_lids=[{CLI_LIDS[0]}]", "--set", "dataset_crop_size=[640, 480]",
        ]
        opts = config_util.load_opts(infer.InferOpts, cli_args + ["--set", f"output_dir={root}/out"])
        model, config = infer.load_model(opts, device)
        pend = object_crops(opts, CLI_LIDS[0], [(1, 0), (1, 1)])
        check(len(pend) == 16, f"{len(pend)} crops in the mesh split")
        save_repre(crop_world_repre(torch, model, config, pend, 0, device),
                   os.path.join(root, "repre", "lmo", "v1", str(CLI_LIDS[0])))
        with open(os.path.join(root, "crops.pkl"), "wb") as f:
            pickle.dump(infer.stack_batch(pend, "cpu"), f)
        del model, pend
        with CapturedRuns() as cap:
            infer.infer(opts)
        cli_ref = cli_rows(cap)
        cli_args += ["--set", f"output_dir={root}/out_mesh"]

        # Single-device references of the steps and the engine.
        refs = {}
        with torch.no_grad():
            for name, (_, config_path) in MESH_STEPS.items():
                model, repre, crops, masks, cams, config, draws = mesh_world(
                    torch, config_path, device, root)
                refs[name] = outputs_np(inference.pose_from_crops(
                    model, crops, masks, cams, repre, config, draws=draws))
            engine_kw, _, _ = serving_engine_kw(torch, params)
            engine = PoseEngine(**engine_kw, device=device)
            for obj_id, seed in ((1, 0), (2, 1)):
                engine.register_object(obj_id, realistic_repre(seed, device))
            image, boxes = serving_request()
            split = (load_repre(os.path.join(root, "repre", "lmo", "v1", str(CLI_LIDS[0])),
                                device=device), *split_request(root, det_path))
            engine_ref = engine_rows(engine_mesh_calls(engine, image, boxes, split))
            del engine, split

            # (a) NCCL, world 1, mesh (1, 1), at lmo.json.
            name = "step (2, 2) lmo.json"
            model, repre, crops, masks, cams, config, draws = mesh_world(
                torch, MESH_STEPS[name][1], device, root)
            dist.init_process_group("nccl", init_method=f"file://{root}/nccl_store", rank=0,
                                    world_size=1)
            try:
                mesh = mesh_mod.make_mesh((1, 1))
                step = shd.make_object_mesh_step(mesh, config, repre)
                nccl = mesh_requests(torch, lambda: step(model, crops, masks, cams, draws=draws))
                nccl["backend"] = dist.get_backend()
            finally:
                dist.destroy_process_group()
            del model, repre, step
        nccl["vs_single"] = compare_poses(nccl.pop("outputs"), refs[name], all_crops=True)
        res["nccl (1, 1) lmo.json"] = nccl
        res["setup_s"] = time.perf_counter() - t0

        # (b) 4 gloo ranks sharing the card.
        with open(os.path.join(root, "mesh_inputs.pkl"), "wb") as f:
            pickle.dump(dict(engine_kw=engine_kw, cli_args=cli_args, det_path=det_path), f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launch.run(_mesh_rank, MESH_WORLD, root)
        res["ranks_wall_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(MESH_WORLD):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        with open(os.path.join(root, "out", "lmo", "v1", str(CLI_LIDS[0]),
                               "estimated-poses.json")) as f:
            single_records = json.load(f)
        with open(os.path.join(root, "out_mesh", "lmo", "v1", str(CLI_LIDS[0]),
                               "estimated-poses.json")) as f:
            mesh_records = json.load(f)

    r = res["nccl (1, 1) lmo.json"]
    log(11, f"(a) NCCL world 1, mesh (1, 1), lmo.json, 16 crops: vs the single-device step "
            f"{r['vs_single']}; launches {r['launches']}; {MESH_TIMED} requests ms median "
            f"{r['median_s'] * 1e3:.2f} (min {min(r['latency_s']) * 1e3:.2f})")
    check(r["vs_single"]["ok"], "the NCCL (1, 1) step differs from the single-device step")
    check(all(r["launches"][k] > 0 for k in ("vit_block", "buddies", "ransac_score", "refine")),
          f"NCCL step launches {r['launches']}")
    for name in MESH_STEPS:
        per_rank = [rk[name] for rk in ranks]
        for rk in per_rank:
            rk["vs_single"] = compare_poses(rk.pop("outputs"), refs[name],
                                            all_crops=name.startswith("step"))
        tp = name.startswith("TP")
        need = (("attention", "ransac_score", "refine") if tp
                else ("vit_block", "buddies", "ransac_score", "refine"))
        res[name] = per_rank
        log(11, f"(b) {name}, 16 crops, per rank [{MESH_LABEL}]: "
                + "; ".join(f"rank {i} {rk['coords']}: launches {rk['launches']}, median "
                            f"{rk['median_s'] * 1e3:.2f} ms" for i, rk in enumerate(per_rank))
                + f"; vs single device {per_rank[0]['vs_single']}")
        if not tp:
            bank = {i: rk["stages"]["bank fetch"] for i, rk in enumerate(per_rank)}
            log(11, f"(b) {name}, each stage on a rank's rows from the single-device chain's "
                    f"inputs against the single-device stage, largest difference: "
                    + "; ".join(f"rank {i} {rk['stages']}" for i, rk in enumerate(per_rank)))
            check(all(v == 0.0 for v in bank.values()), f"fetched banks not bit-equal: {bank}")
        for i, rk in enumerate(per_rank):
            check(rk["vs_single"]["ok"], f"{name}: rank {i} differs from the single-device "
                                         f"step: {rk['vs_single']}")
            check(all(rk["launches"][k] > 0 for k in need), f"{name}: rank {i} launched "
                                                            f"{rk['launches']}")
            check(rk["launches"]["vit_block"] == (0 if tp else vit_cfg.layer + 1)
                  and rk["launches"]["attention"] == (vit_cfg.layer + 1 if tp else 0),
                  f"{name}: rank {i} ViT launches {rk['launches']}")
    eng = [rk["engine"] for rk in ranks]
    diffs = []
    for i, e in enumerate(eng):
        check(len(e["rows"]) == len(engine_ref), "engine row count")
        for g, rf in zip(e["rows"], engine_ref):
            check(all(bool(g[k] == rf[k]) for k in ("success", "best_template", "quality")),
                  f"mesh engine rank {i} decisions differ from the single-device engine")
            if g["success"]:
                diffs.append((float(np.abs(g["R_m2c"] - rf["R_m2c"]).max()),
                              float(np.abs(g["t_m2c"] - rf["t_m2c"]).max())))
    d_r = max([a for a, _ in diffs], default=0.0)
    d_t = max([b for _, b in diffs], default=0.0)
    solved = sum(bool(r["success"]) for r in engine_ref)
    res["engine"] = dict(ranks=[{k: v for k, v in e.items() if k != "rows"} for e in eng],
                         solved=solved, rows=len(engine_ref), max_abs_R=d_r, max_abs_t=d_t)
    log(11, f"(b) PoseEngine(mesh_shape=(2, 2)) lmo_exact.json, estimate() of 16 boxes, "
            f"estimate_mixed() over 2 objects and estimate() of the split's object on its "
            f"image 0: decisions equal the single-device engine's on every rank; {solved} of "
            f"{len(engine_ref)} rows solved, |R| {d_r:.2e}, |t| {d_t:.2e} over them on every "
            f"rank; per rank "
            f"[{MESH_LABEL}]: " + "; ".join(
                f"launches {e['launches']}, estimate() median {e['median_s'] * 1e3:.2f} ms"
                for e in eng))
    check(solved > 0, "no mesh engine row solved: its poses went unchecked")
    check(d_r <= REFINE_WORLD_R_ATOL and d_t <= REFINE_WORLD_T_ATOL, "mesh engine poses differ")
    check(all(e["launches"]["attention"] == 3 * (vit_cfg.layer + 1)
              and e["launches"]["vit_block"] == 0 for e in eng),
          f"mesh engine launches {[e['launches'] for e in eng]}")
    cli = [rk["cli"] for rk in ranks]
    rows = cli[0]["rows"]
    check(all(c["finalized"] == [] for c in cli[1:]) and cli[0]["finalized"] == [CLI_LIDS[0]],
          f"ranks that finalized: {[c['finalized'] for c in cli]}")
    check([x["key"] for x in rows] == [x["key"] for x in cli_ref], "mesh CLI instances")
    cmp = compare_poses(*({k: np.stack([x[k] for x in xs]) for k in rows[0] if k != "key"}
                          for xs in (rows, cli_ref)), all_crops=False)
    res["cli"] = dict(ranks=[{k: v for k, v in c.items() if k != "rows"} for c in cli],
                      vs_single=cmp, records=len(mesh_records),
                      single_records=len(single_records))
    log(11, f"(b) infer() at mesh_shape=[2, 2], lmo.json, 16 crops: vs the single-device CLI "
            f"{cmp}; estimated-poses.json {len(mesh_records)} records (single device "
            f"{len(single_records)}), written by rank 0 only; walls s [{MESH_LABEL}] "
            + ", ".join(f"{c['wall_s']:.2f}" for c in cli) + f"; rank 0 launches "
            f"{cli[0]['launches']}")
    check(cmp["ok"] and cmp["both_succeeded"] > 0, "the mesh CLI differs from the single-device CLI")
    check(len(mesh_records) == len(single_records) > 0, "estimated-poses.json records differ")
    check(all(c["launches"][k] > 0 for c in cli
              for k in ("vit_block", "buddies", "ransac_score", "refine")),
          "mesh CLI kernels not launched")
    log(11, f"setup {res['setup_s']:.1f} s, 4 ranks {res['ranks_wall_s']:.1f} s (spawn, loads, "
            f"all of (b))")
    return res


# Phase 12: DINOv2 ViT-G/14-reg (SwiGLU, 1536 wide, 24 heads, 40 blocks) at
# configs/infer/lmo.json with the extractor replaced through the options
# seam (the CLI's --set extractor_name=...); its weights are bench_weights'
# calibrated random weights from seed 0.
VITG_EXTRACTOR = "dinov2_version=vitg14-reg_stride=14_facet=token_layer=39_norm=1"
# (e) the tensor-parallel leg at ViT-G width, unfused f32 at lmo_exact.json
# as phase 11's TP step, cut to the first 2 blocks (layer 1) so that gloo's
# host round trips of [16, 905, 1536] f32 psums (89 MB, 4 a request) stay
# within the run's time; VITG_TP_TIMED timed requests a rank.
VITG_TP_SET = {"extractor_name": "dinov2_version=vitg14-reg_stride=14_facet=token_layer=1_norm=1",
               "vit_overrides": {"depth": 2}}
VITG_TP_WEIGHTS = "vitg14_reg_2blocks.pth"
VITG_TP_BLOCKS = 2
VITG_TP_TIMED = 3


def vitg_registration(torch, model, device):
    """One registration chunk of gen_repre at configs/gen_repre/lmo.json
    with the ViT-G extractor (layer 39; unfused f32, erf): 16 templates
    (the main path's random crops, 500 mm of depth on the bench masks' box)
    through register_templates on the phase's model, whose configuration
    is swapped to the builder's for the call."""
    from foundpose_torch.pipeline import gen_repre, inference
    from foundpose_torch.utils import config as config_util

    opts = config_util.load_opts(gen_repre.GenRepreOpts, [
        "--opts-path", GR_CONFIG, "--set", f"extractor_name={VITG_EXTRACTOR}"])
    reg_cfg = inference.vit_config_from_opts(dataclasses.asdict(opts))
    serve_cfg = model.cfg
    check(reg_cfg == dataclasses.replace(serve_cfg, use_fused_block=False, approx_gelu=False,
                                         softmax_stabilizer="column"),
          f"the builder's ViT-G config {reg_cfg} is not the served one unfused in f32")
    images, _, _ = main_path_inputs(torch, device)
    n = images.shape[0]
    depths = torch.zeros(n, 420, 420, device=device)
    depths[:, 80:340, 80:340] = 500.0  # mm; the eroded mask is depth > 0
    cam_f = torch.full((n, 2), 600.0, device=device)
    cam_c = torch.full((n, 2), 209.5, device=device)
    cam_t = torch.eye(4, device=device).expand(n, 4, 4).contiguous()
    model.cfg = reg_cfg
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        feats, _, valid = gen_repre.register_templates(
            model, opts.grid_cell_size, (420, 420), images, depths, None, cam_f, cam_c, cam_t)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counts()
    finally:
        model.cfg = serve_cfg
    res = dict(seconds=secs, launches=launches, features_shape=list(feats.shape),
               valid_cells=int(valid.sum()), finite=bool(torch.isfinite(feats[valid]).all()))
    log(12, f"(d) one gen_repre registration chunk, configs/gen_repre/lmo.json with the ViT-G "
            f"extractor (layer {reg_cfg.layer}, unfused f32), 16 templates: {secs:.3f} s, "
            f"features {tuple(feats.shape)} ({res['valid_cells']} valid cells, finite "
            f"{res['finite']}), launches {launches}; the 798-template build (50 chunks) is not run")
    check(launches["attention"] == reg_cfg.layer + 1 and launches["vit_block"] == 0,
          f"registration launches {launches}")
    check(feats.shape[-1] == reg_cfg.embed_dim and res["finite"] and res["valid_cells"] > 0,
          "ViT-G registration features")
    return res


def _vitg_tp_rank(rank, world, root):
    """One gloo rank of phase 12 (e): the (1, 2, 2) tensor-parallel step at
    ViT-G width (2 blocks) on the shared card; writes rank{rank}.pkl."""
    import pickle

    import torch

    from foundpose_torch.parallel import mesh as mesh_mod
    from foundpose_torch.parallel import sharded_inference as shd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = mesh_mod.compute_device("cuda")
    torch.cuda.set_device(device)
    with torch.no_grad():
        model, repre, crops, masks, cams, config, draws = mesh_world(
            torch, LMO_EXACT_CONFIG, device, root, VITG_TP_SET, VITG_TP_WEIGHTS)
        mesh = mesh_mod.make_mesh((1, 2, 2))
        step = shd.make_object_mesh_step(mesh, config, repre)
        params = shd.prepare_mesh_vit_params(mesh, model)
        res = mesh_requests(torch, lambda: step(params, crops, masks, cams, draws=draws),
                            timed=VITG_TP_TIMED)
        res["coords"] = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def vitg_tp(torch, tp_state, device):
    """Phase 12 (e), from the state dict of the ViT-G's first blocks
    (`tp_state`, on the host): the split of phase 11 (object 1, 2 images,
    16 crops), a crop-world representation from the 2-block ViT-G's own
    features (PCA 1536 -> 256), the single-device step at lmo_exact.json
    with the ViT-G layer-1 extractor, then 4 gloo ranks sharing the card on
    the (1, 2, 2) step (12 heads and 2,048 hidden units a rank)."""
    import pickle
    import tempfile

    from foundpose_torch.models.weights import load_checkpoint
    from foundpose_torch.parallel import launch
    from foundpose_torch.pipeline import infer, inference
    from foundpose_torch.repre import save_repre
    from foundpose_torch.utils import config as config_util

    res = {"label": MESH_LABEL}
    with tempfile.TemporaryDirectory(prefix="foundpose_vitg_tp_") as root:
        t0 = time.perf_counter()
        det_path = write_split(torch, root, n_images=2)
        torch.save(tp_state, os.path.join(root, VITG_TP_WEIGHTS))
        opts = config_util.load_opts(infer.InferOpts, [
            "--opts-path", LMO_EXACT_CONFIG, "--set", f"bop_root={root}/bop",
            "--set", f"detections_path={det_path}", "--set", f"object_lids=[{CLI_LIDS[0]}]",
            "--set", "dataset_crop_size=[640, 480]", "--set", f"output_dir={root}/out"])
        pend = object_crops(opts, CLI_LIDS[0], [(1, 0), (1, 1)])
        check(len(pend) == 16, f"{len(pend)} crops in the split")
        with open(os.path.join(root, "crops.pkl"), "wb") as f:
            pickle.dump(infer.stack_batch(pend, "cpu"), f)
        with open(LMO_EXACT_CONFIG) as f:
            exact = json.load(f)
        exact["infer_opts"].update(VITG_TP_SET)
        with torch.no_grad():
            small = load_checkpoint(os.path.join(root, VITG_TP_WEIGHTS),
                                    inference.vit_config_from_opts(exact)).to(device)
            save_repre(crop_world_repre(torch, small, inference.inference_config_from_opts(exact),
                                        pend, 0, device),
                       os.path.join(root, "repre", "lmo", "v1", str(CLI_LIDS[0])))
            del small, pend
            small, repre, crops, masks, cams, config, draws = mesh_world(
                torch, LMO_EXACT_CONFIG, device, root, VITG_TP_SET, VITG_TP_WEIGHTS)
            ref = outputs_np(inference.pose_from_crops(small, crops, masks, cams, repre, config,
                                                       draws=draws))
            del small, repre
        res["setup_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launch.run(_vitg_tp_rank, MESH_WORLD, root)
        res["ranks_wall_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(MESH_WORLD):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    for rk in ranks:
        rk["vs_single"] = compare_poses(rk.pop("outputs"), ref, all_crops=False)
    res["ranks"] = ranks
    log(12, f"(e) TP step (1, 2, 2) at ViT-G width, 2 blocks, lmo_exact.json (f32), 16 crops, per "
            f"rank [{MESH_LABEL}]: "
            + "; ".join(f"rank {i} {rk['coords']}: launches {rk['launches']}, median "
                        f"{rk['median_s'] * 1e3:.1f} ms of {VITG_TP_TIMED}"
                        for i, rk in enumerate(ranks))
            + f"; vs single device {ranks[0]['vs_single']}; setup {res['setup_s']:.1f} s, 4 "
              f"ranks {res['ranks_wall_s']:.1f} s")
    for i, rk in enumerate(ranks):
        check(rk["vs_single"]["ok"] and rk["vs_single"]["both_succeeded"] > 0,
              f"ViT-G TP rank {i} differs from the single-device step: {rk['vs_single']}")
        check(rk["launches"]["attention"] == 2 and rk["launches"]["vit_block"] == 0
              and rk["launches"]["ransac_score"] > 0 and rk["launches"]["refine"] > 0,
              f"ViT-G TP rank {i} launched {rk['launches']}")
    return res


def phase_vitg(torch, device):
    """DINOv2 ViT-G/14 at lmo.json on the card (see the module docstring)."""
    from foundpose_torch.models import bench_weights, dinov2
    from foundpose_torch.models.weights import module_from_jax_params
    from foundpose_torch.pipeline import inference
    from foundpose_torch.synthetic import realistic_repre

    with open(LMO_CONFIG) as f:
        opts = json.load(f)
    opts["infer_opts"]["extractor_name"] = VITG_EXTRACTOR
    config = inference.inference_config_from_opts(opts)
    vit_cfg = inference.vit_config_from_opts(opts)
    check(vit_cfg.swiglu and (vit_cfg.embed_dim, vit_cfg.num_heads, vit_cfg.mlp_hidden,
                              vit_cfg.depth, vit_cfg.layer) == (1536, 24, 4096, 40, 39),
          f"not ViT-G/14: {vit_cfg}")
    res = {}

    # (a) The weights: numpy init and calibration, the module built block by
    # block, then the logit maxima at 420 px on the card.
    t0 = time.perf_counter()
    params = bench_weights.realistic_params(0, vit_cfg)
    t_params = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = module_from_jax_params(params, vit_cfg, device)
    del params
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe = torch.as_tensor(bench_weights._probe_images(420, 1), device=device)
    maxima = bench_weights.model_logit_maxima(model, probe).tolist()
    t_probe = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    res["weights"] = dict(params_seconds=t_params, module_seconds=t_model, probe_seconds=t_probe,
                          attn_logit_max_420px=max(maxima), parameters=n_params)
    log(12, f"(a) ViT-G/14-reg weights ({n_params / 1e9:.3f} B parameters): realistic_params "
            f"{t_params:.1f} s (numpy init and calibration), module on the card block by block "
            f"{t_model:.1f} s; attention logit max at 420 px {max(maxima):.2f} over {len(maxima)} "
            f"layers "
            f"(tol < 99, the capped window; torch on the card, {t_probe:.2f} s)")
    check(max(maxima) < 99.0, f"attention logits {max(maxima)} leave the capped window")

    with torch.no_grad():
        # (b) Kernel against twin on real activations through all 40 layers.
        gen = torch.Generator(device=device).manual_seed(11)
        crops = torch.rand(16, 420, 420, 3, generator=gen, device=device)
        x0, _ = dinov2.embed_tokens(model, inference.preprocess_crops(crops, config))
        res["kernel"] = block_vs_twin(torch, model, vit_cfg, x0, 12)
        del x0, crops

        # (c) The main path.
        repre = realistic_repre(0, device, raw_dim=vit_cfg.embed_dim).cast_banks(
            config.compute_dtype)
        res["main_path"] = phase_main_path(torch, model, repre, config, device, 12,
                                           "vitg14 lmo.json", "profile_vitg.txt")
        crops, masks, cams = main_path_inputs(torch, device)
        torch.cuda.synchronize()
        reset_counts()
        inference.pose_from_crops(model, crops, masks, cams, repre, config,
                                  generator=torch.Generator(device=device).manual_seed(1))
        torch.cuda.synchronize()
        one = read_counts()
        res["main_path"]["launches_one_request"] = one
        log(12, f"(c) launches from zero over one request: {one}")
        check(one["vit_block"] == vit_cfg.layer + 1 and one["buddies"] == 1
              and one["ransac_score"] == 1 and one["refine"] == 1,
              f"ViT-G request launches {one}")
        del repre, crops, masks, cams

        # (d) One registration chunk of the builder.
        res["registration"] = vitg_registration(torch, model, device)

    # (e), the tensor-parallel leg, runs after phase 16 on the first two
    # blocks' weights (vitg_tp): its gloo ranks come after every phase that
    # reads torch.profiler.
    tp_state = {k: v.cpu() for k, v in model.state_dict().items()
                if not k.startswith("blocks.") or int(k.split(".")[1]) < VITG_TP_BLOCKS}
    del model
    torch.cuda.empty_cache()
    return res, tp_state


# Phase 13: configs/infer/lmo_vitl.json, DINOv2 ViT-L/14 (no registers,
# 1024 wide, 16 heads of 64, GELU MLP 4096) to the key facet of layer 18:
# 18 fused blocks, then layer 18's qkv as a plain F.linear.
VITL_CONFIG = os.path.join(ROOT, "configs", "infer", "lmo_vitl.json")


def phase_vitl(torch, device):
    """configs/infer/lmo_vitl.json on the card (see the module docstring)."""
    from foundpose_torch.benchmarks import bench
    from foundpose_torch.models import dinov2
    from foundpose_torch.pipeline import inference
    from foundpose_torch.synthetic import realistic_repre

    with open(VITL_CONFIG) as f:
        opts = json.load(f)
    config = inference.inference_config_from_opts(opts)
    vit_cfg = inference.vit_config_from_opts(opts)
    check(not vit_cfg.swiglu and vit_cfg.num_register_tokens == 0 and vit_cfg.facet == "key"
          and (vit_cfg.embed_dim, vit_cfg.num_heads, vit_cfg.mlp_hidden, vit_cfg.layer)
          == (1024, 16, 4096, 18) and vit_cfg.use_fused_block, f"not ViT-L/14 key 18: {vit_cfg}")
    t0 = time.perf_counter()
    model, logit_max = bench.calibrated_model(vit_cfg, device)  # raises at a logit >= 99
    res = {"weights": dict(seconds=time.perf_counter() - t0, attn_logit_max_420px=logit_max)}
    log(13, f"ViT-L/14 weights: calibrated and built on the card in {res['weights']['seconds']:.1f} "
            f"s; attention logit max at 420 px {logit_max:.2f} (tol < 99)")

    with torch.no_grad():
        # (a) Kernel 1's GELU body against its twin through the 18 fused
        # layers; the feature maps compared are the key facet's.
        gen = torch.Generator(device=device).manual_seed(11)
        crops = torch.rand(16, 420, 420, 3, generator=gen, device=device)
        x0, _ = dinov2.embed_tokens(model, inference.preprocess_crops(crops, config))
        check(x0.shape[1] == 901, f"{x0.shape[1]} tokens")
        res["kernel"] = block_vs_twin(torch, model, vit_cfg, x0, 13)
        del x0, crops

        # (b) A request at batch 16, as phase 3.
        repre = realistic_repre(0, device, raw_dim=vit_cfg.embed_dim).cast_banks(
            config.compute_dtype)
        res["main_path"] = phase_main_path(torch, model, repre, config, device, 13,
                                           "vitl14 lmo_vitl.json", "profile_vitl.txt")
        crops, masks, cams = main_path_inputs(torch, device)
        torch.cuda.synchronize()
        reset_counts()
        inference.pose_from_crops(model, crops, masks, cams, repre, config,
                                  generator=torch.Generator(device=device).manual_seed(1))
        torch.cuda.synchronize()
        one = read_counts()
        res["main_path"]["launches_one_request"] = one
        log(13, f"(b) launches from zero over one request: {one}")
        check(one["vit_block"] == dinov2.facet_depth(vit_cfg) == 18 and one["buddies"] == 1
              and one["ransac_score"] == 1 and one["refine"] == 1,
              f"ViT-L request launches {one}")
    del model, repre
    torch.cuda.empty_cache()
    return res


# Phase 19: kernel 1 at DINOv3 ViT-7B/16, on the operands pose_from_crops
# gives it in the benchmark's cell dinov3vit7b16_offline_b32 (that cell's
# configuration, weights from the cell's own recipe, a batch of 32).
DINOV3_CONFIG = os.path.join(ROOT, "perfbench", "configs", "lmo_dinov3vit7b16.json")
DINOV3_BATCH = 32
DINOV3_WEIGHTS_SEED = 2147500019


def library_rotation(torch, x, rope, num_heads, head_dim):
    """A callable: the rotation of q and k as PyTorch calls in x's dtype
    (x cos + rotate_half(x) sin on the tables tiled to the head) over
    seeded q and k of x's [B, T] and `rope`'s tokens, the library's
    counterpart of the rotation kernel 1's qkv GEMM folds in."""
    cos, sin, prefix = rope
    b, t, _ = x.shape
    half = head_dim // 2
    gen = torch.Generator(device=x.device).manual_seed(1)
    qk = torch.randn(b, t - prefix, 2, num_heads, head_dim, generator=gen,
                     device=x.device).to(x.dtype)
    c, s_ = (torch.cat([a, a], dim=-1)[None, :, None, None].to(x.dtype) for a in (cos, sin))
    return lambda: qk * c + torch.cat([-qk[..., half:], qk[..., :half]], dim=-1) * s_


def dinov3_pieces(torch, x0, p, vit_cfg, rope, split):
    """Kernel 1's three DINOv3 launches on layer 0's operands: LayerNorm at
    the 7B width, the qkv GEMM with RoPE (EPI_QKV_ROPE) and attention at
    heads of 128. For each, its device ms in `split` (block_split's
    launches, or None where torch.profiler lost kernels), the CUDA-event ms
    of the twin's code for it and of the PyTorch calls that compute the
    same function, and its bound."""
    from foundpose_torch.ops import vit_block as vb

    F = torch.nn.functional
    b, t, d = x0.shape
    m, h, hd, eps = b * t, vit_cfg.num_heads, vit_cfg.head_dim, vit_cfg.layer_norm_eps
    kernel_ms = {r["launch"]: r["ms"] for r in split} if isinstance(split, list) else {}
    xn = vb.layer_norm(x0, p["norm1_scale"], p["norm1_bias"], eps)
    q, k, v = vb.plain_qkv(xn, p, h, hd, rope)
    q16, k16, v16 = (a.to(x0.dtype) for a in (q, k, v))
    w = p["qkv_weight"]
    rotate = library_rotation(torch, x0, rope, h, hd)
    cos, sin, _ = rope
    pieces = {
        "layernorm_4096": dict(
            launch="LN1", kernel_name="layernorm_kernel<32>",
            twin=lambda: vb.layer_norm(x0, p["norm1_scale"], p["norm1_bias"], eps),
            library=lambda: F.layer_norm(x0, (d,), p["norm1_scale"], p["norm1_bias"], eps),
            library_is="F.layer_norm", flops=0, bytes=2 * nbytes(x0)),
        "qkv_rope_gemm": dict(
            launch="qkv GEMM", kernel_name="gemm_kernel<5> (EPI_QKV_ROPE)",
            twin=lambda: vb.plain_qkv(xn, p, h, hd, rope),
            library=lambda: (F.linear(xn, w, p["qkv_bias"]), rotate()),
            library_is="F.linear, then the rotation of q and k (library_rotation)",
            flops=2 * m * d * 3 * d,
            bytes=nbytes(xn, w, p["qkv_bias"], cos, sin) + m * 3 * d * x0.element_size()),
        "attention_hd128": dict(
            launch="attention", kernel_name="attention_kernel<128, ·>",
            twin=lambda: vb.plain_attention(q, k, v, t, vit_cfg.softmax_stabilizer, x0.dtype),
            library=lambda: F.scaled_dot_product_attention(q16, k16, v16),
            library_is="scaled_dot_product_attention", flops=4 * b * h * t * t * hd,
            bytes=nbytes(q16, k16, v16) + nbytes(x0)),
    }
    res = {}
    for name, pc in pieces.items():
        bms, by = bound(pc["flops"], pc["bytes"], "bf16")
        ms = kernel_ms.get(pc["launch"])
        res[name] = dict(
            kernel=pc["kernel_name"], ms=ms, plain_ms=cuda_ms(torch, pc["twin"]),
            library_ms=cuda_ms(torch, pc["library"]), library_is=pc["library_is"],
            bound_ms=bms, bound_by=by, share=None if ms is None else bms / ms,
            max_abs_err=None)
    return res


def phase_dinov3(torch, device, opts=None, batch=DINOV3_BATCH):
    """Phase 19 (see the module docstring): kernel 1 at DINOv3 ViT-7B/16."""
    from foundpose_torch.models import dinov2, dinov3
    from foundpose_torch.ops.vit_block import fused_vit_block, fused_vit_block_plain
    from foundpose_torch.pipeline import inference
    from foundpose_torch.structs import PinholeCamera
    from foundpose_torch.synthetic import realistic_repre
    from perfbench import models as families

    if opts is None:
        with open(DINOV3_CONFIG) as f:
            opts = json.load(f)["infer_opts"]
    config = inference.inference_config_from_opts(opts)
    vit_cfg = inference.vit_config_from_opts(opts)
    fam = families.family("dinov3")
    t0 = time.perf_counter()
    model, _, _ = fam.program(fam.make_weights(fam.shape(opts), DINOV3_WEIGHTS_SEED, device),
                              opts, device)
    torch.cuda.synchronize()
    res = {"weights_seconds": time.perf_counter() - t0}
    crop = config.crop_size[0]
    gen = torch.Generator(device=device).manual_seed(19)
    crops = torch.randint(0, 256, (batch, crop, crop, 3), dtype=torch.uint8, generator=gen,
                          device=device)
    x0, (gh, gw) = dinov3.embed_tokens(model, inference.preprocess_crops(crops, config))
    rope = (*dinov3.rope_tables(gh, gw, device, vit_cfg.head_dim, vit_cfg.rope_base),
            1 + vit_cfg.storage_tokens)
    log(19, f"DINOv3 {vit_cfg.variant}: the cell's weights (seed {DINOV3_WEIGHTS_SEED}) made on "
            f"the card in {res['weights_seconds']:.1f} s; x0 {list(x0.shape)} bf16, "
            f"{vit_cfg.num_heads} heads of {vit_cfg.head_dim}, RoPE tables "
            f"{list(rope[0].shape)}, prefix {rope[2]}")

    with torch.no_grad():
        # (a) The block with RoPE through the facet's layers, against the twin.
        res["kernel"] = block_vs_twin(torch, model, vit_cfg, x0, 19, rope=rope, f32_chain=True)
        # (b) The same gates on layer 0 without RoPE (EPI_QKV at heads of 128).
        p0 = model.blocks[0].kernel_params(torch.bfloat16)
        kw = dict(seq_len=x0.shape[1], num_heads=vit_cfg.num_heads, head_dim=vit_cfg.head_dim,
                  eps=vit_cfg.layer_norm_eps, softmax_stabilizer=vit_cfg.softmax_stabilizer)

        def branch_err(got, ref):
            return float(torch.linalg.vector_norm((got - ref).float())
                         / torch.linalg.vector_norm((ref - x0).float()))

        y_plain = fused_vit_block(x0, p0, **kw)
        plain_err = branch_err(y_plain, fused_vit_block_plain(x0, p0, **kw))
        plain_ms = cuda_ms(torch, lambda: fused_vit_block(x0, p0, **kw))
        # (c) A wrong rotation fails the branch gate: the kernel with RoPE
        # against the twin with none, with the opposite angle and with the
        # grid's two axes swapped.
        y = fused_vit_block(x0, p0, rope=rope, **kw)
        cos, sin, prefix = rope
        half = cos.shape[1] // 2
        swap = torch.cat([torch.arange(half, 2 * half), torch.arange(half)]).to(device)
        wrong = {"none": None, "opposite angle": (cos, -sin, prefix),
                 "axes swapped": (cos[:, swap].contiguous(), sin[:, swap].contiguous(), prefix)}
        wrong_err = {name: branch_err(y, fused_vit_block_plain(x0, p0, rope=r, **kw))
                     for name, r in wrong.items()}
        right_err = branch_err(y, fused_vit_block_plain(x0, p0, rope=rope, **kw))
        res.update(no_rope=dict(branch_rel_l2=plain_err, ms=plain_ms),
                   wrong_rotation_branch_rel_l2=wrong_err, rope_branch_rel_l2=right_err)
        log(19, f"(b) layer 0 without RoPE: branch rel L2 {plain_err:.2e} (tol {BRANCH_REL_L2}), "
                f"{plain_ms:.3f} ms (with RoPE {res['kernel']['ms']:.3f}); (c) the kernel with "
                f"RoPE against the twin with a wrong rotation, branch rel L2: "
                + ", ".join(f"{k} {v:.3f}" for k, v in wrong_err.items())
                + f" (the right one {right_err:.2e}; each wrong one must exceed {BRANCH_REL_L2})")
        check(plain_err <= BRANCH_REL_L2, f"layer 0 without RoPE: branch rel L2 {plain_err}")
        check(all(v > BRANCH_REL_L2 for v in wrong_err.values()),
              f"a wrong rotation passes the branch gate: {wrong_err}")
        # (d) Kernel 1's three new launches, timed beside the twin and library.
        res["pieces"] = dinov3_pieces(torch, x0, p0, vit_cfg, rope, res["kernel"].get("split"))
        log(19, "(d) " + "; ".join(
            f"{k} ({v['kernel']}): kernel " + ("not measured" if v["ms"] is None
                                               else f"{v['ms']:.4f}") + f" ms, twin "
            f"{v['plain_ms']:.3f}, library {v['library_ms']:.4f} ({v['library_is']}), bound "
            f"{v['bound_ms']:.4f} ({v['bound_by']})"
            + ("" if v["share"] is None else f", {100 * v['share']:.1f}%")
            for k, v in res["pieces"].items()))
        del x0, y, y_plain

        # (e) Launches from zero over one batch of the cell's step.
        repre = realistic_repre(0, device, raw_dim=vit_cfg.embed_dim).cast_banks(
            config.compute_dtype)
        masks = torch.ones(batch, crop, crop, device=device)
        cams = PinholeCamera(
            f=torch.full((batch, 2), 600.0, device=device),
            c=torch.full((batch, 2), crop / 2 - 0.5, device=device),
            T_world_from_eye=torch.eye(4, device=device).expand(batch, 4, 4).contiguous(),
            width=crop, height=crop)
        torch.cuda.synchronize()
        reset_counts()
        fused_vit_block.rope_launches = 0
        builds = dinov3.rope_tables.builds
        out = inference.pose_from_crops(model, crops, masks, cams, repre, config,
                                        generator=torch.Generator(device=device).manual_seed(1))
        torch.cuda.synchronize()
        launches = dict(read_counts(), rope_launches=fused_vit_block.rope_launches)
        res["launches"] = launches
        res["rope_tables_builds"] = dinov3.rope_tables.builds - builds
        log(19, f"(e) launches from zero over one batch of {batch}: {launches}; RoPE tables "
                f"built {res['rope_tables_builds']} times (cached)")
        depth = dinov2.facet_depth(vit_cfg)
        check_launches(read_counts(), dict(vit_block=depth, buddies=1, ransac_dlt=1, ransac_score=1,
                                           refine=1), "dinov3 batch")
        check(launches["rope_launches"] == depth and res["rope_tables_builds"] == 0,
              f"rope launches {launches['rope_launches']}, table builds "
              f"{res['rope_tables_builds']}")
        check(bool(torch.isfinite(out.R_m2c).all()), "dinov3 batch: poses not finite")
    del model, repre
    torch.cuda.empty_cache()
    return res


# Phase 14: the bench layer's three entry points, called in this process.
VITL_EXTRACTOR = "dinov2_version=vitl14_stride=14_facet=key_layer=18_norm=1"
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_crops_per_sec",
              "baseline_method", "batch", "extractor", "mfu", "flops_per_step_analytic",
              "weight_source", "attn_logit_max", "card", "stage_ms_per_batch",
              "device_crops_per_sec", "flops_per_step_cost_analysis"}
LATENCY_KEYS = {"metric", "unit", "reps", "note", "per_batch", "card"}
LATENCY_BATCH_KEYS = {"device_ms_per_step", "fused_device_ms_time_to_pose",
                      "device_crops_per_sec", "engine_wall_ms_p50", "engine_wall_ms_p95",
                      "engine_wall_ms_min"}
LAT_REPS = 20


def captured_operands(step):
    """The arguments one call of `step()` passes to the buddies kernel, to
    the hypotheses kernel, to the scorer and to the LO/LM refinement, by
    kernel name: cycle_distances' five operands, score_hypotheses' as (a
    dict of its operands, the inlier threshold), and dlt_hypotheses' and
    refine_lo_lm's as a dict of all their arguments."""
    import inspect

    from foundpose_torch.pose import corresp, pnp

    got = {}
    originals = (corresp.cycle_distances, pnp.score_hypotheses, pnp.refine_lo_lm,
                 pnp.dlt_hypotheses)

    class Grab:
        """Records a wrapper's arguments and calls it; its attributes (the
        launch count the wrapper adds to through its module's name) are
        the wrapper's own."""

        def __init__(self, name, fn):
            self.__dict__.update(name=name, fn=fn)

        def __call__(self, *args, **kwargs):
            got[self.name] = inspect.signature(self.fn).bind(*args, **kwargs).arguments
            return self.fn(*args, **kwargs)

        def __getattr__(self, attr):
            return getattr(self.fn, attr)

        def __setattr__(self, attr, value):
            setattr(self.fn, attr, value)

    corresp.cycle_distances = Grab("buddies", originals[0])
    pnp.score_hypotheses = Grab("ransac_score", originals[1])
    pnp.refine_lo_lm = Grab("refine", originals[2])
    pnp.dlt_hypotheses = Grab("ransac_dlt", originals[3])
    try:
        step()
    finally:
        (corresp.cycle_distances, pnp.score_hypotheses, pnp.refine_lo_lm,
         pnp.dlt_hypotheses) = originals
    ops = dict(got["ransac_score"])
    thr = ops.pop("inlier_thresh")
    return {"buddies": tuple(got["buddies"].values()), "ransac_score": (ops, thr),
            "refine": dict(got["refine"]), "ransac_dlt": dict(got["ransac_dlt"])}


def bench_kernels(torch, s, label):
    """Kernels 1-3 against their twins on what the bench step at its batch
    gives them, with phase 2's gates: the block through the facet's layers
    on the step's own crops, the buddies and the scorer on the operands one
    step passes them; then the launches from zero over one step (the
    facet's blocks, buddies 1, hypotheses 1, scorer 1, refinement 1,
    nothing else)."""
    from foundpose_torch.models import dinov2
    from foundpose_torch.pipeline import inference

    x0, _ = dinov2.embed_tokens(s.model, inference.preprocess_crops(s.crops, s.config))
    # No launch split here: at [128, 901, 1024] torch.profiler kept 33 of
    # 5 calls' 35 kernels on both of block_split's tries, in a process of
    # its own (phase 13 splits the ViT-L layer at batch 16).
    res = {"vit_block": block_vs_twin(torch, s.model, s.vit_cfg, x0, 14, split=False)}
    del x0
    ops = captured_operands(s.step)
    res["buddies"] = buddies_vs_twin(torch, *ops["buddies"], 14)
    res["ransac_score"] = scorer_check(torch, *ops["ransac_score"], 14,
                                       f"(bench {label} step's operands)")
    del ops
    torch.cuda.synchronize()
    reset_counts()
    s.step()
    torch.cuda.synchronize()
    launches = read_counts()
    log(14, f"bench {label} batch {s.batch}: launches from zero over one step {launches}")
    check_launches(launches, dict(vit_block=dinov2.facet_depth(s.vit_cfg), buddies=1,
                                  ransac_dlt=1, ransac_score=1, refine=1), f"bench {label} step")
    res["launches"] = launches
    return res


def phase_bench(torch):
    """The bench twins on the card (see the module docstring)."""
    from foundpose_torch.benchmarks import bench, featuremetric_bench, latency

    res = {}
    for label, extractor in (("vits14", bench.DEFAULT_EXTRACTOR), ("vitl14", VITL_EXTRACTOR)):
        t0 = time.perf_counter()
        setup = bench.prepare(batch=128, extractor=extractor)
        with torch.no_grad():
            kernels = bench_kernels(torch, setup, label)
        t1 = time.perf_counter()
        r = bench.measure(setup, stages=True)
        del setup
        torch.cuda.empty_cache()
        r["seconds"] = time.perf_counter() - t0
        res[f"bench {label} b128"] = r
        res[f"kernels {label} b128"] = dict(kernels, seconds=t1 - t0)
        times = [r["value"], r["device_crops_per_sec"], *r["stage_ms_per_batch"].values()]
        log(14, f"bench {label} batch 128: {r['value']:.2f} crops/s ({128e3 / r['value']:.2f} ms a "
                f"step), mfu {r['mfu']:.4f}, stages ms "
                + ", ".join(f"{k} {v:.2f}" for k, v in r["stage_ms_per_batch"].items())
                + f" (device-only {r['device_crops_per_sec']:.1f} crops/s), attn logit max "
                  f"{r['attn_logit_max']:.2f}; {r['seconds']:.1f} s ({t1 - t0:.1f} s set-up and "
                  "kernel checks)")
        check(set(r) - {"seconds"} == BENCH_KEYS, f"bench keys {sorted(r)}")
        check(r["attn_logit_max"] < 99.0 and 0.0 < r["mfu"] <= 1.0
              and all(np.isfinite(times)), f"bench {label}: {r}")
    t0 = time.perf_counter()
    lat = latency.run(reps=LAT_REPS)
    lat["seconds"] = time.perf_counter() - t0
    res["latency"] = lat
    log(14, f"latency (LAT_REPS={LAT_REPS}): " + "; ".join(
        f"b{b}: wall p50 {v['engine_wall_ms_p50']:.2f} p95 {v['engine_wall_ms_p95']:.2f} min "
        f"{v['engine_wall_ms_min']:.2f} ms, device step {v['device_ms_per_step']:.2f} ms, "
        f"time-to-pose {v['fused_device_ms_time_to_pose']:.2f} ms"
        for b, v in lat["per_batch"].items()) + f"; {lat['seconds']:.1f} s")
    check(set(lat) - {"seconds"} == LATENCY_KEYS and sorted(lat["per_batch"]) == [1, 8, 16]
          and all(set(v) == LATENCY_BATCH_KEYS and all(np.isfinite(list(v.values())))
                  for v in lat["per_batch"].values()), f"latency report {lat}")
    t0 = time.perf_counter()
    fm = featuremetric_bench.run()
    fm["seconds"] = time.perf_counter() - t0
    res["featuremetric"] = fm
    want = {"metric", "refine_iters", "card"} | {
        f"{k}_b{b}" for b in featuremetric_bench.BATCHES
        for k in ("crops_per_sec_off", "crops_per_sec_on", "ms_per_batch_off", "ms_per_batch_on",
                  "refine_ms_per_batch", "peak_mem_bytes_off", "peak_mem_bytes_on")}
    log(14, "featuremetric: " + "; ".join(
        f"b{b}: off {fm[f'crops_per_sec_off_b{b}']:.1f} on {fm[f'crops_per_sec_on_b{b}']:.1f} "
        f"crops/s, refine {fm[f'refine_ms_per_batch_b{b}']:.2f} ms a batch, peak "
        f"{fm[f'peak_mem_bytes_off_b{b}'] / 2**20:.0f} / {fm[f'peak_mem_bytes_on_b{b}'] / 2**20:.0f} "
        "MiB" for b in featuremetric_bench.BATCHES) + f"; {fm['seconds']:.1f} s")
    check(set(fm) - {"seconds"} == want and all(
        np.isfinite(v) for k, v in fm.items() if k not in ("metric", "card")),
        f"featuremetric report {fm}")
    return res


# Phase 15: BASELINE.json config 5 (the multi-dataset sweep). Each
# dataset's split holds SWEEP_IMAGES images with SWEEP_DETS detections of
# each of its objects (data/bop.OBJECT_IDS: TUD-L 3, YCB-V 21, T-LESS 30).
# SWEEP_REPRES distinct LM-O-scale representations are written and every
# object's directory links to one of them, round-robin (2.6 GB on disk in
# place of 46 GB for 54 objects); every object is still loaded as its own
# copy. Each representation's first templates are the crops of its
# objects' detections, so those detections can solve.
SWEEP_DATASETS = ("tudl", "ycbv", "tless")
SWEEP_IMAGES, SWEEP_DETS, SWEEP_REPRES = 2, 2, 3
DATASET_CONFIGS = {ds: os.path.join(ROOT, "configs", "infer", f"{ds}.json")
                   for ds in SWEEP_DATASETS}
# The 30-object mixed load's peak after the repair (bf16 banks loaded
# object by object, then stacked: ~26 GB reckoned; the parent's path held
# ~64 GB).
MIXED_PEAK_LIMIT_BYTES = 30e9


def measured_run(torch, fn, opts, **kw):
    """What fn(opts, **kw), an infer entry point, took: the host-clock wall,
    counts and detections solved, launches from zero, each load_repre's seconds
    (load and copy to the card, between synchronizes), the peak memory
    from a reset at the call to the first batch's dispatch and over the
    whole call, and the memory held at the first dispatch."""
    from foundpose_torch.pipeline import infer

    loads, first = [], {}
    orig_load, orig_dispatch = infer.load_repre, infer.dispatch_batch

    def timed_load(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_load(*args, **kwargs)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        return out

    def probed_dispatch(*args, **kwargs):
        if not first:
            first.update(peak_before_first_batch_bytes=torch.cuda.max_memory_allocated(),
                         held_at_first_batch_bytes=torch.cuda.memory_allocated())
        return orig_dispatch(*args, **kwargs)

    infer.load_repre, infer.dispatch_batch = timed_load, probed_dispatch
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with CapturedRuns() as cap:
            t0 = time.perf_counter()
            counts = fn(opts, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        infer.load_repre, infer.dispatch_batch = orig_load, orig_dispatch
    crops = sum(counts.values())
    successes = sum(r["success"] for res in cap.results.values() for _, r in res)
    return dict(wall_s=wall, crops=crops, crops_per_s=crops / wall, successes=successes,
                counts={str(k): v for k, v in counts.items()}, launches=read_counts(),
                load_s=loads, peak_bytes=torch.cuda.max_memory_allocated(), **first)


def batches_of(counts, multi=False):
    """Batches of 16 the runner dispatched: one object's crops at a time,
    or all objects' together (`multi`)."""
    if multi:
        return -(-sum(counts.values()) // 16)
    return sum(-(-n // 16) for n in counts.values())


def write_datasets(torch, root, params, vit_cfg, device):
    """The three splits (detections under root/dets/<dataset>.json, as
    pipeline/sweep reads them), the weights, SWEEP_REPRES crop-world
    representations and every object's link to one. Returns the weights'
    path, the tless.json model and configuration, and each dataset's
    options at its own configuration."""
    from foundpose_torch.data import bop
    from foundpose_torch.models.weights import state_dict_from_jax_params
    from foundpose_torch.pipeline import infer
    from foundpose_torch.repre import save_repre
    from foundpose_torch.utils import config as config_util

    weights = os.path.join(root, "vits14_reg.pth")
    torch.save(state_dict_from_jax_params(params, vit_cfg), weights)
    opts = {}
    for i, ds in enumerate(SWEEP_DATASETS):
        write_split(torch, root, seed=10 + i, n_images=SWEEP_IMAGES, dataset=ds,
                    lids=bop.OBJECT_IDS[ds], dets=SWEEP_DETS,
                    det_path=os.path.join(root, "dets", f"{ds}.json"))
        opts[ds] = config_util.load_opts(infer.InferOpts, [
            "--opts-path", DATASET_CONFIGS[ds], "--set", f"bop_root={root}/bop",
            "--set", f"repre_dir={root}/repre", "--set",
            f"detections_path={root}/dets/{ds}.json", "--set", f"weights_path={weights}",
            "--set", f"output_dir={root}/out_{ds}"])
    model, config = infer.load_model(opts["tless"], device)
    keys = [(1, i) for i in range(SWEEP_IMAGES)]
    objects = [(ds, lid) for ds in SWEEP_DATASETS for lid in bop.OBJECT_IDS[ds]]
    for g in range(SWEEP_REPRES):
        crops = [c for ds, lid in objects[g::SWEEP_REPRES]
                 for c in object_crops(opts[ds], lid, keys)]
        save_repre(crop_world_repre(torch, model, config, crops, 20 + g, device),
                   os.path.join(root, "repre_src", str(g)))
        del crops
    for i, (ds, lid) in enumerate(objects):
        d = os.path.join(root, "repre", ds, "v1")
        os.makedirs(d, exist_ok=True)
        os.symlink(os.path.join(root, "repre_src", str(i % SWEEP_REPRES)),
                   os.path.join(d, str(lid)))
    torch.cuda.synchronize()
    return weights, model, config, opts


def phase_datasets(torch, params, vit_cfg, device):
    """BASELINE.json config 5 on the card (see the module docstring)."""
    import tempfile

    from foundpose_torch.data import bop
    from foundpose_torch.pipeline import infer
    from foundpose_torch.pipeline import sweep as sweep_mod
    from foundpose_torch.repre import save_repre

    res = {}
    with tempfile.TemporaryDirectory(prefix="foundpose_datasets_") as root:
        t0 = time.perf_counter()
        weights, model, config, opts = write_datasets(torch, root, params, vit_cfg, device)
        res["setup_s"] = time.perf_counter() - t0
        log(15, f"splits {', '.join(SWEEP_DATASETS)} ({SWEEP_IMAGES} images, {SWEEP_DETS} "
                f"detections of each object per image), {SWEEP_REPRES} LM-O-scale crop-world "
                f"representations linked round-robin to 54 objects: {res['setup_s']:.1f} s")

        # (a) pipeline/sweep as the JAX package defines it: InferOpts'
        # defaults (unfused f32 ViT, exact top-k), not the datasets' configs.
        runs, orig_infer = {}, infer.infer

        def per_dataset(o, **kw):
            runs[o.object_dataset] = measured_run(torch, orig_infer, o, **kw)
            return {int(k): v for k, v in runs[o.object_dataset]["counts"].items()}

        sweep_opts = sweep_mod.SweepOpts(
            datasets=list(SWEEP_DATASETS), weights_path=weights, bop_root=f"{root}/bop",
            repre_dir=f"{root}/repre", detections_dir=f"{root}/dets",
            output_dir=f"{root}/out_sweep")
        infer.infer = per_dataset
        try:
            t0 = time.perf_counter()
            csvs = sweep_mod.sweep(sweep_opts)
            sweep_s = time.perf_counter() - t0
        finally:
            infer.infer = orig_infer
        res["sweep"] = dict(wall_s=sweep_s, datasets=runs)
        for ds in SWEEP_DATASETS:
            r = runs[ds]
            nb = batches_of(r["counts"])
            with open(csvs[ds]) as f:
                rows = len(f.read().strip().split("\n")) - 1
            r.update(batches=nb, csv_rows=rows)
            log(15, f"(a) sweep {ds} (InferOpts defaults: unfused f32 ViT, exact top-k, RANSAC "
                    f"200): {r['crops']} crops in {nb} batches, {r['wall_s']:.2f} s -> "
                    f"{r['crops_per_s']:.1f} crops/s (host clock); loads {len(r['load_s'])} x "
                    f"{np.mean(r['load_s']):.3f} s (min {min(r['load_s']):.3f}, max "
                    f"{max(r['load_s']):.3f}); peak {r['peak_bytes'] / 2**30:.2f} GiB; "
                    f"{r['successes']} solved, CSV {rows} rows; launches {r['launches']}")
            check(sorted(int(k) for k in r["counts"]) == bop.OBJECT_IDS[ds]
                  and rows == r["successes"], f"sweep {ds}: {r['counts']}, {rows} CSV rows for "
                  f"{r['successes']} solved")
            check_launches(r["launches"], dict(attention=10 * nb, ransac_dlt=nb, ransac_score=nb,
                                               refine=nb), f"sweep {ds}")
        check(sum(runs[ds]["successes"] for ds in SWEEP_DATASETS) > 0, "no detection solved")

        # (b) each dataset's own configuration: infer at tudl.json and
        # ycbv.json, infer_multi_object at tless.json over all 30 objects.
        for ds in SWEEP_DATASETS:
            multi = ds == "tless"
            fn = infer.infer_multi_object if multi else infer.infer
            r = measured_run(torch, fn, opts[ds])
            nb = batches_of(r["counts"], multi)
            r["batches"] = nb
            res[f"{ds}.json"] = r
            what = "infer_multi_object" if multi else "infer"
            log(15, f"(b) {what} {os.path.relpath(DATASET_CONFIGS[ds], ROOT)} over "
                    f"{len(r['counts'])} objects: {r['crops']} crops in {nb} batches, "
                    f"{r['wall_s']:.2f} s -> {r['crops_per_s']:.1f} crops/s; loads "
                    f"{len(r['load_s'])} x {np.mean(r['load_s']):.3f} s (max "
                    f"{max(r['load_s']):.3f}); peak before the first batch "
                    f"{r['peak_before_first_batch_bytes'] / 2**30:.2f} GiB, held at it "
                    f"{r['held_at_first_batch_bytes'] / 2**30:.2f} GiB, over the run "
                    f"{r['peak_bytes'] / 2**30:.2f} GiB; {r['successes']} solved; launches "
                    f"{r['launches']}")
            check_launches(r["launches"], dict(vit_block=10 * nb, buddies=nb, ransac_dlt=nb,
                                               ransac_score=nb, refine=nb), f"{what} {ds}.json")
        mixed = res["tless.json"]
        check(len(mixed["counts"]) == 30
              and mixed["peak_before_first_batch_bytes"] < MIXED_PEAK_LIMIT_BYTES,
              f"the 30-object mixed load: {mixed['peak_before_first_batch_bytes'] / 1e9:.2f} GB "
              f"(limit {MIXED_PEAK_LIMIT_BYTES / 1e9:.0f} GB)")

        # Card against CPU at tless.json through infer_multi_object: image
        # 0's first 4 detections (objects 1 and 2), each object's
        # representation a 5-template world of those 4 crops (as phase 9).
        with open(opts["tless"].detections_path) as f:
            first = [d for d in json.load(f) if d["image_id"] == 0][:4]
        cmp_path = os.path.join(root, "dets_cmp.json")
        with open(cmp_path, "w") as f:
            json.dump(first, f)
        lids = sorted({d["category_id"] for d in first})
        cmp_opts = dataclasses.replace(opts["tless"], detections_path=cmp_path, object_lids=lids,
                                       batch_size=4, repre_dir=os.path.join(root, "repre_cmp"))
        pend = [c for lid in lids for c in object_crops(cmp_opts, lid, [(1, 0)])]
        world = crop_world_repre(torch, model, config, pend, 7, device, num_templates=5,
                                 mix=CMP_MIX, knn_k=1)
        for lid in lids:
            save_repre(world, os.path.join(root, "repre_cmp", "tless", "v1", str(lid)))
        del pend, world
        h, k = config.pnp_ransac_iter, config.top_k_buddies
        draws = lambda s: np.random.default_rng(1000 + s).integers(
            0, k, (4, config.top_n_templates, h, 6))
        by_dev = {}
        for dev in ("cuda", "cpu"):
            dev_opts = dataclasses.replace(cmp_opts, output_dir=f"{root}/out_cmp_{dev}", device=dev)
            with CapturedRuns() as cap:
                infer.infer_multi_object(dev_opts, draws_fn=draws)
            by_dev[dev] = [r for lid in lids for _, r in cap.results[lid]]
        res["card_vs_cpu"] = dict(results_card_vs_cpu(
            by_dev["cuda"], by_dev["cpu"], 15, f"infer_multi_object at tless.json on image 0's "
            f"first 4 detections (objects {lids}, 720x540 test_primesense, same draws)"),
            objects=lids)
        del model
    return res


# Phase 16: the measurement entry points of benchmarks/ that phase 14 does
# not run. cli_throughput is cut from its 40 images to CLI_BENCH_IMAGES.
CLI_BENCH_IMAGES = 8
CLI_BENCH_KEYS = {"metric", "value", "unit", "crops", "success_rate", "wall_s", "warmup_wall_s",
                  "setup_s", "images", "batch", "stage_median_s", "card"}


def fmt_ms(v, digits=3):
    """A time, or the "not measured" that stands for it."""
    return f"{v:.{digits}f}" if isinstance(v, float) else v


def check_substages(report, what, expect):
    """Every substage's time finite and positive, its device figures
    finite or "not measured"; the kernel launches of one call of each
    substage in `expect` (name -> {kernel: count}) exactly those."""
    for name, r in report.items():
        check(np.isfinite(r["ms"]) and r["ms"] > 0 and all(
            r[k] == "not measured" or np.isfinite(r[k]) for k in ("device_ms", "host_launches")),
            f"{what} {name}: {r}")
    for name, want in expect.items():
        check_launches(report[name]["kernel_launches"], want, f"{what} {name}, one call")


def phase_micro(torch):
    """The micro-benches, vit_stage_bench and cli_throughput on the card
    (see the module docstring)."""
    from foundpose_torch.benchmarks import (cli_throughput, micro_buddies, micro_pnp,
                                            micro_retrieval, vit_stage_bench)

    res = {}
    for name, run, expect in (
            ("micro_pnp", micro_pnp.run, {
                "ransac_no_lm": dict(ransac_dlt=1, ransac_score=1),
                "ransac_full(+lm)": dict(ransac_dlt=1, ransac_score=1, refine=1)}),
            ("micro_buddies", micro_buddies.run, {"real_match_batch": dict(buddies=1)}),
            ("micro_retrieval", micro_retrieval.run, {})):
        t0 = time.perf_counter()
        reset_counts()
        r = run()
        torch.cuda.synchronize()
        r.update(launches=read_counts(), seconds=time.perf_counter() - t0)
        res[name] = r
        log(16, f"{name}: " + "; ".join(
            f"{k} {v['ms']:.3f} ms, device {fmt_ms(v['device_ms'])} ms, host launches "
            f"{v['host_launches']}" for k, v in r["substages"].items())
            + f"; {r['seconds']:.1f} s")
        check_substages(r["substages"], name, expect)
    check(np.isfinite(res["micro_retrieval"]["segment_vs_onehot_max_abs"]),
          "micro_retrieval's tf-idf forms")
    t0 = time.perf_counter()
    stage, info = vit_stage_bench.prepare()
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        stage()
    torch.cuda.synchronize()
    launches = read_counts()
    check_launches(launches, dict(vit_block=10), "vit_stage_bench, one call")
    r = vit_stage_bench.measure(stage, info)
    r.update(launches=launches, seconds=time.perf_counter() - t0)
    res["vit_stage_bench"] = r
    log(16, f"vit_stage_bench batch {r['batch']} (fused {r['fused']}, {r['stabilizer']}): "
            f"{r['vit_ms_per_batch']:.3f} ms a batch; launches of one call {launches}; "
            f"{r['seconds']:.1f} s")
    check(np.isfinite(r["vit_ms_per_batch"]) and r["vit_ms_per_batch"] > 0, f"vit stage {r}")
    del stage
    t0 = time.perf_counter()
    reset_counts()
    r = cli_throughput.run(images=CLI_BENCH_IMAGES)
    r.update(launches=read_counts(), seconds=time.perf_counter() - t0)
    res["cli_throughput"] = r
    log(16, f"cli_throughput ({CLI_BENCH_IMAGES} images, 4 detections each, batch 64): "
            f"{r['value']:.2f} crops/s ({r['crops']} crops in {r['wall_s']:.2f} s, warm-up pass "
            f"{r['warmup_wall_s']:.2f} s, split and representation {r['setup_s']:.1f} s), "
            f"success rate {r['success_rate']:.3f}; launches over the run {r['launches']}; "
            f"{r['seconds']:.1f} s")
    check(set(r) - {"launches", "seconds"} == CLI_BENCH_KEYS and r["crops"] > 0
          and np.isfinite(r["value"]) and r["value"] > 0, f"cli_throughput report {r}")
    check(all(r["launches"][k] > 0 for k in ("vit_block", "buddies", "ransac_score", "refine")),
          f"cli_throughput launched {r['launches']}")
    return res


# Phase 17: the JAX scripts' defaults (benchmarks/cross_parity.py,
# ransac_sweep.py, lm_iters_sweep.py, select_iter_sweep.py).
PARITY_CROPS = 100
# The sweeps' crops, cut from the JAX scripts' 200 to hold the smoke's
# time: the replica takes ~0.33 s a crop on the card machine's host (cv2
# 4.13's solvePnPRansac, ~196 ms a call alone), where the JAX scripts'
# host took 0.116 s. select_iter_sweep's oracle is the harness's memo of
# lm_iters_sweep's: both sweeps score the same two worlds.
SWEEP_CROPS = 100
# tests/test_cross_parity.py's offline gates.
PARITY_IDF_ATOL, PARITY_DESC_COS = 1e-5, 0.999
ORACLE_AR_MIN = 0.9


def sweep_cells(report):
    """(cell, seed, AR, wall ms, launches) of every cell of a sweep report
    (ransac_sweep's one seed, or the harness's list per seed)."""
    for cell, ars in report["cells"].items():
        walls, launches = report["cell_wall_ms"][cell], report["cell_launches"][cell]
        if not isinstance(ars, list):
            ars, walls, launches = [ars], [walls], [launches]
        for seed, (ar, wall, n) in enumerate(zip(ars, walls, launches)):
            yield cell, seed, ar, wall, n


def phase_parity(torch, device):
    """The cross-parity oracle and the solve sweeps on the card (see the
    module docstring)."""
    from foundpose_torch.benchmarks import (cross_parity, lm_iters_sweep, ransac_sweep,
                                            select_iter_sweep)
    from foundpose_torch.pipeline import inference

    started = time.perf_counter()
    res = {}
    # (d) Kernels 3 and 2 on the operands one fast-leg call passes them, on
    # (a)'s world and queries, at (a)'s 400 hypotheses and at 100.
    rng = np.random.default_rng(0)
    world = cross_parity.make_world(rng, device=device)
    fmaps, masks, _, _ = cross_parity.render_queries(rng, world, PARITY_CROPS, 1000)
    fast = inference.InferenceConfig(top_n_templates=5, top_k_buddies=300, pnp_ransac_iter=400,
                                     compute_dtype=torch.bfloat16, approx_topk=True)
    kern = {}
    for h in (400, 100):
        cfg = dataclasses.replace(fast, pnp_ransac_iter=h)
        torch.cuda.synchronize()
        reset_counts()
        ops = captured_operands(lambda: cross_parity.port_poses(fmaps, masks, world[0], cfg, device))
        launches = read_counts()
        check_launches(launches, dict(buddies=1, ransac_dlt=1, ransac_score=1, refine=1),
                       f"cross-parity fast-leg call at H {h}")
        if h == 400:
            kern["buddies"] = dict(buddies_vs_twin(torch, *ops["buddies"], 17),
                                   launches=launches["buddies"])
        kern[f"ransac_score_h{h}"] = dict(scorer_check(
            torch, *ops["ransac_score"], 17, f"(cross-parity fast leg's operands, H {h})"),
            launches=launches["ransac_score"])
        del ops
    del world, fmaps, masks
    res["kernels"] = kern

    # (a) run_parity at the JAX script's defaults.
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rep = cross_parity.run_parity(n_crops=PARITY_CROPS, device=device, verbose=False)
    torch.cuda.synchronize()
    rep.update(launches=read_counts(), seconds=time.perf_counter() - t0)
    res["parity"] = rep
    log(17, "cross_parity " + json.dumps({k: v for k, v in rep.items() if k != "launches"}))
    log(17, f"cross_parity ({rep['num_templates']} templates, {rep['n_crops']} crops): AR replica "
            f"{rep['ar_replica']:.3f}, port exact {rep['ar_port_exact']:.3f} / fast "
            f"{rep['ar_port_fast']:.3f} (deltas {rep['ar_delta_exact']} / {rep['ar_delta_fast']}, "
            f"tol 0.01); idf max|delta| {rep['idf_max_delta']:.2e} (tol {PARITY_IDF_ATOL}), desc "
            f"cosine min {rep['template_desc_cosine_min']:.7f} (tol {PARITY_DESC_COS}); replica "
            f"{rep['replica_sec_per_crop']} s a crop, offline tf-idf {rep['replica_offline_tfidf_s']} "
            f"s; port wall exact {rep['port_wall_s_exact'] * 1e3:.1f} / fast "
            f"{rep['port_wall_s_fast'] * 1e3:.1f} ms; launches from zero exact "
            f"{rep['launches_exact']}, fast {rep['launches_fast']}, whole run {rep['launches']}; "
            f"{rep['seconds']:.1f} s")
    check(not cross_parity.ar_gate_failed(rep), "cross_parity: an AR delta exceeds 1 point")
    check(rep["idf_max_delta"] < PARITY_IDF_ATOL and rep["template_desc_cosine_min"] > PARITY_DESC_COS,
          "cross_parity: the offline tf-idf disagrees with the replica's")
    check(rep["launches_exact"] == {"buddies": 0, "ransac_dlt": 1, "ransac_score": 1, "refine": 1}
          and rep["launches_fast"] == {"buddies": 1, "ransac_dlt": 1, "ransac_score": 1,
                                       "refine": 1},
          f"cross_parity legs launched {rep['launches_exact']} / {rep['launches_fast']}")
    check_launches(rep["launches"], dict(buddies=1, ransac_dlt=2, ransac_score=2, refine=2),
                   "cross_parity run_parity")

    # (b) featuremetric_leg at 100 crops: tests/test_cross_parity.py's rules.
    reset_counts()
    t0 = time.perf_counter()
    fm = cross_parity.featuremetric_leg(n_crops=PARITY_CROPS, device=device, verbose=False)
    torch.cuda.synchronize()
    fm.update(launches=read_counts(), seconds=time.perf_counter() - t0)
    res["featuremetric"] = fm
    log(17, f"featuremetric_leg ({fm['n_crops']} crops, {fm['num_templates']} templates, exact "
            f"f32): off -> on recall {fm['recall_off']:.3f} -> {fm['recall_on']:.3f}, median rot "
            f"{fm['median_rot_err_deg_off']} -> {fm['median_rot_err_deg_on']} deg, t "
            f"{fm['median_t_err_mm_off']} -> {fm['median_t_err_mm_on']} mm, BOP AR "
            f"{fm['bop_ar_off']} -> {fm['bop_ar_on']}, successes {fm['n_success_off']} -> "
            f"{fm['n_success_on']}; wall {fm['port_wall_s_off'] * 1e3:.1f} / "
            f"{fm['port_wall_s_on'] * 1e3:.1f} ms; launches {fm['launches']}; {fm['seconds']:.1f} s")
    check(fm["n_success_off"] >= 20 and fm["recall_on"] >= fm["recall_off"] - 1.0 / fm["n_crops"]
          and fm["median_rot_err_deg_on"] <= fm["median_rot_err_deg_off"]
          and fm["median_t_err_mm_on"] <= fm["median_t_err_mm_off"],
          "featuremetric refinement did not improve the poses")
    check_launches(fm["launches"], dict(ransac_dlt=2, ransac_score=2, refine=2),
                   "featuremetric_leg")

    # (c) The three sweeps at their JAX defaults but for the crops
    # (SWEEP_CROPS); `picked` is a finding.
    for name, mod in (("ransac_sweep", ransac_sweep), ("lm_iters_sweep", lm_iters_sweep),
                      ("select_iter_sweep", select_iter_sweep)):
        reset_counts()
        t0 = time.perf_counter()
        rep = mod.run(crops=SWEEP_CROPS, device=device)
        torch.cuda.synchronize()
        launches, seconds = read_counts(), time.perf_counter() - t0
        log(17, f"{name} " + json.dumps(rep))
        cells = list(sweep_cells(rep))
        log(17, f"{name}: " + "; ".join(f"{c} seed {sd} AR {ar:.3f} {wall:.1f} ms {n}"
                                        for c, sd, ar, wall, n in cells)
                + f"; oracle {rep['ar_replica_oracle']}, replica {rep['replica_sec_per_crop']} s a "
                  f"crop; picked {rep['picked']}; launches over the sweep {launches}; "
                  f"{seconds:.1f} s")
        oracle = rep["ar_replica_oracle"]
        check(all(np.isfinite(ar) for _, _, ar, _, _ in cells)
              and min(oracle if isinstance(oracle, list) else [oracle]) >= ORACLE_AR_MIN,
              f"{name}: an AR is not finite or the oracle AR is below {ORACLE_AR_MIN}")
        expect = {"buddies": 0, "ransac_dlt": 0, "ransac_score": 0, "refine": 0}
        for cell, _, _, _, n in cells:
            ransac = 2 if cell.startswith("select") and cell != "select0" else 1
            want = {"buddies": 1, "ransac_dlt": ransac, "ransac_score": ransac, "refine": 1}
            check(n == want, f"{name} {cell} launched {n}, expected {want}")
            expect = {k: expect[k] + want[k] for k in want}
        check_launches(launches, expect, name)
        res[name] = dict(rep, launches=launches, seconds=seconds)
    res["seconds"] = time.perf_counter() - started
    log(17, f"phase 17 took {res['seconds']:.1f} s")
    return res


# Phase 18: the ViT parity leg's gate, the JAX package's bound for its full
# forward against transformers (tests/test_dinov2.py); the leg's kernel-4
# launches (the unfused ViT-S to layer 9).
VIT_PARITY_ATOL = 2e-4
VIT_PARITY_LAUNCHES = 10


def first_attention_operands(fn):
    """(fn(), the q, k, v of the first attention call fn makes through
    models/dinov2): the wrapper keeps its own launch count."""
    from foundpose_torch.models import dinov2

    orig, got = dinov2.fused_attention_bhtd, []

    def grab(q, k, v, *args, **kwargs):
        if not got:
            got.append((q, k, v))
        return orig(q, k, v, *args, **kwargs)

    dinov2.fused_attention_bhtd = grab
    try:
        out = fn()
    finally:
        dinov2.fused_attention_bhtd = orig
    return out, got[0]


def finite_positive(values):
    return all(np.isfinite(v) and v > 0 for v in values)


def phase_reference(torch, device, report):
    """The ViT parity leg and the reference replicas on the card (see the
    module docstring)."""
    from foundpose_torch.benchmarks import (bench, builder_full_scale, cross_parity,
                                            reference_baseline, reference_offline_baseline)

    started = time.perf_counter()
    res = {}
    # (a) vit_parity_leg at 518 px: the gate, kernel 4's launches from zero
    # and its operands (layer 0's q, k, v), then kernel 4 against its twin.
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    delta, qkv = first_attention_operands(lambda: cross_parity.vit_parity_leg(device=device))
    torch.cuda.synchronize()
    launches = read_counts()
    leg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    delta_420 = cross_parity.vit_parity_leg(size=420, device=device)
    leg420_s = time.perf_counter() - t0
    log(18, f"vit_parity_leg 518 px, 2 crops: max |delta| {delta:.3e} (tol {VIT_PARITY_ATOL}), "
            f"launches from zero {launches}, {leg_s:.1f} s; 420 px (not gated: the two "
            f"interpolation recipes) {delta_420:.5f}, {leg420_s:.1f} s")
    check(delta <= VIT_PARITY_ATOL, f"vit_parity_leg: the port's ViT and hf_dinov2 differ by "
                                    f"{delta} at 518 px")
    check_launches(launches, dict(attention=VIT_PARITY_LAUNCHES), "vit_parity_leg 518")
    kern = attention_pair(torch, *qkv, "f32", 18)
    del qkv
    res["vit_parity_leg"] = dict(max_delta_native=delta, max_delta_420_interp=delta_420,
                                 launches=launches, seconds=leg_s, seconds_420=leg420_s,
                                 kernel=dict(kern, launches=launches["attention"]))

    # (b) the per-crop replica at its defaults; it runs none of the port's kernels.
    bench_cps = report["bench"]["bench vits14 b128"]["value"]
    reset_counts()
    t0 = time.perf_counter()
    rb = reference_baseline.run(device=device)
    rb.update(launches=read_counts(), seconds=time.perf_counter() - t0)
    check_launches(rb["launches"], {}, "reference_baseline")
    stages = rb["stage_seconds_per_crop"]
    crops_s = {k: rb[k] for k in ("measured_this_host", "adjusted_with_measured_vit",
                                  "adjusted_reference_estimate")}
    rb["bench_vits14_b128_ratio"] = {k: bench_cps / v for k, v in crops_s.items()}
    log(18, "reference_baseline " + json.dumps(rb))
    log(18, f"reference_baseline ({rb['n_crops']} crops, {rb['cpu_count']} cores, "
            f"{rb['card']}): measured {crops_s['measured_this_host']:.3f} crops/s, adjusted "
            f"with the measured ViT {crops_s['adjusted_with_measured_vit']:.3f}, JAX formula "
            f"{crops_s['adjusted_reference_estimate']:.3f}; ViT {stages['vit'] * 1e3:.2f} ms, pnp "
            f"{stages['pnp'] * 1e3:.1f} ms a crop; phase 14's ViT-S bench at batch 128 "
            f"({bench_cps:.2f} crops/s) over each: " + ", ".join(
                f"{k} {v:.2f}x" for k, v in rb["bench_vits14_b128_ratio"].items())
            + f" (the bench's vs_baseline: {bench_cps / bench.REFERENCE_CROPS_PER_SEC:.2f}x over "
              f"{bench.REFERENCE_CROPS_PER_SEC}); {rb['seconds']:.1f} s")
    check(finite_positive([*crops_s.values(), *stages.values()]),
          f"reference_baseline: a figure is not finite and positive: {rb}")
    res["reference_baseline"] = rb

    # (c) the offline replica at its defaults, against phase 10's build of
    # one LM-O-sized object through builder_full_scale.build_object.
    built = report["builder"]["lmo"]["builder_full_scale"]
    port_s = built["gen_templates_s_per_object"] + built["repre_build_s_per_object"]
    reset_counts()
    t0 = time.perf_counter()
    ro = reference_offline_baseline.run(device=device)
    ro.update(launches=read_counts(), seconds=time.perf_counter() - t0)
    check_launches(ro["launches"], {}, "reference_offline_baseline")
    per_object = {
        "measured": ro["gen_templates"]["measured_cpu_s_per_object_excl_render"]
        + ro["gen_repre"]["measured_s_per_object"],
        "adjusted": ro["adjusted_total_s_per_object"],
        "jax_constants": builder_full_scale.REF_GEN_TEMPLATES_S
        + builder_full_scale.REF_GEN_REPRE_S,
    }
    ro["builder_ratio"] = {k: v / port_s for k, v in per_object.items()}
    log(18, "reference_offline_baseline " + json.dumps(ro))
    log(18, f"reference_offline_baseline: s an object measured {per_object['measured']:.1f} "
            f"(gen_templates {ro['gen_templates']['measured_cpu_s_per_object_excl_render']:.1f} "
            f"without the render, gen_repre {ro['gen_repre']['measured_s_per_object']:.1f}), "
            f"adjusted {per_object['adjusted']:.1f} (gen_templates "
            f"{ro['gen_templates']['adjusted_s_per_object']:.1f}, gen_repre "
            f"{ro['gen_repre']['adjusted_s_per_object']:.1f}); ViT "
            f"{ro['gen_repre']['per_template_s']['vit_s'] * 1e3:.2f} ms a template; phase 10's "
            f"build {port_s:.2f} s: each over it " + ", ".join(
                f"{k} {v:.2f}x" for k, v in ro["builder_ratio"].items())
            + f"; {ro['seconds']:.1f} s")
    figures = [*per_object.values(), *ro["gen_templates"]["per_view_cpu_s"].values(),
               *ro["gen_repre"]["per_template_s"].values(), ro["gen_repre"]["pca_s"],
               ro["gen_repre"]["kmeans_s_extrapolated"], ro["gen_repre"]["tfidf_s"]]
    check(finite_positive(figures),
          f"reference_offline_baseline: a figure is not finite and positive: {ro}")
    res["reference_offline_baseline"] = ro
    res["seconds"] = time.perf_counter() - started
    log(18, f"phase 18 took {res['seconds']:.1f} s")
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from foundpose_torch.models import bench_weights
    from foundpose_torch.models.dinov2 import DinoV2
    from foundpose_torch.models.weights import state_dict_from_jax_params
    from foundpose_torch.pipeline import inference
    from foundpose_torch.synthetic import realistic_repre

    started = time.perf_counter()
    device = torch.device("cuda", 0)
    report = {"card": phase_card(torch)}
    report["build"] = phase_build()
    with open(LMO_CONFIG) as f:
        opts = json.load(f)
    config = inference.inference_config_from_opts(opts)
    vit_cfg = inference.vit_config_from_opts(opts)
    params = bench_weights.realistic_params(0, vit_cfg)
    logit_max = float(bench_weights.attention_logit_maxima(
        params, vit_cfg, probe_size=420, probe_batch=1).max())
    check(logit_max < 99.0, f"attention logits {logit_max} leave the capped window")
    model = DinoV2(vit_cfg)
    model.load_state_dict(state_dict_from_jax_params(params, vit_cfg))
    model = model.to(device).eval()
    t0 = time.perf_counter()
    repre = realistic_repre(0, device).cast_banks(config.compute_dtype)
    torch.cuda.synchronize()
    report["setup"] = dict(attn_logit_max_420px=logit_max,
                           repre_seconds=time.perf_counter() - t0)
    with torch.no_grad():
        report["kernels"] = phase_kernels(torch, model, vit_cfg, repre, config, device)
        report["main_path"] = phase_main_path(torch, model, repre, config, device)
        report["world"] = phase_world(torch, config, device)
        with open(LMO_EXACT_CONFIG) as f:
            exact_config = inference.inference_config_from_opts(json.load(f))
        report["world_exact"] = phase_world(torch, exact_config, device)
        with open(LMO_REFINE_CONFIG) as f:
            refine_opts = json.load(f)
        refine_config = inference.inference_config_from_opts(refine_opts)
        check(refine_config.refine_featuremetric
              and refine_config == dataclasses.replace(config, refine_featuremetric=True)
              and inference.vit_config_from_opts(refine_opts) == vit_cfg,
              "lmo_refine.json is not lmo.json with refinement on")
        report["main_path_refine"] = phase_refine(torch, model, repre, refine_config, device,
                                                  report["main_path"])
        report["world_refine"] = phase_world_refine(torch, refine_config, device)
        del model, repre
        report["serving"] = phase_serving(torch, params, device)
        report["probe"] = phase_probe(torch)
        report["cli"] = phase_cli(torch, params, vit_cfg, device,
                                  report["main_path"]["median_latency_s"])
    report["builder"] = phase_builder(torch, params, vit_cfg, device)
    # Phases 13, 12 (a)-(d), 14, 15, 16, 17 and 18 run before phase 12 (e)
    # and phase 11, and 13 before 12: once gloo ranks had been spawned from
    # this process (phase 11, phase 12 (e)), torch.profiler here recorded
    # 13 of a ViT-G layer's 35 device kernels, 16 of a ViT-L layer's and 2
    # of 20 scorer launches, and the launch splits and request profiles
    # need them all.
    report["vitl"] = phase_vitl(torch, device)
    report["dinov3"] = phase_dinov3(torch, device)
    report["vitg"], vitg_tp_state = phase_vitg(torch, device)
    report["bench"] = phase_bench(torch)
    report["datasets"] = phase_datasets(torch, params, vit_cfg, device)
    report["micro"] = phase_micro(torch)
    report["parity"] = phase_parity(torch, device)
    report["reference"] = phase_reference(torch, device, report)
    report["vitg"]["tp"] = vitg_tp(torch, vitg_tp_state, device)
    del vitg_tp_state
    report["mesh"] = phase_mesh(torch, params, vit_cfg, device)
    report["seconds"] = time.perf_counter() - started

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    # Each kernel's launches come from the run of its own path, counted from
    # zero: the lmo.json main path (phase 3), the lmo_exact.json serving path
    # (phase 5), the probe's entry point (phase 6), for attention this
    # slice's path, gen_repre at configs/gen_repre/lmo.json (phase 10), and
    # for the refinement the lmo.json main path's winners (phase 3).
    path_launches = {
        "vit_block": report["main_path"]["launches"]["vit_block"],
        "buddies": report["main_path"]["launches"]["buddies"],
        "ransac_score": report["main_path"]["launches"]["ransac_score"],
        "attention": report["builder"]["lmo"]["launches"]["attention"],
        "micro_mm": report["probe"]["launches"]["mm_int8"],
        "refine": report["main_path"]["launches"]["refine"],
        "ransac_dlt": report["main_path"]["launches"]["ransac_dlt"],
    }
    mesh = report["mesh"]
    by_path = {"lmo.json": report["main_path"]["launches"],
               "lmo_exact.json serving": report["serving"]["launches"],
               "gen_repre lmo.json": report["builder"]["lmo"]["launches"],
               "mesh (1, 1) NCCL lmo.json": mesh["nccl (1, 1) lmo.json"]["launches"],
               "mesh (2, 2) lmo.json, rank 0": mesh["step (2, 2) lmo.json"][0]["launches"],
               "mesh TP (1, 2, 2) lmo_exact.json, rank 0":
                   mesh["TP step (1, 2, 2) lmo_exact.json"][0]["launches"],
               "PoseEngine mesh (2, 2) lmo_exact.json, rank 0":
                   mesh["engine"]["ranks"][0]["launches"],
               "infer mesh [2, 2] lmo.json, rank 0": mesh["cli"]["ranks"][0]["launches"],
               "vitg14 lmo.json": report["vitg"]["main_path"]["launches"],
               "gen_repre vitg14, one registration chunk":
                   report["vitg"]["registration"]["launches"],
               "mesh TP (1, 2, 2) vitg14 layer=1 lmo_exact.json, rank 0":
                   report["vitg"]["tp"]["ranks"][0]["launches"],
               "vitl14 lmo_vitl.json": report["vitl"]["main_path"]["launches"],
               "dinov3 vit7b16 lmo_dinov3vit7b16, one batch of 32": {
                   k: v for k, v in report["dinov3"]["launches"].items() if k != "rope_launches"},
               "PoseEngine lmo_exact.json, one estimate()":
                   report["serving"]["host_syncs_before_fetch"]["lmo_exact.json"]["launches"],
               "PoseEngine lmo.json switches, one estimate()":
                   report["serving"]["host_syncs_before_fetch"]["lmo.json switches"]["launches"],
               "bench vits14 b128, one step": report["bench"]["kernels vits14 b128"]["launches"],
               "bench vitl14 b128, one step": report["bench"]["kernels vitl14 b128"]["launches"],
               **{f"sweep {ds} (InferOpts defaults)":
                  report["datasets"]["sweep"]["datasets"][ds]["launches"] for ds in SWEEP_DATASETS},
               "infer tudl.json": report["datasets"]["tudl.json"]["launches"],
               "infer ycbv.json": report["datasets"]["ycbv.json"]["launches"],
               "infer_multi_object tless.json, 30 objects":
                   report["datasets"]["tless.json"]["launches"],
               "micro_pnp ransac_full(+lm), one call": report["micro"]["micro_pnp"]["substages"][
                   "ransac_full(+lm)"]["kernel_launches"],
               "micro_buddies real_match_batch, one call": report["micro"]["micro_buddies"][
                   "substages"]["real_match_batch"]["kernel_launches"],
               "vit_stage_bench b64, one call": report["micro"]["vit_stage_bench"]["launches"],
               "cross_parity run_parity, exact + fast legs":
                   report["parity"]["parity"]["launches"],
               "cross_parity featuremetric_leg, off + on":
                   report["parity"]["featuremetric"]["launches"],
               **{f"{sw} (every cell)": report["parity"][sw]["launches"]
                  for sw in ("ransac_sweep", "lm_iters_sweep", "select_iter_sweep")},
               "vit_parity_leg 518, one call": report["reference"]["vit_parity_leg"]["launches"]}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        k = report["kernels"][name]
        entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                     launches=path_launches[name], **{key: k[key] for key in keys})
        if name != "micro_mm":
            entry["launches_by_path"] = {path: c[name] for path, c in by_path.items()}
        if "bf16" in k:  # the other dtype of attention (f32 above) and the probe (int8 above)
            entry["bf16"] = {key: k["bf16"][key] for key in keys}
            if name == "micro_mm":
                entry["bf16"]["launches"] = report["probe"]["launches"]["mm_bf16"]
        if "lmo_exact" in k:  # the scorer at lmo_exact.json's 400 hypotheses (lmo.json above)
            entry["lmo_exact"] = {key: k["lmo_exact"][key] for key in keys}
            entry["lmo_exact"]["launches"] = report["serving"]["launches"]["ransac_score"]
        # Kernels 3 and 2 on the operands of one cross-parity fast-leg call
        # (phase 17 (d)), with that call's launches counted from zero.
        for label, k17 in report["parity"]["kernels"].items():
            if label.startswith(name):
                entry[f"cross_parity{label[len(name):]}"] = {
                    key: k17[key] for key in keys + ("launches",)}
        if name in ("refine", "ransac_dlt"):  # at 128 crops (phase 2; 16 above)
            entry["b128"] = {key: k["b128"][key] for key in keys}
            entry["b128"]["launches"] = report["bench"]["kernels vits14 b128"]["launches"][name]
        if name == "attention":  # on the ViT parity leg's [2, 6, 1374, 64] (phase 18)
            k18 = report["reference"]["vit_parity_leg"]["kernel"]
            entry["vit_parity_leg_518"] = {key: k18[key] for key in keys + ("launches",)}
        if name == "vit_block":  # the SwiGLU body at ViT-G/14 (phase 12; GELU above)
            g = report["vitg"]["kernel"]
            entry["swiglu"] = {key: g[key] for key in keys}
            entry["swiglu"]["launches"] = report["vitg"]["main_path"]["launches"]["vit_block"]
            # the GELU body at ViT-L/14 width (phase 13)
            g = report["vitl"]["kernel"]
            entry["gelu_vitl"] = {key: g[key] for key in keys}
            entry["gelu_vitl"]["launches"] = report["vitl"]["main_path"]["launches"]["vit_block"]
            # the SwiGLU body with RoPE at heads of 128, DINOv3 ViT-7B/16 (phase 19),
            # and its three new launches one by one
            g = report["dinov3"]
            entry["dinov3_vit7b16"] = {key: g["kernel"][key] for key in keys}
            entry["dinov3_vit7b16"].update(launches=g["launches"]["vit_block"],
                                           rope_launches=g["launches"]["rope_launches"])
            for piece, row in g["pieces"].items():
                entry[f"dinov3_vit7b16_{piece}"] = dict(
                    {key: row[key] for key in keys},
                    launches=g["launches"]["vit_block"] * (2 if piece.startswith("layernorm")
                                                           else 1))
        kernels.append(entry)
    log(16, f"the whole smoke took {report['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
