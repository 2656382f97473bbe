"""The offline builder at the published LM-O scale on one NVIDIA GPU:
per-stage wall times (counterpart of benchmarks/builder_full_scale.py).

    python -m foundpose_torch.benchmarks.builder_full_scale [--viewpoints 57] \\
        [--rotations 14] [--out DIR] [--batch-size 16]          # needs a CUDA GPU

Runs the per-object offline path end to end: `pipeline.gen_templates`
(57 viewpoints x 14 in-plane rotations = 798 templates of 420 x 420 px at
SSAA 4, host rendering) and `pipeline.gen_repre` (ViT-S/14-reg layer 9
registration on the card, PCA 384 -> 256, 2,048-word k-means, tf-idf
descriptors), with the JAX script's options: a 2-times subdivided
icosphere of 40 mm with positional vertex colours (no BOP data ships),
depths 600-1,200 mm, the fused block with tanh GELU (bf16 on the card,
where the JAX package registers in f32) and bench_weights' random weights
from seed 0, as the CLIs use without a checkpoint. `build_object` times
any pair of options (chip_smoke.py's phase 10 runs it at
configs/gen_templates/lmo.json and configs/gen_repre/lmo.json): the two
stages' walls, gen_repre's `Timer` stages, k-means' init and Lloyd loop
apart (each ended by a device synchronize), and the time under no stage.

Prints one JSON line with the JAX script's keys. `vs_baseline` divides by
the reference replica's seconds per object measured on another host and
adjusted in the reference's favour (BASELINE.md), not on this machine;
`python -m foundpose_torch.benchmarks.reference_offline_baseline` measures
the same replica on the card's own machine, its ViT on the card.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from foundpose_torch.data.ply import Mesh, save_ply
from foundpose_torch.pipeline import gen_repre, gen_templates

OBJ_ID = 1
EXTRACTOR = "dinov2_version=vits14-reg_stride=14_facet=token_layer=9_norm=1"

# The reference's offline seconds per object (the JAX script's constants:
# benchmarks/reference_offline_baseline.py's replica, adjusted in the
# reference's favour; BASELINE.md section offline).
REF_GEN_TEMPLATES_S = 30.1
REF_GEN_REPRE_S = 11.3
BASELINE_METHOD = ("measured replica, reference-favoring (BASELINE.md section offline), on "
                   "another host")


class StageLog:
    """Collects the `Timer` lines ("<stage>: <seconds>s") the builder logs
    while active, and times k-means' init and Lloyd loop (a device
    synchronize before and after each) as "k-means init" and "k-means
    Lloyd"."""

    def __init__(self, device):
        from foundpose_torch.ops import kmeans

        self.device, self.kmeans, self.stages = torch.device(device), kmeans, {}
        self.handler = logging.Handler()
        self.handler.emit = self._emit
        self.logger = logging.getLogger("foundpose_torch")

    def _emit(self, record):
        name, _, sec = record.getMessage().rpartition(": ")
        if name and sec.endswith("s"):
            try:
                self.stages[name] = self.stages.get(name, 0.0) + float(sec[:-1])
            except ValueError:
                pass

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, name, fn):
        def run(*args, **kwargs):
            self._sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self._sync()
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    def __enter__(self):
        self.orig = self.kmeans._kmeanspp_init, self.kmeans._lloyd
        self.kmeans._kmeanspp_init = self._timed("k-means init", self.orig[0])
        self.kmeans._lloyd = self._timed("k-means Lloyd", self.orig[1])
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.kmeans._kmeanspp_init, self.kmeans._lloyd = self.orig
        self.logger.removeHandler(self.handler)


def build_object(tpl_opts: gen_templates.GenTemplatesOpts, repre_opts: gen_repre.GenRepreOpts,
                 model=None) -> Dict[str, Any]:
    """gen_templates, then gen_repre (with `model`, else the options'
    weights) for the options' one object; the stage walls and rates."""
    lid = tpl_opts.object_lids[0]
    t0 = time.perf_counter()
    gen_templates.synthesize_templates(tpl_opts)
    tpl_s = time.perf_counter() - t0
    with open(os.path.join(tpl_opts.output_dir, tpl_opts.object_dataset, tpl_opts.version,
                           str(lid), "metadata.json")) as f:
        num_t = len(json.load(f))
    stages = StageLog(repre_opts.device)
    with stages:
        stages._sync()
        t0 = time.perf_counter()
        gen_repre.generate_repre_from_list(repre_opts, model=model)
        stages._sync()
        repre_s = time.perf_counter() - t0
    timed = {k: v for k, v in stages.stages.items() if not k.startswith("k-means ")}
    reg_s = timed.get("Feature registration")
    return {
        "num_templates": num_t,
        "gen_templates_s_per_object": tpl_s,
        "repre_build_s_per_object": repre_s,
        "value": num_t / (tpl_s + repre_s),
        "render_templates_per_s": num_t / tpl_s,
        "registration_templates_per_s": num_t / reg_s if reg_s else None,
        "gen_repre_stage_s": stages.stages,
        "gen_repre_untimed_s": repre_s - sum(timed.values()),
    }


def make_icosphere(scale: float = 40.0, subdivisions: int = 2) -> Mesh:
    """The JAX script's mesh: a subdivided icosahedron of `scale` mm with
    positional vertex colours."""
    phi = (1 + 5 ** 0.5) / 2
    verts = [np.array(p, np.float64) for p in (
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0], [0, -1, phi], [0, 1, phi],
        [0, -1, -phi], [0, 1, -phi], [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1])]
    faces = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
             [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
             [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(subdivisions):
        mids, new_faces = {}, []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                verts.append((verts[a] + verts[b]) / 2.0)
                mids[key] = len(verts) - 1
            return mids[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        faces = new_faces
    v = np.array(verts)
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * scale
    colors = (v - v.min(0)) / (v.max(0) - v.min(0)) * 255.0
    return Mesh(vertices=v.astype(np.float32), faces=np.array(faces, np.int32),
                colors=colors.astype(np.uint8))


def run(out: Optional[str] = None, viewpoints: int = 57, rotations: int = 14,
        batch_size: int = 16, device="cuda",
        vit_overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The JAX script's build under `out` (a temporary directory by
    default); `vit_overrides` shrink the ViT for tests."""
    from foundpose_torch.benchmarks.bench import card, require_device

    device = require_device(device)
    own = out is None
    out = tempfile.mkdtemp(prefix="foundpose_builder_") if own else out
    try:
        shutil.rmtree(out, ignore_errors=True)
        bop_root = os.path.join(out, "bop")
        models = os.path.join(bop_root, "demo", "models")
        os.makedirs(models)
        mesh = make_icosphere()
        save_ply(os.path.join(models, f"obj_{OBJ_ID:06d}.ply"), mesh)
        diameter = float(np.linalg.norm(mesh.vertices.max(axis=0) - mesh.vertices.min(axis=0)))
        with open(os.path.join(models, "models_info.json"), "w") as f:
            json.dump({str(OBJ_ID): {"diameter": diameter}}, f)
        tpl_opts = gen_templates.GenTemplatesOpts(
            object_dataset="demo", object_lids=[OBJ_ID], min_num_viewpoints=viewpoints,
            num_inplane_rotations=rotations, depth_range=(600.0, 1200.0), ssaa_factor=4.0,
            crop_size=(420, 420), bop_root=bop_root, output_dir=os.path.join(out, "templates"),
            overwrite=True)
        repre_opts = gen_repre.GenRepreOpts(
            object_dataset="demo", object_lids=[OBJ_ID], extractor_name=EXTRACTOR,
            apply_pca=True, pca_components=256, cluster_num=2048, batch_size=batch_size,
            use_pallas_attention=True, use_fused_block=True, approx_gelu=True,
            vit_overrides=vit_overrides, templates_dir=os.path.join(out, "templates"),
            output_dir=os.path.join(out, "repre"), overwrite=True, device=str(device))
        res = build_object(tpl_opts, repre_opts)
    finally:
        if own:
            shutil.rmtree(out, ignore_errors=True)
    tpl_s, repre_s = res["gen_templates_s_per_object"], res["repre_build_s_per_object"]
    ref = REF_GEN_TEMPLATES_S + REF_GEN_REPRE_S
    return {
        "metric": "offline_builder_templates_per_sec", "unit": "templates/sec", **res,
        "vs_baseline": ref / (tpl_s + repre_s),
        "vs_baseline_gen_templates": REF_GEN_TEMPLATES_S / tpl_s,
        "vs_baseline_gen_repre": REF_GEN_REPRE_S / repre_s,
        "baseline_s_per_object": {"gen_templates": REF_GEN_TEMPLATES_S,
                                  "gen_repre": REF_GEN_REPRE_S, "method": BASELINE_METHOD},
        "card": card(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--viewpoints", type=int, default=57)
    ap.add_argument("--rotations", type=int, default=14)
    ap.add_argument("--out", default=None, help="work directory (default: a temporary one)")
    ap.add_argument("--batch-size", type=int, default=16)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.out, args.viewpoints, args.rotations, args.batch_size)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
