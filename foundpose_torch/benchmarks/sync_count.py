"""Host syncs of one PoseEngine.estimate() on the card.

    python3 foundpose_torch/benchmarks/sync_count.py [--root DIR]   # needs a CUDA GPU

Builds `foundpose_torch.engine.PoseEngine` at configs/infer/lmo_exact.json
and at configs/infer/lmo.json (each config's ViT switches as
`extractor_overrides`), with the engine's own random ViT-S/14-reg weights
from seed 0 and one LM-O-scale synthetic object (`synthetic.realistic_repre`,
seed 0), warms it with one estimate() of 16 boxes (120 x 90 px on a 4 x 4
grid) on a 480x640 image, then counts the host syncs of one more estimate()
under the CUDA sync debug mode "warn", which warns once at each sync.
estimate() ends in one fetch of its packed results per chunk of
`batch_size` (here one chunk), so a serving path with no other sync counts 1.

`--root` imports foundpose_torch from another checkout (for example a
parent commit unpacked into the ignored `_parent/`), so two trees are
counted on one card. Prints one JSON line: the root, and per
configuration the count and where each sync was made (the innermost
file:line of the checkout's foundpose_torch).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import traceback
import warnings

import numpy as np
import torch

CONFIGS = ("lmo_exact.json", "lmo.json")
SYNC_WARNING = "called a synchronizing CUDA operation"
K = np.array([[600.0, 0.0, 320.0], [0.0, 600.0, 240.0], [0.0, 0.0, 1.0]])


def request(n=16, seed=3):
    """A uniform uint8 480x640 image from `seed` and n boxes on a 4 x 4
    grid of 120 x 90 px."""
    image = (np.random.default_rng(seed).uniform(size=(480, 640, 3)) * 255).astype(np.uint8)
    boxes = [np.array([40 + (i % 4) * 140, 40 + (i // 4) * 100,
                       160 + (i % 4) * 140, 130 + (i // 4) * 100], np.float32) for i in range(n)]
    return image, boxes


def count_syncs(fn, root):
    """The host syncs in one call of `fn()` (CUDA sync debug mode "warn"),
    each as the innermost file:line of `root`'s foundpose_torch that made
    it, and the other warnings raised meanwhile."""
    pkg, here = os.path.join(root, "foundpose_torch") + os.sep, os.path.abspath(__file__)
    at, other = [], []

    def record(message, category, filename, lineno, file=None, line=None):
        # The sync's own warning; torch warns once more, on first setting
        # a debug mode, that the mode does not see every sync.
        if SYNC_WARNING in str(message):
            frames = [f for f in traceback.extract_stack()
                      if f.filename.startswith(pkg) and os.path.abspath(f.filename) != here]
            at.append(f"{os.path.relpath(frames[-1].filename, root)}:{frames[-1].lineno}"
                      if frames else f"{filename}:{lineno}")
        else:
            other.append(str(message)[:120])

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return at, other


def engine_syncs(root, config_path):
    """The syncs of one warm estimate() at the configuration `config_path`
    (count_syncs)."""
    from foundpose_torch.engine import PoseEngine
    from foundpose_torch.models import dinov2
    from foundpose_torch.pipeline import inference
    from foundpose_torch.synthetic import realistic_repre

    with open(config_path) as f:
        opts = json.load(f)
    name = opts["infer_opts"]["extractor_name"]
    vit_cfg, named = inference.vit_config_from_opts(opts), dinov2.parse_model_name(name)
    overrides = {f.name: getattr(vit_cfg, f.name) for f in dataclasses.fields(vit_cfg)
                 if getattr(vit_cfg, f.name) != getattr(named, f.name)}
    engine = PoseEngine(extractor_name=name, config=inference.inference_config_from_opts(opts),
                        batch_size=16, extractor_overrides=overrides, device="cuda")
    engine.register_object(1, realistic_repre(0, "cuda"))
    image, boxes = request()
    with torch.no_grad():
        engine.estimate(1, image, boxes, K)  # warm
        return count_syncs(lambda: engine.estimate(1, image, boxes, K), root)


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here, help="checkout whose foundpose_torch is counted")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sync_count: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    res = {"root": root}
    for name in CONFIGS:
        at, other = engine_syncs(root, os.path.join(root, "configs", "infer", name))
        res[name] = {"syncs": len(at), "at": at, "other_warnings": other}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
