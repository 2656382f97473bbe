"""The ViT stage alone on one NVIDIA GPU, batch 64 (counterpart of
benchmarks/vit_stage_bench.py).

    python -m foundpose_torch.benchmarks.vit_stage_bench    # needs a CUDA GPU
    VIT_MODEL=dinov2_version=vitl14_stride=14_facet=key_layer=18_norm=1 VIT_FUSED=0 \\
        VIT_STABILIZER=column BENCH_BATCH=16 python -m foundpose_torch.benchmarks.vit_stage_bench

Times `dinov2.extract_facet` on `BENCH_BATCH` (default 64) uniform random
420 px crops, normalized and cast to bf16 as the JAX script casts them,
for the extractor `VIT_MODEL` (default ViT-S/14-reg, layer-9 token facet)
with tanh GELU, the fused block unless `VIT_FUSED=0` (kernel 1; unfused:
cuBLAS GEMMs and kernel 4) and the softmax stabilizer `VIT_STABILIZER`
(default "capped"). The weights are bench_weights' calibrated random
weights from seed 0 (the JAX script's are plain random; the calibration
keeps every attention logit inside the capped softmax's window, checked
on one probe image). `VIT_IMG_PER_STEP` and `VIT_PAIRED` tile the TPU
kernel and have no counterpart on the card: any value but their defaults
(1 and 0) raises. Timing: bench.settle, then bench.window_seconds (CUDA
events around calls launched back to back, best of 3 windows). Prints one
line, `vit_ms_per_batch=... batch=... fused=...`, and one JSON line.
`run(device="cpu")` runs it on the CPU (host clock).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from foundpose_torch.benchmarks import bench
from foundpose_torch.models import dinov2

DEFAULT_MODEL = "dinov2_version=vits14-reg_stride=14_facet=token_layer=9_norm=1"
# The JAX script's TPU tiling knobs and their defaults: no counterpart here.
TPU_KNOBS = {"VIT_IMG_PER_STEP": "1", "VIT_PAIRED": "0"}


def options_from_env(env: Mapping[str, str] = os.environ) -> Dict[str, Any]:
    """run()'s options from the JAX script's environment variables; a TPU
    tiling knob set to anything but its default raises."""
    for key, default in TPU_KNOBS.items():
        if env.get(key, default) != default:
            raise ValueError(f"{key}={env[key]!r} tiles the TPU kernel and has no counterpart "
                             f"on the card; leave it unset or {default!r}")
    return dict(batch=int(env.get("BENCH_BATCH", "64")),
                model_name=env.get("VIT_MODEL", DEFAULT_MODEL),
                fused=env.get("VIT_FUSED", "1") == "1",
                stabilizer=env.get("VIT_STABILIZER", "capped"))


@torch.no_grad()
def prepare(batch: int = 64, model_name: str = DEFAULT_MODEL, fused: bool = True,
            stabilizer: str = "capped", device="cuda",
            vit_overrides: Optional[Dict[str, Any]] = None) -> Tuple[Callable[[], Any], Dict]:
    """(the stage as a callable on inputs made once, what it runs);
    `vit_overrides` shrink the ViT for tests."""
    device = bench.require_device(device)
    cfg = dataclasses.replace(dinov2.parse_model_name(model_name), approx_gelu=True,
                              use_fused_block=fused, softmax_stabilizer=stabilizer,
                              **(vit_overrides or {}))
    model, logit_max = bench.calibrated_model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(7)
    crops = torch.rand(batch, bench.CROP_PX, bench.CROP_PX, 3, generator=gen, device=device)

    def stage():
        images = dinov2.normalize_images(crops).to(torch.bfloat16)
        return dinov2.extract_facet(model, images)["feature_maps"].float()

    return stage, dict(batch=batch, extractor=model_name, fused=fused, stabilizer=stabilizer,
                       attn_logit_max=logit_max, device=device)


@torch.no_grad()
def measure(stage: Callable[[], Any], info: Dict) -> Dict[str, Any]:
    """`vit_ms_per_batch` of the prepared stage, with what it ran."""
    device = info["device"]
    bench.settle(stage, device)
    ms = bench.window_seconds(stage, device) * 1e3
    print(f"vit_ms_per_batch={ms:.2f} batch={info['batch']} fused={info['fused']}",
          file=sys.stderr)
    return dict({k: v for k, v in info.items() if k != "device"}, vit_ms_per_batch=ms,
                card=bench.card(device))


def run(batch: int = 64, model_name: str = DEFAULT_MODEL, fused: bool = True,
        stabilizer: str = "capped", device="cuda",
        vit_overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """`measure(*prepare(...))`."""
    return measure(*prepare(batch, model_name, fused, stabilizer, device, vit_overrides))


def main() -> int:
    print(json.dumps(run(**options_from_env())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
