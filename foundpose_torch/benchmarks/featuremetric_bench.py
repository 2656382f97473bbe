"""Device cost of featuremetric refinement on one NVIDIA GPU (counterpart of
benchmarks/featuremetric_bench.py).

    python -m foundpose_torch.benchmarks.featuremetric_bench     # needs a CUDA GPU

Crops per second and milliseconds a batch of the bench's configuration
(configs/infer/lmo.json's switches, calibrated ViT-S/14-reg, LM-O-scale
representation with bf16 banks; foundpose_torch.benchmarks.bench) with
`refine_featuremetric` off and on (8 LM steps on each crop's winner,
pose/featuremetric.py) at batch 64 and 128, timed as the bench times
(warm-up windows, a sync-free step, CUDA events around 8 steps launched
back to back, best of 3). `refine_ms_per_batch_b{64,128}` is the
difference of the two. Beside the JAX script's keys, the line has `card`
(nvidia-smi's name and power limit) and `peak_mem_bytes_{off,on}_b{64,128}`,
`torch.cuda.max_memory_allocated` over each measurement (null on the CPU):
refinement's J^T J product grows with the batch. `run()` takes `device`,
"cuda" by default; the tests run it with `device="cpu"` at small sizes.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from foundpose_torch.benchmarks import bench
from foundpose_torch.pipeline import inference
from foundpose_torch.synthetic import realistic_repre

BATCHES = (64, 128)


@torch.no_grad()
def measure(model, repre, config, batch: int, device) -> Tuple[float, Optional[int]]:
    """(seconds a step, peak device bytes or None) of `pose_from_crops`
    under `config` on `batch` bench crops."""
    crops, masks, cams = bench.bench_inputs(batch, device)
    gen = torch.Generator(device=device).manual_seed(1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    sec, _ = bench.step_seconds(
        lambda: inference.pose_from_crops(model, crops, masks, cams, repre, config, generator=gen),
        device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return sec, peak


def run(batches: Sequence[int] = BATCHES, device="cuda",
        vit_overrides: Optional[Dict[str, Any]] = None, scale: Dict[str, int] = bench.LMO_SCALE):
    """The refinement report as a dict (see the module docstring)."""
    device = bench.require_device(device)
    vit_cfg, config = bench.bench_configs(vit_overrides=vit_overrides)
    model, _ = bench.calibrated_model(vit_cfg, device)
    repre = realistic_repre(0, device, raw_dim=vit_cfg.embed_dim, **scale).cast_banks(
        config.compute_dtype)
    report = {"metric": "featuremetric_device_cost", "refine_iters": config.featuremetric_iters}
    for b in batches:
        sec_off, peak_off = measure(model, repre, config, b, device)
        sec_on, peak_on = measure(model, repre,
                                  dataclasses.replace(config, refine_featuremetric=True), b, device)
        report[f"crops_per_sec_off_b{b}"] = b / sec_off
        report[f"crops_per_sec_on_b{b}"] = b / sec_on
        report[f"ms_per_batch_off_b{b}"] = sec_off * 1e3
        report[f"ms_per_batch_on_b{b}"] = sec_on * 1e3
        report[f"refine_ms_per_batch_b{b}"] = (sec_on - sec_off) * 1e3
        report[f"peak_mem_bytes_off_b{b}"] = peak_off
        report[f"peak_mem_bytes_on_b{b}"] = peak_on
        print(f"[featuremetric-bench] b{b}: off {b / sec_off:.1f} on {b / sec_on:.1f} crops/s "
              f"(+{(sec_on - sec_off) * 1e3:.2f} ms a batch; peak bytes {peak_off} / {peak_on})",
              file=sys.stderr)
    report["card"] = bench.card(device)
    return report


def main() -> int:
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
