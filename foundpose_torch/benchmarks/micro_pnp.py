"""The solve stage's substages on one NVIDIA GPU at LM-O scale
(counterpart of benchmarks/micro_pnp.py).

    python -m foundpose_torch.benchmarks.micro_pnp      # needs a CUDA GPU

Splits `pipeline/inference.solve_batch` into its parts over B x top-n = 64
x 5 = 320 correspondence sets of K = 300 points and H = 400 hypotheses, on
the JAX script's inputs (2D points uniform in [0, 420) px, 3D points
uniform in +-0.05 m, 80% valid, query ids in [0, 900), f 600, c 209.5):

  hypothesis_sampling   pose/pnp.sample_counts (each draw's valid point)
  sampling+dlt          the above, then pose/pnp._dlt_pose_many
  ransac_no_lm          pose/pnp.ransac_pnp without LM
  ransac_full(+lm)      pose/pnp.ransac_pnp with 10 LM steps (kernel 2 scores)
  estimate_score(best)  pipeline/inference.estimate_score on B sets

Both RANSAC substages run with lo_iters=0, as the JAX script pins them.
The draws [S, H, 6] are made once from a torch.Generator and passed in, so
no substage times the draw itself. Eager PyTorch has no scan, so each
substage reports three numbers (bench.substage_times): `ms`, CUDA-event
time a call over calls launched back to back; `device_ms`, the device
kernels' own time a call under torch.profiler; `host_launches`, the
host's kernel-launch calls a call. Prints one line per substage and one
JSON line. `run(device="cpu")` runs it on the CPU (host clock; no device
numbers).
"""

from __future__ import annotations

import json
import sys
from typing import Any, Callable, Dict

import torch

from foundpose_torch.benchmarks import bench
from foundpose_torch.pipeline.inference import estimate_score
from foundpose_torch.pose import pnp

B, TOP_N, K, H = 64, 5, 300, 400
NUM_QUERY_POINTS = 900
LM_ITERS = 10


def problem(device, b: int = B, top_n: int = TOP_N, k: int = K, h: int = H,
            seed: int = 0) -> Dict[str, torch.Tensor]:
    """The micro's inputs over b * top_n sets, made on `device` from one
    generator, with the draws [S, h, 6]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s = b * top_n

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    return dict(
        c2d=uniform((s, k, 2), 0.0, 420.0), c3d=uniform((s, k, 3), -0.05, 0.05),
        valid=torch.rand(s, k, generator=gen, device=device) > 0.2,
        ids=torch.randint(0, NUM_QUERY_POINTS, (s, k), generator=gen, device=device),
        kf=torch.full((s, 2), 600.0, device=device), kc=torch.full((s, 2), 209.5, device=device),
        draws=torch.randint(0, k, (s, h, 6), generator=gen, device=device),
    )


def substages(p: Dict[str, torch.Tensor], b: int = B) -> Dict[str, Callable[[], Any]]:
    """The five substages on the problem `p` (estimate_score on its first
    `b` sets), each returning its outputs."""
    h = p["draws"].shape[1]
    validf = p["valid"].float()
    rays = (p["c2d"] - p["kc"][:, None]) / p["kf"][:, None]

    def ransac(refine_lm):
        return pnp.ransac_pnp(p["c2d"], p["c3d"], p["valid"], p["kf"], p["kc"],
                              num_hypotheses=h, refine_lm=refine_lm, lm_iters=LM_ITERS,
                              lo_iters=0, draws=p["draws"])

    def final_score():
        dev = p["c2d"].device
        r = torch.eye(3, device=dev).expand(b, 3, 3)
        t = torch.tensor([0.0, 0.0, 0.5], device=dev).expand(b, 3)
        return estimate_score(r, t, p["c2d"][:b], p["ids"][:b], p["c3d"][:b], p["valid"][:b],
                              p["kf"][:b], p["kc"][:b], num_query_points=NUM_QUERY_POINTS)

    return {
        "hypothesis_sampling": lambda: pnp.sample_counts(p["valid"], p["draws"]),
        "sampling+dlt": lambda: pnp._dlt_pose_many(
            p["c3d"], rays, validf, pnp.sample_counts(p["valid"], p["draws"])),
        "ransac_no_lm": lambda: ransac(False),
        "ransac_full(+lm)": lambda: ransac(True),
        "estimate_score(best)": final_score,
    }


def run(device="cuda", b: int = B, top_n: int = TOP_N, k: int = K, h: int = H) -> Dict[str, Any]:
    """The micro at its sizes (smaller ones for tests) on `device`."""
    device = bench.require_device(device)
    with torch.no_grad():
        subs = substages(problem(device, b, top_n, k, h), b)
    return dict(sets=b * top_n, points=k, hypotheses=h, card=bench.card(device),
                substages=bench.substage_report(subs, device, "micro_pnp", b))


def main() -> int:
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
