"""AR-gated RANSAC budget sweep on the cross-parity world (counterpart of
benchmarks/ransac_sweep.py).

    python -m foundpose_torch.benchmarks.ransac_sweep [--crops 200] [--templates 798] [--seed 0]

The reference's 400 RANSAC iterations are cv2.solvePnPRansac's adaptive
budget cap, not a law (reference: utils/pnp_util.py:46-55); the port's
solver adds LO-RANSAC refits of the running best hypothesis
(pose/pnp.lo_refine), which may make most of the fixed hypotheses
redundant. Sweeps pnp_ransac_iter x pnp_lo_iters on the benched fast path
(bf16, approximate top-k) over one world at LM-O scale (make_world's
defaults, queries with pose seeds 1000 + i), scores each cell's AR against
the independent replica oracle held at the full reference budget (400
iterations), and picks the cheapest cell within the 1-point gate of BOTH
the replica and the 400 x 2 default (solve_sweep_harness.admissible).
Prints one JSON line with the JAX script's keys plus the device and each
cell's wall ms and launches. Runs on "cuda" unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import itertools
import sys

from foundpose_torch.benchmarks import bench
from foundpose_torch.benchmarks.cross_parity import host_threads
from foundpose_torch.benchmarks.solve_sweep_harness import (
    admissible,
    build_world,
    cell_ar,
    emit,
    oracle_ar,
)

RANSAC_ITERS = (100, 200, 400)
LO_ITERS = (1, 2)
DEFAULT_CELL = (400, 2)  # shipped default going into the sweep
# make_world's own sizes (LM-O scale) but for the template count.
WORLD = dict(pts_per_template=400, feat_dim=256, num_words=2048, n_points=4000)


def pick(cells):
    """Cheapest admissible cell: fewest hypotheses, then fewest LO rounds."""
    return min(cells, key=lambda c: (c[0], c[1]), default=DEFAULT_CELL)


def overrides(cell):
    ri, lo = cell
    return {"pnp_ransac_iter": ri, "pnp_lo_iters": lo}


def name(cell):
    return f"ransac{cell[0]}_lo{cell[1]}"


def run(crops=200, templates=798, seed=0, device="cuda"):
    device = bench.require_device(device)
    sw = build_world(seed, crops, templates, device, world_kw=WORLD, pose_seed_base=1000)
    ar_rep, rep_s = oracle_ar(sw)
    print(f"[sweep] replica oracle AR={ar_rep:.3f} ({rep_s:.1f}s)", file=sys.stderr)
    results = {}
    for cell in itertools.product(RANSAC_ITERS, LO_ITERS):
        results[cell] = cell_ar(sw, overrides(cell), device)
        print(f"[sweep] {name(cell)}: AR={results[cell]['ar']:.3f} (delta vs replica "
              f"{abs(results[cell]['ar'] - ar_rep):.3f}) [{results[cell]['wall_ms']:.1f} ms, "
              f"{results[cell]['launches']}]", file=sys.stderr)
    ok = sorted(admissible({c: [r["ar"]] for c, r in results.items()}, [ar_rep], DEFAULT_CELL))
    picked = pick(ok)
    return {
        "metric": "ransac_budget_sweep",
        "device": bench.card(device),
        "n_crops": crops,
        "ar_replica_oracle": round(ar_rep, 4),
        "replica_threads": host_threads(),
        "replica_sec_per_crop": round(rep_s / crops, 4),
        "cells": {name(c): round(r["ar"], 4) for c, r in results.items()},
        "gate": "AR within 1 pt of replica AND of the 400x2 default",
        "admissible": [name(c) for c in ok],
        "picked": {"pnp_ransac_iter": picked[0], "pnp_lo_iters": picked[1]},
        "cell_wall_ms": {name(c): r["wall_ms"] for c, r in results.items()},
        "cell_launches": {name(c): r["launches"] for c, r in results.items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--crops", type=int, default=200)
    ap.add_argument("--templates", type=int, default=798)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return emit(run(args.crops, args.templates, args.seed, args.device))


if __name__ == "__main__":
    sys.exit(main())
