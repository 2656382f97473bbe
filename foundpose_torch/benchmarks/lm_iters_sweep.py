"""AR-gated LM-iteration budget sweep on the cross-parity world (counterpart
of benchmarks/lm_iters_sweep.py).

    python -m foundpose_torch.benchmarks.lm_iters_sweep [--crops 200] [--seeds 2]

Cells lm_iters in {10, 6, 4, 2} (shipped default 10) on the benched fast
path at RANSAC 200 x LO 2, scored against the replica oracle on each seed's
world (solve_sweep_harness); the pick is the cheapest admissible budget.
Prints one JSON line with the per-cell AR table, each cell's wall ms and
launches per seed, and the pick. Runs on "cuda" unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import sys

from foundpose_torch.benchmarks.solve_sweep_harness import emit, run_sweep

CELLS = {f"lm{n}": {"lm_iters": n} for n in (10, 6, 4, 2)}
DEFAULT_CELL = "lm10"


def pick(cells):
    """The cheapest admissible budget by NUMERIC value: cell keys are
    strings, and a bare min() would sort them lexicographically ("lm10" <
    "lm2")."""
    return min(cells, key=lambda c: int(c[2:]))


def run(crops=200, seeds=2, templates=96, device="cuda"):
    """The sweep's report (see the module docstring)."""
    return run_sweep(metric="lm_iters_sweep", config_overrides_by_cell=CELLS,
                     default_cell=DEFAULT_CELL, crops=crops, seeds=seeds, templates=templates,
                     pick_rule=pick, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--crops", type=int, default=200)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--templates", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return emit(run(args.crops, args.seeds, args.templates, args.device))


if __name__ == "__main__":
    sys.exit(main())
