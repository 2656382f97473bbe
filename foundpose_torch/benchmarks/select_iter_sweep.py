"""AR-gated two-phase-solve sweep on the cross-parity world (counterpart of
benchmarks/select_iter_sweep.py).

    python -m foundpose_torch.benchmarks.select_iter_sweep [--crops 200] [--seeds 2]

Cells `pnp_select_iter` in {0, 100, 50, 25} (0 = single-pass, the
default) at the 200-hypothesis final budget on the benched fast path,
scored against the replica oracle on each seed's world
(solve_sweep_harness). Selection is by pre-refinement inlier count, so the
cheap pass can only change WHICH template wins; the winner still gets the
full budget and the better pass is kept (inference.full_budget_winner), so
a cell launches the scorer twice. Prints one JSON line with the per-cell
AR table, each cell's wall ms and launches per seed, and the pick. Runs on
"cuda" unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import sys

from foundpose_torch.benchmarks.solve_sweep_harness import emit, run_sweep

CELLS = {f"select{n}": {"pnp_select_iter": n} for n in (0, 100, 50, 25)}
DEFAULT_CELL = "select0"


def pick(cells):
    """The cheapest admissible NONZERO selection budget by NUMERIC value
    (select0 is the single-pass default, not a two-phase pick; cell keys
    are strings, so a bare min() would sort them lexicographically)."""
    return min((c for c in cells if c != DEFAULT_CELL), key=lambda c: int(c[6:]),
               default=DEFAULT_CELL)


def run(crops=200, seeds=2, templates=96, device="cuda"):
    """The sweep's report (see the module docstring)."""
    return run_sweep(metric="select_iter_sweep", config_overrides_by_cell=CELLS,
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
