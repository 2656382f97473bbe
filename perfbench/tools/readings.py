"""The readings that a cell's limits on `correct` are set from.

    python3 -m perfbench.tools.readings --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 3] [--out readings.jsonl]

For each seed, in one process: the cell's set-up, warm-up and a short
window at the cell's own load, then the judge's numbers of the program's
answers; on the control seeds also the numbers of the control, the
reference in the program's place one precision below the configuration's
in every stage (side "control"), and in each of the kind's stages alone
(side "control:<stage>"). One JSON line per seed and side, on standard
output and appended to `--out`. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    from perfbench import harness

    torch.set_grad_enabled(False)
    m = harness.manifest()
    _, config, mix, _ = harness.cell_parts(m, args.workload)
    device = torch.device("cuda")
    controls = {int(x) for x in args.control_seeds.split(",") if x}
    for seed in [int(x) for x in args.seeds.split(",")]:
        t0 = time.perf_counter()
        s = harness.setup(config, mix, seed, device, t0)
        harness.warm(s, device)
        _, e2e, answers = harness.measure(s, args.seconds)
        harness.free_program(s)
        rows = [("program", s.kind.check(s, answers, seed))]
        if seed in controls:
            rows.append(("control", s.kind.check(s, answers, seed, control=True)))
            rows += [(f"control:{stage}", s.kind.check(s, answers, seed, control=(stage,)))
                     for stage in s.kind.CONTROL_STAGES]
        for side, numbers in rows:
            line = json.dumps({"workload": args.workload, "seed": seed, "side": side,
                               "numbers": numbers, "e2e": e2e,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        del s, answers
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
