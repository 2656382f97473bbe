"""The program's spans in a cell, and what recording them costs.

    python3 -m perfbench.tools.span_readings --workload <cell> --seeds 1,2 \
        [--seconds 10] [--out spans.jsonl]

For each seed, in one process: the cell's set-up and warm-up; windows of
`--seconds` at the cell's own load in turns with the recorder off, on
(device times), counting ops, on, off, each giving the cell's end-to-end
metric; then the kind's traced readings (`traced`, recorder off) and the
readings of the program's spans (`perfbench.spans.READINGS`), and from
them every per-layer metric the cell reports and every metric of
`spans.METRICS`. One JSON line per seed on standard output and appended to
`--out`; the span medians on standard error. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import torch

MODES = ("off", "on", "count", "on", "off")


def recorder(mode: str):
    from contextlib import nullcontext

    from foundpose_torch.utils import profiling

    if mode == "off":
        return nullcontext()
    return profiling.record(count_ops=mode == "count")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_readings: no CUDA card", file=sys.stderr)
        return 2
    from perfbench import harness, spans, trace

    torch.set_grad_enabled(False)
    m = harness.manifest()
    _, config, mix, _ = harness.cell_parts(m, args.workload)
    device = torch.device(harness.DEVICE)
    for seed in [int(x) for x in args.seeds.split(",")]:
        t0 = time.perf_counter()
        s = harness.setup(config, mix, seed, device, t0)
        harness.warm(s, device)
        first, windows = harness.WARM_STEPS, []
        for mode in MODES:
            with recorder(mode):
                attempted, e2e, _ = s.kind.measure(s.system, args.seconds, first)
            first += attempted  # each window starts further along the traffic's order
            windows.append({"mode": mode, **e2e})
        errors: list = []
        rec = s.kind.traced(s, windows[0], errors)
        rec.update(spans.READINGS[mix["kind"]](s, errors))
        spans.report(rec)
        metrics = {}
        for spec in harness.cell_metrics(m, args.workload, "per_layer"):
            metrics[spec["name"]] = trace.guarded(spec["name"],
                                                  lambda: harness.reader(spec["name"])(rec),
                                                  errors)
        suffix = "." + mix["kind"]
        metrics.update({name: trace.guarded(name, lambda: read(rec), errors)
                        for name, read in spans.METRICS.items() if name.endswith(suffix)})
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "device": torch.cuda.get_device_name(device), "windows": windows,
                           "metrics": metrics, "spans": spans.summary(rec), "errors": errors,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        harness.free_program(s)
        del s, rec
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
