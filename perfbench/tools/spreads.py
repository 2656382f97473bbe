"""The spreads that the end-to-end bounds are set from.

    python3 -m perfbench.tools.spreads runs.jsonl

Each line of the input is one run: {"cell", "set", "seed", "result"}, with
`result` the run's result line. For each cell, metric and set it prints the
median and the spread, the distance between the first and the third
quartile (`statistics.quantiles(values, n=4)`) as a share of the median; then
for each metric the widest spread over the cells and sets, five times it
(the bound the contract asks for, never under 1% nor over 25%), and how far
the second set's median lies from the first's. Runs not `correct` are
listed and left out.
"""

from __future__ import annotations

import collections
import json
import statistics
import sys


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    path = (argv or sys.argv[1:])[0]
    runs = collections.defaultdict(list)
    for line in open(path):
        r = json.loads(line)
        if not r["result"]["correct"]:
            print(f"not correct: {r['cell']} seed {r['seed']}: {r['result'].get('checks')}")
            continue
        for name, m in r["result"]["metrics"].items():
            runs[(r["cell"], name, r["set"])].append(m["value"])
    widest = collections.defaultdict(float)
    medians = collections.defaultdict(dict)
    for (cell, name, s), values in sorted(runs.items()):
        sp = spread(values) if len(values) >= 2 else float("nan")
        medians[(cell, name)][s] = statistics.median(values)
        print(f"{cell:26s} {name:18s} set {s}: n {len(values)}, "
              f"median {statistics.median(values):.6g}, spread {sp:.4%}, "
              f"values {', '.join(f'{v:.6g}' for v in values)}")
        if name != "setup_s":
            widest[name] = max(widest[name], sp)
    for (cell, name), by_set in sorted(medians.items()):
        if len(by_set) == 2:
            a, b = (by_set[k] for k in sorted(by_set))
            print(f"{cell:26s} {name:18s} second set's median vs first: {b / a - 1:+.4%}")
    for name, w in sorted(widest.items()):
        print(f"{name:18s} widest spread {w:.4%} -> bound {min(0.25, max(0.01, 5 * w)):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
