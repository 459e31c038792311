"""The spread of a metric over a set of runs, as the bounds are set from it.

    python3 portbench/spread.py FILE [FILE ...]

Each FILE holds one set of runs: lines ``<cell> <result JSON line>``.  For
every cell and metric it prints each set's median and spread (the distance
between the first and third quartiles, ``statistics.quantiles(values,
n=4)``, over the median), the spread without each set's run farthest from
the median, and five times the widest spread.
"""

import json
import statistics
import sys


def spread(values, drop_farthest=False):
    values = list(values)
    if drop_farthest:
        med = statistics.median(values)
        values.remove(max(values, key=lambda v: abs(v - med)))
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def read(path):
    """{cell: {metric: [values]}} of one set."""
    out = {}
    with open(path) as f:
        for line in f:
            cell, _, rest = line.strip().partition(" ")
            if not rest:
                continue
            result = json.loads(rest)
            for name, m in result["metrics"].items():
                out.setdefault(cell, {}).setdefault(name, []).append(m["value"])
    return out


def main(paths):
    sets = [read(p) for p in paths]
    for cell in sorted({c for s in sets for c in s}):
        for metric in sorted({m for s in sets for m in s.get(cell, {})}):
            runs = [s[cell][metric] for s in sets if metric in s.get(cell, {})]
            cols = []
            for vals in runs:
                cols.append(f"median {statistics.median(vals):.6g} spread {spread(vals):.4f} "
                            f"less farthest {spread(vals, True):.4f} (n={len(vals)})")
            widest = max(spread(v) for v in runs)
            allruns = spread([v for vals in runs for v in vals])
            print(f"{cell} {metric}: " + " | ".join(cols) +
                  f" | all runs {allruns:.4f} | 5 x widest {5 * widest:.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
