#!/usr/bin/env python3
"""Each phase-3 case of an A/B that tools/ab_torch_kernels.sh ran, parent against change.

    python3 tools/ab_torch_summary.py LABEL [KERNEL ...]

Reads chiprun_out/LABEL.{parent1,change1,change2,parent2}.jsonl (one line a
case: kernel, flags, width, dtype, event `ms`, `device_ms`, bound) and
prints, for each case of the named kernels (all by default): the device
time of the four runs in order, the change's speed-up (mean parent device
time over mean change device time), the spread of each side ((max - min) /
mean of its two runs), and the change's event time, plain time and bound,
and what else its records hold (K9's route time `route_ms`, K10's
`dp_floor_ms`), the change's means. Needs no card.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUNS = ("parent1", "change1", "change2", "parent2")


def _key(r):
    flags = "+".join(f"{k}={v}" for k, v in sorted(r["flags"].items())) or "-"
    return r["name"], flags, r["width"], r["dtype"]


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    label, kernels = argv[0], set(argv[1:])
    runs = {}
    for run in RUNS:
        path = ROOT / "chiprun_out" / f"{label}.{run}.jsonl"
        runs[run] = {_key(r): r for r in map(json.loads, path.read_text().splitlines())}
    print("case | device ms parent1 change1 change2 parent2 | parent / change | spread parent, "
          "change | change event ms | plain ms | bound ms | other")
    for key, r in runs["change1"].items():
        if kernels and key[0] not in kernels:
            continue
        if not all(key in runs[run] for run in RUNS):
            print(f"{' '.join(map(str, key))}: not in every run")
            continue
        d = [runs[run][key]["device_ms"] for run in RUNS]
        parent, change = (d[0] + d[3]) / 2, (d[1] + d[2]) / 2
        spread = (abs(d[0] - d[3]) / parent, abs(d[1] - d[2]) / change)
        mean = {k: (runs["change1"][key][k] + runs["change2"][key][k]) / 2 for k in r
                if k in ("ms", "plain_ms", "route_ms", "dp_floor_ms")}
        other = ", ".join(f"{k} {mean[k]:.4f}" for k in ("route_ms", "dp_floor_ms") if k in mean)
        print(f"{key[0]} {key[1]} w{key[2]} {key[3]} | {d[0]:.4f} {d[1]:.4f} {d[2]:.4f} {d[3]:.4f} | "
              f"{parent / change:.3f}x | {spread[0]:.3f}, {spread[1]:.3f} | {mean['ms']:.4f} | "
              f"{mean['plain_ms']:.3f} | {r['bound_ms']:.4f} | {other}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
