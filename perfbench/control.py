#!/usr/bin/env python3
"""The control of `check.py`'s comparison: the plain reference put in the
program's place and computed in float32, the precision below the float64
that the configurations state, then checked as a run checks the program
(the same inputs and sample, drawn from each seed by the cell's call shape,
compared by the shape against the float64 reference). It has to come out
not correct.

    python3 perfbench/control.py --workload CELL --seeds 11,12,13

Prints one JSON line a seed with the numbers compared and the verdict. The
benchmark's runs do not run it. It needs no card: it runs no program code.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(workload: str, seed: int, scale: float = 1.0) -> dict:
    from perfbench import check, loadgen

    w = loadgen.load(loadgen.manifest(), workload, seed, scale)
    w.shape.select(w, seed)
    lower = w.shape.reference(w, np.float32)
    numbers = w.shape.compare(sorted(lower.items()), w.shape.reference(w), 0)
    return {"workload": workload, "seed": seed, "correct": check.verdict(numbers, w.shape.LIMITS),
            **numbers}


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--scale", type=float, default=1.0)
    args = p.parse_args(argv)
    for seed in map(int, args.seeds.split(",")):
        print(json.dumps(control_numbers(args.workload, seed, args.scale)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
