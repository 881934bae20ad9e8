#!/usr/bin/env python3
"""End-to-end pairs/s and host phases of one tree's strsim_tpu_torch, on one CUDA GPU.

    python3 tools/ab_torch_host.py TREE LABEL

Imports strsim_tpu_torch from TREE (this checkout, or another commit's
`git archive` unpacked under build/) and bench.py's data generators from
this checkout, so that two trees score the same rows. For make_pairs(1M)
and make_wide_pairs(200K), the five measures: one warm pass of
compute_scores over the string columns, then 3 timed passes (host clock
around a call that ends in a synchronise). Prints one JSON line a workload
under LABEL: each pass's wall and RunMetrics phases (encode, classify,
buckets, finalize; the encode route where the tree records it).

An A/B of two trees runs it in turns on one machine, so that both meet the
same host:
    for t in build/parent . . build/parent; do python3 tools/ab_torch_host.py $t $t; done > ab_host.jsonl
Imports neither jax nor strsim_tpu.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIVE = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    tree, label = pathlib.Path(argv[0]).resolve(), argv[1]
    sys.path.insert(0, str(tree))
    sys.path.insert(1, str(ROOT))
    import torch

    import bench
    from strsim_tpu_torch.models.pipeline import compute_scores
    from strsim_tpu_torch.utils.metrics import RunMetrics

    if not torch.cuda.is_available():
        print("ab_torch_host: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for name, (col_a, col_b) in (("make_pairs(1_000_000)", bench.make_pairs(1_000_000)),
                                 ("make_wide_pairs(200_000)", bench.make_wide_pairs(200_000))):
        compute_scores(col_a, col_b, FIVE)
        passes = []
        for _ in range(3):
            rm = RunMetrics()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compute_scores(col_a, col_b, FIVE, metrics=rm)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            passes.append({"wall_s": wall, "pairs_per_sec": len(col_a) / wall,
                           "encode_s": rm.encode_wall_s, "classify_s": rm.classify_wall_s,
                           "buckets_s": rm.device_wall_s, "finalize_s": rm.finalize_wall_s,
                           "encode_route": getattr(rm, "encode_route", "numpy")})
        record = {"label": label, "tree": str(tree), "workload": name, "card": card,
                  "passes": passes}
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
