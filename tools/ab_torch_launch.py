#!/usr/bin/env python3
"""The launch path's cost in one tree's strsim_tpu_torch, on one CUDA GPU.

    python3 tools/ab_torch_launch.py TREE LABEL

Imports strsim_tpu_torch from TREE (this checkout, or another commit's
`git archive` unpacked under build/). Times calls whose device work is a
microsecond or two, so that the host's side of a launch (the wrapper, the
launch path of ops/_build.py:call, the ctypes call, the driver) sets their
pace: K11 (`warm`) on an [8, 128] int32 tensor, K1
(`levenshtein_distance`) on 8 int8 rows of width 7, and torch.add(one, x,
alpha=2) on the [8, 128] tensor beside them. Each is called 2,000 times in
a row, 5 times over: host microseconds a call (the host clock around the
calls, before the synchronise) and event microseconds a call (CUDA events
around the same calls). Prints one JSON line under LABEL with the card's
name and power limit, each case's 5 readings of both.

An A/B of two trees runs it in turns on one machine:
    for t in build/parent . . build/parent; do python3 tools/ab_torch_launch.py $t $t; done
Imports neither jax nor strsim_tpu.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

CALLS, REPEATS = 2000, 5


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    tree, label = pathlib.Path(argv[0]).resolve(), argv[1]
    sys.path.insert(0, str(tree))
    import torch

    from strsim_tpu_torch.ops.levenshtein_cuda import levenshtein_distance
    from strsim_tpu_torch.ops.warm_cuda import warm

    if not torch.cuda.is_available():
        print("ab_torch_launch: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(-2 ** 31, 2 ** 31, (8, 128), dtype=torch.int32, generator=gen).to(dev)
    one = torch.ones_like(x)
    a, b = (torch.randint(97, 100, (8, 7), dtype=torch.int8, generator=gen).to(dev) for _ in "ab")
    lens = torch.full((8,), 7, dtype=torch.int32, device=dev)
    cases = {"warm_8x128": lambda: warm(x), "myers_8xw7": lambda: levenshtein_distance(a, b, lens, lens),
             "torch_add_8x128": lambda: torch.add(one, x, alpha=2)}
    out = {"label": label, "tree": str(tree), "card": card, "calls": CALLS}
    for name, fn in cases.items():
        fn()
        host, event = [], []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(CALLS):
                fn()
            end.record()
            host.append((time.perf_counter() - t0) / CALLS * 1e6)
            end.synchronize()
            event.append(start.elapsed_time(end) / CALLS * 1e3)
        out[name] = {"host_us": host, "event_us": event}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
