#!/usr/bin/env python3
"""Where the time of strsim_tpu_torch's main path goes, on one CUDA GPU.

    python3 tools/profile_torch_e2e.py

For bench.py's make_pairs(1_000_000) and make_wide_pairs(200_000), after one
warm-up pass of compute_many over the five measures:
  * three unprofiled walls (host clock, the call returns numpy scores);
  * one pass under torch.profiler (CPU and CUDA activities): the device's
    busy time as the union of its kernel and copy intervals, the idle share
    1 - busy / wall of that pass, and the device ops that took the most time;
  * the host short-circuit crossover: N rows of the workload scored with
    host_short_circuit_rows = 0 (kernels) and = N (the host scorer: the
    native library on every core).

Imports neither jax nor strsim_tpu. Prints the card's name and power limit
first, since a card below its maximum power runs slower.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIVE = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")
CROSSOVER_ROWS = (8, 64, 512, 4096)


def device_busy_s(prof) -> float:
    """Seconds during which at least one device op ran (union of intervals)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e6


def top_device_ops(prof, k: int = 10):
    ops = [(getattr(e, "self_device_time_total", 0), e.count, e.key) for e in prof.key_averages()]
    return sorted((o for o in ops if o[0] > 0), reverse=True)[:k]


def timed(fn) -> float:
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_e2e: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import bench
    import strsim_tpu_torch as st
    from strsim_tpu_torch.ops import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    _build.build_all()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    workloads = (("make_pairs(1_000_000)", bench.make_pairs(1_000_000)),
                 ("make_wide_pairs(200_000)", bench.make_wide_pairs(200_000)))
    for label, (col_a, col_b) in workloads:
        st.compute_many(FIVE, col_a, col_b)
        walls = [timed(lambda: st.compute_many(FIVE, col_a, col_b)) for _ in range(3)]
        with torch.profiler.profile(activities=acts) as prof:
            wall = timed(lambda: st.compute_many(FIVE, col_a, col_b))
        busy = device_busy_s(prof)
        print(f"{label}: unprofiled walls {walls} s; profiled wall {wall} s, device busy "
              f"{busy} s, idle share {1 - busy / wall}", flush=True)
        for us, count, key in top_device_ops(prof):
            print(f"    {us / 1e3:10.4f} ms  x{count:<5d} {key[:100]}", flush=True)
        for n in CROSSOVER_ROWS:
            a, b = col_a[:n], col_b[:n]
            cfg = st.get_config()
            kernels = timed(lambda: st.compute_many(FIVE, a, b, config=cfg.replace(host_short_circuit_rows=0)))
            host = timed(lambda: st.compute_many(FIVE, a, b, config=cfg.replace(host_short_circuit_rows=n)))
            print(f"  {label} first {n} rows: kernels {kernels} s, host (native) {host} s", flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
