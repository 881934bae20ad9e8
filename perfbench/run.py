#!/usr/bin/env python3
"""Run one cell of the benchmark of strsim_tpu_torch once, on one card.

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

CELL is an entry of `workloads` in BENCHMARK.json. Set-up makes the cell's
inputs from the seed (`loadgen.py`), builds and loads the kernels the cell's
routes reach, and warms every input with one call. The window then calls
the program in a closed loop, one caller, each call starting when the
previous one has returned its numpy scores, for S seconds (the call running
at the close finishes and counts). The call is the cell's call shape's own
(`shapes/<shape>.py`, named by the traffic file: its `entry`, which calls
the program's public API):
  --trace 0  the shape's untraced call; the line holds the cell's
             end-to-end metrics; where one of them comes from the device's
             trace, the window runs under a profiler that records the
             device's ops alone;
  --trace 1  the shape's traced call, `models.pipeline.compute_scores` with
             a `RunMetrics`, on the same inputs under torch.profiler; the
             line holds the cell's per-layer metrics, the device's busy and
             window seconds and a breakdown.
After the window what the shape kept of each call is checked against the
plain reference (the shape's `reference` and `compare`, over `check.py`).
The last stdout line is one JSON object; the numbers compared, each beside
the shape's limit, are the last lines on stderr and the line's last key.

Exits non-zero with no result when there is no CUDA device (or fewer than
the cell asks for), when the program is not the checkout's, and when jax,
jaxlib, flax, strsim_tpu, bench or bench_torch was imported.

`--rehearse` runs the cell on the CPU at a small scale (`--scale`, default
0.002), with the program's plain torch forms, for the tests: its line names
the CPU and is no measurement of the card.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "strsim_tpu", "bench", "bench_torch")


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["STRSIM_TPU_TORCH_BUILD_DIR"] = str(build / "strsim_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "perfbench" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "perfbench" / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "perfbench" / "cuda_cache")


def steady_host() -> None:
    """One intra-op thread for torch's own host ops, whatever the machine's
    cores (the program's native host library keeps its own threads)."""
    os.environ["OMP_NUM_THREADS"] = "1"  # read when torch is imported
    os.environ["MKL_NUM_THREADS"] = "1"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metrics(bench: dict, cell: str, rec, traced: bool) -> dict:
    out = {}
    for m in bench["per_layer" if traced else "end_to_end"]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        value = load_reader(m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def prebuild(workload, cfg) -> list:
    """Build (first run in a checkout) and load the kernel libraries that the
    routes of the cell's buckets reach, and no other. Returns their names."""
    import torch

    from strsim_tpu_torch.ops import _build
    from strsim_tpu_torch.ops.stats import stat_routes

    ascii_of = {}
    for inp in workload.inputs:
        for w, asc in workload.shape.widths(inp, cfg).items():
            ascii_of[w] = ascii_of.get(w, True) and asc
    libs = set()
    for width, asc in ascii_of.items():
        if width < 0:
            continue
        dtype = torch.int8 if asc and cfg.narrow_tiles else torch.int32
        for route in stat_routes(workload.measures, width, dtype, cfg.impls()).values():
            if route == "plain":
                continue
            if route in _build.LIBRARIES:
                libs.add(route)
            else:  # a route named after one C function of a library
                libs.update(n for n, (_, fns) in _build.LIBRARIES.items() if f"strsim_{route}" in fns)
    for name in sorted(libs):
        _build.library(name)
    return sorted(libs)


def window(entry, workload, seconds: float, span=None):
    """Closed loop over the inputs in turn until `seconds` have passed.
    Returns (calls, window seconds, [(input, what the shape keeps of the
    call)], the process's CPU seconds over the window, every thread's)."""
    from perfbench.record import Call

    calls, got = [], []
    n = len(workload.inputs)
    cpu0 = time.process_time()
    start = time.perf_counter()
    deadline = start + seconds
    k = 0
    while True:
        inp = workload.inputs[k % n]
        t0 = time.perf_counter()
        try:
            if span is not None:
                with span():
                    out, rm = entry(inp)
            else:
                out, rm = entry(inp)
        except Exception:  # a call that raises is a failed call of the run
            t1 = time.perf_counter()
            traceback.print_exc()
            calls.append(Call(input=k % n, rows=inp.rows, wall_s=t1 - t0, failed=True))
        else:
            t1 = time.perf_counter()
            calls.append(Call(input=k % n, rows=inp.rows, wall_s=t1 - t0, run_metrics=rm))
            got.append((k % n, workload.shape.keep(out, inp, workload.measures)))
            del out
        k += 1
        if t1 >= deadline:
            return calls, t1 - start, got, time.process_time() - cpu0


def run(args, fault=None):
    """One run of a cell: (the result line's object, not printed, and the
    Record its metrics were read from). `fault`, for the tests only, wraps
    the entry."""
    cache_env()
    steady_host()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    torch.set_num_threads(1)

    from perfbench import check, loadgen, trace
    from perfbench.record import Record
    from perfbench.roofline._peaks import PEAKS

    bench = loadgen.manifest()
    cell = loadgen.cell(bench, args.workload)
    if not args.rehearse:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"no CUDA device, or fewer than the {cell['chips']} the cell asks for")
        torch.cuda.init()
    import strsim_tpu_torch as st

    if Path(st.__file__).resolve().parents[1] != ROOT:
        raise SystemExit(f"strsim_tpu_torch at {st.__file__} is not this checkout's")
    cfg = st.get_config().replace(device="cpu") if args.rehearse else None
    scale = args.scale if args.rehearse else 1.0

    workload = loadgen.load(bench, args.workload, args.seed, scale)
    shape = workload.shape
    shape.select(workload, args.seed)
    libs = [] if args.rehearse else prebuild(workload, st.get_config())
    traced = bool(args.trace)
    entry = shape.entry(st, workload.measures, cfg, traced)
    if fault is not None:
        entry = fault(entry)
    for inp in workload.inputs:  # warm every input: every shape the window uses
        entry(inp)
    gc.collect()
    gc.freeze()  # set-up's objects out of every later collection
    setup_s = time.perf_counter() - T0

    # The untraced run of a cell with an end-to-end metric from the device's
    # trace records the device's ops alone (no host ops, no spans).
    device_only = not traced and not args.rehearse and any(
        m["source"] == "device_trace" and args.workload in m.get("workloads", [args.workload])
        for m in bench["end_to_end"])
    gc.disable()  # no collection pauses inside the window
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if not args.rehearse:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        span = lambda: torch.profiler.record_function(trace.CALL_SPAN)  # noqa: E731
        with torch.profiler.profile(activities=acts) as prof:
            calls, window_s, got, cpu_s = window(entry, workload, args.seconds, span)
    elif device_only:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            calls, window_s, got, cpu_s = window(entry, workload, args.seconds)
    else:
        calls, window_s, got, cpu_s = window(entry, workload, args.seconds)
    gc.enable()

    if args.rehearse:
        device = {"platform": "cpu", "kind": "cpu (rehearsal)", "count": 1, "memory_peak_bytes": 0}
    else:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    rec = Record(workload=workload, setup_s=setup_s, window_s=window_s, calls=calls,
                 peaks=None if args.rehearse else PEAKS.get(device["kind"]))
    breakdown = None
    if prof is not None:
        rec.trace = trace.reduce(prof)
        del prof
    if traced:
        device["busy_s"] = rec.trace.busy_s()
        device["window_s"] = window_s
        if rec.trace.device:
            breakdown = trace.breakdown(rec.trace, rec)

    t_ref = time.perf_counter()
    want = shape.reference(workload)
    failed = sum(c.failed for c in calls)
    numbers = shape.compare(got, want, failed)
    print(f"perfbench: {len(got)} calls checked over {len(workload.inputs)} inputs "
          f"({shape.__name__}); reference {time.perf_counter() - t_ref:.2f} s; "
          f"libraries {libs}; setup {setup_s:.3f} s; window {window_s:.3f} s, {len(calls)} calls, "
          f"{sum(c.rows for c in rec.done()) / window_s:.1f} rows a second",
          file=sys.stderr)
    walls = np.array([c.wall_s for c in calls])
    half = len(walls) // 2
    print("perfbench: call walls s (min, quartiles, max) "
          f"{' '.join(f'{q:.4f}' for q in np.quantile(walls, [0, 0.25, 0.5, 0.75, 1]))}, "
          f"mean of the first and second half {walls[:half].mean():.4f} {walls[half:].mean():.4f}; "
          f"process CPU {cpu_s:.2f} s", file=sys.stderr)
    if rec.trace is not None and rec.trace.device:
        by_kind = {}
        for name, lo, hi, _ in rec.trace.device:
            kind = " ".join(name.split()[:2]) if name.startswith("Memcpy") else trace._kind(name)
            by_kind[kind] = by_kind.get(kind, 0.0) + (hi - lo) / 1e6
        print(f"perfbench: device s in the window: busy {rec.trace.busy_s():.6f}, "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(by_kind.items())), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        raise SystemExit(4)
    result = {
        "correct": check.verdict(numbers, shape.LIMITS),
        "attempted": len(calls),
        "failed": failed,
        "metrics": read_metrics(bench, args.workload, rec, traced),
        "device": device,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    if args.rehearse:
        result["rehearsal"] = True
    result["checks"] = {k: {"value": v, "limit": shape.LIMITS[k]} for k, v in numbers.items()}
    return result, rec


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true", help="on the CPU, at --scale (tests only)")
    p.add_argument("--scale", type=float, default=0.002)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not args.rehearse:
        print(f"card: {card_line()}", file=sys.stderr, flush=True)
    result, _ = run(args)
    print(json.dumps(result), flush=True)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
