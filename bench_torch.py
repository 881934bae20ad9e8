#!/usr/bin/env python3
"""strsim_tpu_torch benchmark: bench.py's sections through the PyTorch/CUDA port.

    python3 bench_torch.py                                 # one CUDA GPU, full size
    python3 bench_torch.py --device cpu --n-pairs 2000     # harness smoke on the CPU

Workloads: bench.py's make_pairs(--n-pairs, default 1,000,000; genealogy
name pairs, length <= 64) and make_wide_pairs(--n-wide, default 200,000;
lengths 48..511), from bench.py's seeds, uncut. Sections, in bench.py's
order, each skipped (and listed under "skipped") when the global deadline
(STRSIM_BENCH_DEADLINE_S, default 1380 s) leaves less than 120 s:

  1. each of the five measures alone on make_pairs;
  2. the five together (compute_many);
  3. the wide ladder: levenshtein, jaro_winkler, jaccard and osa alone on
     make_wide_pairs (none with --n-wide 0, the CPU's default);
  4. encode: the native route against the numpy route on make_pairs (best
     of 3 each; codes, lengths and validity equal, int8 iff all ASCII);
  5. host crossover (card only): the five on the first 1 .. 65,536 rows of
     make_pairs and of make_wide_pairs (until the host takes over 1 s),
     scored on the host (native library, every core) and on the device; the
     rows to score at the largest size the host wins up to is a workload's
     crossover, and the smaller of the two the host short circuit's size.

A section: one untimed warm pass, then --passes timed passes (default 5) of
compute_scores over the string columns (encode included), host clock
around a call that ends in a synchronise: median pairs/s and spread ((max -
min) / median), the RunMetrics phases of the median pass; on the card the
resident pairs/s (utils/devicetime.py: device time a block of each bucket's
real blocks staged on the card, times its blocks, summed) beside each
bucket's bound (ops/roofline.py). Parity: the scores on the first
200,000 rows (20,000 wide) must equal the single-core native baseline's
(native_compute, threads=1, best of 3) byte for byte, or the run fails.

At t = 0 a thread builds the native library and (card) every CUDA kernel,
K11 among them, while the data is made and encoded and the baselines run;
then K11 (csrc/warm.cu) launches once on [8, 128] and must equal
warm_plain: `kernel_build_s` and `first_launch_ms` stand for bench.py's
`mosaic_init_s`.

Writes build/bench_torch/details.json (--details) after every section. The
last line of stdout is one JSON object: {"metric":
"levenshtein_pairs_per_sec", "value": median end-to-end pairs/s of the
levenshtein section, "unit": "pairs/s", "vs_baseline": value / the native
baseline's, "device": "<name>, <power limit>" or "cpu"}. A section that
raises fails the run (non-zero exit) after the details and that line are
written. Without a CUDA device the run exits non-zero unless --device cpu is
given; a CPU run reports no resident, roofline or crossover numbers ("not
measured"). Imports neither jax nor strsim_tpu; bench.py only for its data.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIVE = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")
WIDE_MEASURES = ("levenshtein", "jaro_winkler", "jaccard", "osa")
BASELINE_SUBSET = 200_000
WIDE_BASELINE_SUBSET = 20_000
CROSSOVER_ROWS = (1, 8, 64, 256, 1024, 4096, 16384, 65536)
HOST_LIMIT_S = 1.0
SECTION_MIN_S = 120.0
NOT_MEASURED = "not measured"


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--n-pairs", type=int, default=1_000_000)
    p.add_argument("--n-wide", type=int, default=None,
                   help="rows of make_wide_pairs (default 200,000 on the card, 0 on the CPU: "
                        "the plain torch forms take seconds a pass at widths up to 511); "
                        "0 skips the wide sections")
    p.add_argument("--passes", type=int, default=5, help="timed passes a section")
    p.add_argument("--details", type=Path, default=ROOT / "build" / "bench_torch" / "details.json")
    args = p.parse_args(argv)
    if args.n_wide is None:
        args.n_wide = 200_000 if args.device == "cuda" else 0
    if args.passes < 1 or args.n_pairs < 1 or args.n_wide < 0:
        p.error("--passes and --n-pairs must be positive, --n-wide not negative")
    return args


class Run:
    """One benchmark run: its configuration, clock, details and headline."""

    def __init__(self, args):
        import torch

        import strsim_tpu_torch as st

        self.args = args
        self.t0 = time.time()
        self.deadline_s = float(os.environ.get("STRSIM_BENCH_DEADLINE_S", "1380"))
        self.device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
        self.cfg = st.get_config().replace(device=args.device)
        self.on_card = args.device == "cuda"
        self.clock_hz = None
        if self.on_card:
            from strsim_tpu_torch.ops.roofline import card_line, max_sm_clock_hz

            self.card = card_line()
            self.clock_hz = max_sm_clock_hz()
        else:
            self.card = "cpu"
        self.details = {
            "device": self.card, "n_pairs": args.n_pairs, "n_wide": args.n_wide,
            "passes": args.passes, "measures": {}, "wide": {}, "skipped": [], "_meta": {
                "harness": "bench_torch.py: one process; details rewritten after every "
                           f"section; global deadline {self.deadline_s:.0f} s",
                "pairs_per_sec": "end to end: compute_scores over the string columns (encode, "
                                 "classify, buckets, finalize), host clock, median of the timed "
                                 "passes; spread = (max - min) / median",
                "resident_pairs_per_sec": "device rows / sum over buckets of (device ms a block, "
                                          "utils/devicetime.py, x blocks)",
                "baseline_single_core_pairs_per_sec": "native_compute, threads=1, best of 3",
            }}

    def log(self, msg: str) -> None:
        print(f"[bench_torch +{time.time() - self.t0:7.1f}s] {msg}", file=sys.stderr, flush=True)

    def remaining(self) -> float:
        return self.deadline_s - (time.time() - self.t0)

    def flush(self) -> None:
        path = self.args.details
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.details, indent=2, default=str))
        os.replace(tmp, path)

    def headline(self) -> dict:
        lev = self.details["measures"].get("levenshtein", {})
        value = lev.get("pairs_per_sec_median", 0.0)
        base = lev.get("baseline_single_core_pairs_per_sec")
        return {"metric": "levenshtein_pairs_per_sec", "value": value, "unit": "pairs/s",
                "vs_baseline": value / base if base else 0.0, "device": self.card}

    def sync(self) -> None:
        if self.on_card:
            import torch

            torch.cuda.synchronize(self.device)

    def section_open(self, name: str) -> bool:
        if self.remaining() < SECTION_MIN_S:
            self.details["skipped"].append(name)
            self.log(f"DEADLINE: skipping {name} ({self.remaining():.0f} s left)")
            return False
        self.log(f"section {name} ({self.remaining():.0f} s left)")
        return True


# --- build and warm-up -------------------------------------------------------

def start_builds(run: Run):
    """At t = 0: the native library in one thread and (card) every CUDA
    kernel in another (one nvcc per source, all at once). Returns a join
    function that waits for both, records kernel_build_s and raises what a
    build raised."""
    times, errors = {}, []

    def native():
        from strsim_tpu_torch.native import build

        t0 = time.perf_counter()
        build.get_lib()
        times["native"] = time.perf_counter() - t0

    def kernels():
        from strsim_tpu_torch.ops import _build

        t0 = time.perf_counter()
        built = _build.build_all()
        times["cuda_wall"] = time.perf_counter() - t0
        times.update((name, seconds) for name, (seconds, _) in built.items())

    def guarded(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 -- re-raised in the main thread by join()
            errors.append(e)

    threads = [threading.Thread(target=guarded, args=(native,), daemon=True)]
    if run.on_card:
        threads.append(threading.Thread(target=guarded, args=(kernels,), daemon=True))
    for t in threads:
        t.start()

    def join():
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        run.details["kernel_build_s"] = times
        run.log(f"kernel_build_s {json.dumps({k: round(v, 3) for k, v in times.items()})}")

    return join


def first_launch(run: Run) -> None:
    """K11 once on [8, 128] after the build, against warm_plain: the CUDA
    context's start (cuda_init_ms) and the first launch (first_launch_ms)."""
    if not run.on_card:
        run.details["first_launch_ms"] = NOT_MEASURED
        return
    import torch

    from strsim_tpu_torch.ops.warm_cuda import warm, warm_plain

    t0 = time.perf_counter()
    torch.cuda.init()
    x = torch.ones((8, 128), dtype=torch.int32, device=run.device)
    torch.cuda.synchronize(run.device)
    t1 = time.perf_counter()
    y = warm(x)
    torch.cuda.synchronize(run.device)
    t2 = time.perf_counter()
    if not torch.equal(y, warm_plain(x)):
        raise AssertionError("K11 (csrc/warm.cu) differs from warm_plain on [8, 128]")
    run.details["cuda_init_ms"] = (t1 - t0) * 1e3
    run.details["first_launch_ms"] = (t2 - t1) * 1e3
    run.log(f"first_launch_ms {(t2 - t1) * 1e3:.3f} (CUDA context {(t1 - t0) * 1e3:.1f} ms); "
            "K11 equals warm_plain")


# --- one section ---------------------------------------------------------------

def native_baseline(measure, a, b, rows: int, reps: int = 3):
    """(pairs/s, scores) of the single-core native library on the first
    `rows` rows, best of `reps`."""
    from strsim_tpu_torch.native import native_compute

    validity = a.validity[:rows] & b.validity[:rows]
    best, scores = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        scores = native_compute(measure, a.codes[:rows], a.lengths[:rows], b.codes[:rows],
                                b.lengths[:rows], validity, threads=1)
        best = min(best, time.perf_counter() - t0)
    return rows / best, scores


def timed_passes(run: Run, measures, col_a, col_b):
    """One warm pass and run.args.passes timed passes; the median pass's
    phases and scores."""
    from strsim_tpu_torch.models.pipeline import compute_scores
    from strsim_tpu_torch.utils.metrics import RunMetrics

    n = len(col_a)
    compute_scores(col_a, col_b, measures, config=run.cfg)
    passes = []
    for _ in range(run.args.passes):
        rm = RunMetrics()
        run.sync()
        t0 = time.perf_counter()
        res = compute_scores(col_a, col_b, measures, config=run.cfg, metrics=rm)
        run.sync()
        passes.append((time.perf_counter() - t0, rm, res))
    passes.sort(key=lambda p: p[0])
    dt, rm, res = passes[len(passes) // 2]
    rates = [n / p[0] for p in passes]
    median = n / dt
    return {
        "n_pairs": n,
        "pairs_per_sec_median": median,
        "pairs_per_sec": rates,
        "spread": (max(rates) - min(rates)) / median,
        "phases_s": {"encode": rm.encode_wall_s, "classify": rm.classify_wall_s,
                     "device": rm.device_wall_s, "finalize": rm.finalize_wall_s,
                     "total": rm.total_wall_s},
        "encode_route": rm.encode_route,
        "rows": {"device": rm.device_rows, "host": rm.oracle_rows, "null": rm.null_rows,
                 "fast_path": rm.fast_path_rows + rm.one_empty_rows},
        "buckets": {w: {"rows": bm.rows, "dtype": bm.dtype, "padding_waste": bm.padding_waste}
                    for w, bm in sorted(rm.buckets.items())},
    }, {m: v for m, (v, _) in res.items()}


def resident(run: Run, a, b, measures) -> dict:
    """Resident pairs/s: each bucket's real blocks staged on the card, the
    device time a block (compute_stats and the stack of its stats, as a pass
    launches them) times the bucket's blocks, summed; and each bucket beside
    its bound."""
    import torch

    from strsim_tpu_torch.models import pipeline as pp
    from strsim_tpu_torch.ops.roofline import roofline_report
    from strsim_tpu_torch.ops.stats import compute_stats, stat_routes
    from strsim_tpu_torch.utils.devicetime import marginal_block_time

    cfg, impls = run.cfg, run.cfg.impls()
    fields = pp._stat_fields(measures)

    def block_pass(*blk):
        stats = compute_stats(*blk, measures, impls)
        return torch.stack([stats[f] for f in fields])

    _, la, lb, _, _, idx = pp.classify(a, b, cfg)
    buckets, per_bucket, rows, device_ms = [], {}, 0, 0.0
    for width, sel in pp.bucket_rows(idx, la, lb, cfg).items():
        if width < 0:
            continue
        staged = pp.stage_bucket(measures, a, b, la, lb, sel, width, cfg, run.device)
        blocks = list(pp.bucket_blocks(staged, width))
        block_ms = marginal_block_time(block_pass, blocks, clock_hz=run.clock_hz)
        ms = block_ms * len(blocks)
        sel = staged["sel"]
        per_bucket[width] = {"rows": int(sel.size), "blocks": len(blocks),
                             "block_rows": staged["block"], "block_ms": block_ms,
                             "device_ms": ms, "dtype": staged["dtype"]}
        buckets.append({"width": width, "dtype": staged["dtype"], "lens": (la[sel], lb[sel]),
                        "routes": stat_routes(measures, width, getattr(torch, staged["dtype"]), impls),
                        "fields": fields, "measured_ms": ms})
        rows += int(sel.size)
        device_ms += ms
    report = roofline_report(buckets, run.clock_hz)
    for width, entry in report["buckets"].items():
        per_bucket[width].update(entry)
    return {"resident_pairs_per_sec": rows / (device_ms / 1e3) if device_ms else None,
            "resident_device_ms": device_ms, "resident_rows": rows,
            "roofline_share": report["share"], "bound_ms": report["bound_ms"],
            "resident_buckets": per_bucket}


def measure_section(run: Run, measures, col_a, col_b, a, b, baselines, subset) -> dict:
    """Timed passes, resident rate and roofline (card), and byte parity
    with the native baseline of each measure in `baselines` on the first
    `subset` rows."""
    result, scores = timed_passes(run, measures, col_a, col_b)
    result["measures"] = list(measures)
    if run.on_card:
        result.update(resident(run, a, b, measures))
    else:
        result.update({"resident_pairs_per_sec": NOT_MEASURED, "roofline_share": NOT_MEASURED})
    parity = {}
    for m in measures:
        if m in baselines:
            pps, base = baselines[m]
            parity[m] = scores[m][:subset].tobytes() == base.tobytes()
            if len(measures) == 1:
                result["baseline_single_core_pairs_per_sec"] = pps
                result["speedup_vs_single_core"] = result["pairs_per_sec_median"] / pps
    result["bit_exact_parity"] = parity
    res_pps = result["resident_pairs_per_sec"]
    run.log(f"{','.join(measures)}: median {result['pairs_per_sec_median']:,.0f} pairs/s, spread "
            f"{result['spread']:.3f}, phases {json.dumps({k: round(v, 3) for k, v in result['phases_s'].items()})}, "
            f"route {result['encode_route']}, resident "
            f"{res_pps if isinstance(res_pps, str) else f'{res_pps:,.0f}'} pairs/s, parity {parity}")
    if not all(parity.values()):
        result["error"] = "scores differ from the native baseline"
    return result


def encode_section(run: Run, col_a, col_b) -> dict:
    """The native route against the numpy route on the same rows, best of
    3 each; codes, lengths and validity must be equal, the native tiles
    int8 exactly when every char is ASCII."""
    from strsim_tpu_torch.utils import encode as enc

    out = {"n_pairs": len(col_a)}
    for name, fn in (("native", enc.encode_pair_with_route),
                     ("numpy", lambda x, y: (*enc.encode_pair_numpy(x, y), "numpy"))):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            got = fn(col_a, col_b)
            best = min(best, time.perf_counter() - t0)
        out[name] = {"seconds": best, "pairs_per_sec": len(col_a) / best, "route": got[2],
                     "dtype": got[0].codes.dtype.name, "width": got[0].width}
        if name == "native":
            native = got
    for side, want in zip(native[:2], got[:2]):
        ascii_only = int(want.codes.max(initial=0)) < 128
        if (side.codes.dtype == np.int8) != ascii_only \
                or not np.array_equal(side.codes.astype(np.int32), want.codes) \
                or not np.array_equal(side.lengths, want.lengths) \
                or not np.array_equal(side.validity, want.validity):
            raise AssertionError("the native encode differs from the numpy route")
    out["equal"] = True
    run.log(f"encode: native ({out['native']['route']}) {out['native']['pairs_per_sec']:,.0f} "
            f"pairs/s, numpy {out['numpy']['pairs_per_sec']:,.0f} pairs/s, equal")
    return out


def crossover_section(run: Run, workloads) -> dict:
    """The five on the first n rows of each workload ({label: (col_a,
    col_b)}) for n in CROSSOVER_ROWS: scored on the host (native library,
    every core) and on the device, best of 5 after a warm pass each. A
    workload's crossover is the count of rows to score (device rows) at the
    largest size up to which the host won at every size (0 if the device
    won at the smallest); its walk stops after a size at which the host
    took over HOST_LIMIT_S (larger sizes only take it longer). The host
    short circuit takes the smallest crossover over the workloads: a row
    count that serves short names may cost long rows many times their
    device time."""
    from strsim_tpu_torch.models.pipeline import compute_scores
    from strsim_tpu_torch.utils.metrics import RunMetrics

    out = {}
    for label, (col_a, col_b) in workloads.items():
        table, crossover, host_leads = [], 0, True
        for n in CROSSOVER_ROWS:
            if n > len(col_a) or (table and table[-1]["host_ms"] > HOST_LIMIT_S * 1e3):
                break
            xa, xb = col_a[:n], col_b[:n]
            row = {"rows": n}
            for where, cfg in (("host", run.cfg.replace(host_short_circuit_rows=n)),
                               ("device", run.cfg.replace(host_short_circuit_rows=0))):
                rm = RunMetrics()
                compute_scores(xa, xb, FIVE, config=cfg, metrics=rm)
                best = float("inf")
                for _ in range(5):
                    run.sync()
                    t0 = time.perf_counter()
                    compute_scores(xa, xb, FIVE, config=cfg)
                    run.sync()
                    best = min(best, time.perf_counter() - t0)
                row[f"{where}_ms"] = best * 1e3
                row["work_rows"] = rm.device_rows + rm.oracle_rows
            host_leads = host_leads and row["host_ms"] < row["device_ms"]
            if host_leads:
                crossover = row["work_rows"]
            table.append(row)
        out[label] = {"sizes": table, "crossover_rows": crossover}
        run.log(f"crossover {label}: " + "; ".join(
            f"{r['rows']} rows ({r['work_rows']} to score) host {r['host_ms']:.3f} ms, device "
            f"{r['device_ms']:.3f} ms" for r in table) + f" -> {crossover}")
    out["host_short_circuit_rows"] = min(v["crossover_rows"] for v in out.values())
    run.log(f"host_short_circuit_rows {out['host_short_circuit_rows']}")
    return out


# --- the run -------------------------------------------------------------------

def run_sections(run: Run) -> None:
    sys.path.insert(0, str(ROOT))
    import bench  # for its data generators only

    from strsim_tpu_torch.utils import encode as enc

    args, d = run.args, run.details
    join_builds = start_builds(run)
    col_a, col_b = bench.make_pairs(args.n_pairs)
    t0 = time.perf_counter()
    a, b, route = enc.encode_pair_with_route(col_a, col_b)
    d["encode_s"], d["encode_route"] = time.perf_counter() - t0, route
    run.log(f"make_pairs({args.n_pairs}) encoded in {d['encode_s']:.3f} s ({route}, width "
            f"{a.width}, {a.codes.dtype})")
    subset = min(BASELINE_SUBSET, args.n_pairs)
    baselines = {m: native_baseline(m, a, b, subset) for m in FIVE}
    for m, (pps, _) in baselines.items():
        run.log(f"native baseline {m}: {pps:,.0f} pairs/s (one thread, best of 3)")
    join_builds()
    first_launch(run)
    run.flush()

    for m in FIVE:
        if run.section_open(m):
            d["measures"][m] = measure_section(run, (m,), col_a, col_b, a, b, baselines, subset)
            run.flush()
    if run.section_open("fused"):
        d["fused"] = measure_section(run, FIVE, col_a, col_b, a, b, baselines, subset)
        run.flush()
    wide = None
    for m in WIDE_MEASURES:
        if not args.n_wide:
            d["skipped"].append(f"wide:{m} (--n-wide 0)")
            continue
        if not run.section_open(f"wide:{m}"):
            continue
        if wide is None:
            wcol_a, wcol_b = bench.make_wide_pairs(args.n_wide)
            wa, wb = enc.encode_pair(wcol_a, wcol_b)
            wide = (wcol_a, wcol_b, wa, wb)
            wsubset = min(WIDE_BASELINE_SUBSET, args.n_wide)
        base = {m: native_baseline(m, wa, wb, wsubset, reps=2)}
        d["wide"][m] = measure_section(run, (m,), *wide, base, wsubset)
        run.flush()
    if run.section_open("encode"):
        d["encode"] = encode_section(run, col_a, col_b)
        run.flush()
    if not run.on_card:
        d["crossover"] = NOT_MEASURED
    elif run.section_open("crossover"):
        workloads = {"make_pairs": (col_a, col_b)}
        if wide is not None:
            workloads["make_wide_pairs"] = wide[:2]
        d["crossover"] = crossover_section(run, workloads)
    failed = [name for name, r in (*d["measures"].items(), ("fused", d.get("fused", {})),
                                   *((f"wide:{k}", v) for k, v in d["wide"].items()))
              if "error" in r]
    if failed:
        raise AssertionError(f"sections failed their parity with the native baseline: {failed}")


def main(argv) -> int:
    args = _parse(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device (pass --device cpu for the CPU smoke)", file=sys.stderr)
        return 2
    run = Run(args)
    try:
        run_sections(run)
    finally:
        run.details["total_wall_s"] = time.time() - run.t0
        run.flush()
        print(json.dumps(run.headline()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
