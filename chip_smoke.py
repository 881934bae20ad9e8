#!/usr/bin/env python3
"""Drive strsim_tpu_torch on one CUDA GPU and check it end to end.

    python3 chip_smoke.py

Phases, one line of findings each (any failure exits non-zero):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel from csrc/, one nvcc per source in parallel;
  3. kernels: each kernel against its plain torch version on the card, at the
     main path's shapes (65536-row blocks at each ladder width it serves, int8
     and int32 tiles, seeded inputs incl. astral codepoints); integers must
     match exactly; both times from CUDA events, and for the fused kernel
     also the time of the separate kernels it replaces;
  4. end to end: bench.py's make_pairs(1_000_000) and make_wide_pairs(200_000)
     through compute_many over the five measures and through each measure
     function, with the launch counts zeroed just before and read just after;
     scores byte-identical to the pure-Python oracle on a 20K-row subset of
     each workload, the 1,115 golden cases and the README demo table;
  5. a {"kernels": [...]} JSON line, the card line again, and last
     {"ok": true, "device": {...}}.

Imports neither jax nor strsim_tpu. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import multiprocessing
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
FIVE = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")
LADDER = (7, 15, 23, 31, 47, 63, 95, 127, 191, 255, 383, 511)
BLOCK = 65536
ORACLE_ROWS = 20_000
SEED = 20261016

# name -> (source, TPU kernel it replaces)
KERNELS = {
    "levenshtein_myers": ("strsim_tpu_torch/csrc/levenshtein_myers.cu",
                          "strsim_tpu/ops/levenshtein_pallas_scan.py:72"),
    "jaro_scan": ("strsim_tpu_torch/csrc/jaro_scan.cu",
                  "strsim_tpu/ops/jaro_pallas_scan.py:106"),
    "multiset_rank": ("strsim_tpu_torch/csrc/multiset.cu",
                      "strsim_tpu/ops/multiset_pallas.py:51"),
    "multiset_hist": ("strsim_tpu_torch/csrc/multiset.cu",
                      "strsim_tpu/ops/multiset_pallas.py:79"),
    "lev_jaro_fused": ("strsim_tpu_torch/csrc/lev_jaro_fused.cu",
                       "strsim_tpu/ops/lev_jaro_pallas.py:129"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """One line from `nvcc -Xptxas -v`: kernels, most registers, largest stack
    frame, and spill bytes summed over every kernel of a library."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", log)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", log))
    return (f"{len(regs)} kernels, registers <= {max(regs, default=0)}, "
            f"stack frame <= {max(stack, default=0)} B, spill {spills} B")


# --- phase 3: kernels against their plain versions ---------------------------

def make_tiles(rng, n: int, width: int, dtype):
    """A packed [n, 2*width] tile (a | b per row, as the pipeline packs it)
    and [2, n] int32 lengths [la; lb], padded with -1 / -2.

    A small alphabet (int8: ASCII with NUL; int32: ASCII, BMP and astral
    codepoints) keeps matches, repeats, greedy ties and transpositions dense.
    Rows: near-duplicates (one substitution, one adjacent swap), independent
    pairs, equal pairs, empty sides, len-1/len-1 pairs (rows % 11 == 5),
    all-equal rows whose length ends on a word boundary, so that bit 31 is
    the tracked Myers bit and jaro flags fill whole words (rows % 13 == 6),
    the edge lengths 0, 1, 2, width - 1, width and 31..65 in the first rows,
    and padded rows (la = lb = 0) at the end, as at the end of a bucket."""
    if dtype == np.int8:
        alphabet = np.array([97, 98, 99, 100, 101, 32, 0, 126], dtype=np.int64)
    else:
        alphabet = np.array([97, 98, 99, 0x416, 0x4F60, 0xFFFF, 0x1F600, 0x10FFFF],
                            dtype=np.int64)
    rows = np.arange(n)
    la = rng.integers(0, width + 1, n)
    la[rng.random(n) < 0.25] = width
    a = alphabet[rng.integers(0, alphabet.size, (n, width))]
    b = a.copy()
    b[rows, rng.integers(0, width, n)] = alphabet[rng.integers(0, alphabet.size, n)]
    if width > 1:
        p = rng.integers(0, width - 1, n)
        b[rows, p], b[rows, p + 1] = b[rows, p + 1].copy(), b[rows, p].copy()
    lb = np.clip(la + rng.integers(-2, 3, n), 0, width)
    indep = rng.random(n) < 0.3
    b[indep] = alphabet[rng.integers(0, alphabet.size, (int(indep.sum()), width))]
    lb[indep] = rng.integers(0, width + 1, int(indep.sum()))
    equal = rng.random(n) < 0.05
    b[equal], lb[equal] = a[equal], la[equal]
    la[rng.random(n) < 0.02] = 0
    lb[rng.random(n) < 0.02] = 0
    one = rows % 11 == 5
    la[one] = lb[one] = 1
    top = rows % 13 == 6
    a[top] = b[top] = alphabet[1]
    la[top] = lb[top] = (width // 32) * 32 or width
    edges = [0, 1, 2, width - 1, width] + [k for k in (31, 32, 33, 63, 64, 65, 256) if k <= width]
    la[: len(edges)] = edges
    lb[: len(edges)] = edges[::-1]
    pads = max(n // 1024, 1)
    la[-pads:] = lb[-pads:] = 0
    pos = np.arange(width)[None, :]
    a[pos >= la[:, None]] = -1
    b[pos >= lb[:, None]] = -2
    packed = np.concatenate([a, b], axis=1).astype(dtype)
    return packed, np.stack([la, lb]).astype(np.int32)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_cases():
    """(name, [(kernel, plain), ...], widths, dtypes): every pair is checked,
    the first is timed. The fused kernel is timed with the multiset step on,
    as compute_many over the five measures runs it."""
    from functools import partial

    from strsim_tpu_torch.ops import jaro_cuda, lev_jaro_cuda, levenshtein_cuda, multiset_cuda

    both = (np.int8, np.int32)
    narrow = tuple(w for w in LADDER if w <= 63)
    fused = [(partial(lev_jaro_cuda.lev_jaro_stats, with_inter=k),
              partial(lev_jaro_cuda.lev_jaro_plain, with_inter=k)) for k in (True, False)]
    return [
        ("levenshtein_myers", [(levenshtein_cuda.levenshtein_distance,
                                levenshtein_cuda.myers_plain)], LADDER, both),
        ("jaro_scan", [(jaro_cuda.jaro_match_stats, jaro_cuda.jaro_plain)], LADDER, both),
        ("multiset_rank", [(multiset_cuda.multiset_intersection_rank,
                            multiset_cuda.rank_plain)], narrow, both),
        ("multiset_hist", [(multiset_cuda.multiset_intersection_hist, multiset_cuda.hist_plain)],
         tuple(w for w in LADDER if w > 63), (np.int8,)),
        ("lev_jaro_fused", fused, narrow, both),
    ]


def separate_kernels(a, b, la, lb):
    """What the fused kernel replaces: K1, K2, K3 and the plain prefix."""
    from strsim_tpu_torch.ops import jaro_cuda, levenshtein_cuda, multiset_cuda
    from strsim_tpu_torch.ops.stats import shared_prefix_length

    return (levenshtein_cuda.levenshtein_distance(a, b, la, lb),
            *jaro_cuda.jaro_match_stats(a, b, la, lb),
            shared_prefix_length(a, b),
            multiset_cuda.multiset_intersection_rank(a, b, la, lb))


def check_kernels(device) -> dict:
    """Every kernel against its plain version on the same card tensors."""
    import torch

    rng = np.random.default_rng(SEED)
    summary = {}
    for name, pairs, widths, dtypes in kernel_cases():
        err, ms, plain_ms = 0, 0.0, 0.0
        for width in widths:
            for dtype in dtypes:
                packed, lens = make_tiles(rng, BLOCK, width, dtype)
                codes = torch.from_numpy(packed).to(device)
                lengths = torch.from_numpy(lens).to(device)
                args = (codes[:, :width], codes[:, width:], lengths[0], lengths[1])
                for kernel, plain in pairs:
                    got, want = kernel(*args), plain(*args)
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    torch.cuda.synchronize()
                    if len(got) != len(want):
                        raise AssertionError(f"{name} w{width}: {len(got)} outputs vs {len(want)}")
                    for g, w in zip(got, want):
                        if g.shape != w.shape or g.dtype != w.dtype:
                            raise AssertionError(f"{name} w{width}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
                        e = int((g.long() - w.long()).abs().max())
                        if e:
                            bad = int(torch.nonzero(g != w)[0, 0])
                            raise AssertionError(
                                f"{name} w{width} {np.dtype(dtype).name}: kernel != plain "
                                f"(max abs err {e}; row {bad}: la={int(lens[0, bad])} "
                                f"lb={int(lens[1, bad])} got {int(g[bad])} want {int(w[bad])})")
                        err = max(err, e)
                kernel, plain = pairs[0]
                k_ms = time_ms(lambda: kernel(*args), 5)
                p_ms = time_ms(lambda: plain(*args), 1)
                ms += k_ms
                plain_ms += p_ms
                extra = ""
                if name == "lev_jaro_fused":
                    s_ms = time_ms(lambda: separate_kernels(*args), 5)
                    extra = f", separate K1+K2+K3+prefix {s_ms:.4f} ms"
                print(f"  {name:18s} w{width:<3d} {np.dtype(dtype).name:5s} "
                      f"rows {BLOCK}: exact, kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms{extra}",
                      flush=True)
        summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return summary


# --- phase 4: end to end ------------------------------------------------------

def _oracle_scores(task):
    """Worker: oracle scores [rows, measures] for (a, b) pairs, NaN at nulls."""
    from strsim_tpu_torch.ops.oracle import ORACLES

    pairs = task
    out = np.full((len(pairs), len(FIVE)), np.nan)
    for r, (a, b) in enumerate(pairs):
        if a is not None and b is not None:
            out[r] = [ORACLES[m](a, b) for m in FIVE]
    return out


def oracle_check(label, col_a, col_b, got: dict, pool) -> None:
    rng = np.random.default_rng(SEED + 1)
    rows = np.sort(rng.choice(len(col_a), size=min(ORACLE_ROWS, len(col_a)), replace=False))
    pairs = [(col_a[i], col_b[i]) for i in rows]
    chunks = [pairs[k : k + 250] for k in range(0, len(pairs), 250)]
    want = np.concatenate(pool.map(_oracle_scores, chunks))
    for k, m in enumerate(FIVE):
        if got[m][rows].tobytes() != want[:, k].tobytes():
            bad = int(np.nonzero(got[m][rows] != want[:, k])[0][0])
            raise AssertionError(f"{label} {m}: row {rows[bad]} got {got[m][rows][bad]!r} "
                                 f"want {want[bad, k]!r}")
    print(f"  {label}: {rows.size} rows byte-identical to the oracle on all five measures", flush=True)


def run_workloads(st, workloads) -> dict:
    """The main path: compute_many over the five measures, then each measure
    function, on every workload, and one more five-measure pass that records
    where the wall time goes (RunMetrics). Returns {label: compute_many
    scores}."""
    from strsim_tpu_torch.models.pipeline import compute_scores
    from strsim_tpu_torch.utils.metrics import RunMetrics

    scores = {}
    for label, col_a, col_b in workloads:
        n = len(col_a)
        t0 = time.perf_counter()
        many = st.compute_many(FIVE, col_a, col_b)
        dt = time.perf_counter() - t0
        print(f"  {label}: compute_many(five) {n} pairs in {dt:.3f} s = {n / dt:.0f} pairs/s", flush=True)
        rm = RunMetrics()
        compute_scores(col_a, col_b, FIVE, metrics=rm)
        print(f"  {label}: wall s encode {rm.encode_wall_s:.3f}, classify {rm.classify_wall_s:.3f}, "
              f"buckets (sort, pack, upload, kernels, download) {rm.device_wall_s:.3f}, finalize "
              f"{rm.finalize_wall_s:.3f}, total {rm.total_wall_s:.3f}; rows null {rm.null_rows}, "
              f"host fast path {rm.fast_path_rows + rm.one_empty_rows}, device {rm.device_rows}, "
              f"oracle {rm.oracle_rows}; buckets {sorted(rm.buckets)}", flush=True)
        for m in FIVE:
            t0 = time.perf_counter()
            one = getattr(st, m)(col_a, col_b)
            dt = time.perf_counter() - t0
            if one.tobytes() != many[m].tobytes():
                raise AssertionError(f"{label}: {m}() differs from compute_many")
            print(f"  {label}: {m} {n / dt:.0f} pairs/s ({dt:.3f} s)", flush=True)
        scores[label] = many
    return scores


def check_golden_and_demo(st) -> None:
    from strsim_tpu_torch.ops.oracle import ORACLES

    through_kernels = st.get_config().replace(host_short_circuit_rows=0)
    n_cases = 0
    for path in sorted((ROOT / "tests" / "golden").glob("*.json")):
        cases = json.loads(path.read_text())
        n_cases += len(cases)
        measure = path.stem
        for cfg in (through_kernels, None):
            got = st.compute(measure, [c[0] for c in cases], [c[1] for c in cases], config=cfg)
            want = np.array([ORACLES[measure](c[0], c[1]) for c in cases])
            expected = np.array([c[2] for c in cases])
            if got.tobytes() != want.tobytes() or not np.all(np.abs(got - expected) < 1e-8):
                raise AssertionError(f"golden {measure}: mismatch")
    if n_cases != 1115:
        raise AssertionError(f"expected 1115 golden cases, found {n_cases}")
    name_a = ["phillips", "phillips", "", "", None, None]
    name_b = ["phillips", "philips", "phillips", "", "phillips", None]
    table = {
        "levenshtein": [1.0, 0.875, 0.0, 1.0],
        "jaro": [1.0, 0.9583333333333334, 0.0, 1.0],
        "jaro_winkler": [1.0, 0.975, 0.0, 1.0],
        "jaccard": [1.0, 0.875, 0.0, 1.0],
        "sorensen_dice": [1.0, 0.9333333333333333, 0.0, 1.0],
    }
    for cfg in (through_kernels, None):
        out = st.compute_many(FIVE, name_a, name_b, config=cfg)
        for m, want in table.items():
            if out[m][:4].tolist() != want or not np.isnan(out[m][4:]).all():
                raise AssertionError(f"demo table {m}: {out[m].tolist()}")
    print(f"  golden: {n_cases} cases byte-identical to the oracle, through the kernels "
          "and the default config; demo table exact", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import strsim_tpu_torch as st
    from strsim_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    device = torch.device("cuda", 0)
    print(f"phase 1 device: {card} | torch {torch.__version__} CUDA {torch.version.cuda} "
          f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"phase 2 build: {len(_build.LIBRARIES)} libraries ready in "
          f"{time.perf_counter() - t0:.1f} s (built here: {sorted(built)})", flush=True)
    for name, (_, log) in sorted(built.items()):
        print(f"  ptxas {name}: {ptxas_summary(log)}")

    print("phase 3 kernels vs plain torch on the card:", flush=True)
    summary = check_kernels(device)

    print("phase 4 end to end:", flush=True)
    sys.path.insert(0, str(ROOT))
    import bench

    workloads = [
        ("make_pairs(1_000_000)", *bench.make_pairs(1_000_000)),
        ("make_wide_pairs(200_000)", *bench.make_wide_pairs(200_000)),
    ]
    _build.reset_launch_counts()
    scores = run_workloads(st, workloads)
    launches = _build.launch_counts()
    print(f"  launches on the main path: {launches}", flush=True)
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    for label, col_a, col_b in workloads:
        valid = np.array([x is not None and y is not None for x, y in zip(col_a, col_b)])
        for m in FIVE:
            v = scores[label][m]
            if v.shape != (len(col_a),) or v.dtype != np.float64:
                raise AssertionError(f"{label} {m}: {v.dtype} {v.shape}")
            if not (np.isnan(v[~valid]).all() and ((v[valid] >= 0) & (v[valid] <= 1)).all()):
                raise AssertionError(f"{label} {m}: NaN off the null rows or a score outside [0, 1]")
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(8) as pool:
        for label, col_a, col_b in workloads:
            oracle_check(label, col_a, col_b, scores[label], pool)
    check_golden_and_demo(st)

    print(f"phase 5 done in {time.perf_counter() - t_start:.1f} s", flush=True)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], **summary[name]}
        for name, (src, tpu) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
