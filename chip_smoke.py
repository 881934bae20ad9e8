#!/usr/bin/env python3
"""Drive strsim_tpu_torch on one CUDA GPU and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels levenshtein_myers,osa_scan   # phases 1-3 for these only

Phases, one line of findings each (any failure exits non-zero):
  1. device: the card's name, power limit and maximum SM clock (nvidia-smi),
     and where Python.h lies (the native library's str-object routes need it);
  2. build: every CUDA kernel from csrc/ (K11 csrc/warm.cu among them), one
     nvcc per source in parallel, and the native host library (g++), each
     build's time (each library's `-Xptxas -v` log, kept beside the
     library when it was built, to chiprun_out/ptxas/<library>.log, whether
     this run built it or found it built), and each K9, K10 and K23
     instantiation's registers, stack frame and spills (without --kernels,
     a missing report fails, as does a K10 instantiation with a stack frame
     or a spill, whose DP state belongs in registers, and a K23
     instantiation that spills);
  3. kernels: each kernel against its plain torch version on the card, at the
     main path's shapes (65536-row blocks at each ladder width it serves, int8
     and int32 tiles, seeded inputs incl. astral codepoints and the rows of
     `lane_rows` and every word-boundary length, one set of tiles per width
     and dtype that every kernel there reads), K2 with and without the
     prefix (and without it also beside the plain prefix, the route's time
     before the prefix moved into K2), first K2's residency at each ladder
     width (blocks an SM, registers, local and shared memory), K5 with its
     multiset, OSA and LCS outputs on and off, K6 with all three recurrences
     at every width and with {lev, osa}, {osa, lcs}, {lcs} at w31/w63/w255;
     integers must match exactly; both times from CUDA events, and the
     kernel's own device time (`device_ms`, from one torch.profiler session
     over 5 more launches of every case: see `DeviceTimes`), beside the
     least time the card could take (`bound_ms`, from this run's lengths:
     strsim_tpu_torch/ops/roofline.py); for K5 also the time of the separate
     kernels it replaces;
     K9 (its m and both flag tensors; beside it the forced jaro route,
     jaro_flags_cuda.jaro_match_stats, K9 with the plain transposition count
     and patch) and K10 (beside its bound, K1's, the full DP's own floor:
     roofline.dp_floor_ms) at every width on both dtypes,
     K4 at every width on int8 (a forced "pallas_hist" sends it narrow tiles);
     K11 (x * 2 + 1) on [8, 128] and [65536, 128] int32 over the whole int32
     range, on an offset view of the latter and on 3 and 1,021 elements,
     beside torch.add(one, x, alpha=2) (`library_ms`);
     the jaro probes K12-K15 (csrc/probe_jaro.cu, strsim_tpu_torch/probes/)
     at their tools' widths: K12 (m and both flag words) at w7, w15, w31,
     K13 (raw m, t on byte slots) at w95, w127, w255, w511 on int8, K14 in
     both clips at w191, w383, w511, K15 in its four modes at w15, w31, w63,
     w255, w511 on int8 and w511 on int32; the Myers and fused lev + jaro
     probes K16-K19 (csrc/probe_myers.cu, csrc/probe_fused_lj.cu,
     strsim_tpu_torch/probes/myers.py): K16 (its scan and its unrolled
     steps, over Eq words built once a tile outside the timed launches) and
     K17 at w7, w15, w31, w32 on int8 and int32, K18 there on int8, K19 at
     w15 and w31 on int8; the multiset probes K20-K22
     (csrc/probe_multiset.cu, strsim_tpu_torch/probes/multiset.py) at every
     narrow width: K20 in its three modes and K22 with 4 and 8 a-positions a
     read on int8 and int32, K21 on int8; K23 (csrc/topk_scan.cu) on BLOCK
     queries against the 1,105 names of the benchmark's dictionary cell,
     int8 rows and int32 rows (TOPK_WIDE), jaro and jaro_winkler, k = 5 and
     8, the names in one shared-memory tile and in five, ids and score bits
     equal to its plain form's (`check_topk`; its bound
     roofline.topk_bound); and at the cell's size (`check_topk_cell`:
     1,000,000 queries, int8, jaro_winkler, k = 5; sampled queries against
     the plain form), with its greedy share and ptxas lines;
     with --kernels, the run ends here (an A/B of kernels between two trees
     copies this script into each and runs it there);
  4. end to end: bench.py's make_pairs(1_000_000) and make_wide_pairs(200_000)
     through compute_many over the five measures, over all fourteen and over
     (levenshtein, osa, lcs_seq, indel), and through each of the fourteen
     measure functions (native encode, pack into pinned memory and native
     finalize; the host phases and the encode route of each pass printed),
     with the launch counts zeroed just before and read
     just after (K1-K8 must all launch, K5 also with its OSA and LCS outputs
     on, K2 with its prefix), and for the five, all fourteen, a jaccard()
     pass (K3 at w7..w63, K4 above) and a jaro() pass each kernel's event
     and device time per pass from the buckets' rows and phase 3's times
     (`pass_reckoning`), and for the five and the jaro pass the route of the
     prefix on each bucket (K2's wherever K2 serves jaro_m); then the
     forced-implementation path, compute_many over the five
     with levenshtein_impl="pallas", jaro_impl="pallas" on both workloads
     whole, and every other forced combination (DIFFERENTIAL and
     `single_overrides`, which the tests/test_torch_forced_*.py files share)
     on 20,000 rows of each, all byte-identical to the default config's
     scores, each with its own launch counts: every kernel that stat_routes
     names for it on the buckets it formed must launch (K9 and K10 on the
     forced path); a second forced five pass on each workload records its
     buckets, its host phases and each kernel's time a pass, K9's and K10's
     by bucket (`pass_reckoning`);
     scores byte-identical to the pure-Python oracle on all fourteen
     measures for 20K rows of make_pairs, on the five for 20K rows of
     make_wide_pairs and on the nine extensions for 4K of them (the OSA and
     LCS oracles are O(la * lb) a row), the 1,115 golden cases and the README
     demo table;
     native: on those rows the native library's scores (native_compute)
     byte-identical to the same oracle scores, its encode of both workloads
     equal to the numpy route, and its finalize (native_finalize=True)
     byte-identical to the numpy finalizers on the kernels' stats, all
     fourteen measures;
     linkage (`run_linkage`): top_k_matches at the dictionary cell's size
     (1,000,000 queries against its 1,105 names, jaro_winkler, k = 5), the
     launch counts zeroed just before and read just after (K23 must launch,
     and on no pairs path), its spans and counters printed, every query's
     own name first at 1.0 and 4,096 sampled queries byte-identical to the
     plain route;
     bench_torch.py in this process at a reduced size (200,000 pairs, 3 timed
     passes, 40,000 wide), its launch counts zeroed before and read after
     (K11 and the kernels of its sections must launch), its JSON line
     printed;
     tools/ab_torch_jaro.py, tools/ab_torch_myers.py, then
     tools/ab_torch_multiset.py, in this process at a reduced size (one
     width a probe: w15, w255, w383, w31 for the jaro probes; pallas w15,
     swar w15, fused_lj L = 31 for the Myers ones; w15 for the multiset
     ones; 2 trip counts), the launch counts zeroed before each and read
     after (the jaro tool: K2 and K12-K15, both clips and all four modes;
     the Myers tool: K1, K2, K5 and K16-K19, K16 in both loop forms; the
     multiset tool: K3, K4 and K20-K22, K20 in all three modes; no probe
     launches on the main path, the forced paths or bench_torch.py's run),
     each JSON line printed;
  5. a {"kernels": [...]} JSON line, the card line again, and last
     {"ok": true, "device": {...}}. Each phase-3 case also goes as a JSON line
     to chiprun_out/chip_smoke_kernels.jsonl.

Imports neither jax nor strsim_tpu. Exits non-zero without a CUDA device.
Stops and reaps every process it starts before it exits (`stop_children`).
"""
from __future__ import annotations

import contextlib
import importlib.util
import inspect
import json
import multiprocessing
import pathlib
import re
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
FIVE = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")
EXT = ("jaccard_bigram", "sorensen_dice_bigram", "cosine", "overlap", "hamming",
       "lcs_seq", "indel", "osa", "soundex")
ALL = FIVE + EXT
DP_SET = ("levenshtein", "osa", "lcs_seq", "indel")
LADDER = (7, 15, 23, 31, 47, 63, 95, 127, 191, 255, 383, 511)
NARROW = tuple(w for w in LADDER if w <= 63)
BLOCK = 65536
ORACLE_ROWS = 20_000
ORACLE_ROWS_WIDE_EXT = 4_000
SEED = 20261016
OUT_DIR = ROOT / "chiprun_out"

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
    "dp_fused": ("strsim_tpu_torch/csrc/dp_fused.cu",
                 "strsim_tpu/ops/dp_fused_pallas.py:69"),
    "osa_scan": ("strsim_tpu_torch/csrc/osa_scan.cu",
                 "strsim_tpu/ops/osa_pallas_scan.py:59"),
    "bigram": ("strsim_tpu_torch/csrc/bigram.cu",
               "strsim_tpu/ops/bigram_pallas.py:62"),
    "jaro_flags": ("strsim_tpu_torch/csrc/jaro_flags.cu",
                   "strsim_tpu/ops/jaro_pallas.py:36"),
    "levenshtein_wavefront": ("strsim_tpu_torch/csrc/levenshtein_wavefront.cu",
                              "strsim_tpu/ops/levenshtein_pallas.py:41"),
    "warm": ("strsim_tpu_torch/csrc/warm.cu", "bench.py:685"),
    "jaro_flags_probe": ("strsim_tpu_torch/csrc/probe_jaro.cu", "tools/ab_jaro_pallas.py:59"),
    "jaro_packed_t": ("strsim_tpu_torch/csrc/probe_jaro.cu", "tools/ab_jaro_wide.py:38"),
    "jaro_clipped": ("strsim_tpu_torch/csrc/probe_jaro.cu", "tools/ab_jaro_wide2.py:56"),
    "jaro_ablated": ("strsim_tpu_torch/csrc/probe_jaro.cu", "tools/ab_jaro_sol_probe.py:62"),
    "myers_eq_scan": ("strsim_tpu_torch/csrc/probe_myers.cu", "tools/ab_myers_pallas.py:92"),
    "myers_ineq": ("strsim_tpu_torch/csrc/probe_myers.cu", "tools/ab_myers_pallas.py:113"),
    "myers_swar": ("strsim_tpu_torch/csrc/probe_myers.cu", "tools/ab_myers_swar.py:54"),
    "fused_lev_jaro": ("strsim_tpu_torch/csrc/probe_fused_lj.cu", "tools/ab_fused_lj.py:86"),
    # K20 also replaces tools/ab_multiset_r3.py's _kernel_tree :40 and _kernel_astype :66
    "multiset_unrolled": ("strsim_tpu_torch/csrc/probe_multiset.cu",
                          "tools/ab_multiset_pallas.py:39"),
    "multiset_swar": ("strsim_tpu_torch/csrc/probe_multiset.cu", "tools/ab_multiset_r3.py:89"),
    "multiset_blocked": ("strsim_tpu_torch/csrc/probe_multiset.cu", "tools/ab_multiset_r3.py:140"),
    # K23 replaces K2's TPU kernel on the linkage path, which runs it inside
    # strsim_tpu/models/linkage.py:_scan_scorer's lax.scan over candidate blocks
    "topk_scan": ("strsim_tpu_torch/csrc/topk_scan.cu", "strsim_tpu/ops/jaro_pallas_scan.py:106"),
}
# launched on the linkage path (run_linkage), not on the pairs' main path
LINKAGE_KERNELS = ("topk_scan",)
# K23's cases: the benchmark's name-dictionary cell (names.topk.jw.1m), its
# 1,105 names (perfbench/generators/name_dictionary.py) as the candidates;
# phase 3 at BLOCK queries, k in TOPK_K, in one shared-memory tile and in
# tiles of at most TOPK_TILE; its int32 rows take two letters past ASCII
# (one astral) in every other name; phase 4 at the cell's TOPK_QUERIES
# queries, k = 5, TOPK_SAMPLE of them against the plain route
TOPK_NAMES = "data/genealogy_pairs.json"
TOPK_K = (5, 8)
TOPK_TILE = 256
TOPK_WIDE = str.maketrans({"a": "\u00e4", "y": "\U0001F600"})
TOPK_QUERIES = 1_000_000
TOPK_SAMPLE = 4_096
# K11 and the kernels of bench_torch.py's sections (the five measures alone
# and together on make_pairs, levenshtein, jaro_winkler, jaccard and osa on
# make_wide_pairs): each must launch on its run
BENCH_KERNELS = ("warm", "levenshtein_myers", "jaro_scan", "multiset_rank", "multiset_hist",
                 "lev_jaro_fused", "osa_scan")
BENCH_ARGS = ("--n-pairs", "200000", "--passes", "3", "--n-wide", "40000")
BENCH_ONLY = ("warm",)  # launched on bench_torch.py's run, not the main path's
# The probes, K12-K15 (strsim_tpu_torch/probes/jaro.py), K16-K19
# (probes/myers.py) and K20-K22 (probes/multiset.py): launched on phase 3 and
# on their tools' runs
# (PROBE_ARGS, in this process), never on a main path. Each tool must launch
# its probes, their baselines and each variant's count.
PROBE_TOOLS = {
    "ab_torch_jaro": ("jaro_flags_probe", "jaro_packed_t", "jaro_clipped", "jaro_ablated",
                      "jaro_scan", "jaro_clipped.row", "jaro_ablated.full",
                      "jaro_ablated.no_tcount", "jaro_ablated.scan_only", "jaro_ablated.eqb_only"),
    "ab_torch_myers": ("myers_eq_scan", "myers_ineq", "myers_swar", "fused_lev_jaro",
                       "myers_eq_scan.unroll", "levenshtein_myers", "jaro_scan", "lev_jaro_fused"),
    "ab_torch_multiset": ("multiset_unrolled", "multiset_swar", "multiset_blocked",
                          "multiset_unrolled.select", "multiset_unrolled.tree",
                          "multiset_unrolled.astype", "multiset_rank", "multiset_hist"),
}
PROBE_ONLY = ("jaro_flags_probe", "jaro_packed_t", "jaro_clipped", "jaro_ablated",
              "myers_eq_scan", "myers_ineq", "myers_swar", "fused_lev_jaro",
              "multiset_unrolled", "multiset_swar", "multiset_blocked")
PROBE_ARGS = ("--quick", "--trips", "2,6")
# K11's cases: (label, shape, elements skipped at the front of the flattened
# tensor): bench.py's tile, a block's worth, an offset view (a 4-byte shift
# from the 16-byte boundary of the output), n < 4 and n % 4 != 0
WARM_CASES = (("8x128", (8, 128), 0), ("65536x128", (BLOCK, 128), 0),
              ("65536x128+1", (BLOCK, 128), 1), ("3", (3,), 0), ("1021", (1021,), 0))
# launch counts the main path must also show: K5 with its OSA / LCS outputs
# on, K2 with the prefix
VARIANTS = ("lev_jaro_fused.osa", "lev_jaro_fused.lcs", "jaro_scan.prefix")
# the forced-implementation path (tests/test_differential.py:50-52) and the
# kernels only it reaches
FORCED = {"levenshtein_impl": "pallas", "jaro_impl": "pallas"}
FORCED_KERNELS = ("jaro_flags", "levenshtein_wavefront")
FORCED_ROWS = 20_000
# FORCED and the implementation matrix of tests/test_differential.py:61-69;
# with `single_overrides` the forced configurations that this script and the
# tests/test_torch_forced_*.py files drive
DIFFERENTIAL = (
    FORCED,
    {"levenshtein_impl": "myers", "jaro_impl": "bitmask", "multiset_impl": "chunked"},
    {"levenshtein_impl": "pallas_scan", "jaro_impl": "bitmask", "multiset_impl": "pallas_scan"},
    {"levenshtein_impl": "myers", "jaro_impl": "bitmask", "multiset_impl": "xla"},
    {"levenshtein_impl": "wavefront", "jaro_impl": "scan", "multiset_impl": "table"},
)

# The card's peaks and each kernel's bound: strsim_tpu_torch/ops/roofline.py
# (`bound`, `work_ops`, `card_line`, `max_sm_clock_hz`).


def ptxas_kernels(log: str) -> list:
    """[(kernel, registers, stack frame bytes, spill store bytes, spill load
    bytes)] for every entry function in an `nvcc -Xptxas -v` log, names
    demangled where the toolkit's cu++filt (or c++filt) is found."""
    import shutil
    import subprocess

    found = []
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", chunk)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                          chunk)
        found.append([name, int(regs.group(1)) if regs else 0,
                      *(int(x) for x in (frame.groups() if frame else (0, 0, 0)))])
    filt = shutil.which("cu++filt") or shutil.which("/usr/local/cuda/bin/cu++filt") or shutil.which("c++filt")
    if filt and found:
        done = subprocess.run([filt], input="\n".join(k[0] for k in found), capture_output=True,
                              text=True)
        names = done.stdout.splitlines()
        if done.returncode == 0 and len(names) == len(found):
            for k, name in zip(found, names):
                for ns in ("strsim::(anonymous namespace)::", "strsim::<unnamed>::"):
                    name = name.replace(ns, "")
                name = name.replace("signed char", "int8").removeprefix("void ")
                k[0] = name[:name.rfind(">(") + 1] or name  # the template, not the arguments
    return [tuple(k) for k in found]


def print_forced_ptxas(logs: dict, strict: bool) -> list:
    """Registers, stack frame and spills of each instantiation of K9, K10
    and K23, from `logs` ({library: its nvcc log}); if `strict`, each of the
    three must have a report, every K10 instantiation must keep its DP state
    in registers (no stack frame, no spill), and no K23 instantiation may
    spill. Returns K23's [(kernel, registers, stack frame, spill stores,
    spill loads)]."""
    topk = []
    for name, kernel in (("jaro_flags", "K9"), ("levenshtein_wavefront", "K10"),
                         ("topk_scan", "K23")):
        found = ptxas_kernels(logs.get(name, ""))
        if not found:
            print(f"  {kernel}: no ptxas report in {name}'s build log", flush=True)
            if strict:
                raise AssertionError(f"{kernel}: no ptxas report in {name}'s build log")
        for fn, regs, frame, stores, loads in found:
            print(f"  {kernel} {fn}: registers {regs}, stack frame {frame} B, spill stores "
                  f"{stores} B, spill loads {loads} B", flush=True)
            if kernel == "K23":
                topk.append((fn, regs, frame, stores, loads))
            if strict and kernel == "K10" and frame + stores + loads:
                raise AssertionError(f"K10 {fn}: {frame} B stack frame, {stores + loads} B spilled")
            if strict and kernel == "K23" and stores + loads:
                raise AssertionError(f"K23 {fn}: {stores + loads} B spilled")
    return topk


def ptxas_summary(log: str) -> str:
    """One line from `nvcc -Xptxas -v`: kernels, most registers, largest stack
    frame, and spill bytes summed over every kernel of a library."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", log)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", log))
    return (f"{len(regs)} kernels, registers <= {max(regs, default=0)}, "
            f"stack frame <= {max(stack, default=0)} B, spill {spills} B")


# --- phase 3: kernels against their plain versions ---------------------------

def lane_rows(rng, rows, a, b, la, lb, dtype) -> None:
    """Overwrite two thirds of the rows (rows % 12 in 0, 1, 3, 4, 6, 7, 9,
    10) of the unpadded [n, width] char arrays a, b and the lengths la, lb
    with rows that stress the lane-group kernels (one word of 32 chars a
    lane):
      0: rows far shorter than their bucket (la <= 8; lb as short, or long);
      1: one char repeated, more often in a than in b or the other way round
         (the multiset counts);
      3: chars over the full 0..127 alphabet, codes 0 and 127 in every row
         (int32 tiles: half of them codepoints up to U+10FFFF);
      4: one bigram repeated, more often in a than in b or the other way
         round (the bigram counts);
      6: all-equal rows of length 32k, k = 1 .. width // 32 in turn, whose
         addition carries run through every word;
      7: a bigram of b at positions 31 and 32 (the last two at widths below
         33), across bit 31/32, and one of a at 30, 31 or 32, each also found
         in the other side;
      9: jaro rows whose matches lie at the window's edge (b is a rotated by
         bound - 1, bound or bound + 1 places either way over the full
         alphabet), so windows whose ends cross word boundaries decide them;
      10: sides of length 0, 1 and 2 against any length."""
    width = a.shape[1]

    def chars(shape):
        c = rng.integers(0, 128, shape)
        if dtype != np.int8:
            c = np.where(rng.random(shape) < 0.5, c, rng.integers(0, 0x110000, shape))
        return c

    kind = rows % 12
    short = rows[kind == 0]
    la[short] = rng.integers(1, min(width, 8) + 1, short.size)
    lb[short] = np.where(rng.random(short.size) < 0.5,
                         np.clip(la[short] + rng.integers(-2, 3, short.size), 1, width),
                         rng.integers(0, width + 1, short.size))

    full = rows[kind == 3]
    a[full] = chars((full.size, width))
    a[full, 0] = 0
    a[full, width - 1] = 127
    b[full] = a[full]
    b[full, rng.integers(0, width, full.size)] = chars(full.size)
    b[full, rng.integers(0, width, full.size)] = 127
    b[full, 0] = 0
    lb[full] = np.clip(la[full] + rng.integers(-2, 3, full.size), 0, width)

    def counts(which, fill):
        """Put `fill` (chars per row, [rows, k]) at every k-th slot of a and b
        with probabilities 0.7 / 0.2 or 0.2 / 0.7: more in one side."""
        more_a = rng.random(which.size) < 0.5
        for side, p in ((a, np.where(more_a, 0.7, 0.2)), (b, np.where(more_a, 0.2, 0.7))):
            side[which] = chars((which.size, width))
            k = fill.shape[1]
            for s0 in range(0, width - k + 1, k):
                put = rng.random(which.size) < p
                side[which[put], s0:s0 + k] = fill[put]
        la[which] = rng.integers(1, width + 1, which.size)
        lb[which] = rng.integers(1, width + 1, which.size)

    same = rows[kind == 1]
    counts(same, chars((same.size, 1)))
    pairs = rows[kind == 4]
    if width >= 2:
        counts(pairs, chars((pairs.size, 2)))

    cross = rows[kind == 7]
    if width >= 2:
        a[cross], b[cross] = chars((cross.size, width)), chars((cross.size, width))
        la[cross] = rng.integers(min(33, width), width + 1, cross.size)
        lb[cross] = rng.integers(min(33, width), width + 1, cross.size)
        # b's at 31 (the last at widths below 33), a's at 30, 31 or 32, each
        # found at some place in the other side too
        for side, start, other, n_other in (
                (b, np.full(cross.size, min(31, width - 2)), a, la),
                (a, np.minimum(rng.integers(30, 33, cross.size), width - 2), b, lb)):
            gram = chars((cross.size, 2))
            side[cross, start], side[cross, start + 1] = gram[:, 0], gram[:, 1]
            at = rng.integers(0, n_other[cross] - 1)
            other[cross, at], other[cross, at + 1] = gram[:, 0], gram[:, 1]

    flat = rows[kind == 6]
    ks = np.arange(1, width // 32 + 1) * 32 if width >= 32 else np.array([width])
    a[flat] = b[flat] = 98
    la[flat] = lb[flat] = ks[np.arange(flat.size) % ks.size]

    edge = rows[kind == 9]
    length = rng.integers(2, width + 1, edge.size) if width >= 2 else np.ones(edge.size, np.int64)
    bound = np.maximum(length // 2 - 1, 0)
    shift = np.clip(bound + rng.integers(-1, 2, edge.size), 0, None)
    shift = np.where(rng.random(edge.size) < 0.5, shift, -shift)
    a[edge] = chars((edge.size, width))
    pos = np.arange(width)[None, :]
    src = (pos - shift[:, None]) % length[:, None]
    b[edge] = np.where(pos < length[:, None], np.take_along_axis(a[edge], src, 1), a[edge])
    la[edge] = lb[edge] = length

    tiny = rows[kind == 10]
    small = rng.integers(0, 3, tiny.size)
    other = rng.integers(0, width + 1, tiny.size)
    pick = rng.integers(0, 3, tiny.size)  # which side is short, or both
    la[tiny] = np.where(pick == 1, other, small)
    lb[tiny] = np.where(pick == 0, other, np.where(pick == 1, small, rng.integers(0, 3, tiny.size)))


def make_tiles(rng, n: int, width: int, dtype):
    """A packed [n, 2*width] tile (a | b per row, as the pipeline packs it)
    and [2, n] int32 lengths [la; lb], padded with -1 / -2.

    A small alphabet (int8: ASCII with NUL; int32: ASCII, BMP and astral
    codepoints) keeps matches, repeats, greedy ties and transpositions dense.
    Rows: near-duplicates (one substitution, one adjacent swap), independent
    pairs, equal pairs, empty sides, len-1/len-1 pairs (rows % 11 == 5),
    all-equal rows whose length ends on a word boundary, so that bit 31 is
    the tracked Myers bit and jaro flags fill whole words (rows % 13 == 6),
    and padded rows (la = lb = 0) at the end, as at the end of a bucket.
    The first rows take the edge lengths 0, 1, 2, width - 1, width and each
    word boundary 32k and 32k +- 1 up to the width, so the tracked bit lies
    in every word (every lane of a lane-group kernel). Eight kinds of row
    stress those kernels (`lane_rows`), in place of random rows."""
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
    lane_rows(rng, rows, a, b, la, lb, dtype)
    one = rows % 11 == 5
    la[one] = lb[one] = 1
    top = rows % 13 == 6
    a[top] = b[top] = alphabet[1]
    la[top] = lb[top] = (width // 32) * 32 or width
    edges = [0, 1, 2, width - 1, width] + [32 * k + d for k in range(1, width // 32 + 2)
                                           for d in (-1, 0, 1) if 32 * k + d <= width]
    edges = edges[:n]
    la[: len(edges)] = edges
    lb[: len(edges)] = edges[::-1]
    pads = max(n // 1024, 1)
    la[-pads:] = lb[-pads:] = 0
    pos = np.arange(width)[None, :]
    a[pos >= la[:, None]] = -1
    b[pos >= lb[:, None]] = -2
    packed = np.concatenate([a, b], axis=1).astype(dtype)
    return packed, np.stack([la, lb]).astype(np.int32)


def time_ms(fn, reps: int, warm_up: bool = True) -> float:
    import torch

    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class DeviceTimes:
    """One torch.profiler session (CPU and CUDA activity) over the kernels'
    timed launches of phase 3, each case's launches under a record_function
    range named by its label; nothing else runs on the card inside it (the
    plain versions' many small kernels would swamp the trace, and toggling
    CUDA collection off and on loses the kernels after it on torch 2.11).
    `per_launch(label)` is then the mean device time of that case's kernels:
    their own time, without the host's launch pace. The cases run one after
    another with the card synchronised between them, so the session's
    kernels in device order are each case's launches in turn; they are
    matched to the cases by that order, not by time (the device timeline is
    not aligned with the host's closely enough to tell neighbouring cases
    apart, nor are the kernels linked to the ranges)."""

    def __init__(self, launches: int):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.launches = launches
        self.labels = []  # the cases in the order they ran
        self.times = None  # label -> ms a launch, read at the first per_launch

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    @contextlib.contextmanager
    def recording(self, label):
        import torch

        self.labels.append(label)
        torch.cuda.synchronize()
        with torch.profiler.record_function(label):
            yield
            torch.cuda.synchronize()

    def per_launch(self, label) -> float:
        from torch.autograd import DeviceType

        if self.times is None:
            names = set(self.labels)  # each range also lands on the device timeline
            kernels = sorted((e.time_range.start, e.time_range.end, e.name) for e in self.prof.events()
                             if e.device_type == DeviceType.CUDA and e.name not in names)
            n = self.launches
            if len(kernels) != n * len(self.labels):
                raise AssertionError(f"{len(kernels)} device kernels in the profile, expected "
                                     f"{n} for each of {len(self.labels)} cases")
            self.times = {}
            for i, case in enumerate(self.labels):
                group = kernels[n * i: n * (i + 1)]
                if len({name for *_, name in group}) != 1:
                    raise AssertionError(f"{case}: its {n} kernels are not one kernel: {group}")
                self.times[case] = sum(e - s for s, e, _ in group) / 1e3 / n
        return self.times[label]


def kernel_cases():
    """(name, [(flags, kernel, plain), ...], widths, dtypes): every pair is
    checked and timed at every width and dtype; `flags` are the keyword
    arguments that select the kernel's outputs."""
    from functools import partial

    from strsim_tpu_torch.ops import (bigram_cuda, dp_fused_cuda, jaro_cuda, jaro_flags_cuda,
                                      lev_jaro_cuda, levenshtein_cuda,
                                      levenshtein_wavefront_cuda, multiset_cuda, osa_cuda)
    from strsim_tpu_torch.probes import jaro as probes
    from strsim_tpu_torch.probes import multiset, myers

    def variants(kernel, plain, *flag_sets):
        return [(flags, partial(kernel, **flags), partial(plain, **flags)) for flags in flag_sets]

    both = (np.int8, np.int32)
    k5 = variants(lev_jaro_cuda.lev_jaro_stats, lev_jaro_cuda.lev_jaro_plain,
                  *({"with_inter": i, "with_osa": o, "with_lcs": o}
                    for i, o in ((True, False), (False, False), (True, True), (False, True))))
    k6 = partial(variants, dp_fused_cuda.dp_fused_stats, dp_fused_cuda.dp_fused_plain)
    k15 = variants(probes.jaro_ablated, probes.jaro_ablated_plain,
                   *({"mode": mode} for mode in probes.MODES))
    words = {}  # K16's Eq words of each phase-3 tile, built once outside the timed launches

    def eq_of(a, b):
        key = (a.data_ptr(), b.data_ptr(), tuple(a.shape), a.stride(0))
        if key not in words:
            words[key] = myers.pattern_eq_words(a, b)
        return words[key]

    def k16(loop):
        unroll = loop == "unroll"

        def kernel(a, b, la, lb):
            return myers.myers_eq_scan(eq_of(a, b), la, lb, unroll)

        def plain(a, b, la, lb):
            return myers.myers_eq_scan_plain(eq_of(a, b), la, lb, unroll)

        return {"loop": loop}, kernel, plain

    def on_len_a(fn, **kw):  # the multiset probes read len_a only
        return lambda a, b, la, lb: fn(a, b, la, **kw)

    k2 = [({}, jaro_cuda.jaro_match_stats, jaro_cuda.jaro_plain)]
    if "with_prefix" in inspect.signature(jaro_cuda.jaro_match_stats).parameters:
        k2 += variants(jaro_cuda.jaro_match_stats, jaro_cuda.jaro_plain, {"with_prefix": True})

    k20 = [({"mode": m}, on_len_a(multiset.multiset_unrolled, mode=m),
            on_len_a(multiset.multiset_unrolled_plain, mode=m)) for m in multiset.MODES]
    k22 = [({"gi": f"gi{g}"}, on_len_a(multiset.multiset_blocked, gi=g),
            on_len_a(multiset.multiset_blocked_plain, gi=g)) for g in multiset.GROUPS]

    return [
        ("levenshtein_myers", [({}, levenshtein_cuda.levenshtein_distance,
                                levenshtein_cuda.myers_plain)], LADDER, both),
        ("jaro_scan", k2, LADDER, both),
        ("multiset_rank", [({}, multiset_cuda.multiset_intersection_rank,
                            multiset_cuda.rank_plain)], NARROW, both),
        # K4 serves int8 above 63 under "auto" and every width under "pallas_hist"
        ("multiset_hist", [({}, multiset_cuda.multiset_intersection_hist, multiset_cuda.hist_plain)],
         LADDER, (np.int8,)),
        ("lev_jaro_fused", k5, NARROW, both),
        ("dp_fused", k6({"with_lev": True, "with_osa": True, "with_lcs": True}), LADDER, both),
        ("dp_fused", k6({"with_lev": True, "with_osa": True}, {"with_osa": True, "with_lcs": True},
                        {"with_lcs": True}), (31, 63, 255), both),
        ("osa_scan", [({}, osa_cuda.osa_distance, osa_cuda.osa_plain)], LADDER, both),
        ("bigram", [({}, bigram_cuda.bigram_stats, bigram_cuda.bigram_plain)], NARROW, both),
        ("jaro_flags", [({}, jaro_flags_cuda.jaro_flag_scan, jaro_cuda.greedy_scan)], LADDER, both),
        ("levenshtein_wavefront", [({}, levenshtein_wavefront_cuda.levenshtein_distance,
                                    levenshtein_wavefront_cuda.wavefront_plain)], LADDER, both),
        # the jaro probes K12-K15 at their tools' widths (tools/ab_torch_jaro.py)
        ("jaro_flags_probe", [({}, probes.jaro_flags_scan, probes.jaro_flags_scan_plain)],
         (7, 15, 31), both),
        ("jaro_packed_t", [({}, probes.packed_t_stats, probes.packed_t_stats_plain)],
         (95, 127, 255, 511), (np.int8,)),
        ("jaro_clipped", variants(probes.jaro_clipped, probes.jaro_clipped_plain,
                                  *({"clip": clip} for clip in probes.CLIPS)), (191, 383, 511), both),
        ("jaro_ablated", k15, (15, 31, 63, 255, 511), (np.int8,)),
        ("jaro_ablated", k15, (511,), (np.int32,)),
        # the Myers and fused lev + jaro probes K16-K19 (tools/ab_torch_myers.py),
        # at one word: the tools' widths and w32
        ("myers_eq_scan", [k16("scan"), k16("unroll")], (7, 15, 31, 32), both),
        ("myers_ineq", [({}, myers.myers_ineq, myers.myers_ineq_plain)], (7, 15, 31, 32), both),
        ("myers_swar", [({}, myers.myers_swar, myers.myers_swar_plain)], (7, 15, 31, 32),
         (np.int8,)),
        ("fused_lev_jaro", [({}, myers.fused_lev_jaro, myers.fused_lev_jaro_plain)], (15, 31),
         (np.int8,)),
        # the multiset probes K20-K22 (tools/ab_torch_multiset.py), at every narrow width
        ("multiset_unrolled", k20, NARROW, both),
        ("multiset_swar", [({}, on_len_a(multiset.multiset_swar),
                            on_len_a(multiset.multiset_swar_plain))], NARROW, (np.int8,)),
        ("multiset_blocked", k22, NARROW, both),
    ]


def check_warm(device, clock_hz: float, rng) -> dict:
    """K11 against warm_plain, exactly, on each of WARM_CASES, int32 drawn
    over the whole int32 range (x * 2 + 1 wraps), timed beside the PyTorch
    call that computes the same function, torch.add(one, x, alpha=2) with
    `one` allocated beforehand. Returns {"summary": the kernel's summed
    entry, "cases": [(record, launch)]}."""
    from functools import partial

    import torch

    from strsim_tpu_torch.ops.roofline import warm_bound
    from strsim_tpu_torch.ops.warm_cuda import warm, warm_plain

    entry = {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {},
             "library_ms": 0.0}
    cases = []
    for label, shape, skip in WARM_CASES:
        whole = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape).astype(np.int32)).to(device)
        x = whole.view(-1)[skip:] if skip else whole
        one = torch.ones_like(x)
        got, want = warm(x), warm_plain(x)
        p_ms = time_ms(lambda: warm_plain(x), 1, warm_up=False)
        if not torch.equal(got, want):
            raise AssertionError(f"warm {label}: kernel != plain at "
                                 f"{tuple(torch.nonzero(got != want)[0].tolist())}")
        if not torch.equal(torch.add(one, x, alpha=2), want):
            raise AssertionError("torch.add(one, x, alpha=2) differs from x * 2 + 1")
        k_ms = time_ms(lambda: warm(x), 5)
        lib_ms = time_ms(lambda: torch.add(one, x, alpha=2), 5)
        b_ms, b_by = warm_bound(x.numel(), clock_hz)
        record = {"name": "warm", "flags": {"shape": label}, "width": x.shape[-1],
                  "dtype": "int32", "rows": x.numel() // x.shape[-1], "ms": k_ms, "plain_ms": p_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        record["label"] = case_label(record)
        cases.append((record, partial(warm, x)))
        for k, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms), ("library_ms", lib_ms)):
            entry[k] += v
        entry["bound_by"][b_by] = entry["bound_by"].get(b_by, 0) + 1
    return {"summary": entry, "cases": cases}


def dictionary_names(n_queries: int, seed: int):
    """(queries, dictionary), lists of str: the columns of the benchmark's
    name-dictionary cell (perfbench/generators/name_dictionary.py) with
    n_queries queries."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench.generators.name_dictionary import generate

    queries, dictionary = generate(n_queries, seed, rows=TOPK_NAMES)
    return queries.tolist(), dictionary.tolist()


def event_call(fn):
    """(fn(), its ms by CUDA events), one call, no warm-up."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def check_topk(device, clock_hz: float) -> dict:
    """K23 against its plain form (`topk_cuda.topk_plain`) on the card,
    exactly (ids and the scores' bits), on BLOCK queries against the 1,105
    names of the benchmark's dictionary cell, the queries in length order as
    the linkage orders them: int8 rows as the cell has them and int32 rows
    (TOPK_WIDE), jaro and jaro_winkler, k in TOPK_K, the dictionary in one
    shared-memory tile and in tiles of TOPK_TILE. Each case's event time
    beside the plain form's and the bound (`roofline.topk_bound`, from these
    rows' lengths). Returns {"summary": the kernel's summed entry, "cases":
    [(record, launch)]}."""
    from functools import partial

    import torch

    from strsim_tpu_torch.ops import topk_cuda
    from strsim_tpu_torch.ops.roofline import topk_bound
    from strsim_tpu_torch.utils import encode as enc

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    queries, dictionary = dictionary_names(BLOCK, SEED)
    wide = {x: x.translate(TOPK_WIDE) for x in dictionary[::2]}
    entry = {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {}}
    cases = []
    for dtype, qs, cs in (("int8", queries, dictionary),
                          ("int32", [wide.get(x, x) for x in queries],
                           [wide.get(x, x) for x in dictionary])):
        q, c = enc.encode_column(qs, pad=enc.PAD_A), enc.encode_column(cs, pad=enc.PAD_B)
        if q.codes.dtype != np.dtype(dtype) or c.codes.dtype != np.dtype(dtype):
            raise AssertionError(f"K23 {dtype}: encoded as {q.codes.dtype} / {c.codes.dtype}")
        alphabet, c_idx = topk_cuda.candidate_indices(c.codes, c.lengths)
        args = {"q_codes": dev(q.codes), "q_len": dev(q.lengths),
                "q_rows": dev(np.argsort(q.lengths, kind="stable").astype(np.int64)),
                "c_idx": dev(c_idx), "c_len": dev(c.lengths),
                "c_ids": dev(np.arange(c.n, dtype=np.int32)), "alphabet": dev(alphabet)}
        plain_args = (args["q_codes"], args["q_len"], dev(c.codes), args["c_len"],
                      torch.arange(c.n, device=device))
        names = set(cs)
        equal_len = np.array([len(x) for x in qs if x in names], dtype=np.int64)
        for winkler in (True, False):
            measure = "jaro_winkler" if winkler else "jaro"
            for k in TOPK_K:
                (want_i, want_s), p_ms = event_call(
                    lambda: topk_cuda.topk_plain(*plain_args, k, winkler))
                want_s = torch.where(torch.isinf(want_s), float("nan"), want_s)
                b_ms, b_by = topk_bound(q.lengths, c.lengths, q.codes.itemsize, k, winkler,
                                        clock_hz, equal_len)
                for tile in (0, TOPK_TILE):
                    tiles = -(-c.n // (tile or topk_cuda.max_tile(alphabet.size)))
                    out_i = torch.full((q.n, k), -1, dtype=torch.int64, device=device)
                    out_s = torch.full((q.n, k), float("nan"), dtype=torch.float64, device=device)
                    launch = partial(topk_cuda.topk_scan, **args, k=k, out_idx=out_i,
                                     out_score=out_s, winkler=winkler, tile=tile)
                    launch()
                    torch.cuda.synchronize()
                    same_s = out_s.cpu().numpy().tobytes() == want_s.cpu().numpy().tobytes()
                    if not (torch.equal(out_i, want_i) and same_s):
                        bad = int(torch.nonzero(((out_i != want_i)
                                                 | ~((out_s == want_s)
                                                     | (out_s.isnan() & want_s.isnan()))).any(1))[0])
                        raise AssertionError(
                            f"topk_scan {measure} k{k} tile {tile} {dtype}: K23 != plain at query {qs[bad]!r}: ids "
                            f"{out_i[bad].tolist()} want {want_i[bad].tolist()}, scores "
                            f"{out_s[bad].tolist()} want {want_s[bad].tolist()}")
                    k_ms = time_ms(launch, 5)
                    record = {"name": "topk_scan",
                              "flags": {"measure": measure, "k": f"k{k}", "tiles": f"{tiles} tile{'s' * (tiles > 1)}"},
                              "width": q.codes.shape[1], "dtype": dtype, "rows": q.n,
                              "candidates": c.n, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                              "bound_by": b_by}
                    record["label"] = case_label(record)
                    cases.append((record, launch))
                    for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms)):
                        entry[key] += v
                    entry["bound_by"][b_by] = entry["bound_by"].get(b_by, 0) + 1
    return {"summary": entry, "cases": cases}


def check_topk_cell(device, clock_hz: float, ptxas: list) -> tuple:
    """K23 at the benchmark cell's size: TOPK_QUERIES queries against the
    1,105 names (int8 rows, jaro_winkler, k = 5), in length order as the
    linkage orders them; its count of greedy pairs over all pairs (the
    greedy share), every query's own name first at 1.0 and TOPK_SAMPLE
    sampled queries' ids and score bits equal to the plain form's; its
    event time beside the bound (`roofline.topk_bound`). `ptxas`: K23's
    (kernel, registers, stack frame, spill stores, spill loads), from phase
    2's build. Returns (record, launch)."""
    from functools import partial

    import torch

    from strsim_tpu_torch.ops import topk_cuda
    from strsim_tpu_torch.ops.roofline import topk_bound
    from strsim_tpu_torch.utils import encode as enc

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    queries, dictionary = dictionary_names(TOPK_QUERIES, SEED + 2)
    q, c = enc.encode_column(queries, pad=enc.PAD_A), enc.encode_column(dictionary, pad=enc.PAD_B)
    alphabet, c_idx = topk_cuda.candidate_indices(c.codes, c.lengths)
    out_i = torch.full((q.n, 5), -1, dtype=torch.int64, device=device)
    out_s = torch.full((q.n, 5), float("nan"), dtype=torch.float64, device=device)
    launch = partial(topk_cuda.topk_scan, dev(q.codes), dev(q.lengths),
                     dev(np.argsort(q.lengths, kind="stable").astype(np.int64)), dev(c_idx),
                     dev(c.lengths), dev(np.arange(c.n, dtype=np.int32)), dev(alphabet), 5, out_i,
                     out_s, True)
    greedy = torch.zeros(1, dtype=torch.int64, device=device)
    launch(greedy_pairs=greedy)
    torch.cuda.synchronize()
    pairs = q.n * c.n
    share = int(greedy) / pairs
    idx, scores = out_i.cpu().numpy(), out_s.cpu().numpy()
    own = np.array(dictionary, dtype=object)[idx[:, 0]]
    if not ((scores[:, 0] == 1.0).all() and (own == np.array(queries, dtype=object)).all()):
        raise AssertionError("topk_scan at the cell's size: a query's first match is not its own name")
    rows = np.sort(np.random.default_rng(SEED).choice(q.n, TOPK_SAMPLE, replace=False))
    want_i, want_s = topk_cuda.topk_plain(dev(q.codes[rows]), dev(q.lengths[rows]), dev(c.codes),
                                          dev(c.lengths), torch.arange(c.n, device=device), 5, True)
    want_s = torch.where(torch.isinf(want_s), float("nan"), want_s).cpu().numpy()
    if not (np.array_equal(idx[rows], want_i.cpu().numpy())
            and scores[rows].tobytes() == want_s.tobytes()):
        raise AssertionError("topk_scan at the cell's size: K23 != plain on the sampled queries")
    k_ms = time_ms(launch, 5)
    names = set(dictionary)
    equal_len = np.array([len(x) for x in queries if x in names], dtype=np.int64)
    b_ms, b_by = topk_bound(q.lengths, c.lengths, q.codes.itemsize, 5, True, clock_hz, equal_len)
    record = {"name": "topk_scan", "flags": {"measure": "jaro_winkler", "k": "k5", "tiles": "cell"},
              "width": q.codes.shape[1], "dtype": str(q.codes.dtype), "rows": q.n,
              "candidates": c.n, "ms": k_ms, "plain_ms": float("nan"), "bound_ms": b_ms, "bound_by": b_by,
              "greedy_pairs": int(greedy), "greedy_share": share,
              "ptxas": [dict(zip(("kernel", "registers", "stack_frame", "spill_stores",
                                  "spill_loads"), k)) for k in ptxas]}
    record["label"] = case_label(record)
    return record, launch


def print_residency() -> None:
    """K2's residency at each ladder width (one instantiation each) and
    dtype, with and without the prefix: blocks an SM holds by the occupancy
    calculator, registers and local memory a thread, shared memory a
    block."""
    import torch

    from strsim_tpu_torch.ops import _build, jaro_cuda

    if "strsim_jaro_scan_residency" not in _build.LIBRARIES["jaro_scan"][1]:
        return  # a tree from before the entry point
    for dtype in (torch.int8, torch.int32):
        for width in LADDER:
            on = [jaro_cuda.residency(width, dtype, p) for p in (False, True)]
            print(f"  K2 residency w{width} {str(dtype)[6:]}: " + "; ".join(
                f"{label} blocks/SM {r['blocks_per_sm']}, registers {r['registers']}, local "
                f"{r['local_bytes']} B, shared {r['smem_bytes']} B"
                for label, r in zip(("m, t", "with prefix"), on)), flush=True)


def separate_kernels(a, b, la, lb):
    """What the fused kernel replaces: K1, K2, K3 and the plain prefix."""
    from strsim_tpu_torch.ops import jaro_cuda, levenshtein_cuda, multiset_cuda
    from strsim_tpu_torch.ops.stats import shared_prefix_length

    return (levenshtein_cuda.levenshtein_distance(a, b, la, lb),
            *jaro_cuda.jaro_match_stats(a, b, la, lb),
            shared_prefix_length(a, b),
            multiset_cuda.multiset_intersection_rank(a, b, la, lb))


def case_label(record) -> str:
    on = "+".join(str(v) if isinstance(v, str) else k[5:]
                  for k, v in record["flags"].items() if v) or "-"
    rows = "" if record.get("rows", BLOCK) == BLOCK else f" x{record['rows']}"
    return f"{record['name']} {on} w{record['width']} {record['dtype']}{rows}"


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_kernels(device, clock_hz: float, only=None, topk_ptxas=()):
    """Every kernel (or those named in `only`) against its plain version on
    the same card tensors; K23 also at the benchmark cell's size
    (`check_topk_cell`, with `topk_ptxas`, its ptxas lines). Returns ({name: {max_abs_err, ms, plain_ms,
    bound_ms, bound_by}}, the times summed over the name's cases; [one
    record per case], each also with `device_ms`, the kernel's own device
    time a launch from torch.profiler, beside `ms` from CUDA events)."""
    from functools import partial

    import torch

    from strsim_tpu_torch.ops import jaro_flags_cuda
    from strsim_tpu_torch.ops import roofline
    from strsim_tpu_torch.ops.roofline import bound
    from strsim_tpu_torch.ops.stats import shared_prefix_length

    rng = np.random.default_rng(SEED)
    tiles = {}  # (width, dtype) -> (card tensors, lengths): one set for every kernel

    def tiles_for(width, dtype):
        key = (width, np.dtype(dtype).name)
        if key not in tiles:
            packed, lens = make_tiles(rng, BLOCK, width, dtype)
            codes = torch.from_numpy(packed).to(device)
            lengths = torch.from_numpy(lens).to(device)
            tiles[key] = (codes[:, :width], codes[:, width:], lengths[0], lengths[1]), lens
        return tiles[key]

    summary, cases, launches = {}, [], []
    for name, pairs, widths, dtypes in kernel_cases():
        if only is not None and name not in only:
            continue
        entry = summary.setdefault(name, {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0,
                                          "bound_ms": 0.0, "bound_by": {}})
        for width in widths:
            for dtype in dtypes:
                args, lens = tiles_for(width, dtype)
                for flags, kernel, plain in pairs:
                    label = case_label({"name": name, "flags": flags, "width": width,
                                        "dtype": np.dtype(dtype).name})
                    got = _as_tuple(kernel(*args))
                    want = _as_tuple(plain(*args))  # also the plain version's warm-up
                    p_ms = time_ms(lambda: plain(*args), 1, warm_up=False)
                    if len(got) != len(want):
                        raise AssertionError(f"{label}: {len(got)} outputs vs {len(want)}")
                    for g, w in zip(got, want):
                        if g.shape != w.shape or g.dtype != w.dtype:
                            raise AssertionError(f"{label}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
                        e = int((g.long() - w.long()).abs().max())
                        if e:
                            bad = tuple(torch.nonzero(g != w)[0].tolist())
                            raise AssertionError(
                                f"{label}: kernel != plain (max abs err {e}; at {bad}: "
                                f"la={int(lens[0, bad[0]])} lb={int(lens[1, bad[0]])} "
                                f"got {int(g[bad])} want {int(w[bad])})")
                    k_ms = time_ms(lambda: kernel(*args), 5)
                    out_bytes = sum(g[0].numel() * g.element_size() for g in got)
                    b_ms, b_by = bound(name, flags, lens, np.dtype(dtype).itemsize, out_bytes,
                                       clock_hz)
                    record = {"name": name, "flags": flags, "width": width,
                              "dtype": np.dtype(dtype).name, "rows": BLOCK, "ms": k_ms,
                              "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "label": label}
                    if name == "lev_jaro_fused" and flags == {"with_inter": True, "with_osa": False,
                                                              "with_lcs": False}:
                        record["separate_ms"] = time_ms(lambda: separate_kernels(*args), 5)
                    if name == "jaro_scan" and not flags:  # the route's time before the prefix moved
                        record["with_plain_prefix_ms"] = time_ms(
                            lambda: (kernel(*args), shared_prefix_length(*args[:2])), 5)
                    # the full DP's own floor beside K1's bound (none in a tree from before it)
                    if name == "levenshtein_wavefront" and hasattr(roofline, "dp_floor_ms"):
                        record["dp_floor_ms"] = roofline.dp_floor_ms(lens, clock_hz)
                    if name == "jaro_flags":  # the forced jaro route: K9, then t and the patch
                        record["route_ms"] = time_ms(
                            lambda: jaro_flags_cuda.jaro_match_stats(*args), 5)
                    cases.append(record)
                    launches.append((label, partial(kernel, *args)))
                    entry["ms"] += k_ms
                    entry["plain_ms"] += p_ms
                    entry["bound_ms"] += b_ms
                    entry["bound_by"][b_by] = entry["bound_by"].get(b_by, 0) + 1
    for name, check in (("warm", lambda: check_warm(device, clock_hz, rng)),
                        ("topk_scan", lambda: check_topk(device, clock_hz))):
        if only is None or name in only:
            found = check()
            summary[name] = found.pop("summary")
            for record, launch in found["cases"]:
                cases.append(record)
                launches.append((record["label"], launch))
    if only is None or "topk_scan" in only:
        record, launch = check_topk_cell(device, clock_hz, topk_ptxas)
        cases.append(record)
        launches.append((record["label"], launch))
    with DeviceTimes(5) as device_times:  # each case's kernel again, 5 launches
        for label, launch in launches:
            with device_times.recording(label):
                for _ in range(5):
                    launch()
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_kernels.jsonl", "w") as log:
        for record in cases:
            record["device_ms"] = device_times.per_launch(record.pop("label"))
            log.write(json.dumps(record) + "\n")
            extra = (f", separate K1+K2+K3+prefix {record['separate_ms']:.4f} ms"
                     if "separate_ms" in record else "")
            if "with_plain_prefix_ms" in record:
                extra += f", with the plain prefix {record['with_plain_prefix_ms']:.4f} ms"
            if "dp_floor_ms" in record:
                extra += f", DP floor {record['dp_floor_ms']:.4f} ms"
            if "route_ms" in record:
                extra += f", route (jaro_match_stats) {record['route_ms']:.4f} ms"
            if "library_ms" in record:
                extra += f", library (torch.add) {record['library_ms']:.4f} ms"
            if "candidates" in record:
                extra += f", against {record['candidates']} candidates"
            if "greedy_share" in record:
                extra += (f", greedy share {100 * record['greedy_share']:.3f} % "
                          f"({record['greedy_pairs']} pairs), ptxas " + "; ".join(
                              f"{k['kernel']}: {k['registers']} registers, {k['stack_frame']} B "
                              f"stack, {k['spill_stores']} + {k['spill_loads']} B spilled"
                              for k in record["ptxas"]))
            plain = ("plain on a sample" if np.isnan(record["plain_ms"])
                     else f"plain {record['plain_ms']:.3f} ms")
            print(f"  {case_label(record):42s} rows {record['rows']}: exact, kernel {record['ms']:.4f} ms "
                  f"(device {record['device_ms']:.4f} ms), {plain}, "
                  f"bound {record['bound_ms']:.4f} ms ({record['bound_by']}){extra}", flush=True)
    for entry in summary.values():  # what bounds most of the name's cases
        entry["bound_by"] = max(entry["bound_by"], key=entry["bound_by"].get)
    return summary, cases


# --- phase 4: end to end ------------------------------------------------------

def _oracle_scores(task):
    """Worker: oracle scores [rows, measures] for (a, b) pairs, NaN at nulls."""
    from strsim_tpu_torch.ops.oracle import ORACLES

    pairs, measures = task
    out = np.full((len(pairs), len(measures)), np.nan)
    for r, (a, b) in enumerate(pairs):
        if a is not None and b is not None:
            out[r] = [ORACLES[m](a, b) for m in measures]
    return out


def oracle_check(label, col_a, col_b, got: dict, measures, n_rows: int, pool):
    """The rows `got` (scores of the whole columns) holds byte-identical to
    the oracle's on `n_rows` random rows; returns (rows, measures, oracle
    scores [rows, measures])."""
    rng = np.random.default_rng(SEED + n_rows)
    rows = np.sort(rng.choice(len(col_a), size=min(n_rows, len(col_a)), replace=False))
    pairs = [(col_a[i], col_b[i]) for i in rows]
    chunks = [(pairs[k : k + 100], measures) for k in range(0, len(pairs), 100)]
    want = np.concatenate(pool.map(_oracle_scores, chunks))
    for k, m in enumerate(measures):
        if got[m][rows].tobytes() != want[:, k].tobytes():
            bad = int(np.nonzero(got[m][rows] != want[:, k])[0][0])
            raise AssertionError(f"{label} {m}: row {rows[bad]} got {got[m][rows][bad]!r} "
                                 f"want {want[bad, k]!r}")
    print(f"  {label}: {rows.size} rows byte-identical to the oracle on {len(measures)} measures",
          flush=True)
    return rows, measures, want


def check_native(st, workloads, oracle_sets) -> None:
    """The native host layer on the card's host: its encode of each whole
    workload equal to the numpy route (codes, lengths, validity; int8 tiles
    exactly when every char is ASCII); its scalar kernels (native_compute,
    every core) byte-identical to the oracle on the rows and measures of
    `oracle_sets` ({label: [(rows, measures, oracle scores)]}); and its
    finalize byte-identical to the numpy finalizers on the kernels' stats
    (compute_scores with native_finalize on and off, all fourteen, on the
    oracle rows' count of leading rows)."""
    from strsim_tpu_torch.models.pipeline import compute_scores
    from strsim_tpu_torch.native import native_compute
    from strsim_tpu_torch.utils import encode as enc

    cfg = st.get_config()
    for label, col_a, col_b in workloads:
        (a, b, route), t_native = _timed(lambda: enc.encode_pair_with_route(col_a, col_b))
        (numpy_a, numpy_b), t_numpy = _timed(lambda: enc.encode_pair_numpy(col_a, col_b))
        for side, want in ((a, numpy_a), (b, numpy_b)):
            ascii_only = int(want.codes.max(initial=0)) < 128
            if ((side.codes.dtype == np.int8) != ascii_only
                    or not np.array_equal(side.codes.astype(np.int32), want.codes)
                    or not np.array_equal(side.lengths, want.lengths)
                    or not np.array_equal(side.validity, want.validity)):
                raise AssertionError(f"{label}: the native encode differs from the numpy route")
        print(f"  native {label}: encode ({route}, {a.codes.dtype}) {t_native:.3f} s equal to the "
              f"numpy route ({t_numpy:.3f} s)", flush=True)
        most = 0
        for rows, measures, want in oracle_sets[label]:
            valid = a.validity[rows] & b.validity[rows]
            for k, m in enumerate(measures):
                got = native_compute(m, a.codes[rows], a.lengths[rows], b.codes[rows],
                                     b.lengths[rows], valid, threads=0)
                if got.tobytes() != want[:, k].tobytes():
                    bad = int(np.nonzero(got != want[:, k])[0][0])
                    raise AssertionError(f"native {label} {m}: row {rows[bad]} got {got[bad]!r} "
                                         f"want {want[bad, k]!r}")
            most = max(most, rows.size)
            print(f"  native {label}: native_compute on {rows.size} rows byte-identical to the "
                  f"oracle on {len(measures)} measures", flush=True)
        first = slice(0, most)
        on = compute_scores(col_a[first], col_b[first], ALL, config=cfg)
        off = compute_scores(col_a[first], col_b[first], ALL, config=cfg.replace(native_finalize=False))
        for m in ALL:
            if on[m][0].tobytes() != off[m][0].tobytes():
                raise AssertionError(f"native {label} {m}: native finalize differs from numpy")
        print(f"  native {label}: finalize_scatter byte-identical to the numpy finalizers on "
              f"{most} rows, all fourteen measures", flush=True)



def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _phases(label, measures_label, rm) -> None:
    print(f"  {label}: {measures_label} wall s encode ({rm.encode_route}) {rm.encode_wall_s:.3f}, classify "
          f"{rm.classify_wall_s:.3f}, buckets (sort, pack, upload, kernels, download) "
          f"{rm.device_wall_s:.3f}, finalize {rm.finalize_wall_s:.3f}, total "
          f"{rm.total_wall_s:.3f}; rows null {rm.null_rows}, host fast path "
          f"{rm.fast_path_rows + rm.one_empty_rows}, device {rm.device_rows}, oracle "
          f"{rm.oracle_rows}; buckets {sorted(rm.buckets)}", flush=True)


def run_workloads(st, workloads) -> dict:
    """The main path, on every workload: compute_many over the five measures
    and a five-measure pass that records where the wall time goes
    (RunMetrics), each of the five measure functions, then the same over all
    fourteen, compute_many over (levenshtein, osa, lcs_seq, indel) and each
    of the nine extension functions, and a jaccard pass with its RunMetrics
    (the single multiset function's buckets, which K3 and K4 serve). Every
    result must equal compute_many over all fourteen. Returns ({label:
    compute_many(all fourteen) scores}, {label: RunMetrics} of the five,
    all-fourteen, jaccard and jaro passes). The jaro pass (jaro alone, which
    K2 serves with the prefix at every width) must equal the default too."""
    from strsim_tpu_torch.models.pipeline import compute_scores
    from strsim_tpu_torch.utils.metrics import RunMetrics

    scores, five_metrics, all_metrics, jaccard_metrics, jaro_metrics = {}, {}, {}, {}, {}
    for label, col_a, col_b in workloads:
        n = len(col_a)
        five, dt = _timed(lambda: st.compute_many(FIVE, col_a, col_b))
        print(f"  {label}: compute_many(five) {n} pairs in {dt:.3f} s = {n / dt:.0f} pairs/s", flush=True)
        rm = five_metrics[label] = RunMetrics()
        compute_scores(col_a, col_b, FIVE, metrics=rm)
        _phases(label, "five", rm)
        many, dt = _timed(lambda: st.compute_many(ALL, col_a, col_b))
        print(f"  {label}: compute_many(all 14) {n} pairs in {dt:.3f} s = {n / dt:.0f} pairs/s", flush=True)
        rm = all_metrics[label] = RunMetrics()
        compute_scores(col_a, col_b, ALL, metrics=rm)
        _phases(label, "all 14", rm)
        dp, dt = _timed(lambda: st.compute_many(DP_SET, col_a, col_b))
        print(f"  {label}: compute_many({', '.join(DP_SET)}) in {dt:.3f} s = {n / dt:.0f} pairs/s",
              flush=True)
        for m in ALL:
            one, dt = _timed(lambda: getattr(st, m)(col_a, col_b))
            print(f"  {label}: {m} {n / dt:.0f} pairs/s ({dt:.3f} s)", flush=True)
            for what, res in ((f"{m}()", one), ("compute_many(five)", five.get(m)),
                              (f"compute_many({DP_SET})", dp.get(m))):
                if res is not None and res.tobytes() != many[m].tobytes():
                    raise AssertionError(f"{label}: {what} differs from compute_many(all 14) on {m}")
        rm = jaccard_metrics[label] = RunMetrics()
        res = compute_scores(col_a, col_b, ["jaccard"], metrics=rm)
        if res["jaccard"][0].tobytes() != many["jaccard"].tobytes():
            raise AssertionError(f"{label}: the jaccard pass differs from compute_many(all 14)")
        _phases(label, "jaccard", rm)
        rm = jaro_metrics[label] = RunMetrics()
        res = compute_scores(col_a, col_b, ["jaro"], metrics=rm)
        if res["jaro"][0].tobytes() != many["jaro"].tobytes():
            raise AssertionError(f"{label}: the jaro pass differs from compute_many(all 14)")
        _phases(label, "jaro", rm)
        scores[label] = many
    return scores, five_metrics, all_metrics, jaccard_metrics, jaro_metrics


def pass_reckoning(label, measures_label, measures, rm, cases, impls, by_bucket=()) -> None:
    """Print, kernel by kernel, what one pass of `measures` over the buckets
    of the run that filled RunMetrics `rm` would take on the card by this
    run's phase-3 times: the sum over its buckets of rows / BLOCK times the
    kernel's time (CUDA events, and its own device time), and bound at the
    bucket's width and tile dtype, for the outputs the router asks of it
    there (K6 at its three recurrences where phase 3 did not time that
    subset). Largest gap between device time and bound first. The kernels
    named in `by_bucket` also get one line a bucket (width, tile dtype,
    rows, launches and the three times), so that launches x (time - bound)
    reads from the pass's own buckets."""
    import torch

    from strsim_tpu_torch.ops.roofline import route_flags
    from strsim_tpu_torch.ops.stats import stat_routes

    timed = {(r["name"], json.dumps(r["flags"], sort_keys=True), r["width"], r["dtype"]): r
             for r in cases}
    per = {}
    for bm in rm.buckets.values():
        routes = stat_routes(measures, bm.width, getattr(torch, bm.dtype), impls)
        for kernel in sorted(set(routes.values()) - {"plain"}):
            flags = route_flags(kernel, routes)
            key = (kernel, json.dumps(flags, sort_keys=True), bm.width, bm.dtype)
            if key not in timed and kernel == "dp_fused":
                key = (kernel, json.dumps({"with_lev": True, "with_osa": True, "with_lcs": True},
                                          sort_keys=True), bm.width, bm.dtype)
            r = timed[key]
            t = per.setdefault(kernel, {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0, "rows": 0,
                                        "widths": []})
            for k in ("ms", "device_ms", "bound_ms"):
                t[k] += bm.rows / BLOCK * r[k]
            if kernel in by_bucket:
                print(f"  per bucket, {label} {measures_label}: {kernel} w{bm.width} {bm.dtype} "
                      f"{bm.rows} rows, {bm.device_calls} launches: {bm.rows / BLOCK * r['ms']:.4f} ms, "
                      f"device {bm.rows / BLOCK * r['device_ms']:.4f} ms, bound "
                      f"{bm.rows / BLOCK * r['bound_ms']:.4f} ms", flush=True)
            t["rows"] += bm.rows
            t["widths"].append(bm.width)
    for kernel, t in sorted(per.items(), key=lambda kv: kv[1]["bound_ms"] - kv[1]["device_ms"]):
        print(f"  per pass, {label} {measures_label}: {kernel} {t['ms']:.4f} ms, device "
              f"{t['device_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms, {t['rows']} rows at "
              f"w{min(t['widths'])}..w{max(t['widths'])}", flush=True)


def check_prefix_routes(label, measures_label, measures, rm, impls) -> None:
    """Through stat_routes on the buckets of the pass that filled RunMetrics
    `rm`: the prefix comes from K2 wherever K2 serves jaro_m. Prints the
    route that serves the prefix on each bucket."""
    import torch

    from strsim_tpu_torch.ops.stats import stat_routes

    by_route = {}
    for bm in sorted(rm.buckets.values(), key=lambda bm: (bm.dtype, bm.width)):
        routes = stat_routes(measures, bm.width, getattr(torch, bm.dtype), impls)
        if routes.get("jaro_m") == "jaro_scan" and routes.get("prefix") != "jaro_scan":
            raise AssertionError(f"{label} {measures_label} w{bm.width}: K2 serves jaro_m but the "
                                 f"prefix goes to {routes.get('prefix')}")
        by_route.setdefault(routes.get("prefix"), []).append(f"w{bm.width} {bm.dtype}")
    print(f"  prefix, {label} {measures_label}: " + "; ".join(
        f"{route} on {', '.join(widths)}" for route, widths in by_route.items()), flush=True)


def single_overrides():
    """Each family forced to each of its values."""
    from strsim_tpu_torch.config import IMPL_VALUES

    return [{f"{family}_impl": value} for family, values in IMPL_VALUES.items()
            for value in values if value != "auto"]


def forced_combinations():
    """Every forced configuration but FORCED (which run_forced drives)."""
    return [*DIFFERENTIAL[1:], *single_overrides()]


def routed_kernels(rm, measures, cfg) -> set:
    """The kernels `stat_routes` names for `measures` under `cfg` on the
    buckets (width, tile dtype) of the run that filled RunMetrics `rm`."""
    import torch

    from strsim_tpu_torch.ops.stats import stat_routes

    return {route for bm in rm.buckets.values()
            for route in stat_routes(measures, bm.width, getattr(torch, bm.dtype), cfg.impls()).values()
            if route != "plain"}


def require_launched(what, kernels) -> dict:
    """The launch counts since the last reset; raises unless each of
    `kernels` launched."""
    from strsim_tpu_torch.ops import _build

    counts = _build.launch_counts()
    missing = sorted(k for k in kernels if counts.get(k, 0) <= 0)
    if missing:
        raise AssertionError(f"kernels not launched on {what}: {missing} (launches {counts})")
    return counts


def require_not_launched(what, kernels) -> None:
    """Raises if any of `kernels` launched since the last reset."""
    from strsim_tpu_torch.ops import _build

    counts = _build.launch_counts()
    stray = sorted(k for k in kernels if counts.get(k, 0) > 0)
    if stray:
        raise AssertionError(f"kernels launched on {what} that no path of it reaches: {stray}")


def _same_scores(label, what, got: dict, want: dict, rows=slice(None)) -> None:
    for m, v in got.items():
        if v.tobytes() != want[m][rows].tobytes():
            bad = int(np.nonzero(v != want[m][rows])[0][0])
            raise AssertionError(f"{label}: {what} differs from the default config on {m} "
                                 f"at row {bad}: {v[bad]!r} against {want[m][rows][bad]!r}")


def run_forced(st, workloads, scores, five_metrics, cases) -> dict:
    """The forced-implementation path: compute_many over the five measures
    with FORCED on every workload whole, byte-identical to the default
    config's scores (`scores`, from run_workloads), then a five pass with
    FORCED that records its buckets (RunMetrics: host phases, and K9's and
    K10's time a pass by bucket from phase 3's `cases`, `pass_reckoning`).
    Every kernel that the router names for FORCED on the workloads' buckets
    (`five_metrics`, from the default five-measure pass) must launch, K9 and
    K10 among them. Returns the launch counts."""
    from strsim_tpu_torch.models.pipeline import compute_scores
    from strsim_tpu_torch.ops import _build
    from strsim_tpu_torch.utils.metrics import RunMetrics

    cfg = st.get_config().replace(**FORCED)
    _build.reset_launch_counts()
    want = set(FORCED_KERNELS)
    for label, col_a, col_b in workloads:
        n = len(col_a)
        got, dt = _timed(lambda: st.compute_many(FIVE, col_a, col_b, config=cfg))
        _same_scores(label, "compute_many(five) forced", got, scores[label])
        want |= routed_kernels(five_metrics[label], FIVE, cfg)
        print(f"  {label}: compute_many(five) levenshtein_impl=pallas, jaro_impl=pallas {n} pairs "
              f"in {dt:.3f} s = {n / dt:.0f} pairs/s, byte-identical to the default config",
              flush=True)
        rm = RunMetrics()
        res = compute_scores(col_a, col_b, FIVE, config=cfg, metrics=rm)
        _same_scores(label, "the forced five pass", {m: v for m, (v, _) in res.items()}, scores[label])
        _phases(label, "five forced", rm)
        pass_reckoning(label, "five forced", FIVE, rm, cases, cfg.impls(), by_bucket=FORCED_KERNELS)
    counts = require_launched("the forced path", want)
    require_not_launched("the forced path", PROBE_ONLY)
    print(f"  launches on the forced path: {counts}", flush=True)
    return counts


def run_forced_combinations(st, workloads, scores) -> None:
    """Every other forced combination (`forced_combinations`) over all
    fourteen measures on the first FORCED_ROWS rows of every workload,
    byte-identical to the default config's scores, each with its launch
    counts zeroed before and read after: every kernel that the router names
    for it on the buckets it formed must launch."""
    from strsim_tpu_torch.models.pipeline import compute_scores
    from strsim_tpu_torch.ops import _build
    from strsim_tpu_torch.utils.metrics import RunMetrics

    t0 = time.perf_counter()
    combos = forced_combinations()
    rows = slice(0, FORCED_ROWS)
    for overrides in combos:
        cfg = st.get_config().replace(**overrides)
        _build.reset_launch_counts()
        want = set()
        for label, col_a, col_b in workloads:
            rm = RunMetrics()
            res = compute_scores(col_a[rows], col_b[rows], ALL, config=cfg, metrics=rm)
            _same_scores(label, f"compute_many(all 14) {overrides}", {m: v for m, (v, _) in res.items()},
                         scores[label], rows)
            want |= routed_kernels(rm, ALL, cfg)
        counts = require_launched(f"forced {overrides}", want)
        require_not_launched(f"forced {overrides}", PROBE_ONLY)
        print(f"  forced {overrides}: kernels {sorted(counts)}", flush=True)
    print(f"  {len(combos)} other forced combinations x {len(workloads)} workloads, "
          f"{FORCED_ROWS} rows each, all fourteen measures: byte-identical to the default config, "
          f"every routed kernel launched ({time.perf_counter() - t0:.1f} s)", flush=True)


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


def run_linkage(st) -> dict:
    """The linkage path at the benchmark cell's size: top_k_matches over
    TOPK_QUERIES queries against the 1,105-name dictionary (jaro_winkler,
    k = 5), the launch counts zeroed just before and read just after (K23
    must launch, no probe), the call's spans and counters printed; every
    query (each is a dictionary name) first matches its own name at 1.0,
    and TOPK_SAMPLE queries drawn from the seed hold ids and scores exactly
    equal to the plain route's (`topk_cuda.topk_plain` on the card). Returns
    the launch counts."""
    import torch

    from strsim_tpu_torch.ops import _build, topk_cuda
    from strsim_tpu_torch.utils import encode as enc
    from strsim_tpu_torch.utils.metrics import RunMetrics

    queries, dictionary = dictionary_names(TOPK_QUERIES, SEED + 1)
    rm = RunMetrics()
    _build.reset_launch_counts()
    (idx, scores), dt = _timed(lambda: st.top_k_matches(queries, dictionary, "jaro_winkler", 5,
                                                        metrics=rm))
    counts = require_launched("the linkage path", LINKAGE_KERNELS)
    require_not_launched("the linkage path", PROBE_ONLY)
    pairs = len(queries) * len(dictionary)
    print(f"  linkage: top_k_matches {len(queries)} queries x {len(dictionary)} names "
          f"(jaro_winkler, k = 5) in {dt:.3f} s = {pairs / dt:.4g} pairs/s; spans s "
          + ", ".join(f"{name.removeprefix('strsim.topk.')} {rm.span_s(name):.4f}"
                      for name in ("strsim.topk.encode", "strsim.topk.stage", "strsim.topk.launch",
                                   "strsim.topk.collect", "strsim.topk.finish"))
          + f"; counters {rm.counters}; launches {counts}", flush=True)
    if rm.counters.get("topk.pairs") != pairs:
        raise AssertionError(f"linkage: topk.pairs {rm.counters} against {pairs} pairs")
    own = np.array(dictionary, dtype=object)[idx[:, 0]]
    if not ((scores[:, 0] == 1.0).all() and (own == np.array(queries, dtype=object)).all()):
        raise AssertionError("linkage: a query's first match is not its own name at 1.0")
    rows = np.sort(np.random.default_rng(SEED).choice(len(queries), TOPK_SAMPLE, replace=False))
    device = torch.device("cuda", 0)
    q = enc.encode_column([queries[r] for r in rows], pad=enc.PAD_A)
    c = enc.encode_column(dictionary, pad=enc.PAD_B)
    T = torch.from_numpy
    want_i, want_s = topk_cuda.topk_plain(T(q.codes).to(device), T(q.lengths).to(device),
                                          T(c.codes).to(device), T(c.lengths).to(device),
                                          torch.arange(c.n, device=device), 5, True)
    want_s = torch.where(torch.isinf(want_s), float("nan"), want_s).cpu().numpy()
    if not (np.array_equal(idx[rows], want_i.cpu().numpy())
            and scores[rows].tobytes() == want_s.tobytes()):
        raise AssertionError("linkage: top_k_matches differs from the plain route on its sample")
    print(f"  linkage: every query's own name first at 1.0; {TOPK_SAMPLE} sampled queries' ids and "
          "scores byte-identical to the plain route", flush=True)
    return counts


def stop_children() -> None:
    """Stop and reap every process this one started that is still alive: the
    oracle pool's workers, multiprocessing's resource tracker (which some
    Python 3.12 releases leave to end by itself after this process exits)
    and any other child. The script leaves no process behind."""
    import gc
    import os
    import signal
    from multiprocessing import resource_tracker

    gc.collect()  # a dead pool's locks would start the tracker anew when collected later
    for child in multiprocessing.active_children():
        child.terminate()
        child.join(10)
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_fd", None) is not None:
        os.close(tracker._fd)  # its end of the pipe: the tracker sees EOF and exits
        tracker._fd = None
        if tracker._pid is not None:
            with contextlib.suppress(ChildProcessError):
                os.waitpid(tracker._pid, 0)
            tracker._pid = None
    me = str(os.getpid())
    for stat in pathlib.Path("/proc").glob("[0-9]*/stat"):
        with contextlib.suppress(OSError, IndexError, ValueError):
            fields = stat.read_text().rsplit(")", 1)[1].split()
            if fields[1] == me:  # the parent's pid, after the state
                pid = int(stat.parent.name)
                os.kill(pid, signal.SIGKILL)
                with contextlib.suppress(ChildProcessError):
                    os.waitpid(pid, 0)


def main(argv) -> int:
    import torch

    only = None
    if argv[:1] == ["--kernels"] and len(argv) == 2:
        only = argv[1].split(",")
    elif argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import strsim_tpu_torch as st
    from strsim_tpu_torch.native import build as native_build
    from strsim_tpu_torch.ops import _build
    from strsim_tpu_torch.ops.roofline import card_line, max_sm_clock_hz

    t_start = time.perf_counter()
    card = card_line()
    clock_hz = max_sm_clock_hz()
    device = torch.device("cuda", 0)
    print(f"phase 1 device: {card}, max SM clock {clock_hz / 1e6:.0f} MHz | torch "
          f"{torch.__version__} CUDA {torch.version.cuda} | {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()} | Python.h in {native_build.python_include()}", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"phase 2 build: {len(_build.LIBRARIES)} libraries ready in "
          f"{time.perf_counter() - t0:.1f} s (built here: "
          f"{', '.join(f'{k} {v[0]:.1f} s' for k, v in sorted(built.items()))})", flush=True)
    (OUT_DIR / "ptxas").mkdir(parents=True, exist_ok=True)
    logs = {name: _build.build_log(name) for name in _build.LIBRARIES}  # built here or before
    for name, log in sorted(logs.items()):
        (OUT_DIR / "ptxas" / f"{name}.log").write_text(log)  # each kernel's registers and spills
        print(f"  ptxas {name}: {ptxas_summary(log)}")
    topk_ptxas = print_forced_ptxas(logs, strict=only is None)
    t0 = time.perf_counter()
    native_build.get_lib()
    print(f"  native host library {native_build.target().name} ready in "
          f"{time.perf_counter() - t0:.1f} s (str-object routes: "
          f"{native_build.has_object_routes()})", flush=True)

    print("phase 3 kernels vs plain torch on the card:", flush=True)
    if only is None or "jaro_scan" in only:
        print_residency()
    summary, cases = check_kernels(device, clock_hz, only, topk_ptxas)
    if only is not None:
        return 0 if set(only) <= set(summary) else 2

    print(f"phase 4 end to end (phases 1-3 took {time.perf_counter() - t_start:.1f} s):", flush=True)
    sys.path.insert(0, str(ROOT))
    import bench

    workloads = [
        ("make_pairs(1_000_000)", *bench.make_pairs(1_000_000)),
        ("make_wide_pairs(200_000)", *bench.make_wide_pairs(200_000)),
    ]
    _build.reset_launch_counts()
    scores, five_metrics, all_metrics, jaccard_metrics, jaro_metrics = run_workloads(st, workloads)
    launches = require_launched("the main path", [k for k in (*KERNELS, *VARIANTS) if k not in
                                                  (*FORCED_KERNELS, *BENCH_ONLY, *PROBE_ONLY,
                                                   *LINKAGE_KERNELS)])
    print(f"  launches on the main path: {launches}", flush=True)
    require_not_launched("the main path", (*PROBE_ONLY, *LINKAGE_KERNELS))
    for label, *_ in workloads:
        pass_reckoning(label, "five", FIVE, five_metrics[label], cases, st.get_config().impls())
        pass_reckoning(label, "all 14", ALL, all_metrics[label], cases, st.get_config().impls())
        pass_reckoning(label, "jaccard", ("jaccard",), jaccard_metrics[label], cases,
                       st.get_config().impls())
        pass_reckoning(label, "jaro", ("jaro",), jaro_metrics[label], cases, st.get_config().impls())
        check_prefix_routes(label, "five", FIVE, five_metrics[label], st.get_config().impls())
        check_prefix_routes(label, "jaro", ("jaro",), jaro_metrics[label], st.get_config().impls())
    forced_launches = run_forced(st, workloads, scores, five_metrics, cases)
    launches.update((k, forced_launches[k]) for k in FORCED_KERNELS)
    run_forced_combinations(st, workloads, scores)
    for label, col_a, col_b in workloads:
        valid = np.array([x is not None and y is not None for x, y in zip(col_a, col_b)])
        for m in ALL:
            v = scores[label][m]
            if v.shape != (len(col_a),) or v.dtype != np.float64:
                raise AssertionError(f"{label} {m}: {v.dtype} {v.shape}")
            if not (np.isnan(v[~valid]).all() and ((v[valid] >= 0) & (v[valid] <= 1)).all()):
                raise AssertionError(f"{label} {m}: NaN off the null rows or a score outside [0, 1]")
    ctx = multiprocessing.get_context("spawn")
    (narrow_label, *narrow), (wide_label, *wide) = workloads
    with ctx.Pool(8) as pool:
        oracle_sets = {
            narrow_label: [oracle_check(narrow_label, *narrow, scores[narrow_label], ALL,
                                        ORACLE_ROWS, pool)],
            wide_label: [oracle_check(wide_label, *wide, scores[wide_label], FIVE, ORACLE_ROWS, pool),
                         oracle_check(wide_label, *wide, scores[wide_label], EXT,
                                      ORACLE_ROWS_WIDE_EXT, pool)],
        }
        pool.close()
        pool.join()  # the workers end here, not by the context's terminate
    del pool  # its locks unregister from the resource tracker before that stops
    stop_children()
    check_golden_and_demo(st)
    check_native(st, workloads, oracle_sets)
    del workloads, scores
    launches.update((k, v) for k, v in run_linkage(st).items() if k in LINKAGE_KERNELS)

    print(f"  bench_torch.py {' '.join(BENCH_ARGS)}:", flush=True)
    import bench_torch

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rc = bench_torch.main([*BENCH_ARGS, "--details", str(OUT_DIR / "bench_torch_smoke.json")])
    if rc != 0:
        raise AssertionError(f"bench_torch.py exited {rc}")
    bench_launches = require_launched("bench_torch.py", BENCH_KERNELS)
    require_not_launched("bench_torch.py", PROBE_ONLY)
    launches["warm"] = bench_launches["warm"]
    print(f"  bench_torch.py done in {time.perf_counter() - t0:.1f} s; its launches: "
          f"{bench_launches}", flush=True)

    for tool, tool_kernels in PROBE_TOOLS.items():
        print(f"  tools/{tool}.py {' '.join(PROBE_ARGS)}:", flush=True)
        spec = importlib.util.spec_from_file_location(tool, ROOT / "tools" / f"{tool}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        rc = module.main([*PROBE_ARGS, "--out", str(OUT_DIR / f"{tool}_smoke.json")])
        if rc != 0:
            raise AssertionError(f"tools/{tool}.py exited {rc}")
        probe_launches = require_launched(f"tools/{tool}.py", tool_kernels)
        launches.update((k, probe_launches[k]) for k in PROBE_ONLY if k in tool_kernels)
        print(f"  tools/{tool}.py done in {time.perf_counter() - t0:.1f} s; its launches: "
              f"{probe_launches}", flush=True)

    print(f"phase 5 done in {time.perf_counter() - t_start:.1f} s", flush=True)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "library_ms": None, **summary[name]}
        for name, (src, tpu) in KERNELS.items()
    ]
    for k in VARIANTS:
        kernel, variant = k.split(".")
        kernels[list(KERNELS).index(kernel)][f"launches_{variant}"] = launches[k]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    finally:
        stop_children()
    sys.exit(code)
