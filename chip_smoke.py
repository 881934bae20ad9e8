#!/usr/bin/env python3
"""Drive strsim_tpu_torch on one CUDA GPU and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels levenshtein_myers,osa_scan   # phases 1-3 for these only

Phases, one line of findings each (any failure exits non-zero):
  1. device: the card's name, power limit and maximum SM clock (nvidia-smi),
     and where Python.h lies (the native library's str-object routes need it);
  2. build: every CUDA kernel from csrc/ (K11 csrc/warm.cu among them), one
     nvcc per source in parallel, and the native host library (g++), each
     build's time;
  3. kernels: each kernel against its plain torch version on the card, at the
     main path's shapes (65536-row blocks at each ladder width it serves, int8
     and int32 tiles, seeded inputs incl. astral codepoints and the rows of
     `lane_rows` and every word-boundary length, one set of tiles per width
     and dtype that every kernel there reads), K5 with its
     multiset, OSA and LCS outputs on and off, K6 with all three recurrences
     at every width and with {lev, osa}, {osa, lcs}, {lcs} at w31/w63/w255;
     integers must match exactly; both times from CUDA events, and the
     kernel's own device time (`device_ms`, from one torch.profiler session
     over 5 more launches of every case: see `DeviceTimes`), beside the
     least time the card could take (`bound_ms`, from this run's lengths:
     strsim_tpu_torch/ops/roofline.py); for K5 also the time of the separate
     kernels it replaces;
     K9 (its m and both flag tensors) and K10 at every width on both dtypes,
     K4 at every width on int8 (a forced "pallas_hist" sends it narrow tiles);
     K11 (x * 2 + 1) on [8, 128] and [65536, 128] int32 over the whole int32
     range, beside torch.add(one, x, alpha=2) (`library_ms`);
     with --kernels, the run ends here (an A/B of kernels between two trees
     copies this script into each and runs it there);
  4. end to end: bench.py's make_pairs(1_000_000) and make_wide_pairs(200_000)
     through compute_many over the five measures, over all fourteen and over
     (levenshtein, osa, lcs_seq, indel), and through each of the fourteen
     measure functions (native encode, pack into pinned memory and native
     finalize; the host phases and the encode route of each pass printed),
     with the launch counts zeroed just before and read
     just after (K1-K8 must all launch, K5 also with its OSA and LCS outputs
     on), and for the five, all fourteen and a jaccard() pass (K3 at
     w7..w63, K4 above) each kernel's event and device time per pass from
     the buckets' rows and phase 3's times (`pass_reckoning`); then the
     forced-implementation path, compute_many over the five
     with levenshtein_impl="pallas", jaro_impl="pallas" on both workloads
     whole, and every other forced combination (DIFFERENTIAL and
     `single_overrides`, which the tests/test_torch_forced_*.py files share)
     on 20,000 rows of each, all byte-identical to the default config's
     scores, each with its own launch counts: every kernel that stat_routes
     names for it on the buckets it formed must launch (K9 and K10 on the
     forced path);
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
     bench_torch.py in this process at a reduced size (200,000 pairs, 3 timed
     passes, 40,000 wide), its launch counts zeroed before and read after
     (K11 and the kernels of its sections must launch), its JSON line
     printed;
  5. a {"kernels": [...]} JSON line, the card line again, and last
     {"ok": true, "device": {...}}. Each phase-3 case also goes as a JSON line
     to chiprun_out/chip_smoke_kernels.jsonl.

Imports neither jax nor strsim_tpu. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import contextlib
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
}
# K11 and the kernels of bench_torch.py's sections (the five measures alone
# and together on make_pairs, levenshtein, jaro_winkler, jaccard and osa on
# make_wide_pairs): each must launch on its run
BENCH_KERNELS = ("warm", "levenshtein_myers", "jaro_scan", "multiset_rank", "multiset_hist",
                 "lev_jaro_fused", "osa_scan")
BENCH_ARGS = ("--n-pairs", "200000", "--passes", "3", "--n-wide", "40000")
BENCH_ONLY = ("warm",)  # launched on bench_torch.py's run, not the main path's
WARM_SHAPES = ((8, 128), (BLOCK, 128))
# launch counts the main path must also show: K5 with its OSA / LCS outputs on
VARIANTS = ("lev_jaro_fused.osa", "lev_jaro_fused.lcs")
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

    def variants(kernel, plain, *flag_sets):
        return [(flags, partial(kernel, **flags), partial(plain, **flags)) for flags in flag_sets]

    both = (np.int8, np.int32)
    k5 = variants(lev_jaro_cuda.lev_jaro_stats, lev_jaro_cuda.lev_jaro_plain,
                  *({"with_inter": i, "with_osa": o, "with_lcs": o}
                    for i, o in ((True, False), (False, False), (True, True), (False, True))))
    k6 = partial(variants, dp_fused_cuda.dp_fused_stats, dp_fused_cuda.dp_fused_plain)
    return [
        ("levenshtein_myers", [({}, levenshtein_cuda.levenshtein_distance,
                                levenshtein_cuda.myers_plain)], LADDER, both),
        ("jaro_scan", [({}, jaro_cuda.jaro_match_stats, jaro_cuda.jaro_plain)], LADDER, both),
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
    ]


def check_warm(device, clock_hz: float, rng) -> dict:
    """K11 against warm_plain, exactly, on [8, 128] and [65536, 128] int32
    drawn over the whole int32 range (x * 2 + 1 wraps), timed beside the
    PyTorch call that computes the same function, torch.add(one, x,
    alpha=2) with `one` allocated beforehand. Returns {"summary": the
    kernel's summed entry, "cases": [(record, launch)]}."""
    from functools import partial

    import torch

    from strsim_tpu_torch.ops.roofline import warm_bound
    from strsim_tpu_torch.ops.warm_cuda import warm, warm_plain

    entry = {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {},
             "library_ms": 0.0}
    cases = []
    for rows, width in WARM_SHAPES:
        x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (rows, width)).astype(np.int32)).to(device)
        one = torch.ones_like(x)
        got, want = warm(x), warm_plain(x)
        p_ms = time_ms(lambda: warm_plain(x), 1, warm_up=False)
        if not torch.equal(got, want):
            raise AssertionError(f"warm {rows}x{width}: kernel != plain at "
                                 f"{tuple(torch.nonzero(got != want)[0].tolist())}")
        if not torch.equal(torch.add(one, x, alpha=2), want):
            raise AssertionError("torch.add(one, x, alpha=2) differs from x * 2 + 1")
        k_ms = time_ms(lambda: warm(x), 5)
        lib_ms = time_ms(lambda: torch.add(one, x, alpha=2), 5)
        b_ms, b_by = warm_bound(x.numel(), clock_hz)
        record = {"name": "warm", "flags": {}, "width": width, "dtype": "int32", "rows": rows,
                  "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "library_ms": lib_ms}
        record["label"] = case_label(record)
        cases.append((record, partial(warm, x)))
        for k, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms), ("library_ms", lib_ms)):
            entry[k] += v
        entry["bound_by"][b_by] = entry["bound_by"].get(b_by, 0) + 1
    return {"summary": entry, "cases": cases}


def separate_kernels(a, b, la, lb):
    """What the fused kernel replaces: K1, K2, K3 and the plain prefix."""
    from strsim_tpu_torch.ops import jaro_cuda, levenshtein_cuda, multiset_cuda
    from strsim_tpu_torch.ops.stats import shared_prefix_length

    return (levenshtein_cuda.levenshtein_distance(a, b, la, lb),
            *jaro_cuda.jaro_match_stats(a, b, la, lb),
            shared_prefix_length(a, b),
            multiset_cuda.multiset_intersection_rank(a, b, la, lb))


def case_label(record) -> str:
    on = "+".join(k[5:] for k, v in record["flags"].items() if v) or "-"
    rows = "" if record.get("rows", BLOCK) == BLOCK else f" x{record['rows']}"
    return f"{record['name']} {on} w{record['width']} {record['dtype']}{rows}"


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_kernels(device, clock_hz: float, only=None):
    """Every kernel (or those named in `only`) against its plain version on
    the same card tensors. Returns ({name: {max_abs_err, ms, plain_ms,
    bound_ms, bound_by}}, the times summed over the name's cases; [one
    record per case], each also with `device_ms`, the kernel's own device
    time a launch from torch.profiler, beside `ms` from CUDA events)."""
    from functools import partial

    import torch

    from strsim_tpu_torch.ops.roofline import bound

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
                    cases.append(record)
                    launches.append((label, partial(kernel, *args)))
                    entry["ms"] += k_ms
                    entry["plain_ms"] += p_ms
                    entry["bound_ms"] += b_ms
                    entry["bound_by"][b_by] = entry["bound_by"].get(b_by, 0) + 1
    if only is None or "warm" in only:
        warm_cases = check_warm(device, clock_hz, rng)
        summary["warm"] = warm_cases.pop("summary")
        for record, launch in warm_cases["cases"]:
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
            if "library_ms" in record:
                extra += f", library (torch.add) {record['library_ms']:.4f} ms"
            print(f"  {case_label(record):42s} rows {record['rows']}: exact, kernel {record['ms']:.4f} ms "
                  f"(device {record['device_ms']:.4f} ms), plain {record['plain_ms']:.3f} ms, "
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
    all-fourteen and jaccard passes)."""
    from strsim_tpu_torch.models.pipeline import compute_scores
    from strsim_tpu_torch.utils.metrics import RunMetrics

    scores, five_metrics, all_metrics, jaccard_metrics = {}, {}, {}, {}
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
        scores[label] = many
    return scores, five_metrics, all_metrics, jaccard_metrics


def pass_reckoning(label, measures_label, measures, rm, cases, impls) -> None:
    """Print, kernel by kernel, what one pass of `measures` over the buckets
    of the run that filled RunMetrics `rm` would take on the card by this
    run's phase-3 times: the sum over its buckets of rows / BLOCK times the
    kernel's time (CUDA events, and its own device time), and bound at the
    bucket's width and tile dtype, for the outputs the router asks of it
    there (K6 at its three recurrences where phase 3 did not time that
    subset). Largest gap between device time and bound first."""
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
            t["rows"] += bm.rows
            t["widths"].append(bm.width)
    for kernel, t in sorted(per.items(), key=lambda kv: kv[1]["bound_ms"] - kv[1]["device_ms"]):
        print(f"  per pass, {label} {measures_label}: {kernel} {t['ms']:.4f} ms, device "
              f"{t['device_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms, {t['rows']} rows at "
              f"w{min(t['widths'])}..w{max(t['widths'])}", flush=True)


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


def _same_scores(label, what, got: dict, want: dict, rows=slice(None)) -> None:
    for m, v in got.items():
        if v.tobytes() != want[m][rows].tobytes():
            bad = int(np.nonzero(v != want[m][rows])[0][0])
            raise AssertionError(f"{label}: {what} differs from the default config on {m} "
                                 f"at row {bad}: {v[bad]!r} against {want[m][rows][bad]!r}")


def run_forced(st, workloads, scores, five_metrics) -> dict:
    """The forced-implementation path: compute_many over the five measures
    with FORCED on every workload whole, byte-identical to the default
    config's scores (`scores`, from run_workloads). Every kernel that the
    router names for FORCED on the workloads' buckets (`five_metrics`, from
    the default five-measure pass) must launch, K9 and K10 among them.
    Returns the launch counts."""
    from strsim_tpu_torch.ops import _build

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
    counts = require_launched("the forced path", want)
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
    for name, (_, log) in sorted(built.items()):
        print(f"  ptxas {name}: {ptxas_summary(log)}")
    t0 = time.perf_counter()
    native_build.get_lib()
    print(f"  native host library {native_build.target().name} ready in "
          f"{time.perf_counter() - t0:.1f} s (str-object routes: "
          f"{native_build.has_object_routes()})", flush=True)

    print("phase 3 kernels vs plain torch on the card:", flush=True)
    summary, cases = check_kernels(device, clock_hz, only)
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
    scores, five_metrics, all_metrics, jaccard_metrics = run_workloads(st, workloads)
    launches = require_launched("the main path", [k for k in (*KERNELS, *VARIANTS)
                                                  if k not in (*FORCED_KERNELS, *BENCH_ONLY)])
    print(f"  launches on the main path: {launches}", flush=True)
    for label, *_ in workloads:
        pass_reckoning(label, "five", FIVE, five_metrics[label], cases, st.get_config().impls())
        pass_reckoning(label, "all 14", ALL, all_metrics[label], cases, st.get_config().impls())
        pass_reckoning(label, "jaccard", ("jaccard",), jaccard_metrics[label], cases,
                       st.get_config().impls())
    forced_launches = run_forced(st, workloads, scores, five_metrics)
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
    check_golden_and_demo(st)
    check_native(st, workloads, oracle_sets)
    del workloads, scores

    print(f"  bench_torch.py {' '.join(BENCH_ARGS)}:", flush=True)
    import bench_torch

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rc = bench_torch.main([*BENCH_ARGS, "--details", str(OUT_DIR / "bench_torch_smoke.json")])
    if rc != 0:
        raise AssertionError(f"bench_torch.py exited {rc}")
    bench_launches = require_launched("bench_torch.py", BENCH_KERNELS)
    launches["warm"] = bench_launches["warm"]
    print(f"  bench_torch.py done in {time.perf_counter() - t0:.1f} s; its launches: "
          f"{bench_launches}", flush=True)

    print(f"phase 5 done in {time.perf_counter() - t_start:.1f} s", flush=True)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "library_ms": None, **summary[name]}
        for name, (src, tpu) in KERNELS.items()
    ]
    kernels[list(KERNELS).index("lev_jaro_fused")].update(
        {f"launches_{k.split('.')[1]}": launches[k] for k in VARIANTS})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
