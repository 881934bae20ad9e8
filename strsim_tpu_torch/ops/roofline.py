"""The least time an H100 could take for a kernel's work, and the share of
it that a measured time reaches.

A kernel's bound is the larger of two times (`bound`): the bytes its
function must move (each row's la + lb chars and its two lengths read once,
its outputs written once) over the card's memory rate, and the integer
operations its function needs for these rows (`work_ops`) over the card's
INT32 peak: 132 SMs of 64 INT32 lanes at the SM clock that nvidia-smi
reports as the card's maximum. Operations are counted for this data, as a
floor: equality words from a per-row table, each recurrence over its own
row's words (ceil(pattern length / 32)) and steps, multisets by histogram.

The counterpart of `strsim_tpu/ops/roofline.py`, which holds the TPU's
envelope; no number of it carries over.
"""
from __future__ import annotations

import subprocess

import numpy as np

# The card's peaks (H100 SXM): device memory at 3.35 TB/s, and 132 SMs of 64
# INT32 lanes at the SM clock (`max_sm_clock_hz`).
HBM_BYTES_PER_S = 3.35e12
INT32_LANES = 132 * 64

# Word operations per 32-bit word and step of each recurrence, counted in
# its word step (csrc/lanes.cuh: myers_lane, osa_lane, lcs_lane; the carry,
# the score's bit reads and loop control left out):
# Myers 17, Hyyro OSA 21, Allison-Dix LCS 4; and the jaro greedy step's 5 per
# word of its window (window mask, clear the flagged bits, isolate the lowest
# bit in two, set its flag).
MYERS_OPS, OSA_OPS, LCS_OPS, JARO_OPS = 17, 21, 4, 5


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return nvidia_smi("name,power.limit")


def max_sm_clock_hz() -> float:
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def _words(n):
    return -(-n // 32)


def _peq(pattern, steps, words):
    """Operations for the equality words from a per-row table indexed by
    char: one OR per pattern char to build it, one read per word and step.
    K1, K2, K6 and K7 do so on int8 tiles; on int32 tiles, and in the other
    kernels, they compare chars instead. The bound counts the least the
    function needs."""
    return pattern + words * steps


def _jaro_window(la, lb):
    """(a-positions the greedy scan visits, words of b in each window)."""
    bound = np.maximum(la, lb) // 2 - 1
    steps = np.clip(np.minimum(la, lb + bound), 0, None)
    return steps, _words(np.clip(np.minimum(2 * bound + 1, lb), 0, None))


def work_ops(name: str, flags: dict, la, lb) -> float:
    """Integer operations the function of kernel `name` needs for rows of
    lengths la, lb (numpy int64 arrays), counted for this data as a floor:
    equality words from a per-row table (`_peq`), each recurrence over its
    own row's words (ceil(pattern length / 32)) and steps, multisets by
    histogram (one increment per char of one side, one test-and-decrement
    per char of the other)."""
    wa, wb = _words(la), _words(lb)
    if name == "jaro_ablated" and flags.get("mode") == "eqb_only":
        # K15's eqb_only: b's table, then one read and one XOR per word of b
        # and a-position (a's padded positions give 0, so la of them)
        return float(np.sum(lb + 2 * wb * la))
    if name == "myers_eq_scan":  # K16: its Eq words come in ready, no table
        return float(np.sum(MYERS_OPS * wa * lb))
    # K10 computes K1's function, K9 the scan of K2's (its flags are bytes),
    # the jaro probes K12-K15 K2's (probes/jaro.py; K15 in its other modes),
    # the Myers probes K17 and K18 K1's (probes/myers.py), the multiset probes
    # K20-K22 K3's (probes/multiset.py)
    name = {"levenshtein_wavefront": "levenshtein_myers", "jaro_flags": "jaro_scan",
            "jaro_flags_probe": "jaro_scan", "jaro_packed_t": "jaro_scan",
            "jaro_clipped": "jaro_scan", "jaro_ablated": "jaro_scan",
            "myers_ineq": "levenshtein_myers", "myers_swar": "levenshtein_myers",
            "multiset_unrolled": "multiset_rank", "multiset_swar": "multiset_rank",
            "multiset_blocked": "multiset_rank"}.get(name, name)
    if name in ("levenshtein_myers", "osa_scan", "dp_fused"):  # pattern a, text b
        on = {"levenshtein_myers": {"with_lev": True}, "osa_scan": {"with_osa": True}}.get(name, flags)
        per_word = (MYERS_OPS * on.get("with_lev", False) + OSA_OPS * on.get("with_osa", False)
                    + LCS_OPS * on.get("with_lcs", False))
        ops = _peq(la, lb, wa) + per_word * wa * lb
    elif name == "jaro_scan":  # b's equality words, a-position by a-position
        steps, win = _jaro_window(la, lb)
        ops = _peq(lb, steps, win) + JARO_OPS * win * steps
        if flags.get("with_prefix", False):
            ops = ops + np.minimum(np.minimum(la, lb), 4)  # the capped prefix
    elif name in ("multiset_rank", "multiset_hist"):
        ops = 2 * (la + lb)
    elif name in ("lev_jaro_fused", "fused_lev_jaro"):  # one lookup feeds every step
        # K5 (pattern b, text a), and the probe K19 (probes/myers.py), which
        # gives lev, m and t alone: no prefix, inter, OSA or LCS
        steps, win = _jaro_window(la, lb)
        per_word = (MYERS_OPS + OSA_OPS * flags.get("with_osa", False)
                    + LCS_OPS * flags.get("with_lcs", False))
        ops = _peq(lb, la, wb) + per_word * wb * la + JARO_OPS * win * steps
        if name == "lev_jaro_fused":
            ops = ops + np.minimum(np.minimum(la, lb), 4)  # the capped prefix
        if flags.get("with_inter", False):
            ops = ops + 2 * (la + lb)
    elif name == "bigram":  # bigram histograms, then ham_m over the shared positions
        ops = 2 * (np.maximum(la - 1, 0) + np.maximum(lb - 1, 0)) + np.minimum(la, lb)
    else:
        raise KeyError(name)
    return float(np.sum(ops))


def bound(name: str, flags: dict, lens, elem_bytes: int, out_bytes: int, clock_hz: float):
    """(ms, "bytes" or "operations"): the larger of the bytes the function
    must move (each row's la + lb chars, or K16's lb Eq words, and two
    lengths read once, its `out_bytes` of outputs written once) over the
    memory rate, and its
    integer operations (`work_ops`) over the INT32 peak."""
    la, lb = lens[0].astype(np.int64), lens[1].astype(np.int64)
    # K16 reads an Eq word of 4 bytes a text step in place of the chars
    chars = 4 * lb if name == "myers_eq_scan" else (la + lb) * elem_bytes
    t_bytes = float(np.sum(chars + 8 + out_bytes)) / HBM_BYTES_PER_S
    t_ops = work_ops(name, flags, la, lb) / (INT32_LANES * clock_hz)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def topk_bound(q_len, c_len, elem_bytes: int, k: int, winkler: bool, clock_hz: float,
               equal_len=()):
    """(ms, "bytes" or "operations") of K23's top k (csrc/topk_scan.cu) of
    queries of lengths q_len against candidates of lengths c_len: each
    query's and candidate's chars and length read once and [Q, k] int64 ids
    and float64 scores written once, over the memory rate, against the
    integer operations over the INT32 peak: the jaro greedy of every pair
    with both sides non-empty (JARO_OPS and one equality-word read a window
    word and step), with the capped prefix for jaro_winkler, less the pairs
    of equal strings (their lengths `equal_len`: the row conventions decide
    them), and each candidate's table (one operation a char) once, not once
    a pair. Summed over the grid of lengths, never pair by pair."""
    ql, qn = np.unique(np.asarray(q_len, dtype=np.int64), return_counts=True)
    cl, cn = np.unique(np.asarray(c_len, dtype=np.int64), return_counts=True)

    def pair_ops(la, lb):
        steps, win = _jaro_window(la, lb)
        ops = (JARO_OPS + 1) * win * steps
        if winkler:
            ops = ops + np.minimum(np.minimum(la, lb), 4)
        return np.where((la > 0) & (lb > 0), ops, 0)

    eq = np.asarray(equal_len, dtype=np.int64)
    ops = (float(np.sum(qn[:, None] * cn[None, :] * pair_ops(ql[:, None], cl[None, :])))
           - float(np.sum(pair_ops(eq, eq))) + float(np.sum(cn * cl)))
    nbytes = (float(np.sum((ql * elem_bytes + 4) * qn) + np.sum((cl * elem_bytes + 4) * cn))
              + 16.0 * float(np.sum(qn)) * k)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (INT32_LANES * clock_hz)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


# The full dynamic program's own floor (K10, csrc/levenshtein_wavefront.cu):
# its cells at DP_CELL_OPS integer operations each (the char compare and its
# add, one DPX min within the column, one on the chain down the strip), over
# the INT32 peak. K10's bound stays K1's, the least work for its function.
DP_CELL_OPS = 4


def dp_floor_ms(lens, clock_hz: float) -> float:
    """K10's DP floor for rows of lengths lens ([2, n]): la * lb cells a row
    whose lengths are both in 1..L (the others take no cell)."""
    la, lb = lens[0].astype(np.int64), lens[1].astype(np.int64)
    cells = np.where((la >= 1) & (lb >= 1), la * lb, 0)
    return float(np.sum(cells)) * DP_CELL_OPS / (INT32_LANES * clock_hz) * 1e3


def warm_bound(numel: int, clock_hz: float):
    """(ms, "bytes" or "operations") of K11's x * 2 + 1 over `numel` int32:
    4 bytes read and 4 written an element, two operations an element."""
    t_bytes = 8.0 * numel / HBM_BYTES_PER_S
    t_ops = 2.0 * numel / (INT32_LANES * clock_hz)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def route_flags(kernel: str, routes: dict) -> dict:
    """The output flags of `kernel` for the stats `routes` (ops/stats.py:
    stat_routes) sends it."""
    on = {f for f, r in routes.items() if r == kernel}
    if kernel == "lev_jaro_fused":
        deep = bool(on & {"osa_d", "lcs_len"})
        return {"with_inter": "inter" in on, "with_osa": deep, "with_lcs": deep}
    if kernel == "dp_fused":
        return {"with_lev": "lev_d" in on, "with_osa": "osa_d" in on, "with_lcs": "lcs_len" in on}
    if kernel == "jaro_scan" and "prefix" in on:
        return {"with_prefix": True}
    return {}
