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

`roofline_report` puts the bound of each bucket of a pass (every kernel the
router sends the bucket's stats to) beside the bucket's measured device
time. The counterpart of `strsim_tpu/ops/roofline.py`, which holds the TPU's
envelope; no number of it carries over.
"""
from __future__ import annotations

import subprocess
from typing import Dict, List

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
    # K10 computes K1's function, K9 the scan of K2's (its flags are bytes)
    name = {"levenshtein_wavefront": "levenshtein_myers", "jaro_flags": "jaro_scan"}.get(name, name)
    if name in ("levenshtein_myers", "osa_scan", "dp_fused"):  # pattern a, text b
        on = {"levenshtein_myers": {"with_lev": True}, "osa_scan": {"with_osa": True}}.get(name, flags)
        per_word = (MYERS_OPS * on.get("with_lev", False) + OSA_OPS * on.get("with_osa", False)
                    + LCS_OPS * on.get("with_lcs", False))
        ops = _peq(la, lb, wa) + per_word * wa * lb
    elif name == "jaro_scan":  # b's equality words, a-position by a-position
        steps, win = _jaro_window(la, lb)
        ops = _peq(lb, steps, win) + JARO_OPS * win * steps
    elif name in ("multiset_rank", "multiset_hist"):
        ops = 2 * (la + lb)
    elif name == "lev_jaro_fused":  # pattern b, text a: one lookup feeds every step
        steps, win = _jaro_window(la, lb)
        per_word = (MYERS_OPS + OSA_OPS * flags.get("with_osa", False)
                    + LCS_OPS * flags.get("with_lcs", False))
        ops = (_peq(lb, la, wb) + per_word * wb * la + JARO_OPS * win * steps
               + np.minimum(np.minimum(la, lb), 4))  # the capped prefix
        if flags.get("with_inter", False):
            ops = ops + 2 * (la + lb)
    elif name == "bigram":  # bigram histograms, then ham_m over the shared positions
        ops = 2 * (np.maximum(la - 1, 0) + np.maximum(lb - 1, 0)) + np.minimum(la, lb)
    else:
        raise KeyError(name)
    return float(np.sum(ops))


def bound(name: str, flags: dict, lens, elem_bytes: int, out_bytes: int, clock_hz: float):
    """(ms, "bytes" or "operations"): the larger of the bytes the function
    must move (each row's la + lb chars and two lengths read once, its
    `out_bytes` of outputs written once) over the memory rate, and its
    integer operations (`work_ops`) over the INT32 peak."""
    la, lb = lens[0].astype(np.int64), lens[1].astype(np.int64)
    t_bytes = float(np.sum((la + lb) * elem_bytes + 8 + out_bytes)) / HBM_BYTES_PER_S
    t_ops = work_ops(name, flags, la, lb) / (INT32_LANES * clock_hz)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


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
    return {}


def roofline_report(buckets: List[dict], clock_hz: float) -> Dict[str, object]:
    """Each bucket of a pass beside its bound. A bucket: {"width", "dtype"
    (torch dtype name), "lens" ([2, rows] of its rows), "routes" (stat ->
    kernel or "plain"), "fields" (stats it outputs), "measured_ms" (its
    device time)}. Its bound: its rows' chars and lengths read once and its
    int32 stats written once, over the memory rate, against the operations
    of every kernel it routes to (`work_ops`) over the INT32 peak; the plain
    forms' operations are not counted (a floor). Returns {"buckets": {width:
    {bound_ms, bound_by, measured_ms, share}}, "bound_ms", "measured_ms",
    "share"}, share = bound / measured."""
    out, total_bound, total_measured = {}, 0.0, 0.0
    for bk in buckets:
        la, lb = (np.asarray(x, dtype=np.int64) for x in bk["lens"])
        elem = 1 if bk["dtype"] == "int8" else 4
        t_bytes = float(np.sum((la + lb) * elem + 8 + 4 * len(bk["fields"]))) / HBM_BYTES_PER_S
        kernels = sorted(set(bk["routes"].values()) - {"plain"})
        ops = sum(work_ops(k, route_flags(k, bk["routes"]), la, lb) for k in kernels)
        t_ops = ops / (INT32_LANES * clock_hz)
        bound_ms = max(t_bytes, t_ops) * 1e3
        out[bk["width"]] = {
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "measured_ms": bk["measured_ms"],
            "share": bound_ms / bk["measured_ms"],
            "kernels": kernels,
        }
        total_bound += bound_ms
        total_measured += bk["measured_ms"]
    return {"buckets": out, "bound_ms": total_bound, "measured_ms": total_measured,
            "share": total_bound / total_measured if total_measured else None}
