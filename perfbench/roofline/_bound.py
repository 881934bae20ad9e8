"""The least time the card could take for a cell's device rows.

A row's least work: its chars (1 byte each where the row is ASCII, else 4)
and its two int32 lengths read once and each distinct statistic written
once as int32; and the operations of each distinct statistic the cell's
measures need (`<measure>.py`'s STATS, each statistic once a row however
many measures share it), plus, where a bit-parallel statistic is needed,
one equality-word read a word-step of the most demanding one and one table
build (LOOKUPS). A statistic without a count (STATS value None) adds bytes
alone, a floor. The bound is the larger of the bytes over the memory rate
and the operations over the INT32 peak, summed over all the rows first.
It reads the measures and the lengths, and nothing of the program."""
from __future__ import annotations

import importlib
from typing import Sequence, Tuple

import numpy as np

from perfbench.roofline import _counts


def work(measures: Sequence[str], la, lb, ascii_rows) -> Tuple[float, float]:
    """(bytes, operations) of rows of lengths la, lb under `measures`."""
    la = np.asarray(la, dtype=np.int64)
    lb = np.asarray(lb, dtype=np.int64)
    stats, lookups = {}, {}
    for m in measures:
        mod = importlib.import_module(f"perfbench.roofline.{m}")
        stats.update(mod.STATS)
        lookups.update(mod.LOOKUPS)
    ops = np.zeros(la.shape, dtype=np.float64)
    for count in stats.values():
        if count is not None:
            ops += count(la, lb)
    if lookups:
        ops += np.max([fn(la, lb) for fn in lookups.values()], axis=0)
        ops += _counts.table_build(la, lb)
    elem = np.where(np.asarray(ascii_rows, dtype=bool), 1, 4)
    nbytes = (la + lb) * elem + 8 + 4 * len(stats)
    return float(nbytes.sum()), float(ops.sum())


def seconds(nbytes: float, ops: float, peaks: dict) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations", whichever bounds it)."""
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    t_ops = ops / peaks["int32_ops_per_s"]
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")
