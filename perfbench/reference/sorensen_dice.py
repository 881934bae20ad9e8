"""sorensen_dice: 2 * multiset intersection / (la + lb) (strsim.rs:322-343)."""
from __future__ import annotations

import numpy as np

from perfbench.reference import _rows
from perfbench.reference._rows import f


def work(A, B, la, lb, dtype):
    inter = _rows.char_inter(A, B, la, lb)
    return dtype(2.0) * f(inter, dtype) / f(la + lb, dtype)


def scores(a, b, dtype=np.float64) -> np.ndarray:
    return _rows.scores(a, b, work, dtype)
