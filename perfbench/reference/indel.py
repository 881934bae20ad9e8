"""indel (extension): 2 * longest common subsequence / (la + lb)."""
from __future__ import annotations

import numpy as np

from perfbench.reference import _rows
from perfbench.reference._rows import f


def work(A, B, la, lb, dtype):
    return dtype(2.0) * f(_rows.lcs_length(A, B, la, lb), dtype) / f(la + lb, dtype)


def scores(a, b, dtype=np.float64) -> np.ndarray:
    return _rows.scores(a, b, work, dtype)
