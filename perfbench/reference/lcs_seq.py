"""lcs_seq (extension): longest common subsequence / max(la, lb)."""
from __future__ import annotations

import numpy as np

from perfbench.reference import _rows
from perfbench.reference._rows import f


def work(A, B, la, lb, dtype):
    return f(_rows.lcs_length(A, B, la, lb), dtype) / f(np.maximum(la, lb), dtype)


def scores(a, b, dtype=np.float64) -> np.ndarray:
    return _rows.scores(a, b, work, dtype)
