"""jaro: the greedy windowed match and ordered transpositions of
strsim.rs:197-243."""
from __future__ import annotations

import numpy as np

from perfbench.reference import _rows


def work(A, B, la, lb, dtype):
    return _rows.jaro_score(A, B, la, lb, dtype)


def scores(a, b, dtype=np.float64) -> np.ndarray:
    return _rows.scores(a, b, work, dtype)
