"""levenshtein: 1 - distance / max(la, lb), unit-cost edits over Unicode
scalars (strsim.rs:146-160)."""
from __future__ import annotations

import numpy as np

from perfbench.reference import _rows
from perfbench.reference._rows import f


def work(A, B, la, lb, dtype):
    d = _rows.levenshtein_distance(A, B, la, lb)
    return dtype(1.0) - f(d, dtype) / f(np.maximum(la, lb), dtype)


def scores(a, b, dtype=np.float64) -> np.ndarray:
    return _rows.scores(a, b, work, dtype)
