"""jaccard: character multisets, sum of min counts over sum of max counts
(strsim.rs:297-320)."""
from __future__ import annotations

import numpy as np

from perfbench.reference import _rows
from perfbench.reference._rows import f


def work(A, B, la, lb, dtype):
    inter = _rows.char_inter(A, B, la, lb)
    return f(inter, dtype) / f(la + lb - inter, dtype)


def scores(a, b, dtype=np.float64) -> np.ndarray:
    return _rows.scores(a, b, work, dtype)
