"""overlap (extension): Szymkiewicz-Simpson over character multisets,
inter / min(la, lb)."""
from __future__ import annotations

import numpy as np

from perfbench.reference import _rows
from perfbench.reference._rows import f


def work(A, B, la, lb, dtype):
    inter = _rows.char_inter(A, B, la, lb)
    return f(inter, dtype) / f(np.minimum(la, lb), dtype)


def scores(a, b, dtype=np.float64) -> np.ndarray:
    return _rows.scores(a, b, work, dtype)
