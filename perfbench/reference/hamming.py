"""hamming (extension): positional matches over max(la, lb); the length
difference counts as mismatches."""
from __future__ import annotations

import numpy as np

from perfbench.reference import _rows
from perfbench.reference._rows import f


def work(A, B, la, lb, dtype):
    return f(_rows.positional_matches(A, B), dtype) / f(np.maximum(la, lb), dtype)


def scores(a, b, dtype=np.float64) -> np.ndarray:
    return _rows.scores(a, b, work, dtype)
