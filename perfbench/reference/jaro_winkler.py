"""jaro_winkler: jaro plus prefix * 0.1 * (1 - jaro) when jaro > 0.7, the
prefix capped at 4 chars (strsim.rs:258-271)."""
from __future__ import annotations

import numpy as np

from perfbench.reference import _rows
from perfbench.reference._rows import f


def work(A, B, la, lb, dtype):
    js = _rows.jaro_score(A, B, la, lb, dtype)
    p = _rows.shared_prefix(A, B)
    return np.where(js > dtype(0.7), js + (f(p, dtype) * dtype(0.1) * (dtype(1.0) - js)), js)


def scores(a, b, dtype=np.float64) -> np.ndarray:
    return _rows.scores(a, b, work, dtype)
