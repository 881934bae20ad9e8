"""jaccard_bigram (extension): bigram multisets, inter / (na + nb - inter)
with na = la - 1 bigrams; 0.0 where a side has no bigram (a single char)."""
from __future__ import annotations

import numpy as np

from perfbench.reference import _rows
from perfbench.reference._rows import f


def work(A, B, la, lb, dtype):
    inter = _rows.bigram_inter(A, B, la, lb)
    na, nb = la - 1, lb - 1
    with np.errstate(divide="ignore", invalid="ignore"):
        s = f(inter, dtype) / f(na + nb - inter, dtype)
    return np.where((na == 0) | (nb == 0), dtype(0.0), s)


def scores(a, b, dtype=np.float64) -> np.ndarray:
    return _rows.scores(a, b, work, dtype)
