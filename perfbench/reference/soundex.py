"""soundex (extension): 1.0 when the American Soundex codes of the two
strings are equal (two strings without a letter share the empty code),
else 0.0."""
from __future__ import annotations

import numpy as np

from perfbench.reference import _rows


def work(A, B, la, lb, dtype):
    sa, sb = _rows.decode(A, la), _rows.decode(B, lb)
    return np.array([dtype(_rows.soundex_code(x) == _rows.soundex_code(y)) for x, y in zip(sa, sb)])


def scores(a, b, dtype=np.float64) -> np.ndarray:
    return _rows.scores(a, b, work, dtype)
