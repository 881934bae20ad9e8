"""The k best candidates of each query by a measure: the plain reference of
the "topk" call shape (`shapes/topk.py`).

Each distinct query is scored against every candidate with the measure's
plain reference (`reference/<measure>.py`, which holds the row conventions:
a null side NaN, equal or both empty 1.0, one side empty 0.0), in `dtype`;
null candidates never match. The candidates are then ranked by a stable sort
on (-score, candidate index): equal scores keep the lower index first, as
RapidFuzz's extract orders them. A row with fewer than k candidates, and a
null query's row, are -1 / NaN past its candidates. Imports nothing of the
program."""
from __future__ import annotations

import importlib
from typing import Sequence, Tuple

import numpy as np


def scores(measure: str, queries: Sequence, candidates: Sequence, dtype=np.float64) -> np.ndarray:
    """[len(queries), len(candidates)] scores (float64, in `dtype`'s values)."""
    ref = importlib.import_module(f"perfbench.reference.{measure}")
    nq, nc = len(queries), len(candidates)
    a = [x for x in queries for _ in range(nc)]
    b = list(candidates) * nq
    return ref.scores(a, b, dtype).reshape(nq, nc)


def top_k(measure: str, queries: Sequence, candidates: Sequence, k: int,
          dtype=np.float64) -> Tuple[np.ndarray, np.ndarray]:
    """(indices [Q, k] int64, scores [Q, k] float64) of each query's k best
    candidates, each distinct query scored once."""
    distinct = list(dict.fromkeys(x for x in queries if x is not None))
    table = scores(measure, distinct, candidates, dtype) if distinct else None
    row_of = {x: r for r, x in enumerate(distinct)}
    valid = np.array([c is not None for c in candidates], dtype=bool)
    idx = np.full((len(queries), k), -1, dtype=np.int64)
    out = np.full((len(queries), k), np.nan, dtype=np.float64)
    ids = np.nonzero(valid)[0]
    best = {}
    for x, r in row_of.items():
        s = table[r, ids]
        order = np.lexsort((ids, -s))[:k]  # by -score, then by index
        best[x] = (ids[order], s[order])
    for i, x in enumerate(queries):
        if x is None:
            continue
        got_i, got_s = best[x]
        idx[i, : got_i.size] = got_i
        out[i, : got_s.size] = got_s
    return idx, out
