"""Rows of a data file of the source, each distinct row equally often.

The file (a path under perfbench/) holds {"rows": [[a, b], ...]}, null for a
null side. A column of n rows holds each of the file's k rows n // k times
and the first n % k rows once more, so every seed makes the same rows and
draws only their order. Every row is a str object of its own, as a Polars
column's to_list() hands them over."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def generate(n: int, seed, *, rows: str):
    data = json.loads((HERE / rows).read_text())["rows"]
    k = len(data)
    idx = np.concatenate([np.tile(np.arange(k), n // k), np.arange(n % k)])
    idx = np.random.default_rng(seed).permutation(idx)
    cols = []
    for side in (0, 1):
        text = np.array([r[side] or "" for r in data])[idx].tolist()  # a new str a row
        null = np.array([r[side] is None for r in data])[idx]
        col = np.empty(n, dtype=object)
        col[:] = text
        col[null] = None
        cols.append(col)
    return cols[0], cols[1]
