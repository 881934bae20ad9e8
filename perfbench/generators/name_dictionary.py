"""A query column and a name dictionary from the distinct names of a data
file of the source.

The file (a path under perfbench/) holds {"rows": [[a, b], ...]}; its
distinct non-empty names, in order of first appearance, are the dictionary.
The dictionary comes in an order drawn from the seed, every name once. A
query column of n rows holds each name n // k times and the first n % k
names once more (k names), in an order drawn from the seed, so every seed
makes the same queries and draws only their order. Every row is a str
object of its own, as a Polars column's to_list() hands them over."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def names(rows: str) -> list:
    data = json.loads((HERE / rows).read_text())["rows"]
    return list(dict.fromkeys(x for row in data for x in row if x))


def generate(n: int, seed, *, rows: str):
    """(queries [n], dictionary [k]), object arrays of str."""
    distinct = np.array(names(rows))
    k = distinct.size
    rng = np.random.default_rng(seed)
    idx = rng.permutation(np.concatenate([np.tile(np.arange(k), n // k), np.arange(n % k)]))
    queries = np.empty(n, dtype=object)
    queries[:] = distinct[idx].tolist()  # a new str a row
    dictionary = np.empty(k, dtype=object)
    dictionary[:] = distinct[rng.permutation(k)].tolist()
    return queries, dictionary
