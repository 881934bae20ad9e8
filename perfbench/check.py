"""The parts of the check that decides `correct` which call shapes share
(`shapes/<shape>.py` draws its sample, runs the reference and gives the
numbers compared and their limits): a stratified sample of paired rows, the
plain reference's scores (`reference/<measure>.py`) and the exact comparison
of float64 scores.

The sample is stratified, so that it reaches each kind of row the program
treats apart: null rows (a side null), both-empty and equal rows (decided on
the host), one-empty rows, and the rows that need kernel math by the width
of their longer side on the ladder below (one stratum a bucket the program
can form; the strata only spread the sample, the check does not depend on
which bucket the program picks).
"""
from __future__ import annotations

import importlib
from typing import Dict, Sequence, Tuple

import numpy as np

# strata of kernel rows by max(la, lb): the edges of strsim_tpu_torch's
# default bucket ladder, and beyond it
LADDER = (7, 15, 23, 31, 47, 63, 95, 127, 191, 255, 383, 511)


def strata(a: Sequence, b: Sequence) -> Dict[str, np.ndarray]:
    """{stratum: rows} of columns a, b."""
    groups: Dict[str, list] = {}
    for i, (x, y) in enumerate(zip(a, b)):
        if x is None or y is None:
            key = "null"
        elif x == y:
            key = "both_empty" if not x else "equal"
        elif not x or not y:
            key = "one_empty"
        else:
            longest = max(len(x), len(y))
            key = next((f"w{e}" for e in LADDER if longest <= e), "beyond")
        groups.setdefault(key, []).append(i)
    return {k: np.asarray(v, dtype=np.int64) for k, v in groups.items()}


def select(a: Sequence, b: Sequence, per_stratum: int, rng) -> np.ndarray:
    """Sorted rows: up to `per_stratum` of each stratum, drawn by `rng`."""
    picked = []
    groups = strata(a, b)
    for key in sorted(groups):
        rows = groups[key]
        take = min(per_stratum, rows.size)
        picked.append(rng.choice(rows, size=take, replace=False))
    return np.sort(np.concatenate(picked)) if picked else np.zeros(0, np.int64)


def reference_scores(measures: Sequence[str], a: list, b: list, dtype=np.float64) -> np.ndarray:
    """[measures, rows] float64 scores of the plain reference (in `dtype`,
    returned as float64)."""
    return np.stack([importlib.import_module(f"perfbench.reference.{m}").scores(a, b, dtype)
                     for m in measures])


def exact(scores: np.ndarray, ref: np.ndarray) -> Tuple[int, float]:
    """(scores that differ from the reference's, the widest |difference|
    among them): a NaN where a number is due, or the reverse, differs, and
    counts 1 in the gap (scores lie in [0, 1])."""
    both_nan = np.isnan(scores) & np.isnan(ref)
    bad = ~(both_nan | (scores == ref))
    if not bad.any():
        return 0, 0.0
    diff = np.abs(scores[bad] - ref[bad])
    return int(bad.sum()), float(np.max(np.where(np.isnan(diff), 1.0, diff)))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limit for k, limit in limits.items())
