"""The check that decides `correct`: the f64 scores that the window's calls
returned, compared with the plain reference (`reference/<measure>.py`) on a
sample of rows drawn from the seed.

The sample is stratified, so that it reaches each kind of row the program
treats apart: null rows (a side null), both-empty and equal rows (decided on
the host), one-empty rows, and the rows that need kernel math by the width
of their longer side on the ladder below (one stratum a bucket the program
can form; the strata only spread the sample, the check does not depend on
which bucket the program picks). Up to `per_stratum` rows of each. Every
call's scores at those rows are kept and compared, so every call of the
window is checked, at the rows where the program produced them after its
finalize and scatter back to row order.

Numbers compared, each with its limit (the configuration states float64
scores identical to the reference, so the comparison is exact):
  score_mismatches  scores that differ from the reference's (a NaN where a
                    number is due, or the reverse, counts), over every
                    measure, sampled row and call;
  widest_gap        the largest |program - reference| among them, a NaN
                    against a number counting as 1 (scores lie in [0, 1]);
  failed_calls      calls of the window that raised.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Sequence

import numpy as np

LIMITS = {"score_mismatches": 0, "widest_gap": 0.0, "failed_calls": 0}

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


def select_all(workload, seed: int) -> None:
    """Draw each input's check rows from the run's seed."""
    from perfbench.loadgen import child_seed

    rng = np.random.default_rng(child_seed(seed, 3))
    per_stratum = workload.traffic["check_rows_per_stratum"]
    for inp in workload.inputs:
        inp.check_rows = select(inp.a, inp.b, per_stratum, rng)


def reference_all(workload, dtype=np.float64) -> Dict[int, np.ndarray]:
    """{input: [measures, check rows] reference scores}."""
    return {k: reference_scores(workload.measures, [inp.a[i] for i in inp.check_rows],
                                [inp.b[i] for i in inp.check_rows], dtype)
            for k, inp in enumerate(workload.inputs)}


def reference_scores(measures: Sequence[str], a: list, b: list, dtype=np.float64) -> np.ndarray:
    """[measures, rows] float64 scores of the plain reference (in `dtype`,
    returned as float64)."""
    return np.stack([importlib.import_module(f"perfbench.reference.{m}").scores(a, b, dtype)
                     for m in measures])


def compare(got: List[tuple], want: Dict[int, np.ndarray], failed_calls: int) -> Dict[str, float]:
    """The numbers compared. got: (input index, [measures, rows] scores) of
    each call that returned; want: {input index: the reference's}."""
    mismatches, gap = 0, 0.0
    for k, scores in got:
        ref = want[k]
        both_nan = np.isnan(scores) & np.isnan(ref)
        bad = ~(both_nan | (scores == ref))
        mismatches += int(bad.sum())
        if bad.any():
            diff = np.abs(scores[bad] - ref[bad])
            gap = max(gap, float(np.max(np.where(np.isnan(diff), 1.0, diff))))
    return {"score_mismatches": mismatches, "widest_gap": gap, "failed_calls": failed_calls}


def verdict(numbers: Dict[str, float]) -> bool:
    return all(numbers[k] <= limit for k, limit in LIMITS.items())
