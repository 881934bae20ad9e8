"""Call shape "pairs": two paired columns, `compute_many(measures, a, b)`.

Traffic keys: `pairs_per_call` rows a column, `batches` pairs of columns
made by the configuration's generator, which the window's calls alternate,
and `check_rows_per_stratum`.

The check keeps each call's f64 scores at a sample of rows drawn from the
seed (`check.select`: up to `check_rows_per_stratum` rows of each stratum
of each input), so every call of the window is checked, at the rows where
the program produced them after its finalize and scatter back to row order.
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

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from perfbench import check
from perfbench.loadgen import child_seed, scaled
from perfbench.roofline import _bound

LIMITS = {"score_mismatches": 0, "widest_gap": 0.0, "failed_calls": 0}


@dataclasses.dataclass
class Input:
    """One call's input: columns a and b, lists of str | None as a Polars
    column's to_list() gives them."""

    a: list
    b: list
    check_rows: Optional[np.ndarray] = None  # rows whose scores the check compares
    _device: Optional[tuple] = None

    @property
    def rows(self) -> int:
        return len(self.b)

    def device_rows(self):
        """(la, lb, ascii) of the rows that need kernel math: both sides
        non-null, not equal, neither empty (the reference's conventions
        decide the others without any)."""
        if self._device is None:
            la, lb, asc = [], [], []
            for x, y in zip(self.a, self.b):
                if x is None or y is None or x == y or not x or not y:
                    continue
                la.append(len(x))
                lb.append(len(y))
                asc.append(x.isascii() and y.isascii())
            self._device = (np.array(la, dtype=np.int64), np.array(lb, dtype=np.int64),
                            np.array(asc, dtype=bool))
        return self._device


def inputs(gen, params, traffic, seed, scale) -> List[Input]:
    n = scaled(traffic["pairs_per_call"], scale, 64)
    out = []
    for k in range(traffic["batches"]):
        a, b = gen(n, child_seed(seed, 1, k), **params)
        out.append(Input(a=a.tolist(), b=b.tolist()))
    return out


def select(workload, seed: int) -> None:
    rng = np.random.default_rng(child_seed(seed, 3))
    per_stratum = workload.traffic["check_rows_per_stratum"]
    for inp in workload.inputs:
        inp.check_rows = check.select(inp.a, inp.b, per_stratum, rng)


def entry(st, measures, cfg, traced: bool):
    if traced:
        from strsim_tpu_torch.models.pipeline import compute_scores
        from strsim_tpu_torch.utils.metrics import RunMetrics

        def call(inp):
            rm = RunMetrics()
            res = compute_scores(inp.a, inp.b, measures, config=cfg, metrics=rm)
            return {m: v for m, (v, _) in res.items()}, rm
    else:
        def call(inp):
            return st.compute_many(measures, inp.a, inp.b, config=cfg), None
    return call


def keep(out, inp: Input, measures) -> np.ndarray:
    """[measures, check rows] scores."""
    return np.stack([out[m][inp.check_rows] for m in measures])


def reference(workload, dtype=np.float64) -> Dict[int, np.ndarray]:
    return {k: check.reference_scores(workload.measures, [inp.a[i] for i in inp.check_rows],
                                      [inp.b[i] for i in inp.check_rows], dtype)
            for k, inp in enumerate(workload.inputs)}


def compare(got: List[tuple], want: Dict[int, np.ndarray], failed_calls: int) -> Dict[str, float]:
    mismatches, gap = 0, 0.0
    for k, scores in got:
        bad, widest = check.exact(scores, want[k])
        mismatches += bad
        gap = max(gap, widest)
    return {"score_mismatches": mismatches, "widest_gap": gap, "failed_calls": failed_calls}


def work(measures, inp: Input):
    return _bound.work(measures, *inp.device_rows())


def widths(inp: Input, cfg) -> Dict[int, bool]:
    la, lb, asc = inp.device_rows()
    longest = np.maximum(la, lb)
    out: Dict[int, bool] = {}
    for v in np.unique(longest):
        w = cfg.bucket_for(int(v))
        out[w] = out.get(w, True) and bool(asc[longest == v].all())
    return out
