"""Call shape "topk": a query column against a candidate column, each
query's k best candidates by the traffic's one measure,
`top_k_matches(queries, candidates, measure, k)` (traced: with a
RunMetrics).

Traffic keys: `queries_per_call` query rows a call, `k`, `batches` inputs
made by the configuration's generator (each a query column and a candidate
column), which the window's calls alternate, and `check_queries`.

The check keeps each call's [k] candidate indices and float64 scores at a
sample of query rows drawn from the seed (`check_queries` of them,
stratified by the query's length, a null query its own stratum), so every
call of the window is checked, at the rows where the program returned them.
The reference (`reference/topk.py`) scores each sampled query against every
candidate and ranks them by (score descending, index ascending). Numbers
compared, each with its limit (the configuration states float64 scores
identical to the reference and a tie rule, so the comparison is exact):
  index_mismatches  slots whose candidate index differs from the
                    reference's, over every sampled row and call;
  score_mismatches  slots whose score differs (a NaN where a number is due,
                    or the reverse, counts);
  widest_gap        the largest |program - reference| among them, a NaN
                    against a number counting as 1;
  failed_calls      calls of the window that raised.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
from typing import Dict, List, Optional

import numpy as np

from perfbench import check
from perfbench.loadgen import child_seed, scaled
from perfbench.reference import topk as reference_topk
from perfbench.roofline import _counts

LIMITS = {"index_mismatches": 0, "score_mismatches": 0, "widest_gap": 0.0, "failed_calls": 0}


@dataclasses.dataclass
class Input:
    """One call's input: the query and candidate columns, lists of str |
    None as a Polars column's to_list() gives them, and k."""

    queries: list
    candidates: list
    k: int
    check_rows: Optional[np.ndarray] = None  # query rows whose results the check compares
    _work: Optional[tuple] = None

    @property
    def rows(self) -> int:
        """The pairs one call scores: Q x C."""
        return len(self.queries) * len(self.candidates)


def inputs(gen, params, traffic, seed, scale) -> List[Input]:
    n = scaled(traffic["queries_per_call"], scale, 64)
    out = []
    for b in range(traffic["batches"]):
        queries, candidates = gen(n, child_seed(seed, 1, b), **params)
        out.append(Input(queries=queries.tolist(), candidates=candidates.tolist(), k=traffic["k"]))
    return out


def sample(queries, want: int, rng) -> np.ndarray:
    """Sorted query rows: an equal share of `want` from each stratum (the
    query's length, a null query its own), then the rest of `want` drawn
    from the rows not yet taken, all by `rng`."""
    groups: Dict[str, list] = {}
    for i, x in enumerate(queries):
        groups.setdefault("null" if x is None else f"len{len(x):06d}", []).append(i)
    per = max(1, want // max(len(groups), 1))
    picked = [rng.choice(np.asarray(groups[key]), size=min(per, len(groups[key])), replace=False)
              for key in sorted(groups)]
    chosen = np.concatenate(picked) if picked else np.zeros(0, np.int64)
    rest = np.setdiff1d(np.arange(len(queries)), chosen)
    extra = rng.choice(rest, size=min(max(want - chosen.size, 0), rest.size), replace=False)
    return np.sort(np.concatenate([chosen, extra])[:want]).astype(np.int64)


def select(workload, seed: int) -> None:
    rng = np.random.default_rng(child_seed(seed, 3))
    for inp in workload.inputs:
        inp.check_rows = sample(inp.queries, workload.traffic["check_queries"], rng)


def entry(st, measures, cfg, traced: bool):
    (measure,) = measures
    if traced:
        from strsim_tpu_torch.utils.metrics import RunMetrics

        def call(inp):
            rm = RunMetrics()
            return st.top_k_matches(inp.queries, inp.candidates, measure, inp.k, config=cfg,
                                    metrics=rm), rm
    else:
        def call(inp):
            return st.top_k_matches(inp.queries, inp.candidates, measure, inp.k, config=cfg), None
    return call


def keep(out, inp: Input, measures):
    """([check rows, k] indices, [check rows, k] scores)."""
    idx, scores = out
    return np.asarray(idx)[inp.check_rows].copy(), np.asarray(scores)[inp.check_rows].copy()


def reference(workload, dtype=np.float64) -> Dict[int, tuple]:
    (measure,) = workload.measures
    return {b: reference_topk.top_k(measure, [inp.queries[i] for i in inp.check_rows],
                                    inp.candidates, inp.k, dtype)
            for b, inp in enumerate(workload.inputs)}


def compare(got: List[tuple], want: Dict[int, tuple], failed_calls: int) -> Dict[str, float]:
    idx_bad, score_bad, gap = 0, 0, 0.0
    for b, (idx, scores) in got:
        want_idx, want_scores = want[b]
        idx_bad += int((idx != want_idx).sum())
        bad, widest = check.exact(scores, want_scores)
        score_bad += bad
        gap = max(gap, widest)
    return {"index_mismatches": idx_bad, "score_mismatches": score_bad, "widest_gap": gap,
            "failed_calls": failed_calls}


def pair_ops(measures, la, lb):
    """Least operations of one pair of lengths la, lb (arrays): each
    statistic's count (`roofline/<measure>.py`'s STATS, each once) and one
    equality-word read a word-step of the most demanding lookup; the table
    build is counted once a candidate, not here."""
    stats, lookups = {}, {}
    for m in measures:
        mod = importlib.import_module(f"perfbench.roofline.{m}")
        stats.update(mod.STATS)
        lookups.update(mod.LOOKUPS)
    ops = np.zeros(np.broadcast(la, lb).shape, dtype=np.float64)
    for count in stats.values():
        if count is not None:
            ops = ops + count(la, lb)
    if lookups:
        ops = ops + np.max([fn(la, lb) for fn in lookups.values()], axis=0)
    return ops


def work(measures, inp: Input):
    """(bytes, operations) of one call's least work: each query's and each
    candidate's chars (1 byte where the row is ASCII, else 4) and int32
    length read once, and [Q, k] int64 indices and float64 scores written
    once; `pair_ops` summed over the grid of query lengths x candidate
    lengths (counts of each, never the Q x C pairs one by one), less the
    pairs the row conventions decide (a side null or empty, or the two
    equal), plus each candidate's table build (`_counts.table_build`) once."""
    if inp._work is None:
        nbytes = 16.0 * len(inp.queries) * inp.k
        for col in (inp.queries, inp.candidates):
            nbytes += sum(4 + (len(x) if x.isascii() else 4 * len(x)) if x is not None else 4
                          for x in col)
        ql = collections.Counter(len(x) for x in inp.queries if x)
        cl = collections.Counter(len(x) for x in inp.candidates if x)
        ops = 0.0
        if ql and cl:
            la = np.array(sorted(ql), dtype=np.int64)
            lb = np.array(sorted(cl), dtype=np.int64)
            nq = np.array([ql[v] for v in la], dtype=np.float64)
            nc = np.array([cl[v] for v in lb], dtype=np.float64)
            grid = pair_ops(measures, la[:, None], lb[None, :])
            ops = float((nq[:, None] * nc[None, :] * grid).sum())
            same = collections.Counter(x for x in inp.candidates if x)
            equal = collections.Counter()
            for x in inp.queries:
                if x and x in same:
                    equal[len(x)] += same[x]
            if equal:
                le = np.array(sorted(equal), dtype=np.int64)
                ops -= float((np.array([equal[v] for v in le]) * pair_ops(measures, le, le)).sum())
            ops += float((nc * _counts.table_build(lb, lb)).sum())
        inp._work = (nbytes, ops)
    return inp._work


def widths(inp: Input, cfg) -> Dict[int, bool]:
    """None of the pairs pipeline's buckets: the call's kernel (K23) is
    built by set-up's warm calls."""
    return {}
