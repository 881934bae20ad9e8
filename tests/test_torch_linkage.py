"""The port's top_k_matches (models/linkage.py) on the CPU: exact against the
benchmark's plain reference (`perfbench/reference/topk.py`: each query
scored against every candidate by the plain reference of its measure, ranked
by a stable sort on (-score, index)); every returned score equal to
compute() for its pair; close to `strsim_tpu`'s top_k_matches, whose scores
are float32; a float32 finish in K23's place (its plain form) caught by the
exact comparison; the conventions for empty inputs and k; and the call's
spans and counters."""
import json
import sys
import types
from pathlib import Path

import jax  # noqa: F401 (tests/conftest.py pins it to the CPU)
import numpy as np
import pytest
import torch

import strsim_tpu_torch as st
from strsim_tpu.models.linkage import top_k_matches as jax_top_k_matches
from strsim_tpu_torch.models import linkage
from strsim_tpu_torch.ops import topk_cuda
from strsim_tpu_torch.utils import metrics as tmetrics
from strsim_tpu_torch.utils.metrics import RunMetrics

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from perfbench.reference import topk as reference  # noqa: E402

torch.set_num_threads(1)

CPU = st.StrsimConfig(device="cpu")
LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _names(rng, n, alphabet=LETTERS, lo=1, hi=12):
    return ["".join(rng.choice(list(alphabet), rng.integers(lo, hi + 1))) for _ in range(n)]


def _corpus():
    rows = json.loads((ROOT / "perfbench" / "data" / "genealogy_pairs.json").read_text())["rows"]
    return list(dict.fromkeys(x for row in rows for x in row if x))


def _case(name):
    """(queries, candidates, measure, k, candidate_block) of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random":
        return _names(rng, 120), _names(rng, 150), "jaro_winkler", 5, None
    if name == "corpus":
        names = _corpus()
        pick = lambda n: [names[i] for i in rng.integers(len(names), size=n)]  # noqa: E731
        return pick(200), list(rng.permutation(names)[:300]), "jaro_winkler", 5, None
    if name == "nulls_empties_equal":
        cs = _names(rng, 60) + [None, "", None, "abc"]
        qs = _names(rng, 40) + [None, "", "abc", cs[3], cs[10]]
        return qs, cs, "jaro_winkler", 5, None
    if name == "ties":  # two letters: many distinct names of equal score
        return _names(rng, 80, "ab", 1, 6), _names(rng, 90, "ab", 1, 6), "jaro_winkler", 5, None
    if name == "fewer_than_k":
        return _names(rng, 30), ["abc", None, "abd"], "jaro_winkler", 5, None
    if name == "k_above_c":
        return _names(rng, 30), _names(rng, 6), "jaro_winkler", 10, None
    if name == "several_tiles":
        return _names(rng, 70), _names(rng, 100), "jaro_winkler", 4, 16
    if name == "non_ascii":
        alphabet = LETTERS[:10] + "éüöçñ\U0001d11e"
        return _names(rng, 60, alphabet), _names(rng, 80, alphabet), "jaro_winkler", 5, None
    if name == "past_cap":
        qs = _names(rng, 40) + _names(rng, 6, "abcde", 33, 60)
        cs = _names(rng, 50) + _names(rng, 8, "abcde", 30, 70)
        return qs, cs, "jaro_winkler", 5, None
    if name == "jaro":
        return _names(rng, 60), _names(rng, 70), "jaro", 3, None
    if name == "k_above_kernel":
        return _names(rng, 30), _names(rng, 40), "jaro_winkler", topk_cuda.MAX_K + 3, None
    if name in ("levenshtein", "jaccard"):
        return _names(rng, 30), _names(rng, 40) + [None, ""], name, 5, 16
    raise KeyError(name)


CASES = ["random", "corpus", "nulls_empties_equal", "ties", "fewer_than_k", "k_above_c",
         "several_tiles", "non_ascii", "past_cap", "jaro", "k_above_kernel", "levenshtein",
         "jaccard"]


@pytest.mark.parametrize("name", CASES)
def test_exact_against_the_reference(name):
    qs, cs, measure, k, block = _case(name)
    idx, scores = st.top_k_matches(qs, cs, measure, k, config=CPU, candidate_block=block)
    want_i, want_s = reference.top_k(measure, qs, cs, k)
    assert idx.dtype == np.int64 and scores.dtype == np.float64 and idx.shape == (len(qs), k)
    assert np.array_equal(idx, want_i)
    assert scores.tobytes() == want_s.tobytes()


@pytest.mark.parametrize("name", ["random", "ties", "non_ascii", "past_cap", "jaro", "corpus"])
def test_every_score_is_computes(name):
    qs, cs, measure, k, block = _case(name)
    idx, scores = st.top_k_matches(qs, cs, measure, k, config=CPU, candidate_block=block)
    rows, slots = np.nonzero(idx >= 0)
    want = st.compute(measure, [qs[r] for r in rows], [cs[j] for j in idx[rows, slots]], config=CPU)
    assert scores[rows, slots].tobytes() == want.tobytes()


def test_ties_rank_by_the_lower_index():
    qs = ["abcd"]
    cs = ["abcx", "zzzz", "abcy", "abcz", "abcd", "abcw"]
    idx, scores = st.top_k_matches(qs, cs, "jaro_winkler", 4, config=CPU)
    assert idx[0].tolist() == [4, 0, 2, 3] and scores[0, 0] == 1.0
    assert scores[0, 1] == scores[0, 2] == scores[0, 3]


def test_the_conventions_of_empty_inputs():
    for qs, cs, k, shape in (([], ["a"], 3, (0, 3)), (["a", None], [], 3, (2, 3)),
                             (["a"], ["a"], 0, (1, 0)), (["a"], ["a"], -2, (1, 0))):
        idx, scores = st.top_k_matches(qs, cs, "jaro_winkler", k, config=CPU)
        j_idx, j_scores = jax_top_k_matches(qs, cs, "jaro_winkler", k)
        assert idx.shape == scores.shape == shape == j_idx.shape
        assert (idx == -1).all() and np.isnan(scores).all()
        assert idx.dtype == np.int64 and scores.dtype == np.float64
    idx, scores = st.top_k_matches([None, "ab"], [None, None], "jaro", 2, config=CPU)
    assert (idx == -1).all() and np.isnan(scores).all()


def test_float32_finish_fails_the_exact_comparison(monkeypatch):
    """K23's plain form finished in float32 (the precision below the
    configuration's float64) in the program's place: the comparison that the
    benchmark's check makes catches it."""
    qs, cs = _corpus()[:300], _corpus()[300:700]
    real = topk_cuda.finish_scores

    def float32(*args, **kwargs):
        return real(*args, **kwargs).to(torch.float32).to(torch.float64)
    monkeypatch.setattr(topk_cuda, "finish_scores", float32)
    idx, scores = st.top_k_matches(qs, cs, "jaro_winkler", 5, config=CPU)
    want_i, want_s = reference.top_k("jaro_winkler", qs, cs, 5)
    from perfbench import check

    bad, gap = check.exact(scores, want_s)
    assert bad > 0 and gap > 0


def _f32_ulp(x):
    return np.spacing(np.abs(np.asarray(x, dtype=np.float32))).astype(np.float64)


@pytest.mark.parametrize("seed", [11, 12])
def test_close_to_the_jax_package(seed):
    """strsim_tpu's top_k_matches ranks by float32 scores (linkage.py:17-20:
    within one float32 ulp of the exact ones; its float32 finish, three
    divisions and two additions, lands up to two). JAX's score of each
    candidate it returns lies within two float32 ulps of the port's score
    rounded to float32, but where the exact jaro lies within one float32 ulp of 0.7,
    the winkler boost's threshold, which float32 decides otherwise than
    float64 (JAX then leaves the boost out: 0.7 for an exact 0.76); and the two
    agree on the set of the first j candidates wherever JAX's j-th and
    (j+1)-th scores lie more than 2 float32 ulps apart, on the queries whose
    top k, JAX's or the port's, hold no such threshold pair."""
    rng = np.random.default_rng(seed)
    qs, cs = _names(rng, 150, "abcdefgh", 1, 14), _names(rng, 220, "abcdefgh", 1, 14)
    k = 5
    idx, scores = st.top_k_matches(qs, cs, "jaro_winkler", k, config=CPU)
    j_idx, j_scores = jax_top_k_matches(qs, cs, "jaro_winkler", k + 1)
    j_scores = j_scores.astype(np.float64)
    rows = np.repeat(np.arange(len(qs)), k + 1)
    ours = st.compute("jaro_winkler", [qs[r] for r in rows], [cs[j] for j in j_idx.ravel()],
                      config=CPU).reshape(len(qs), k + 1)
    jaro = st.compute("jaro", [qs[r] for r in rows], [cs[j] for j in j_idx.ravel()],
                      config=CPU).reshape(len(qs), k + 1)
    at_threshold = np.abs(jaro - 0.7) <= _f32_ulp(0.7)
    close = np.abs(ours.astype(np.float32).astype(np.float64) - j_scores) <= 2 * _f32_ulp(j_scores)
    assert (close | at_threshold).all()
    assert close.mean() > 0.99
    our_jaro = st.compute("jaro", [qs[r] for r in np.repeat(np.arange(len(qs)), k)],
                          [cs[j] for j in idx.ravel()], config=CPU).reshape(len(qs), k)
    plain = ~at_threshold.any(1) & ~(np.abs(our_jaro - 0.7) <= _f32_ulp(0.7)).any(1)
    agreed = 0
    for r in np.nonzero(plain)[0]:
        for j in range(1, k + 1):
            if j_scores[r, j - 1] - j_scores[r, j] > 2 * _f32_ulp(j_scores[r, j - 1]):
                assert set(idx[r, :j]) == set(j_idx[r, :j]), (r, j)
                agreed += 1
    assert agreed > len(qs)


# --- spans and counters -------------------------------------------------

TREE = {
    "strsim.topk": None,
    "strsim.topk.encode": "strsim.topk",
    "strsim.topk.stage": "strsim.topk",
    "strsim.topk.launch": "strsim.topk",
    "strsim.topk.plain": "strsim.topk",
    "strsim.topk.collect": "strsim.topk",
    "strsim.topk.finish": "strsim.topk",
}


@pytest.fixture(scope="module")
def traced():
    """One RunMetrics over two calls: jaro_winkler with null rows, then
    levenshtein on the tiled route."""
    rm = RunMetrics()
    rng = np.random.default_rng(5)
    cols = [(_names(rng, 50) + [None], _names(rng, 40) + [None, None], "jaro_winkler"),
            (_names(rng, 20), _names(rng, 30), "levenshtein")]
    outs = [st.top_k_matches(qs, cs, m, 5, config=CPU, metrics=rm) for qs, cs, m in cols]
    return rm, cols, outs


def test_each_call_is_one_tree(traced):
    rm, _, _ = traced
    assert rm.calls == 2
    roots = [i for i, s in enumerate(rm.spans) if s.parent == -1]
    assert [rm.spans[i].name for i in roots] == ["strsim.topk"] * 2
    for i, s in enumerate(rm.spans):
        assert s.name in TREE and s.start_ns <= s.end_ns
        if s.parent >= 0:
            parent = rm.spans[s.parent]
            assert parent.name == TREE[s.name] and parent.call == s.call and s.parent < i
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
    for call in range(2):  # the CPU takes the plain route: no launch of K23
        names = [s.name for s in rm.spans if s.call == call and s.parent >= 0]
        assert names == ["strsim.topk.encode", "strsim.topk.stage", "strsim.topk.launch",
                         "strsim.topk.plain", "strsim.topk.collect", "strsim.topk.finish"]


def test_counters_count_the_pairs(traced):
    rm, cols, _ = traced
    pairs = 50 * 40 + 20 * 30  # non-null queries x non-null candidates
    assert rm.counters == {"topk.pairs": pairs, "topk.lane_pairs": pairs, "topk.launches": 0}


def test_off_makes_no_span(traced, monkeypatch):
    rm, cols, outs = traced

    def refuse(*args, **kwargs):
        raise AssertionError("reached with metrics=None")
    monkeypatch.setattr(RunMetrics, "span", refuse)
    monkeypatch.setattr(RunMetrics, "count", refuse)
    monkeypatch.setattr(tmetrics, "time", types.SimpleNamespace(perf_counter_ns=refuse))
    for (qs, cs, m), (want_i, want_s) in zip(cols, outs):
        idx, scores = st.top_k_matches(qs, cs, m, 5, config=CPU)
        assert np.array_equal(idx, want_i) and scores.tobytes() == want_s.tobytes()


def test_the_public_api():
    assert st.top_k_matches is linkage.top_k_matches and "top_k_matches" in st.__all__


def _bound_ops(q_len, c_len, winkler, equal_len=()):
    """roofline.topk_bound's operations: its time at a 1 Hz clock, which
    operations then bound, times the INT32 lanes."""
    from strsim_tpu_torch.ops import roofline

    ms, by = roofline.topk_bound(q_len, c_len, 1, 5, winkler, 1.0, equal_len)
    assert by == "operations"
    return ms / 1e3 * roofline.INT32_LANES


@pytest.mark.parametrize("winkler", [True, False], ids=["jaro_winkler", "jaro"])
def test_topk_bound_counts_every_pair(winkler):
    """K23's bound (chip_smoke.py's, `roofline.topk_bound`), summed over the
    grid of lengths, equals its counts pair by pair: the greedy's window
    words and steps (5 operations and an equality-word read each), the
    capped prefix for jaro_winkler, no pair with an empty side or of equal
    strings, and each candidate's table once; for jaro_winkler it equals the
    benchmark's `work` of the same call."""
    rng = np.random.default_rng(18)
    qs = _names(rng, 70, "abc", 1, 40) + ["", "abc"]
    cs = _names(rng, 50, "abc", 1, 40) + ["", "abc"]
    want = float(sum(len(c) for c in cs))
    for a in qs:
        for b in cs:
            la, lb = len(a), len(b)
            if not la or not lb or a == b:
                continue
            bound = max(la, lb) // 2 - 1
            steps = max(min(la, lb + bound), 0)
            win = -(-max(min(2 * bound + 1, lb), 0) // 32)
            want += 6 * win * steps + (min(la, lb, 4) if winkler else 0)
    equal = [len(a) for a in qs for b in cs if a and a == b]
    got = _bound_ops([len(x) for x in qs], [len(x) for x in cs], winkler, equal)
    assert got == pytest.approx(want, rel=1e-12)
    if winkler:
        from perfbench.shapes import topk as shape

        inp = shape.Input(queries=qs, candidates=cs, k=5)
        assert got == pytest.approx(shape.work(("jaro_winkler",), inp)[1], rel=1e-12)
