"""K23 (`csrc/topk_scan.cu`) and the port's top_k_matches on the card.

K23 against its plain torch form (`topk_cuda.topk_plain`) on int8 and int32
tiles, jaro and jaro_winkler, k = 1, 5 and 8, one tile and several, and on
the inputs of `linkage_cases.SCREEN_CASES` (its screen and queue), with its
count of greedy pairs between the least any correct screen keeps and every
pair; its
float64 scores against the host finalize's bits (`compute`, whose f64
finalize runs on the host); and top_k_matches against the benchmark's plain
reference (`perfbench/reference/topk.py`) with more candidates than three
shared-memory tiles hold, non-ASCII (int32) rows and rows past K23's width
cap, all exact, with the call's counters (K23's greedy pairs among them)
and spans. Marked `cuda`; skipped
where torch sees no CUDA device. On the card (which has no jax, which
tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_linkage_cuda.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import strsim_tpu_torch as st
from linkage_cases import SCREEN_CASES, least_greedy_pairs, screen_inputs
from strsim_tpu_torch.ops import _build, topk_cuda
from strsim_tpu_torch.utils import encode as enc
from strsim_tpu_torch.utils.metrics import RunMetrics

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
LETTERS = "abcdefghijklmnopqrstuvwxyz"
ACCENTED = LETTERS + "éèüöäçñ"


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _names(rng, n, alphabet=LETTERS, lo=0, hi=16):
    """Surname-like rows: random strings, a third of them edits of a few
    stems (near matches and equal scores), some empty."""
    stems = ["".join(rng.choice(list(alphabet), rng.integers(4, 12))) for _ in range(20)]
    out = []
    for i in range(n):
        if i % 3 == 0:
            s = list(stems[rng.integers(len(stems))])
            for _ in range(rng.integers(0, 3)):
                s[rng.integers(len(s))] = rng.choice(list(alphabet))
            out.append("".join(s)[:hi])
        else:
            out.append("".join(rng.choice(list(alphabet), rng.integers(lo, hi + 1))))
    return out


def _k23(q, c, k, winkler, tile, device, threads=0, greedy=None):
    """K23 over every query row of q against every row of c: ([Q, k] ids,
    [Q, k] scores, -1 / NaN where none); `greedy`, an int64 [1] tensor on
    the device, gets its count of greedy pairs added."""
    alphabet, c_idx = topk_cuda.candidate_indices(c.codes, c.lengths)
    rows = np.argsort(q.lengths, kind="stable").astype(np.int64)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    out_idx = torch.full((q.n, k), -1, dtype=torch.int64, device=device)
    out_s = torch.full((q.n, k), float("nan"), dtype=torch.float64, device=device)
    topk_cuda.topk_scan(dev(q.codes), dev(q.lengths), dev(rows), dev(c_idx), dev(c.lengths),
                        dev(np.arange(c.n, dtype=np.int32)), dev(alphabet), k, out_idx, out_s,
                        winkler, tile, threads, greedy)
    torch.cuda.synchronize()
    return out_idx.cpu(), out_s.cpu()


@pytest.mark.parametrize("tile", [0, 300], ids=["one_tile", "tiles"])
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("winkler", [True, False], ids=["jaro_winkler", "jaro"])
@pytest.mark.parametrize("alphabet", [LETTERS, ACCENTED], ids=["int8", "int32"])
def test_k23_matches_plain(cuda, alphabet, winkler, k, tile):
    rng = np.random.default_rng(len(alphabet) * 100 + k * 10 + tile + winkler)
    q = enc.encode_column(_names(rng, 3000, alphabet, hi=32), pad=enc.PAD_A)
    c = enc.encode_column(_names(rng, 1500, alphabet, hi=32), pad=enc.PAD_B)
    assert q.codes.dtype == (np.int8 if alphabet == LETTERS else np.int32)
    launches = _build.launch_counts().get("topk_scan", 0)
    got_i, got_s = _k23(q, c, k, winkler, tile, cuda)
    assert _build.launch_counts()["topk_scan"] == launches + 1
    T = torch.from_numpy
    want_i, want_s = topk_cuda.topk_plain(T(q.codes).to(cuda), T(q.lengths).to(cuda),
                                          T(c.codes).to(cuda), T(c.lengths).to(cuda),
                                          torch.arange(c.n, device=cuda), k, winkler)
    want_s = torch.where(torch.isinf(want_s), float("nan"), want_s).cpu()
    assert torch.equal(got_i, want_i.cpu())
    assert got_s.numpy().tobytes() == want_s.numpy().tobytes()


@pytest.mark.parametrize("case", list(SCREEN_CASES))
def test_k23_screen_inputs(cuda, case):
    k, winkler, tile, threads = SCREEN_CASES[case]
    qs, cs = screen_inputs(case)
    q, c = enc.encode_column(qs, pad=enc.PAD_A), enc.encode_column(cs, pad=enc.PAD_B)
    greedy = torch.zeros(1, dtype=torch.int64, device=cuda)
    got_i, got_s = _k23(q, c, k, winkler, tile, cuda, threads, greedy)
    T = torch.from_numpy
    want_i, want_s = topk_cuda.topk_plain(T(q.codes).to(cuda), T(q.lengths).to(cuda),
                                          T(c.codes).to(cuda), T(c.lengths).to(cuda),
                                          torch.arange(c.n, device=cuda), k, winkler)
    want_s = torch.where(torch.isinf(want_s), float("nan"), want_s).cpu()
    assert torch.equal(got_i, want_i.cpu())
    assert got_s.numpy().tobytes() == want_s.numpy().tobytes()
    assert least_greedy_pairs(qs, cs, k, winkler) <= int(greedy) <= q.n * c.n


def test_k23_scores_have_the_host_finalize_bits(cuda):
    """Every score K23 returns equals compute("jaro_winkler", q, c) for its
    pair, bit for bit: the pipeline's f64 finalize runs on the host."""
    rng = np.random.default_rng(23)
    qs, cs = _names(rng, 2000, hi=27), _names(rng, 1105, hi=27)
    q, c = enc.encode_column(qs, pad=enc.PAD_A), enc.encode_column(cs, pad=enc.PAD_B)
    ids, scores = _k23(q, c, 5, True, 0, cuda)
    ids, scores = ids.numpy().ravel(), scores.numpy().ravel()
    qi = np.repeat(np.arange(len(qs)), 5)
    want = st.compute("jaro_winkler", [qs[i] for i in qi], [cs[j] for j in ids])
    assert (ids >= 0).all() and scores.tobytes() == want.tobytes()


def test_top_k_matches_against_the_reference(cuda):
    """More candidates than three of K23's tiles hold, int32 rows, rows past
    its 32-char cap on both sides, null and empty rows: exact against the
    benchmark's plain reference at a sample of queries."""
    sys.path.insert(0, str(ROOT))
    from perfbench.reference import topk as reference

    rng = np.random.default_rng(4018)
    cs = _names(rng, 4200, ACCENTED, hi=30)
    cs += ["".join(rng.choice(list(ACCENTED), n)) for n in (33, 40, 64)] + [None, ""]
    qs = _names(rng, 3000, ACCENTED, hi=30) + [cs[5][:3] + "x" * 35, cs[4200], None, ""]
    narrow = enc.encode_column([x for x in cs if x and len(x) <= 32], pad=enc.PAD_B)
    alphabet = topk_cuda.candidate_indices(narrow.codes, narrow.lengths)[0]
    assert len(cs) > 3 * topk_cuda.max_tile(alphabet.size)
    launches = _build.launch_counts().get("topk_scan", 0)
    rm = RunMetrics()
    idx, scores = st.top_k_matches(qs, cs, "jaro_winkler", 5, metrics=rm)
    assert _build.launch_counts()["topk_scan"] == launches + 1
    q_lens = [len(x) for x in qs if x is not None]
    c_lens = [len(x) for x in cs if x is not None]
    narrow_q = sum(n <= topk_cuda.MAX_LEN for n in q_lens)
    narrow_c = sum(n <= topk_cuda.MAX_LEN for n in c_lens)
    lanes = -(-narrow_q // topk_cuda.THREADS) * topk_cuda.THREADS * narrow_c
    rest = len(q_lens) * len(c_lens) - narrow_q * narrow_c
    greedy = rm.counters.pop("topk.greedy_pairs")
    assert rm.counters == {"topk.pairs": len(q_lens) * len(c_lens), "topk.lane_pairs": lanes + rest,
                           "topk.launches": 1}
    assert 0 < greedy <= narrow_q * narrow_c
    assert [s.name for s in rm.spans if s.parent >= 0] == [
        "strsim.topk.encode", "strsim.topk.stage", "strsim.topk.launch", "strsim.topk.plain",
        "strsim.topk.collect", "strsim.topk.finish"]
    sample = np.r_[np.arange(0, len(qs), 23), len(qs) - 4, len(qs) - 3, len(qs) - 2, len(qs) - 1]
    want_i, want_s = reference.top_k("jaro_winkler", [qs[i] for i in sample], cs, 5)
    assert np.array_equal(idx[sample], want_i)
    assert scores[sample].tobytes() == want_s.tobytes()
