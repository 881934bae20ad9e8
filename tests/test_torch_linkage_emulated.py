"""K23 (`csrc/topk_scan.cu`) on the CPU against its plain form.

The source is compiled with g++ against `tests/cuda_emulation/cuda_runtime.h`
as `tests/test_torch_lane_kernels_cpu.py` compiles the lane-group kernels
(one thread per CUDA thread, `__syncthreads` a barrier of the block's
threads, the float64 intrinsics plain IEEE operations). Its C entry point
takes int8 and int32 tiles, jaro and jaro_winkler, k = 1..8, one tile of
candidates and several, blocks of several sizes, rows of 0, 1 and 32 chars,
chars no candidate holds, fewer candidates than k, the corpus's names and
the inputs of `linkage_cases.SCREEN_CASES` (its screen and queue: a
one-letter alphabet, ties across chunk, queue and tile boundaries,
alphabets above 32 chars); each query's ids and float64 scores must equal
`topk_cuda.topk_plain`'s, exactly, and slots with no candidate keep what
the caller put there. Its count of greedy pairs lies between the least
any correct screen keeps and every pair. Skipped without g++.
"""
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from linkage_cases import SCREEN_CASES, least_greedy_pairs, screen_inputs
from strsim_tpu_torch.ops import _build, topk_cuda
from strsim_tpu_torch.utils import encode as enc
from test_torch_lane_kernels_cpu import CSRC, SHIM, _for_the_cpu

ROOT = Path(__file__).resolve().parents[1]
LETTERS = "abcdefghijklmnopqrstuvwxyz"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("topk")
    for path in CSRC.glob("*.cu*"):
        (out / path.name).write_text(_for_the_cpu(path.read_text()))
    done = subprocess.run([gxx, "-std=c++17", "-O1", "-pthread", "-shared", "-fPIC", f"-I{SHIM}",
                           f"-I{out}", "-x", "c++", "-o", str(out / "topk_scan.so"),
                           str(out / "topk_scan.cu")], capture_output=True, text=True)
    assert done.returncode == 0, f"g++ topk_scan.cu:\n{done.stderr[-4000:]}"
    loaded = ctypes.CDLL(str(out / "topk_scan.so"))
    for fn, argtypes in _build.LIBRARIES["topk_scan"][1].items():
        getattr(loaded, fn).argtypes = argtypes
        getattr(loaded, fn).restype = ctypes.c_int
    return loaded


def _names(rng, n, alphabet=LETTERS, lo=0, hi=14):
    return ["".join(rng.choice(list(alphabet), rng.integers(lo, hi + 1))) for _ in range(n)]


def _run(lib, qs, cs, k, winkler=True, tile=0, threads=64, dtype=None, greedy=None):
    """K23's ids and scores for every query against every candidate, and the
    plain form's (-1 / NaN where none); `greedy`, an int64 [1] tensor, gets
    K23's count of greedy pairs added."""
    q, c = enc.encode_column(qs, pad=enc.PAD_A), enc.encode_column(cs, pad=enc.PAD_B)
    q_codes = q.codes.astype(dtype) if dtype else q.codes
    alphabet, c_idx = topk_cuda.candidate_indices(c.codes, c.lengths)
    rows = np.argsort(q.lengths, kind="stable").astype(np.int64)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = [T(q_codes), T(q.lengths), T(rows), T(c_idx), T(c.lengths),
            T(np.arange(c.n, dtype=np.int32)), T(alphabet)]
    ids = torch.full((q.n, k), -1, dtype=torch.int64)
    scores = torch.full((q.n, k), float("nan"), dtype=torch.float64)
    qc, ql, qr, ci, cl, cid, al = args
    rc = lib.strsim_topk_scan(qc.data_ptr(), qc.stride(0), ql.data_ptr(), qr.data_ptr(), q.n,
                              ci.data_ptr(), cl.data_ptr(), cid.data_ptr(), c.n, al.data_ptr(),
                              al.numel(), tile, k, int(winkler), threads, ids.data_ptr(),
                              scores.data_ptr(), None if greedy is None else greedy.data_ptr(),
                              qc.element_size(), None)
    assert rc == 0
    want_i, want_s = topk_cuda.topk_plain(qc, ql, T(c.codes), cl, torch.arange(c.n), k, winkler)
    return ids, scores, want_i, torch.where(torch.isinf(want_s), float("nan"), want_s)


def _same(ids, scores, want_i, want_s):
    assert torch.equal(ids, want_i)
    assert scores.numpy().tobytes() == want_s.numpy().tobytes()


@pytest.mark.parametrize("tile,threads", [(0, 64), (37, 96), (5, 32)])
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("winkler", [True, False], ids=["jaro_winkler", "jaro"])
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
def test_k23_matches_plain(lib, dtype, winkler, k, tile, threads):
    rng = np.random.default_rng(k * 100 + tile + winkler)
    qs = _names(rng, 150, "abcdef") + ["", "a", "z" * 32, "q" + "ab" * 15 + "c"]
    cs = _names(rng, 120, "abcdef") + ["", "a", "b", "ab" * 16]
    _same(*_run(lib, qs, cs, k, winkler, tile, threads, dtype))


def test_k23_non_ascii_and_absent_chars(lib):
    rng = np.random.default_rng(8)
    alphabet = "abcdé中\U0001d11e"
    qs = _names(rng, 90, alphabet + "xyz", 1, 20)  # x, y, z: in no candidate
    cs = _names(rng, 70, alphabet, 1, 20)
    _same(*_run(lib, qs, cs, 5))


def test_k23_fewer_candidates_than_k(lib):
    qs = _names(np.random.default_rng(2), 40)
    ids, scores, want_i, want_s = _run(lib, qs, ["ab", "", "b"], 8)
    _same(ids, scores, want_i, want_s)
    assert (ids[:, 3:] == -1).all() and torch.isnan(scores[:, 3:]).all()


def test_k23_on_the_corpus_names(lib):
    rows = json.loads((ROOT / "perfbench" / "data" / "genealogy_pairs.json").read_text())["rows"]
    names = list(dict.fromkeys(x for row in rows for x in row if x))
    rng = np.random.default_rng(18)
    qs = [names[i] for i in rng.integers(len(names), size=300)]
    _same(*_run(lib, qs, list(rng.permutation(names)), 5, threads=128))


@pytest.mark.parametrize("case", list(SCREEN_CASES))
def test_k23_screen_inputs(lib, case):
    k, winkler, tile, threads = SCREEN_CASES[case]
    qs, cs = screen_inputs(case)
    _same(*_run(lib, qs, cs, k, winkler, tile, threads))


@pytest.mark.parametrize("case", ["corpus", "one_letter", "ties_across_boundaries"])
def test_k23_counts_its_greedy_pairs(lib, case):
    """The counter lies between the pairs that any correct screen keeps (a
    best score by the real m at or above the query's final k-th) and every
    pair; on the corpus the screen keeps under a third of them."""
    k, winkler, tile, threads = SCREEN_CASES[case]
    qs, cs = screen_inputs(case)
    greedy = torch.zeros(1, dtype=torch.int64)
    _same(*_run(lib, qs, cs, k, winkler, tile, threads, greedy=greedy))
    counted, pairs = int(greedy), len(qs) * len(cs)
    assert least_greedy_pairs(qs, cs, k, winkler) <= counted <= pairs
    if case == "corpus":
        assert counted < pairs / 3
    greedy.zero_()
    _run(lib, qs, cs, k, winkler, tile, threads)  # no counter: nothing added
    assert int(greedy) == 0


def test_k23_tile_sizes(lib):
    """A tile holds the dictionary's 1,105 names at the default block (26
    chars), and fewer at larger alphabets; never more than a queue entry's
    11-bit candidate field."""
    assert lib.strsim_topk_max_tile(26, 0) >= 1105
    assert lib.strsim_topk_max_tile(26, 0) < lib.strsim_topk_max_tile(26, 64)
    assert lib.strsim_topk_max_tile(topk_cuda.MAX_ALPHABET, 0) < lib.strsim_topk_max_tile(26, 0)
    assert lib.strsim_topk_max_tile(topk_cuda.MAX_ALPHABET, 0) > 100
    assert lib.strsim_topk_max_tile(0, 32) == 2048


def test_k23_refuses_what_it_does_not_take(lib):
    z = torch.zeros(64, dtype=torch.int64)
    p = z.data_ptr()
    # q_codes, stride, q_len, q_rows, nq, c_idx, c_len, c_ids, nc, alphabet, na, tile, k,
    # winkler, threads, out_idx, out_score, greedy_pairs, elem_bytes, stream
    base = [p, 1, p, p, 1, p, p, p, 1, p, 1, 0, 5, 1, 0, p, p, None, 1, None]
    for at, value in ((12, 0), (12, topk_cuda.MAX_K + 1), (10, topk_cuda.MAX_ALPHABET + 1),
                      (14, 48), (14, 2048), (18, 2), (4, 0)):
        args = list(base)
        args[at] = value
        assert lib.strsim_topk_scan(*args) != 0, (at, value)
