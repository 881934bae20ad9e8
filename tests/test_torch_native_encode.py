"""The port's native encode and the pipeline's native paths against
strsim_tpu: `encode_pair` on every input kind equals strsim_tpu's (codes,
lengths, validity, dtype); the UTF-8 route and the numpy route agree with it;
compute_scores with the native encode, pack and finalize is byte-identical to
strsim_tpu.compute_many, as with the numpy finalizers; host rows (the small
input short circuit, rows beyond the ladder) are scored by the native
library or the oracle, byte-identical to the oracle and counted. Each test
pins device="cpu" and host_short_circuit_rows."""
import numpy as np
import pytest
import torch

import strsim_tpu as jst
from strsim_tpu.utils import encode as jenc
from strsim_tpu_torch.config import StrsimConfig
from strsim_tpu_torch.models import pipeline as tpipe
from strsim_tpu_torch.ops.oracle import ORACLES
from strsim_tpu_torch.utils import encode as tenc
from strsim_tpu_torch.utils.metrics import RunMetrics

torch.set_num_threads(1)  # keep torch's pool off the other test workers' cores

FIVE = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")
ALL = FIVE + ("jaccard_bigram", "sorensen_dice_bigram", "cosine", "overlap", "hamming",
              "lcs_seq", "indel", "osa", "soundex")


def cpu(**kw) -> StrsimConfig:
    return StrsimConfig(device="cpu", **{"host_short_circuit_rows": 0, **kw})


def columns(seed: int, n: int, ascii_only: bool, wide: bool = False):
    """str|None columns: names with near-duplicates, equal and empty rows,
    NUL, and (unless ascii_only) BMP and astral chars; a tail of rows up to
    600 chars when `wide` (beyond the 511 ladder, and in several blocks of
    the wide buckets)."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefgh \0") + ([] if ascii_only else ["é", "Ж", "你", "😀"])
    col_a, col_b = [], []
    for i in range(n):
        la = int(rng.integers(0, 12)) if not wide or i % 3 else int(rng.integers(40, 601))
        a = "".join(rng.choice(alphabet, la))
        r = i % 6
        b = a if r == 0 else "" if r == 1 else (a[:-1] + "z" if r == 2 else
                                              "".join(rng.choice(alphabet, int(rng.integers(0, la + 3)))))
        col_a.append(None if i % 29 == 4 else a)
        col_b.append(None if i % 31 == 9 else b)
    return col_a, col_b


def assert_same(ours, theirs):
    for o, t in zip(ours, theirs):
        assert o.codes.dtype == t.codes.dtype
        assert np.array_equal(o.codes, t.codes)
        assert np.array_equal(o.lengths, t.lengths)
        assert np.array_equal(o.validity, t.validity)


KINDS = {
    "list": lambda c: list(c),
    "object_array": lambda c: np.array(c, dtype=object),
    "tuple": lambda c: tuple(c),
    "numpy_U": lambda c: np.array(["" if x is None else x for x in c]),
}


@pytest.mark.parametrize("ascii_only", [True, False], ids=["ascii", "unicode"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_encode_pair_matches_jax(kind, ascii_only):
    col_a, col_b = columns(1, 300, ascii_only)
    if kind == "numpy_U":  # a U array holds no NUL at a row's end nor None
        col_a = [None if x is None else x.rstrip("\0") for x in col_a]
        col_b = [None if x is None else x.rstrip("\0") for x in col_b]
    a, b = KINDS[kind](col_a), KINDS[kind](col_b)
    ours = tenc.encode_pair_with_route(a, b)
    assert ours[2] == "native_objects"
    assert ours[0].codes.dtype == (np.int8 if ascii_only else np.int32)
    assert_same(ours[:2], jenc.encode_pair(a, b))
    assert_same(tenc.encode_pair(a, b, width=40), jenc.encode_pair(a, b, width=40))
    for pad in (tenc.PAD_A, tenc.PAD_B):
        assert_same([tenc.encode_column(a, pad=pad)], [jenc.encode_column(a, pad=pad)])


def test_the_routes_agree():
    """The UTF-8 route and the numpy route give the native route's tiles
    (as int32), lengths and validity."""
    col_a, col_b = columns(2, 200, ascii_only=False)
    a, b = tenc.encode_pair(col_a, col_b)
    na, nb = tenc.encode_pair_numpy(col_a, col_b)
    for pad, ours, numpy_route, col in ((tenc.PAD_A, a, na, col_a), (tenc.PAD_B, b, nb, col_b)):
        utf8 = tenc._encode_utf8(tenc._column_objects(col), pad, ours.width)
        assert_same([utf8], [numpy_route])
        assert_same([ours], [numpy_route])
    ea, eb, route = tenc.encode_pair_with_route([], [])
    assert route == "numpy" and ea.n == eb.n == 0


@pytest.mark.parametrize("bad_row", [0, 5, 299])
def test_a_row_that_is_not_a_string_names_its_index(bad_row):
    col = ["abc"] * 300
    col[bad_row] = 42
    want = f"expected str or None at row {bad_row}, got int"
    with pytest.raises(TypeError, match=want):
        tenc.encode_pair(col, ["x"] * 300)
    with pytest.raises(TypeError, match=want):
        tenc.encode_pair(["x"] * 300, np.array(col, dtype=object))
    with pytest.raises(TypeError, match=want):
        tenc._encode_utf8(tenc._column_objects(col), tenc.PAD_A, None)
    with pytest.raises(TypeError, match=want):
        jenc.encode_pair(col, ["x"] * 300)


@pytest.mark.parametrize("measures", [FIVE, ALL], ids=["five", "all14"])
@pytest.mark.parametrize("native_finalize", [True, False], ids=["native_finalize", "numpy_finalize"])
@pytest.mark.parametrize("ascii_only", [True, False], ids=["ascii", "unicode"])
def test_compute_scores_matches_jax(measures, native_finalize, ascii_only):
    """The native encode, pack and (or numpy) finalize through the plain
    torch stats, byte-identical to strsim_tpu.compute_many; blocks of 16
    rows, so that every bucket spans several blocks with la != lb rows past
    the first."""
    col_a, col_b = columns(3, 160, ascii_only)
    cfg = cpu(native_finalize=native_finalize, max_batch_block=16, min_batch=8)
    rm = RunMetrics()
    ours = tpipe.compute_scores(col_a, col_b, measures, config=cfg, metrics=rm)
    theirs = jst.compute_many(measures, col_a, col_b)
    assert rm.encode_route == "native_objects" and rm.oracle_rows == 0
    assert any(bm.rows > 16 for bm in rm.buckets.values())
    for m in measures:
        assert ours[m][0].tobytes() == theirs[m].tobytes(), m


@pytest.mark.parametrize("fallback", ["native", "oracle"])
def test_host_rows_match_the_oracle(fallback):
    """The small-input short circuit and rows beyond the ladder
    (overflow_policy="oracle") go to the host scorer: byte-identical to the
    oracle, counted as host rows, none on the device."""
    col_a, col_b = columns(4, 60, ascii_only=False, wide=True)
    want = {m: np.array([np.nan if a is None or b is None else ORACLES[m](a, b)
                         for a, b in zip(col_a, col_b)]) for m in ALL}
    work = [a is not None and b is not None and a != b and min(len(a), len(b)) > 0
            for a, b in zip(col_a, col_b)]
    short = cpu(host_short_circuit_rows=8192, fallback=fallback)
    rm = RunMetrics()
    got = tpipe.compute_scores(col_a, col_b, ALL, config=short, metrics=rm)
    assert rm.device_rows == 0 and rm.oracle_rows == sum(work) > 20 and not rm.buckets
    for m in ALL:
        assert got[m][0].tobytes() == want[m].tobytes(), (fallback, m)

    beyond = cpu(overflow_policy="oracle", fallback=fallback)
    rm = RunMetrics()
    got = tpipe.compute_scores(col_a, col_b, ("levenshtein", "jaro_winkler", "osa"),
                               config=beyond, metrics=rm)
    n_long = sum(w and max(len(a), len(b)) > 511 for w, a, b in zip(work, col_a, col_b))
    assert n_long > 0 and rm.oracle_rows == n_long and rm.device_rows > 0
    for m in ("levenshtein", "jaro_winkler", "osa"):
        assert got[m][0].tobytes() == want[m].tobytes(), (fallback, m)


def test_config_rejects_an_unknown_host_scorer():
    with pytest.raises(ValueError, match="fallback"):
        StrsimConfig(device="cpu", fallback="python")
