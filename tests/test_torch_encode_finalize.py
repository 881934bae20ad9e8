"""strsim_tpu_torch's host layers against strsim_tpu: string encoding (tiles,
lengths, validity, padding, equality), the exact f64 finalizers (byte for
byte on the same integer stats), the pure-Python oracle and the measure
registry. Inputs are numpy-seeded random Unicode columns with astral
codepoints, NUL (also trailing) and nulls."""
import numpy as np
import pytest

from strsim_tpu.models import measures as jax_measures
from strsim_tpu.ops import finalize as jax_finalize
from strsim_tpu.ops import oracle as jax_oracle
from strsim_tpu.utils import encode as jenc
from strsim_tpu_torch.models import measures as torch_measures
from strsim_tpu_torch.ops import finalize as torch_finalize
from strsim_tpu_torch.ops import oracle as torch_oracle
from strsim_tpu_torch.utils import encode as tenc

FIVE = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")
ALPHABET = list("ab\0 zé") + ["Ж", "你", "￿", "😀", "\U0010ffff"]


def unicode_column(seed: int, n: int, max_len: int = 40):
    rng = np.random.default_rng(seed)
    col = []
    for i in range(n):
        if i % 9 == 4:
            col.append(None)
            continue
        s = "".join(rng.choice(ALPHABET, int(rng.integers(0, max_len + 1))))
        col.append(s + "\0" if i % 7 == 2 else s)  # trailing NUL counts
    return col


def assert_same_column(ours, theirs):
    assert ours.codes.dtype == np.int32
    np.testing.assert_array_equal(ours.codes, theirs.codes.astype(np.int32))
    np.testing.assert_array_equal(ours.lengths, theirs.lengths)
    np.testing.assert_array_equal(ours.validity, theirs.validity)


def test_pads_match():
    assert (tenc.PAD_A, tenc.PAD_B) == (jenc.PAD_A, jenc.PAD_B) == (-1, -2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_column_matches(seed):
    col = unicode_column(seed, 90)
    for pad in (tenc.PAD_A, tenc.PAD_B):
        assert_same_column(tenc.encode_column(col, pad=pad), jenc.encode_column(col, pad=pad))
        assert_same_column(tenc.encode_column(col, pad=pad, width=64),
                           jenc.encode_column(col, pad=pad, width=64))
    assert_same_column(tenc.encode_column(np.array(col, dtype=object)), jenc.encode_column(col))


@pytest.mark.parametrize("seed", [3, 4])
def test_encode_pair_equal_rows_and_decode(seed):
    col_a = unicode_column(seed, 70, max_len=30)
    col_b = unicode_column(seed + 10, 70, max_len=50)
    col_b[::5] = col_a[::5]  # equal rows, nulls included
    ours = tenc.encode_pair(col_a, col_b)
    theirs = jenc.encode_pair(col_a, col_b)
    for o, t in zip(ours, theirs):
        assert_same_column(o, t)
    np.testing.assert_array_equal(tenc.equal_rows(*ours), jenc.equal_rows(*theirs))
    a, _ = ours
    for i, s in enumerate(col_a):
        assert tenc.decode_row(a.codes[i], int(a.lengths[i])) == (s or "")


def test_empty_column_and_repad():
    for width in (None, 5):
        assert_same_column(tenc.encode_column([], width=width), jenc.encode_column([], width=width))
    col = tenc.encode_column(["ab", None, "😀"], pad=tenc.PAD_B)
    wide = tenc._repad(col, tenc.PAD_B, 6)
    assert_same_column(wide, jenc._repad(jenc.encode_column(["ab", None, "😀"], pad=jenc.PAD_B), jenc.PAD_B, 6))
    assert (wide.codes[:, 2:] == tenc.PAD_B).all()
    with pytest.raises(ValueError, match="shrink"):
        tenc._repad(wide, tenc.PAD_B, 1)
    assert wide.n == 3 and wide.width == 6 and wide.validity.tolist() == [True, False, True]


@pytest.mark.parametrize("col,width,error", [
    (["abc", 3], None, TypeError),
    (["abcdef"], 3, ValueError),
])
def test_encode_errors_match(col, width, error):
    with pytest.raises(error):
        jenc.encode_column(col, width=width)
    with pytest.raises(error):
        tenc.encode_column(col, width=width)


def random_stats(seed: int, n: int = 4000):
    """Integer stats consistent with their lengths, with the edges the
    finalizers guard: empty sides, m = 0, t odd, prefix 0..4, inter 0."""
    rng = np.random.default_rng(seed)
    la = rng.integers(0, 70, n)
    lb = rng.integers(0, 70, n)
    la[:50], lb[:50] = 0, rng.integers(0, 3, 50)
    lo = np.minimum(la, lb)
    m = (rng.random(n) * (lo + 1)).astype(np.int64)
    m[50:200] = lo[50:200]  # all matched: jaro near 1, the winkler boost applies
    stats = {
        "lev_d": (rng.random(n) * (np.maximum(la, lb) + 1)).astype(np.int64),
        "jaro_m": m,
        "jaro_t": (rng.random(n) * (m + 1)).astype(np.int64),
        "prefix": np.minimum(rng.integers(0, 5, n), lo),
        "inter": (rng.random(n) * (lo + 1)).astype(np.int64),
    }
    return stats, la.astype(np.int64), lb.astype(np.int64)


@pytest.mark.parametrize("measure", FIVE)
def test_finalizers_byte_identical(measure):
    stats, la, lb = random_stats(sum(map(ord, measure)))
    ours = torch_finalize.finalize(measure, stats, la, lb)
    theirs = jax_finalize.finalize(measure, stats, la, lb)
    assert ours.dtype == np.float64
    assert ours.tobytes() == theirs.tobytes()
    assert ours.tobytes() == torch_finalize.FINALIZERS[measure](stats, la, lb).tobytes()


@pytest.mark.parametrize("seed", [5, 6])
def test_oracle_matches(seed):
    col_a = [s or "" for s in unicode_column(seed, 80, max_len=25)]
    col_b = [s or "" for s in unicode_column(seed + 1, 80, max_len=25)]
    col_b[::4] = [a[::-1] for a in col_a[::4]]  # reversals: dense transpositions
    col_b[1::6] = col_a[1::6]
    for a, b in zip(col_a, col_b):
        assert torch_oracle.levenshtein_distance(a, b) == jax_oracle.levenshtein_distance(a, b)
        assert torch_oracle.jaro_stats(a, b) == jax_oracle.jaro_stats(a, b)
        assert torch_oracle.multiset_intersection(a, b) == jax_oracle.multiset_intersection(a, b)
        assert torch_oracle.shared_prefix_length(a, b) == jax_oracle.shared_prefix_length(a, b)
        for m in FIVE:
            ours = torch_oracle.ORACLES[m](a, b)
            assert np.float64(ours).tobytes() == np.float64(jax_oracle.ORACLES[m](a, b)).tobytes(), (m, a, b)


def test_measure_registry_matches():
    assert tuple(torch_measures.MEASURES) == tuple(jax_measures.MEASURES)
    for m in jax_measures.MEASURES:
        ours, theirs = torch_measures.MEASURES[m], jax_measures.MEASURES[m]
        assert ours.stat_fields == theirs.stat_fields
    assert torch_measures.resolve_measures("jaro") == ("jaro",)
    assert torch_measures.resolve_measures(["jaccard", "osa"]) == ("jaccard", "osa")
    with pytest.raises(KeyError, match="available"):
        torch_measures.resolve_measures(["jaro", "nysiis"])
