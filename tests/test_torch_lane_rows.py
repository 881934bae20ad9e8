"""The plain versions of the lane-group kernels' functions against
strsim_tpu's XLA formulations, on the rows that stress those kernels.

`chip_smoke.make_tiles` puts a pattern length at every word boundary and
one either side in the first rows, and mixes in rows far shorter than their
bucket, rows over the full 0..127 alphabet (int32 tiles: up to U+10FFFF),
all-equal rows of length 32k and jaro rows whose matches lie at the window's
edge (`chip_smoke.lane_rows`). The CUDA kernels meet the same rows on the
card (chip_smoke phase 3, tests/test_torch_cuda.py); here the plain
versions they are held to meet strsim_tpu, at w95 and w511 on int8 and int32
tiles, exactly:

  * myers_plain             vs levenshtein_myers.levenshtein_distance_myers
  * osa_plain               vs osa_myers.osa_distance_myers
  * dp_fused_plain, every subset the fused kernel takes, vs those and
    lcs.lcs_length
  * jaro_plain              vs jaro_bitmask.jaro_match_stats_bitmask

and K5's and K8's plain versions, at w31 and w63 on int8 and int32 tiles,
whose rows also repeat one char or one bigram more often in one side, put
bigrams across bit 31/32 and give sides of length 0, 1 and 2:

  * lev_jaro_plain, the four output sets chip_smoke times, vs the XLA forms
    above with stats.shared_prefix_length and stats.multiset_intersection,
    and vs lev_jaro_pallas.fused_stats_pallas in interpret mode at w31 (at
    w63 its unrolled W = 2 body does not compile in interpret mode within
    minutes here)
  * bigram_plain            vs multiset_loop.bigram_intersection_loop, the
    positional-match sum and stats.row_equal, and vs
    bigram_pallas.bigram_stats_pallas in interpret mode

The Pallas kernels run in interpret mode on 16 of the rows (`PALLAS_ROWS`),
the kinds named above among them: interpreting takes 10-45 s a call here.
On len-1/len-1 rows the references are those kernels' own stats (m = a_0 ==
b_0, t = 0), not the oracle's.
"""
from functools import lru_cache, partial

import numpy as np
import pytest

import jax.numpy as jnp

from strsim_tpu.ops import stats as jax_stats
from strsim_tpu.ops.bigram_pallas import bigram_stats_pallas
from strsim_tpu.ops.jaro_bitmask import jaro_match_stats_bitmask
from strsim_tpu.ops.lcs import lcs_length
from strsim_tpu.ops.lev_jaro_pallas import fused_stats_pallas
from strsim_tpu.ops.levenshtein_myers import levenshtein_distance_myers
from strsim_tpu.ops.multiset_loop import bigram_intersection_loop
from strsim_tpu.ops.osa_myers import osa_distance_myers
from strsim_tpu_torch.ops import (bigram_cuda, dp_fused_cuda, jaro_cuda, lev_jaro_cuda,
                                  levenshtein_cuda, osa_cuda)
from torch_tiles import as_jax, as_torch, assert_same, make_tiles

ROWS = 80
REFERENCES = {
    "lev_d": levenshtein_distance_myers,
    "osa_d": osa_distance_myers,
    "lcs_len": lcs_length,
    "jaro": jaro_match_stats_bitmask,
    "prefix": lambda a, b, la, lb: jax_stats.shared_prefix_length(a, b),
    "inter": jax_stats.multiset_intersection,
    "bigram": lambda a, b, la, lb: (bigram_intersection_loop(a, b, la, lb),
                                    jnp.sum((a == b).astype(jnp.int32), axis=1),
                                    jax_stats.row_equal(a, b, la, lb)),
}
# K5's (inter, osa and lcs) output sets, as chip_smoke.kernel_cases times them
FUSED_FLAGS = ((True, False, False), (False, False, False), (True, True, True), (False, True, True))
# the sides of length 0, 1 and 2 of the first rows (make_tiles), then rows
# % 12 in 1, 4, 7, 10 (chip_smoke.lane_rows: a repeated char, a repeated
# bigram, bigrams across bit 31/32, short sides) and the len-1/len-1 rows
PALLAS_ROWS = [0, 1, 2] + [r for r in range(12, ROWS) if r % 3 == 1 or r % 11 == 5][:13]


@lru_cache(maxsize=None)
def _tiles(width: int, dtype):
    return make_tiles(width * 23 + np.dtype(dtype).itemsize, ROWS, width, dtype)


@lru_cache(maxsize=None)
def _reference(field: str, width: int, dtype):
    out = REFERENCES[field](*as_jax(*_tiles(width, dtype)))
    return tuple(np.asarray(x) for x in out) if isinstance(out, tuple) else (np.asarray(out),)


def _dp_subset(lev, osa, lcs):
    return pytest.param(partial(dp_fused_cuda.dp_fused_plain, with_lev=lev, with_osa=osa, with_lcs=lcs),
                        dp_fused_cuda.fields(lev, osa, lcs),
                        id="dp_fused_" + "+".join(dp_fused_cuda.fields(lev, osa, lcs)))


@pytest.mark.parametrize("plain,fields", [
    pytest.param(levenshtein_cuda.myers_plain, ("lev_d",), id="myers"),
    pytest.param(osa_cuda.osa_plain, ("osa_d",), id="osa"),
    _dp_subset(True, True, False),
    _dp_subset(True, False, True),
    _dp_subset(False, True, True),
    _dp_subset(True, True, True),
    _dp_subset(False, False, True),
    pytest.param(jaro_cuda.jaro_plain, ("jaro",), id="jaro"),
])
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", [95, 511])
def test_plain_matches_strsim_tpu_on_lane_rows(width, dtype, plain, fields):
    got = plain(*as_torch(*_tiles(width, dtype)))
    got = got if isinstance(got, tuple) else (got,)
    want = tuple(x for f in fields for x in _reference(f, width, dtype))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same(g, w)


@pytest.mark.parametrize("width", [95, 511])
def test_tiles_hold_the_lane_rows(width):
    """The tiles this file reads hold each kind of row it is about."""
    a, b, la, lb = _tiles(width, np.int8)
    boundaries = {32 * k + d for k in range(1, width // 32 + 2) for d in (-1, 0, 1)}
    assert {x for x in boundaries if x <= width} <= set(la.tolist())
    head = width // 32 * 3 + 6
    body = range(head, ROWS - 1)
    assert any(0 < la[r] <= 8 and lb[r] > 0 for r in body)
    assert any(la[r] == lb[r] >= 64 and la[r] % 32 == 0 and (a[r, :la[r]] == a[r, 0]).all()
               and (b[r, :lb[r]] == a[r, 0]).all() for r in body)
    assert any(a[r, 0] == 0 and (a[r, 1:la[r]] > 100).any() for r in body)
    for r in (r for r in body if r % 12 == 9 and la[r] > 2):  # b is a rotated
        assert sorted(a[r, :la[r]].tolist()) == sorted(b[r, :lb[r]].tolist())


def _fused_ids(flags):
    return "+".join(f for f, on in zip(("inter", "osa", "lcs"), flags) if on) or "lev_jaro"


@pytest.mark.parametrize("flags", FUSED_FLAGS, ids=_fused_ids)
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", [31, 63])
def test_fused_plain_matches_strsim_tpu_on_lane_rows(width, dtype, flags):
    got = dict(zip(lev_jaro_cuda.fields(*flags),
                   lev_jaro_cuda.lev_jaro_plain(*as_torch(*_tiles(width, dtype)), *flags)))
    want = {"lev_d": _reference("lev_d", width, dtype)[0],
            "prefix": _reference("prefix", width, dtype)[0]}
    want["jaro_m"], want["jaro_t"] = _reference("jaro", width, dtype)
    for field in ("inter", "osa_d", "lcs_len"):
        want[field] = _reference(field, width, dtype)[0]
    assert len(got) == 4 + sum(flags)
    for field, value in got.items():
        assert_same(value, want[field])


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", [31, 63])
def test_bigram_plain_matches_strsim_tpu_on_lane_rows(width, dtype):
    got = bigram_cuda.bigram_plain(*as_torch(*_tiles(width, dtype)))
    for g, w in zip(got, _reference("bigram", width, dtype), strict=True):
        assert_same(g, w)


def _pallas_tiles(width: int, dtype):
    return tuple(x[PALLAS_ROWS] for x in _tiles(width, dtype))


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
def test_fused_plain_matches_pallas_interpret_on_lane_rows(dtype):
    """Every output set of lev_jaro_plain against one fused_stats_pallas
    call with all outputs on (pack 4 on int8 tiles, 1 on int32 tiles, which
    hold astral codepoints)."""
    tiles = _pallas_tiles(31, dtype)
    lev, m, t, inter, prefix, osa, lcs = fused_stats_pallas(
        *as_jax(*tiles), with_inter=True, with_prefix=True, with_osa=True, with_lcs=True,
        pack=None if dtype == np.int8 else 1, interpret=True)
    want = {"lev_d": lev, "jaro_m": m, "jaro_t": t, "prefix": prefix, "inter": inter,
            "osa_d": osa, "lcs_len": lcs}
    for flags in FUSED_FLAGS:
        got = lev_jaro_cuda.lev_jaro_plain(*as_torch(*tiles), *flags)
        for field, value in zip(lev_jaro_cuda.fields(*flags), got, strict=True):
            assert_same(value, want[field])


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", [31, 63])
def test_bigram_plain_matches_pallas_interpret_on_lane_rows(width, dtype):
    tiles = _pallas_tiles(width, dtype)
    want = bigram_stats_pallas(*as_jax(*tiles), interpret=True)
    for g, w in zip(bigram_cuda.bigram_plain(*as_torch(*tiles)), want, strict=True):
        assert_same(g, w)


def _count(row, item) -> int:
    k = len(item)
    return sum(tuple(row[i:i + k]) == item for i in range(len(row) - k + 1))


@pytest.mark.parametrize("width", [31, 63])
def test_tiles_hold_the_fused_and_bigram_rows(width):
    """The rows K5 and K8 are held on: one char and one bigram more often
    in a than in b and the other way round, a bigram of b that starts at
    position 31 (w63) or 29 (w31) and is found in a, sides of length 0, 1
    and 2 against longer ones, len-1/len-1 rows, one side empty; and the
    Pallas subset holds the repeats, the crossing bigram and the short
    sides too."""
    a, b, la, lb = _tiles(width, np.int8)

    def kinds(rows):
        found = set()
        for r in rows:
            ra, rb = a[r, :la[r]].tolist(), b[r, :lb[r]].tolist()
            for k, name in ((1, "char"), (2, "bigram")):
                grams = {tuple(ra[i:i + k]) for i in range(len(ra) - k + 1)}
                for g in grams:
                    na, nb = _count(ra, g), _count(rb, g)
                    if 0 < nb < na:
                        found.add(f"{name} more in a")
                    if 0 < na < nb:
                        found.add(f"{name} more in b")
            start = 31 if width > 32 else width - 2
            if lb[r] >= start + 2 and _count(ra, tuple(rb[start:start + 2])) > 0:
                found.add("crossing bigram")
            for n in (0, 1, 2):
                if min(la[r], lb[r]) == n and max(la[r], lb[r]) > 2:
                    found.add(f"side of {n}")
        return found

    want = {"char more in a", "char more in b", "bigram more in a", "bigram more in b",
            "crossing bigram", "side of 0", "side of 1", "side of 2"}
    assert not want - kinds(range(ROWS)), want - kinds(range(ROWS))
    assert not want - kinds(PALLAS_ROWS), want - kinds(PALLAS_ROWS)
    assert any(la[r] == lb[r] == 1 for r in PALLAS_ROWS)
    assert any((la[r] == 0) != (lb[r] == 0) for r in range(ROWS))
