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
"""
from functools import lru_cache, partial

import numpy as np
import pytest

from strsim_tpu.ops.jaro_bitmask import jaro_match_stats_bitmask
from strsim_tpu.ops.lcs import lcs_length
from strsim_tpu.ops.levenshtein_myers import levenshtein_distance_myers
from strsim_tpu.ops.osa_myers import osa_distance_myers
from strsim_tpu_torch.ops import dp_fused_cuda, jaro_cuda, levenshtein_cuda, osa_cuda
from torch_tiles import as_jax, as_torch, assert_same, make_tiles

ROWS = 80
REFERENCES = {
    "lev_d": levenshtein_distance_myers,
    "osa_d": osa_distance_myers,
    "lcs_len": lcs_length,
    "jaro": jaro_match_stats_bitmask,
}


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
