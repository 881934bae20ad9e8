"""The jaro_winkler prefix in the port against strsim_tpu: the plain form
(`ops/stats.py:shared_prefix_length`, the running AND of the first min(L,
4) compares, summed) and K2's wrapper with `with_prefix=True`, whose CPU
form adds it to `jaro_plain`; and the router's prefix route, which follows
K2 wherever K2 serves jaro_m (K9's and the plain jaro routes keep the plain
prefix). Exact integer comparisons on numpy-seeded tiles.
"""
import numpy as np
import pytest
import torch

from strsim_tpu.ops import stats as jax_stats
from strsim_tpu.ops.jaro_bitmask import jaro_match_stats_bitmask
from strsim_tpu_torch.ops import jaro_cuda
from strsim_tpu_torch.ops import stats as torch_stats
from torch_tiles import as_jax, as_torch, assert_same, make_tiles

DTYPES = pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])


def _short_tiles(seed: int, n: int, width: int, dtype):
    """[n, width] tiles over a three-char alphabet (int8: with codes below
    0; int32: with astral codepoints), so that prefixes of every length
    0..min(width, 4) occur, padded with -1 / -2 past lengths 0..width."""
    rng = np.random.default_rng(seed)
    alphabet = np.array([97, -7, 0] if dtype == np.int8 else [97, 0x1F600, 0])
    a = alphabet[rng.integers(0, 3, (n, width))]
    b = np.where(rng.random((n, width)) < 0.8, a, alphabet[rng.integers(0, 3, (n, width))])
    la, lb = rng.integers(0, width + 1, (2, n))
    pos = np.arange(width)[None, :]
    a[pos >= la[:, None]] = -1
    b[pos >= lb[:, None]] = -2
    return a.astype(dtype), b.astype(dtype), la.astype(np.int32), lb.astype(np.int32)


@DTYPES
@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 6])
def test_plain_prefix_matches_jax(width, dtype):
    tiles = _short_tiles(width * 11 + np.dtype(dtype).itemsize, 400, width, dtype)
    ta, tb, _, _ = as_torch(*tiles)
    ja, jb, _, _ = as_jax(*tiles)
    got = torch_stats.shared_prefix_length(ta, tb)
    assert_same(got, jax_stats.shared_prefix_length(ja, jb))
    assert set(got.tolist()) == set(range(min(width, 4) + 1))  # every length occurred


@DTYPES
@pytest.mark.parametrize("width", [15, 63, 95])
def test_jaro_with_prefix_matches_jax(width, dtype):
    """K2's wrapper on CPU tiles with the prefix: (m, t) as the JAX bitmask
    form, the prefix as the JAX plain prefix; without it, (m, t) alone."""
    tiles = make_tiles(width * 13 + np.dtype(dtype).itemsize, 131, width, dtype)
    ta, tb, tla, tlb = as_torch(*tiles)
    ja, jb, jla, jlb = as_jax(*tiles)
    m, t = jaro_match_stats_bitmask(ja, jb, jla, jlb)
    prefix = jax_stats.shared_prefix_length(ja, jb)
    got = jaro_cuda.jaro_match_stats(ta, tb, tla, tlb, with_prefix=True)
    assert len(got) == 3
    for g, w in zip(got, (m, t, prefix)):
        assert_same(g, w)
    assert len(jaro_cuda.jaro_match_stats(ta, tb, tla, tlb)) == 2


@pytest.mark.parametrize("impls,width,dtype,prefix", [
    ({}, 15, torch.int8, "jaro_scan"),
    ({}, 95, torch.int32, "jaro_scan"),
    ({}, 511, torch.int8, "jaro_scan"),
    ({"jaro": "bitmask"}, 31, torch.int32, "jaro_scan"),
    ({"jaro": "pallas"}, 31, torch.int8, "plain"),
    ({}, 1023, torch.int8, "plain"),
])
def test_jaro_alone_takes_the_prefix_where_k2_runs(impls, width, dtype, prefix):
    for measures in (("jaro",), ("jaro_winkler",), ("jaro", "jaccard")):
        routes = torch_stats.stat_routes(measures, width, dtype, impls)
        assert routes["prefix"] == prefix, measures
        assert (routes["jaro_m"] == "jaro_scan") == (prefix == "jaro_scan"), measures


@DTYPES
@pytest.mark.parametrize("width", [15, 95])
def test_compute_stats_takes_the_prefix_from_k2(monkeypatch, width, dtype):
    """compute_stats asks K2 for the prefix in the same call and runs no
    plain prefix; its stats equal the JAX ones."""
    tiles = make_tiles(width + 5, 67, width, dtype)
    ta, tb, tla, tlb = as_torch(*tiles)
    ja, jb, jla, jlb = as_jax(*tiles)
    calls = []
    real = jaro_cuda.jaro_match_stats

    def recorder(*args, **kw):
        calls.append(kw.get("with_prefix", False))
        return real(*args, **kw)

    monkeypatch.setattr(jaro_cuda, "jaro_match_stats", recorder)
    monkeypatch.setitem(torch_stats._PLAIN, "prefix",
                        (("prefix",), lambda *a: pytest.fail("the plain prefix ran beside K2")))
    out = torch_stats.compute_stats(ta, tb, tla, tlb, ("jaro_winkler",))
    assert calls == [True]
    m, t = jaro_match_stats_bitmask(ja, jb, jla, jlb)
    assert_same(out["jaro_m"], m)
    assert_same(out["jaro_t"], t)
    monkeypatch.undo()
    assert_same(out["prefix"], jax_stats.shared_prefix_length(ja, jb))
