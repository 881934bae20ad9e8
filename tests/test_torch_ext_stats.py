"""strsim_tpu_torch's plain versions of the extension stats against
strsim_tpu's XLA formulations.

Every ladder width 7..511, int8 and int32 tiles, the same numpy-seeded tiles
through both packages; all comparisons are exact (integer stats):

  * osa_plain       vs osa_myers.osa_distance_myers
  * lcs_plain       vs lcs.lcs_length
  * bigram_plain    vs multiset_loop.bigram_intersection_loop, and its
                    ham_m / eq vs the XLA positional-match sum and row_equal
  * soundex_equal   vs phonetic.soundex_equal (ASCII and Unicode tiles)

(test_torch_ext_pallas.py holds them against the Pallas kernels in interpret
mode.) On CPU tiles each kernel wrapper runs its plain version, so the
wrappers (K5 with its OSA/LCS outputs, K6, K7, K8) and, at w15 and w95, the
compute_stats router are held to the same references.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strsim_tpu.ops import phonetic as jax_phonetic
from strsim_tpu.ops import stats as jax_stats
from strsim_tpu.ops.lcs import lcs_length
from strsim_tpu.ops.levenshtein_myers import levenshtein_distance_myers
from strsim_tpu.ops.multiset_loop import bigram_intersection_loop
from strsim_tpu.ops.osa_myers import osa_distance_myers
from strsim_tpu_torch.ops import (
    _build,
    bigram_cuda,
    dp_fused_cuda,
    lcs,
    lev_jaro_cuda,
    osa_cuda,
    phonetic,
)
from strsim_tpu_torch.ops import stats as torch_stats
from torch_tiles import LADDER, as_jax, as_torch, assert_same, make_tiles

EXT = ("jaccard_bigram", "sorensen_dice_bigram", "cosine", "overlap", "hamming",
       "lcs_seq", "indel", "osa", "soundex")


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", LADDER)
def test_ext_plain_stats_match_xla(width, dtype):
    tiles = make_tiles(width * 19 + np.dtype(dtype).itemsize, 61 if width > 63 else 127, width, dtype)
    ta, tb, tla, tlb = as_torch(*tiles)
    ja, jb, jla, jlb = as_jax(*tiles)

    osa = osa_distance_myers(ja, jb, jla, jlb)
    assert_same(osa_cuda.osa_plain(ta, tb, tla, tlb), osa)
    assert_same(osa_cuda.osa_distance(ta, tb, tla, tlb), osa)
    lcs_len = lcs_length(ja, jb, jla, jlb)
    assert_same(lcs.lcs_plain(ta, tb, tla, tlb), lcs_len)

    inter2 = bigram_intersection_loop(ja, jb, jla, jlb)
    ham = jnp.sum((ja == jb).astype(jnp.int32), axis=1)
    eq = jax_stats.row_equal(ja, jb, jla, jlb)
    for got, want in zip(bigram_cuda.bigram_plain(ta, tb, tla, tlb), (inter2, ham, eq)):
        assert_same(got, want)
    if bigram_cuda.supports_width(width):
        for got, want in zip(bigram_cuda.bigram_stats(ta, tb, tla, tlb), (inter2, ham, eq)):
            assert_same(got, want)
    if width not in (15, 95):
        return
    # compute_stats over the nine extensions: K6 for osa + lcs, K8 (w15) or
    # the plain bigram form (w95), the plain soundex; and K6 with all three
    lev = levenshtein_distance_myers(ja, jb, jla, jlb)
    got = dp_fused_cuda.dp_fused_stats(ta, tb, tla, tlb, with_lev=True, with_osa=True, with_lcs=True)
    for value, want in zip(got, (lev, osa, lcs_len)):
        assert_same(value, want)
    routed = torch_stats.compute_stats(ta, tb, tla, tlb, EXT)
    assert sorted(routed) == ["eq", "ham_m", "inter", "inter2", "lcs_len", "osa_d", "sdx_eq"]
    for field, want in (("osa_d", osa), ("lcs_len", lcs_len), ("inter2", inter2),
                        ("ham_m", ham), ("eq", eq),
                        ("sdx_eq", jax_phonetic.soundex_equal(ja, jb, jla, jlb))):
        assert_same(routed[field], want)


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", [31, 64])
def test_fused_osa_lcs_outputs_match_xla(width, dtype):
    """K5's wrapper (its plain version on CPU tiles) with every output on
    gives the separate XLA stats, in `fields` order."""
    tiles = make_tiles(width * 23 + np.dtype(dtype).itemsize, 97, width, dtype)
    ja, jb, jla, jlb = as_jax(*tiles)
    want = {"lev_d": levenshtein_distance_myers(ja, jb, jla, jlb),
            "osa_d": osa_distance_myers(ja, jb, jla, jlb),
            "lcs_len": lcs_length(ja, jb, jla, jlb)}
    names = lev_jaro_cuda.fields(True, True, True)
    assert names[-2:] == ("osa_d", "lcs_len") and len(names) == 7
    got = dict(zip(names, lev_jaro_cuda.lev_jaro_stats(*as_torch(*tiles), with_inter=True,
                                                       with_osa=True, with_lcs=True)))
    for name, value in want.items():
        assert_same(got[name], value)


def _letter_tiles(seed: int, n: int, width: int, unicode: bool):
    """Rows of letters of both cases with H, W, vowels, digits, punctuation
    and (when `unicode`) non-ASCII letters, padded -1 / -2."""
    chars = "AbCdEfGhHWwIjKlMnOpQrStUvXyZ -.'9"
    if unicode:
        chars += "éÄßжЖ你😀"
    alphabet = np.array([ord(c) for c in chars], dtype=np.int32)
    rng = np.random.default_rng(seed)
    a = alphabet[rng.integers(0, alphabet.size, (n, width))]
    b = a.copy()
    b[rng.random((n, width)) < 0.2] = alphabet[0]
    la = rng.integers(0, width + 1, n).astype(np.int32)
    lb = rng.integers(0, width + 1, n).astype(np.int32)
    pos = np.arange(width)[None, :]
    a[pos >= la[:, None]] = -1
    b[pos >= lb[:, None]] = -2
    dtype = np.int32 if unicode else np.int8
    return a.astype(dtype), b.astype(dtype), la, lb


@pytest.mark.parametrize("unicode", [False, True], ids=["ascii", "unicode"])
@pytest.mark.parametrize("width", [7, 31, 127])
def test_soundex_matches_xla(width, unicode):
    tiles = _letter_tiles(width + unicode, 300, width, unicode)
    ta, tb, tla, tlb = as_torch(*tiles)
    ja, jb, jla, jlb = as_jax(*tiles)
    assert_same(phonetic.soundex_code(ta, tla), jax_phonetic.soundex_code(ja, jla))
    assert_same(phonetic.soundex_equal(ta, tb, tla, tlb),
                jax_phonetic.soundex_equal(ja, jb, jla, jlb))


def test_soundex_codes_spell_the_spec():
    words = ["Robert", "Rupert", "Lee", "Pfister", "Ashcraft", "Tymczak", "", "123", "h-e-l-l-o"]
    width = max(map(len, words))
    a = np.full((len(words), width), -1, dtype=np.int32)
    for i, w in enumerate(words):
        a[i, : len(w)] = [ord(c) for c in w]
    la = np.array([len(w) for w in words], dtype=np.int32)
    got = phonetic.soundex_code(*as_torch(a, la)).tolist()
    packed = [ord(c[0]) * 1000 + int(c[1:]) if c else 0
              for c in ("R163", "R163", "L000", "P236", "A261", "T522", "", "", "H400")]
    assert got == packed


def test_wrappers_reject_what_their_kernels_do_not_take():
    a = torch.full((4, 65), -1, dtype=torch.int8)
    b = torch.full((4, 65), -2, dtype=torch.int8)
    lens = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="width"):
        bigram_cuda.bigram_stats(a, b, lens, lens)
    with pytest.raises(ValueError, match="width"):
        lev_jaro_cuda.lev_jaro_stats(a, b, lens, lens, with_osa=True)
    wide = torch.full((4, 513), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="width"):
        osa_cuda.osa_distance(wide, wide, lens, lens)
    with pytest.raises(ValueError, match="width"):
        dp_fused_cuda.dp_fused_stats(wide, wide, lens, lens, with_lcs=True)
    with pytest.raises(ValueError, match="at least one"):
        dp_fused_cuda.dp_fused_stats(a, b, lens, lens)
    for alone in ("with_lev", "with_osa"):  # K1's and K7's, not K6's
        with pytest.raises(ValueError, match="alone"):
            dp_fused_cuda.dp_fused_stats(a[:, :31], b[:, :31], lens, lens, **{alone: True})
    with pytest.raises(TypeError):
        osa_cuda.osa_distance(a.to(torch.int16), b.to(torch.int16), lens, lens)


def test_cpu_extension_calls_neither_build_nor_count():
    _build.reset_launch_counts()
    a, b, la, lb = as_torch(*make_tiles(4, 20, 31, np.int8))
    osa_cuda.osa_distance(a, b, la, lb)
    bigram_cuda.bigram_stats(a, b, la, lb)
    dp_fused_cuda.dp_fused_stats(a, b, la, lb, with_lev=True, with_lcs=True)
    lev_jaro_cuda.lev_jaro_stats(a, b, la, lb, with_osa=True, with_lcs=True)
    assert _build.launch_counts() == {}
    assert _build._loaded == {}
