"""The plain versions of K9 (greedy jaro flag scan) and K10 (wavefront
levenshtein) against strsim_tpu: the Pallas kernels they replace in
interpret mode at w7..w31, the XLA formulations at the wider widths. Same
numpy-seeded tiles through both, int8 and int32 (astral codepoints), rows
with an empty side and with la + lb == 1; exact comparisons."""
import numpy as np
import pytest
import torch

from strsim_tpu_torch.ops import jaro_cuda, jaro_flags_cuda, levenshtein_wavefront_cuda as lwf
from torch_tiles import as_jax, as_torch, assert_same, make_tiles

DTYPES = pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])


def edge_tiles(seed, n, width, dtype):
    """make_tiles with the first rows set to la + lb <= 2 and to one empty
    side: (0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (0, w), (w, 0)."""
    a, b, la, lb = make_tiles(seed, n, width, dtype)
    edges = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (0, width), (width, 0)]
    for r, (x, y) in enumerate(e for e in edges if max(e) <= width):
        la[r], lb[r] = x, y
    pos = np.arange(width)[None, :]
    for x, lens, pad in ((a, la, -1), (b, lb, -2)):
        x[(pos < lens[:, None]) & (x < 0)] = 97  # a grown row gets real chars
        x[pos >= lens[:, None]] = pad
    return a, b, la, lb


def capture_flags(monkeypatch):
    """Run jaro_match_stats_pallas with its transposition pass recorded: the
    kernel's matched_a and flagged_b flags, transposed back to [R, L]."""
    from strsim_tpu.ops import stats as jax_stats

    seen = {}
    original = jax_stats.transposition_count

    def record(aT, bT, matched_a, flagged_b):
        seen["matched"] = np.asarray(matched_a).T
        seen["flagged"] = np.asarray(flagged_b).T
        return original(aT, bT, matched_a, flagged_b)

    monkeypatch.setattr(jax_stats, "transposition_count", record)
    return seen


@DTYPES
@pytest.mark.parametrize("width", [7, 15, 31])
def test_wavefront_plain_matches_pallas_interpret(width, dtype):
    from strsim_tpu.ops.levenshtein_pallas import levenshtein_distance_pallas

    tiles = edge_tiles(width * 7 + 1, 300, width, dtype)
    want = levenshtein_distance_pallas(*as_jax(*tiles), interpret=True)
    got = lwf.wavefront_plain(*as_torch(*tiles))
    assert_same(got, want)
    assert got[:3].tolist() == [0, 0, 0] and got[4:6].tolist() == [2, 2]


@DTYPES
@pytest.mark.parametrize("width", [63, 127, 511])
def test_wavefront_plain_matches_xla(width, dtype):
    from strsim_tpu.ops.stats import levenshtein_distance

    tiles = edge_tiles(width * 7 + 2, 64, width, dtype)
    want = levenshtein_distance(*as_jax(*tiles))
    assert_same(lwf.levenshtein_distance(*as_torch(*tiles)), want)


@DTYPES
@pytest.mark.parametrize("width", [7, 15, 31])
def test_jaro_flags_plain_matches_pallas_interpret(monkeypatch, width, dtype):
    """The plain greedy scan gives the Pallas kernel's flags and count, and
    with the transposition pass and the len-1 patch its (m, t)."""
    from strsim_tpu.ops.jaro_pallas import jaro_match_stats_pallas

    seen = capture_flags(monkeypatch)
    tiles = edge_tiles(width * 5 + 3, 300, width, dtype)
    m, t = jaro_match_stats_pallas(*as_jax(*tiles), interpret=True)
    raw_m, matched, flagged = jaro_flags_cuda.jaro_flag_scan(*as_torch(*tiles))
    assert matched.dtype == flagged.dtype == torch.bool
    np.testing.assert_array_equal(matched.numpy(), seen["matched"])
    np.testing.assert_array_equal(flagged.numpy(), seen["flagged"])
    assert_same(raw_m, seen["matched"].sum(1))
    got_m, got_t = jaro_flags_cuda.jaro_match_stats(*as_torch(*tiles))
    assert_same(got_m, m)
    assert_same(got_t, t)


@DTYPES
@pytest.mark.parametrize("width", [63, 127, 511])
def test_jaro_flags_plain_matches_xla(width, dtype):
    from strsim_tpu.ops.stats import jaro_match_stats

    tiles = edge_tiles(width * 5 + 4, 64, width, dtype)
    m, t = jaro_match_stats(*as_jax(*tiles))
    got_m, got_t = jaro_flags_cuda.jaro_match_stats(*as_torch(*tiles))
    assert_same(got_m, m)
    assert_same(got_t, t)


def jaro_plain_before_the_split(a, b, len_a, len_b):
    """jaro_cuda.jaro_plain as it was written before its scan, transposition
    and patch became functions of their own."""
    n, width = a.shape
    la, lb = len_a.long(), len_b.long()
    bound = torch.maximum(la, lb) // 2 - 1
    jj = torch.arange(width)
    i_end = torch.clamp(torch.minimum(la, lb + bound), 0, width)
    hi_cap = torch.clamp(lb, max=width) - 1
    flagged = torch.zeros((n, width), dtype=torch.bool)
    matched = torch.zeros((n, width), dtype=torch.bool)
    for i in range(int(i_end.max()) if n else 0):
        hi = torch.minimum(i + bound, hi_cap)
        window = (jj[None, :] >= (i - bound)[:, None]) & (jj[None, :] <= hi[:, None])
        cand = (b == a[:, i : i + 1]) & ~flagged & window & (i < i_end)[:, None]
        found = cand.any(1)
        first = cand.to(torch.uint8).argmax(1)
        flagged |= (jj[None, :] == first[:, None]) & found[:, None]
        matched[:, i] = found
    m = matched.sum(1)
    order_a = torch.sort(torch.where(matched, jj, jj + width), dim=1).indices
    order_b = torch.sort(torch.where(flagged, jj, jj + width), dim=1).indices
    differ = a.gather(1, order_a) != b.gather(1, order_b)
    t = (differ & (jj[None, :] < m[:, None])).sum(1)
    one_one = (la == 1) & (lb == 1)
    m = torch.where(one_one, (a[:, 0] == b[:, 0]).long(), m)
    t = torch.where(one_one, 0, t)
    return m.to(torch.int32), t.to(torch.int32)


@DTYPES
@pytest.mark.parametrize("width", [1, 2, 7, 31, 95, 511])
def test_split_jaro_plain_unchanged(width, dtype):
    """jaro_plain, now greedy_scan + transposition_count + patch_one_one,
    returns what it returned before the split; the scan alone counts 0 on
    len-1/len-1 rows, as the Pallas kernel does."""
    tiles = as_torch(*edge_tiles(width * 5 + 5, 200 if width < 100 else 64, width, dtype))
    got = jaro_cuda.jaro_plain(*tiles)
    want = jaro_plain_before_the_split(*tiles)
    assert all(g.dtype == torch.int32 and torch.equal(g, w) for g, w in zip(got, want))
    scan_m, _, _ = jaro_cuda.greedy_scan(*tiles)
    one_one = (tiles[2] == 1) & (tiles[3] == 1)
    assert bool(one_one.any()) and (scan_m[one_one] == 0).all()


def test_cpu_wrappers_neither_build_nor_count():
    from strsim_tpu_torch.ops import _build

    _build.reset_launch_counts()
    tiles = as_torch(*edge_tiles(9, 40, 15, np.int8))
    lwf.levenshtein_distance(*tiles)
    jaro_flags_cuda.jaro_match_stats(*tiles)
    assert _build.launch_counts() == {}
    assert {"jaro_flags", "levenshtein_wavefront"} <= set(_build.LIBRARIES)
    with pytest.raises(ValueError, match="width"):
        lwf.levenshtein_distance(*as_torch(*edge_tiles(9, 16, 600, np.int8)))
