"""strsim_tpu_torch's plain stat versions against strsim_tpu's Pallas kernels
in interpret mode, at the widths the JAX package's own tests interpret (its
unrolled W=2 bodies and the jaro body at widths 23-63 are too slow to
interpret here; test_torch_stats.py holds every width against the XLA
formulations). Same numpy-seeded tiles through both; exact comparisons."""
import numpy as np
import pytest

from strsim_tpu_torch.ops import jaro_cuda, lev_jaro_cuda, levenshtein_cuda, multiset_cuda
from torch_tiles import as_jax, as_torch, assert_same, make_tiles


@pytest.mark.parametrize("width", [7, 15, 23, 31, 95, 255])
def test_plain_levenshtein_matches_pallas_interpret(width):
    from strsim_tpu.ops.levenshtein_pallas_scan import levenshtein_distance_myers_pallas

    tiles = make_tiles(width * 3 + 1, 203 if width <= 31 else 67, width, np.int32)
    want = levenshtein_distance_myers_pallas(*as_jax(*tiles), interpret=True)
    assert_same(levenshtein_cuda.myers_plain(*as_torch(*tiles)), want)


@pytest.mark.parametrize("width", [7, 15, 95, 255])
def test_plain_jaro_matches_pallas_interpret(width):
    from strsim_tpu.ops.jaro_pallas_scan import jaro_match_stats_pallas_scan

    tiles = make_tiles(width * 5 + 2, 203 if width <= 15 else 67, width, np.int8)
    m, t = jaro_match_stats_pallas_scan(*as_jax(*tiles), interpret=True)
    pm, pt = jaro_cuda.jaro_plain(*as_torch(*tiles))
    assert_same(pm, m)
    assert_same(pt, t)


@pytest.mark.parametrize("width", [7, 15])
def test_plain_rank_matches_pallas_interpret(width):
    from strsim_tpu.ops.multiset_pallas import multiset_intersection_pallas

    tiles = make_tiles(width * 11 + 3, 203, width, np.int32)
    want = multiset_intersection_pallas(*as_jax(*tiles), interpret=True)
    assert_same(multiset_cuda.rank_plain(*as_torch(*tiles)), want)


@pytest.mark.parametrize("width", [95, 255, 511])
def test_plain_hist_matches_pallas_interpret(width):
    from strsim_tpu.ops.multiset_pallas import multiset_intersection_hist

    tiles = make_tiles(width * 13 + 4, 67, width, np.int8)
    want = multiset_intersection_hist(*as_jax(*tiles), interpret=True)
    assert_same(multiset_cuda.hist_plain(*as_torch(*tiles)), want)


@pytest.mark.parametrize("width", [7, 15])
def test_fused_plain_matches_pallas_interpret(width):
    """The fused kernel's plain version against fused_stats_pallas (int8
    tiles, pack = 4, every optional stat of this slice on)."""
    from strsim_tpu.ops.lev_jaro_pallas import fused_stats_pallas

    tiles = make_tiles(width * 17 + 5, 203, width, np.int8)
    lev, m, t, inter, prefix = fused_stats_pallas(
        *as_jax(*tiles), with_inter=True, with_prefix=True, interpret=True)
    got = dict(zip(lev_jaro_cuda.fields(True),
                   lev_jaro_cuda.lev_jaro_plain(*as_torch(*tiles), with_inter=True)))
    for name, want in (("lev_d", lev), ("jaro_m", m), ("jaro_t", t),
                       ("inter", inter), ("prefix", prefix)):
        assert_same(got[name], want)
