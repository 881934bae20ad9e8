"""strsim_tpu_torch's plain extension stats against strsim_tpu's Pallas
kernels in interpret mode, at the widths the JAX package's own tests
interpret (its unrolled W = 2 bodies are too slow to interpret here;
test_torch_ext_stats.py holds every width against the XLA formulations).
Same numpy-seeded tiles through both; exact comparisons."""
import numpy as np
import pytest

from strsim_tpu_torch.ops import bigram_cuda, dp_fused_cuda, lev_jaro_cuda, osa_cuda
from torch_tiles import as_jax, as_torch, assert_same, make_tiles


def _rows(width: int) -> int:
    return 61 if width <= 15 else 29


@pytest.mark.parametrize("width", [7, 15, 95])
def test_plain_osa_matches_pallas_interpret(width):
    from strsim_tpu.ops.osa_pallas_scan import osa_distance_pallas

    tiles = make_tiles(width * 29 + 6, _rows(width), width, np.int32)
    want = osa_distance_pallas(*as_jax(*tiles), interpret=True)
    assert_same(osa_cuda.osa_plain(*as_torch(*tiles)), want)


@pytest.mark.parametrize("flags", [(True, True, False), (False, True, True),
                                   (False, False, True), (True, True, True)],
                         ids=["lev+osa", "osa+lcs", "lcs", "lev+osa+lcs"])
@pytest.mark.parametrize("width", [7, 15, 95])
def test_plain_dp_fused_matches_pallas_interpret(width, flags):
    from strsim_tpu.ops.dp_fused_pallas import dp_fused_stats_pallas

    with_lev, with_osa, with_lcs = flags
    tiles = make_tiles(width * 31 + 7, _rows(width), width, np.int8)
    want = dp_fused_stats_pallas(*as_jax(*tiles), with_lev=with_lev, with_osa=with_osa,
                                 with_lcs=with_lcs, interpret=True)
    got = dp_fused_cuda.dp_fused_plain(*as_torch(*tiles), with_lev, with_osa, with_lcs)
    assert len(got) == len(want) == sum(flags)
    for g, w in zip(got, want):
        assert_same(g, w)


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", [7, 15])
def test_plain_bigram_matches_pallas_interpret(width, dtype):
    from strsim_tpu.ops.bigram_pallas import bigram_stats_pallas

    tiles = make_tiles(width * 37 + np.dtype(dtype).itemsize, 97, width, dtype)
    want = bigram_stats_pallas(*as_jax(*tiles), interpret=True)
    for g, w in zip(bigram_cuda.bigram_plain(*as_torch(*tiles)), want):
        assert_same(g, w)


@pytest.mark.parametrize("width", [7, 15])
def test_fused_osa_lcs_plain_matches_pallas_interpret(width):
    """K5's plain version with every output on against fused_stats_pallas
    (int8 tiles, pack = 4)."""
    from strsim_tpu.ops.lev_jaro_pallas import fused_stats_pallas

    tiles = make_tiles(width * 41 + 8, 97, width, np.int8)
    lev, m, t, inter, prefix, osa, lcs = fused_stats_pallas(
        *as_jax(*tiles), with_inter=True, with_prefix=True, with_osa=True, with_lcs=True,
        interpret=True)
    got = dict(zip(lev_jaro_cuda.fields(True, True, True),
                   lev_jaro_cuda.lev_jaro_plain(*as_torch(*tiles), with_inter=True,
                                                with_osa=True, with_lcs=True)))
    for name, want in (("lev_d", lev), ("jaro_m", m), ("jaro_t", t), ("inter", inter),
                       ("prefix", prefix), ("osa_d", osa), ("lcs_len", lcs)):
        assert_same(got[name], want)
