"""strsim_tpu_torch's CUDA kernels on the card: each against its plain torch
version on the same device tensors (exact), and the pipeline on the card
against the oracle. Marked `cuda`; skipped where torch sees no CUDA device.
Imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import strsim_tpu_torch as tst
from strsim_tpu_torch.ops import (_build, bigram_cuda, dp_fused_cuda, jaro_cuda, jaro_flags_cuda,
                                  lev_jaro_cuda, levenshtein_cuda, levenshtein_wavefront_cuda,
                                  multiset_cuda, osa_cuda)
from strsim_tpu_torch.ops.oracle import ORACLES

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import make_tiles  # noqa: E402

pytestmark = pytest.mark.cuda

FIVE = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")
EXT = ("jaccard_bigram", "sorensen_dice_bigram", "cosine", "overlap", "hamming",
       "lcs_seq", "indel", "osa", "soundex")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def packed_tiles(seed: int, n: int, width: int, dtype, device):
    """Column slices of chip_smoke.make_tiles's packed [n, 2 * width] tile,
    as the pipeline passes them, and [n] lengths."""
    packed, lens = make_tiles(np.random.default_rng(seed), n, width, dtype)
    codes = torch.from_numpy(packed).to(device)
    lengths = torch.from_numpy(lens).to(device)
    return codes[:, :width], codes[:, width:], lengths[0], lengths[1]


CASES = [
    pytest.param(levenshtein_cuda.levenshtein_distance, levenshtein_cuda.myers_plain,
                 (7, 31, 63, 95, 511), (np.int8, np.int32), id="levenshtein_myers"),
    pytest.param(jaro_cuda.jaro_match_stats, jaro_cuda.jaro_plain,
                 (7, 31, 63, 95, 511), (np.int8, np.int32), id="jaro_scan"),
    pytest.param(multiset_cuda.multiset_intersection_rank, multiset_cuda.rank_plain,
                 (7, 31, 63), (np.int8, np.int32), id="multiset_rank"),
    pytest.param(multiset_cuda.multiset_intersection_hist, multiset_cuda.hist_plain,
                 (7, 31, 63, 95, 255, 511), (np.int8,), id="multiset_hist"),
    pytest.param(partial(lev_jaro_cuda.lev_jaro_stats, with_inter=True),
                 partial(lev_jaro_cuda.lev_jaro_plain, with_inter=True),
                 (7, 31, 47, 63, 64), (np.int8, np.int32), id="lev_jaro_fused_inter"),
    pytest.param(partial(lev_jaro_cuda.lev_jaro_stats, with_inter=False),
                 partial(lev_jaro_cuda.lev_jaro_plain, with_inter=False),
                 (7, 31, 47, 63, 64), (np.int8, np.int32), id="lev_jaro_fused"),
    pytest.param(partial(lev_jaro_cuda.lev_jaro_stats, with_inter=True, with_osa=True, with_lcs=True),
                 partial(lev_jaro_cuda.lev_jaro_plain, with_inter=True, with_osa=True, with_lcs=True),
                 (7, 31, 33, 63, 64), (np.int8, np.int32), id="lev_jaro_fused_osa_lcs"),
    pytest.param(partial(lev_jaro_cuda.lev_jaro_stats, with_osa=True),
                 partial(lev_jaro_cuda.lev_jaro_plain, with_osa=True),
                 (15, 63), (np.int8, np.int32), id="lev_jaro_fused_osa"),
    pytest.param(partial(lev_jaro_cuda.lev_jaro_stats, with_lcs=True),
                 partial(lev_jaro_cuda.lev_jaro_plain, with_lcs=True),
                 (15, 63), (np.int8, np.int32), id="lev_jaro_fused_lcs"),
    *(pytest.param(partial(dp_fused_cuda.dp_fused_stats, with_lev=lev, with_osa=osa, with_lcs=lcs),
                   partial(dp_fused_cuda.dp_fused_plain, with_lev=lev, with_osa=osa, with_lcs=lcs),
                   (7, 33, 63, 95, 160, 511), (np.int8, np.int32),
                   id="dp_fused_" + "+".join(n for n, on in (("lev", lev), ("osa", osa), ("lcs", lcs)) if on))
      for lev, osa, lcs in ((True, True, True), (True, True, False), (False, True, True),
                            (False, False, True), (True, False, True))),
    pytest.param(osa_cuda.osa_distance, osa_cuda.osa_plain,
                 (7, 31, 33, 63, 95, 255, 511), (np.int8, np.int32), id="osa_scan"),
    pytest.param(bigram_cuda.bigram_stats, bigram_cuda.bigram_plain,
                 (1, 2, 7, 31, 63, 64), (np.int8, np.int32), id="bigram"),
    pytest.param(jaro_flags_cuda.jaro_flag_scan, jaro_cuda.greedy_scan,
                 (1, 2, 7, 31, 33, 63, 95, 511, 512), (np.int8, np.int32), id="jaro_flags"),
    pytest.param(jaro_flags_cuda.jaro_match_stats, jaro_cuda.jaro_plain,
                 (7, 63, 511), (np.int8, np.int32), id="jaro_flags_m_t"),
    pytest.param(levenshtein_wavefront_cuda.levenshtein_distance,
                 levenshtein_wavefront_cuda.wavefront_plain,
                 (1, 2, 7, 31, 63, 64, 65, 128, 129, 255, 256, 257, 511, 512), (np.int8, np.int32),
                 id="levenshtein_wavefront"),
]


@pytest.mark.parametrize("kernel,plain,widths,dtypes", CASES)
def test_kernel_matches_plain(device, kernel, plain, widths, dtypes):
    for width in widths:
        for dtype in dtypes:
            args = packed_tiles(width, 3000, width, dtype, device)
            got, want = kernel(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                # [B] int32 stats; K9 also returns its [B, L] bool flag tensors
                assert g.device == device and g.dtype == (torch.bool if g.dim() == 2 else torch.int32)
                assert torch.equal(g, w), (width, dtype)


def test_pipeline_on_the_card_matches_oracle(device):
    """Short mixed-script rows (the fused kernel K5), a pure-ASCII wide
    bucket (K1, K2, K4) and a wide non-ASCII bucket (K1, K2 and the plain
    multiset version on the card), then the short rows once more through
    single measures (K1, K2, K3)."""
    rng = np.random.default_rng(0)
    words = ["phillips", "philips", "смит", "你好世界", "😀a😀", "", "martha", "marhta"]
    col_a = [words[i] for i in rng.integers(0, len(words), 400)] + [None]
    col_b = [words[i] for i in rng.integers(0, len(words), 400)] + ["x"]
    for k in range(40):
        col_a += ["abcde" * 30 + "x" * k, "жук" * 70 + "a" * k]
        col_b += ["abdce" * 31, "жкук" * 55]
    cfg = tst.get_config().replace(device="cuda", host_short_circuit_rows=0)
    _build.reset_launch_counts()
    out = tst.compute_many(FIVE, col_a, col_b, config=cfg)
    for m in FIVE:
        want = np.array([np.nan if a is None or b is None else ORACLES[m](a, b) for a, b in zip(col_a, col_b)])
        assert out[m].tobytes() == want.tobytes(), m
        assert tst.compute(m, col_a[:401], col_b[:401], config=cfg).tobytes() == want[:401].tobytes(), m
    assert set(_build.launch_counts()) >= {"lev_jaro_fused", "levenshtein_myers", "jaro_scan",
                                           "multiset_rank", "multiset_hist"}



def test_extension_pipeline_on_the_card_matches_oracle(device):
    """The nine extensions and all fourteen together on the card: short rows
    (K5 with its OSA/LCS outputs, K8), long ASCII rows (K6, K2, K4 and the
    plain bigram and soundex forms), then osa and lcs_seq alone (K7, K6)."""
    rng = np.random.default_rng(1)
    words = ["Robert", "Rupert", "a", "b", "смит", "你好", "😀a😀", "", "martha", "marhta"]
    col_a = [words[i] for i in rng.integers(0, len(words), 300)] + [None]
    col_b = [words[i] for i in rng.integers(0, len(words), 300)] + ["x"]
    for k in range(30):
        col_a += ["Ashcraft" * 12 + "x" * k]
        col_b += ["Ashcroft" * 12]
    cfg = tst.get_config().replace(device="cuda", host_short_circuit_rows=0)
    _build.reset_launch_counts()
    out = tst.compute_many(FIVE + EXT, col_a, col_b, config=cfg)
    for m in FIVE + EXT:
        want = np.array([np.nan if a is None or b is None else ORACLES[m](a, b) for a, b in zip(col_a, col_b)])
        assert out[m].tobytes() == want.tobytes(), m
    for m in ("osa", "lcs_seq"):
        assert tst.compute(m, col_a, col_b, config=cfg).tobytes() == out[m].tobytes(), m
    assert set(_build.launch_counts()) >= {"lev_jaro_fused", "lev_jaro_fused.osa", "lev_jaro_fused.lcs",
                                           "dp_fused", "osa_scan", "bigram", "jaro_scan", "multiset_hist"}


def test_forced_pipeline_on_the_card_matches_oracle(device):
    """levenshtein_impl="pallas", jaro_impl="pallas": K10 and K9 on short
    mixed-script rows and on long ASCII rows, the plain forms past 512."""
    rng = np.random.default_rng(2)
    words = ["phillips", "philips", "смит", "你好世界", "😀a😀", "", "a", "martha", "marhta"]
    col_a = [words[i] for i in rng.integers(0, len(words), 300)] + [None, "ab" * 300]
    col_b = [words[i] for i in rng.integers(0, len(words), 300)] + ["x", "ba" * 290]
    for k in range(20):
        col_a.append("abcde" * 30 + "x" * k)
        col_b.append("abdce" * 31)
    cfg = tst.get_config().replace(device="cuda", host_short_circuit_rows=0, equal_fast_path=False,
                                   levenshtein_impl="pallas", jaro_impl="pallas")
    _build.reset_launch_counts()
    out = tst.compute_many(FIVE, col_a, col_b, config=cfg)
    for m in FIVE:
        want = np.array([np.nan if a is None or b is None else ORACLES[m](a, b) for a, b in zip(col_a, col_b)])
        assert out[m].tobytes() == want.tobytes(), m
    assert set(_build.launch_counts()) >= {"jaro_flags", "levenshtein_wavefront", "multiset_rank"}


def test_forced_multiset_hist_on_the_card_matches_oracle(device):
    """multiset_impl="pallas_hist": K4 on the narrow ASCII buckets (w7, w15)
    too, the plain form on a non-ASCII one (w23)."""
    rng = np.random.default_rng(3)
    words = ["phillips", "philips", "a", "martha", "marhta", "dixon", "dicksonx"]
    col_a = [words[i] for i in rng.integers(0, len(words), 300)] + ["жук" * 6] * 20
    col_b = [words[i] for i in rng.integers(0, len(words), 300)] + ["жкук" * 5] * 20
    cfg = tst.get_config().replace(device="cuda", host_short_circuit_rows=0,
                                   multiset_impl="pallas_hist")
    _build.reset_launch_counts()
    out = tst.compute_many(("jaccard", "cosine"), col_a, col_b, config=cfg)
    for m in ("jaccard", "cosine"):
        want = np.array([ORACLES[m](a, b) for a, b in zip(col_a, col_b)])
        assert out[m].tobytes() == want.tobytes(), m
    assert _build.launch_counts().get("multiset_hist", 0) > 0


def test_warm_matches_plain(device):
    """K11 (csrc/warm.cu) equals warm_plain over the whole int32 range, at
    the benchmark's [8, 128] and on a larger tile, one launch counted a call."""
    from strsim_tpu_torch.ops.warm_cuda import warm, warm_plain

    rng = np.random.default_rng(4)
    _build.reset_launch_counts()
    for shape in ((8, 128), (4096, 128), (3, 5)):
        x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, shape).astype(np.int32)).to(device)
        assert torch.equal(warm(x), warm_plain(x)), shape
    assert _build.launch_counts() == {"warm": 3}


def test_native_paths_on_the_card_match_numpy(device):
    """The native encode, the native pack into pinned memory and the native
    finalize through compute_scores on the card, against the numpy encode,
    the numpy pack (int32 columns into int8 buckets) and the numpy
    finalizers: byte-identical on all fourteen measures. Blocks of 128 rows,
    so that buckets span several blocks and rows with la != lb lie past the
    first (a lengths layout that paired a row with another's lengths would
    show there)."""
    import bench
    from strsim_tpu_torch.models.pipeline import compute_scores
    from strsim_tpu_torch.utils import encode as enc
    from strsim_tpu_torch.utils.metrics import RunMetrics

    cfg = tst.get_config().replace(device="cuda", host_short_circuit_rows=0, max_batch_block=128)
    for col_a, col_b in (bench.make_pairs(6000), bench.make_wide_pairs(700)):
        rm = RunMetrics()
        native = compute_scores(col_a, col_b, FIVE + EXT, config=cfg, metrics=rm)
        assert rm.encode_route in ("native_objects", "native_utf8")
        assert any(bm.rows > 128 for bm in rm.buckets.values())
        a, b = enc.encode_pair_numpy(col_a, col_b)
        numpy = compute_scores(a, b, FIVE + EXT, config=cfg.replace(native_finalize=False))
        for m in FIVE + EXT:
            assert native[m][0].tobytes() == numpy[m][0].tobytes(), m


def test_device_time_on_the_card(device):
    """utils/devicetime.py on the card: a positive time a call, larger for a
    block of twice the work."""
    from strsim_tpu_torch.utils.devicetime import marginal_block_time

    small = [(torch.ones(1 << 22, device=device),) for _ in range(2)]
    large = [(torch.ones(1 << 23, device=device),) for _ in range(2)]
    t_small = marginal_block_time(lambda x: x * 2 + 1, small)
    t_large = marginal_block_time(lambda x: x * 2 + 1, large)
    assert 0 < t_small < t_large
