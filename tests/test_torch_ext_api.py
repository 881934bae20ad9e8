"""The nine extension measures through strsim_tpu_torch's API on the CPU:
finalizers and oracles equal to strsim_tpu's, compute_many over the measure
sets of tools/soak_tpu_differential.py (all fourteen included) byte-identical
to strsim_tpu.compute_many and to the oracle, each measure function, the
bigram equality patch without the equal fast path, and the stat router
against the JAX engine's choices on a TPU."""
import numpy as np
import pytest
import torch

import strsim_tpu as jst
import strsim_tpu_torch as tst
from strsim_tpu.ops import finalize as jax_finalize
from strsim_tpu.ops import oracle as jax_oracle
from strsim_tpu_torch import config as torch_config
from strsim_tpu_torch.ops import finalize as torch_finalize
from strsim_tpu_torch.ops import oracle as torch_oracle
from strsim_tpu_torch.ops import stats as torch_stats

torch.set_num_threads(1)

FIVE = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")
EXT = ("jaccard_bigram", "sorensen_dice_bigram", "cosine", "overlap", "hamming",
       "lcs_seq", "indel", "osa", "soundex")
ALL = FIVE + EXT
# tools/soak_tpu_differential.py:45-59
SOAK_SETS = [
    FIVE,
    ("levenshtein", "osa", "lcs_seq", "indel"),
    ("osa", "lcs_seq"),
    ("lcs_seq",),
    ("jaccard_bigram", "sorensen_dice_bigram", "hamming"),
    ("levenshtein", "jaro", "osa", "lcs_seq"),
    ("jaro_winkler",),
    ("jaccard", "cosine", "overlap"),
    EXT,
    ALL,
]


@pytest.fixture(autouse=True)
def cpu_config(monkeypatch):
    cfg = torch_config.StrsimConfig(device="cpu", host_short_circuit_rows=0)
    monkeypatch.setattr(torch_config, "_CONFIG", cfg)
    return cfg


def columns(seed: int, n: int):
    """Two columns of str|None with lengths 0..127 (buckets 7..127) over
    ASCII letters (soundex codes), BMP, astral and NUL chars: equal pairs,
    near-duplicates (a substitution and an adjacent swap), independent pairs,
    empty sides, length-1 pairs and nulls."""
    rng = np.random.default_rng(seed)
    alphabets = ["RobertRupLeW h", "abc\0", "аб你好￿Ab", "😀😁б\U0010fffdx"]
    col_a, col_b = [], []
    for i in range(n):
        alphabet = alphabets[i % len(alphabets)]
        la = int(rng.choice([0, 1, 2, rng.integers(3, 16), rng.integers(16, 64), rng.integers(64, 128)]))
        a = "".join(rng.choice(list(alphabet), la))
        kind = i % 7
        if kind == 0:
            b = a
        elif kind in (1, 2) and len(a) > 2:
            k = int(rng.integers(0, len(a) - 1))
            b = a[:k] + a[k + 1] + a[k] + a[k + 2:]
            k = int(rng.integers(0, len(b)))
            b = b[:k] + alphabet[0] + b[k + 1:]
        elif kind == 3:
            b = "".join(rng.choice(list(alphabet), int(rng.integers(0, 2))))
        else:
            b = "".join(rng.choice(list(alphabet), int(rng.integers(0, max(la + 3, 2)))))
        col_a.append(a)
        col_b.append(b)
    for i in rng.choice(n, 6, replace=False):
        if i % 2:
            col_a[i] = None
        else:
            col_b[i] = None
    return col_a, col_b


def oracle_scores(measure, col_a, col_b):
    return np.array([np.nan if a is None or b is None else torch_oracle.ORACLES[measure](a, b)
                     for a, b in zip(col_a, col_b)])


def test_registry_order_matches_jax():
    from strsim_tpu.models.measures import MEASURES as JAX_MEASURES

    assert tuple(tst.MEASURES) == tuple(JAX_MEASURES) == ALL
    for m in ALL:
        assert tst.MEASURES[m].stat_fields == JAX_MEASURES[m].stat_fields
        assert callable(getattr(tst, m)) and m in tst.__all__


@pytest.mark.parametrize("measure", EXT)
def test_finalizer_matches_jax(measure):
    rng = np.random.default_rng(len(measure))
    n = 4000
    la = rng.integers(0, 60, n)
    lb = rng.integers(0, 60, n)
    lb[:50] = la[:50]
    la[50:70] = 0
    lo = np.minimum(la, lb)
    stats = {
        "inter": rng.integers(0, lo + 1),
        "inter2": rng.integers(0, np.maximum(lo - 1, 0) + 1),
        "eq": (rng.random(n) < 0.1).astype(np.int64),
        "ham_m": rng.integers(0, lo + 1),
        "lcs_len": rng.integers(0, lo + 1),
        "osa_d": rng.integers(0, np.maximum(la, lb) + 1),
        "sdx_eq": rng.integers(0, 2, n),
    }
    got = torch_finalize.FINALIZERS[measure](stats, la, lb)
    want = jax_finalize.FINALIZERS[measure](stats, la, lb)
    assert got.dtype == np.float64 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("measure", EXT)
def test_oracle_matches_jax(measure):
    col_a, col_b = columns(11, 300)
    pairs = [(a, b) for a, b in zip(col_a, col_b) if a is not None and b is not None]
    pairs += [("a", "a"), ("a", "b"), ("", ""), ("", "x"), ("Robert", "Rupert"),
              ("ca", "abc"), ("abcd", "acbd"), ("你", "你")]
    got = np.array([torch_oracle.ORACLES[measure](a, b) for a, b in pairs])
    want = np.array([jax_oracle.ORACLES[measure](a, b) for a, b in pairs])
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("measures", SOAK_SETS, ids=lambda s: "+".join(m[:5] for m in s))
def test_compute_many_soak_sets_byte_identical(measures):
    col_a, col_b = columns(len(measures), 140)
    got = tst.compute_many(measures, col_a, col_b)
    want = jst.compute_many(measures, col_a, col_b)
    for m in measures:
        assert got[m].tobytes() == want[m].tobytes(), m
        assert got[m].tobytes() == oracle_scores(m, col_a, col_b).tobytes(), m


def test_extension_functions_match_oracle():
    col_a, col_b = columns(5, 120)
    many = tst.compute_many(EXT, col_a, col_b)
    for m in EXT:
        want = oracle_scores(m, col_a, col_b)
        assert getattr(tst, m)(col_a, col_b).tobytes() == want.tobytes(), m
        values, validity = tst.compute_with_validity(m, col_a, col_b)
        assert values.tobytes() == many[m].tobytes() == want.tobytes(), m
        assert validity.tolist() == [a is not None and b is not None for a, b in zip(col_a, col_b)]


def test_no_fast_path_still_exact():
    """Without the host's equal fast path, equal rows reach the device: the
    bigram measures then take 1.0 for equal length-1 pairs from the eq stat
    (K8's on narrow buckets, the plain form's on wide ones)."""
    cfg = torch_config.get_config().replace(equal_fast_path=False)
    col_a = ["s", "s", "x", "same", "ab", "你", "😀", "a" * 70, "ab" * 40]
    col_b = ["s", "t", "x", "same", "ab", "你", "😀", "a" * 70, "ba" * 40]
    for narrow in (True, False):
        for m in ALL:
            got = tst.compute(m, col_a, col_b, config=cfg.replace(narrow_tiles=narrow))
            assert got.tobytes() == oracle_scores(m, col_a, col_b).tobytes(), (m, narrow)


def test_extend_rows_and_broadcast():
    cases = [("ab" * 300, "ba" * 290), ("Robert" * 100, "Rupert" * 99), ("x", "y")]
    col_a = [a for a, _ in cases]
    col_b = [b for _, b in cases]
    out = tst.compute_many(EXT, col_a, col_b)
    for m in EXT:
        assert out[m].tobytes() == oracle_scores(m, col_a, col_b).tobytes(), m
    got = tst.osa(["smith", "smtih", None], tst.lit("smith"))
    assert got[0] == 1.0 and abs(got[1] - 0.8) < 1e-12 and np.isnan(got[2])


# --- the stat router against the JAX engine's choices on a TPU ---------------

def _jax_routes(monkeypatch, measures, width, dtype, config=None):
    """{stat: route} from strsim_tpu.ops.stats.compute_stats with the kernel
    choices strsim_tpu.models.pipeline._impls_for makes on a TPU under
    `config` (a strsim_tpu config; the default one if None), each kernel and
    XLA form replaced by a recorder that names the port's counterpart."""
    import jax
    import jax.numpy as jnp
    from strsim_tpu.models import pipeline as jpipe
    from strsim_tpu.ops import (
        bigram_pallas, dp_fused_pallas, jaro_bitmask, jaro_pallas, jaro_pallas_scan, lcs,
        lev_jaro_pallas, levenshtein_myers, levenshtein_pallas, levenshtein_pallas_scan,
        multiset_loop, multiset_pallas, osa_myers, osa_pallas_scan, phonetic)
    from strsim_tpu.ops import stats as jax_stats

    routes = {}

    def recorder(route, names):
        def fn(a, *args, **kw):
            outs = [n for n, on in names(kw) if on]
            routes.update((n, route) for n in outs)
            zeros = tuple(jnp.zeros((a.shape[0],), jnp.int32) for _ in outs)
            return zeros if len(zeros) > 1 or route in ("dp_fused", "bigram") else zeros[0]
        return fn

    def fixed(*names):
        return lambda kw: [(n, True) for n in names]

    fused = lambda kw: [("lev_d", True), ("jaro_m", True), ("jaro_t", True),  # noqa: E731
                        ("inter", kw["with_inter"]), ("prefix", kw["with_prefix"]),
                        ("osa_d", kw["with_osa"]), ("lcs_len", kw["with_lcs"])]
    dp = lambda kw: [("lev_d", kw["with_lev"]), ("osa_d", kw["with_osa"]),  # noqa: E731
                     ("lcs_len", kw["with_lcs"])]
    # the port's K2 is exact for every codepoint at every width <= 512, so
    # where the JAX engine leaves int32 tiles to its XLA jaro form (its
    # Pallas slot packing has a codepoint contract), the port keeps K2
    jaro_xla = "jaro_scan" if width <= 512 else "plain"
    # the port's K4, K9 and K10 take widths up to 512, its plain forms beyond
    up_to_512 = lambda route: route if width <= 512 else "plain"  # noqa: E731
    for module, name, route, names in [
        (lev_jaro_pallas, "fused_stats_pallas", "lev_jaro_fused", fused),
        (dp_fused_pallas, "dp_fused_stats_pallas", "dp_fused", dp),
        (levenshtein_pallas_scan, "levenshtein_distance_myers_pallas", "levenshtein_myers", fixed("lev_d")),
        (levenshtein_myers, "levenshtein_distance_myers", "plain", fixed("lev_d")),
        (jaro_pallas_scan, "jaro_match_stats_pallas_scan", "jaro_scan", fixed("jaro_m", "jaro_t")),
        (jaro_bitmask, "jaro_match_stats_bitmask", jaro_xla, fixed("jaro_m", "jaro_t")),
        (multiset_pallas, "multiset_intersection_pallas", "multiset_rank", fixed("inter")),
        (multiset_pallas, "multiset_intersection_hist", up_to_512("multiset_hist"), fixed("inter")),
        (multiset_loop, "multiset_intersection_chunked", "plain", fixed("inter")),
        (multiset_loop, "multiset_intersection_loop", "plain", fixed("inter")),
        (jax_stats, "multiset_intersection", "plain", fixed("inter")),
        (levenshtein_pallas, "levenshtein_distance_pallas", up_to_512("levenshtein_wavefront"),
         fixed("lev_d")),
        (jax_stats, "levenshtein_distance", "plain", fixed("lev_d")),
        (jaro_pallas, "jaro_match_stats_pallas", up_to_512("jaro_flags"), fixed("jaro_m", "jaro_t")),
        (jax_stats, "jaro_match_stats", jaro_xla, fixed("jaro_m", "jaro_t")),
        (bigram_pallas, "bigram_stats_pallas", "bigram", fixed("inter2", "ham_m", "eq")),
        (multiset_loop, "bigram_intersection_loop", "plain", fixed("inter2")),
        (osa_pallas_scan, "osa_distance_pallas", "osa_scan", fixed("osa_d")),
        (osa_myers, "osa_distance_myers", "plain", fixed("osa_d")),
        (lcs, "lcs_length", "plain", fixed("lcs_len")),
        (phonetic, "soundex_equal", "plain", fixed("sdx_eq")),
    ]:
        monkeypatch.setattr(module, name, recorder(route, names))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    impls = jpipe._impls_for(config or jst.get_config(), width, dtype,
                             max_char=0xFFFF if dtype == np.int32 else 127)
    a = jnp.full((8, width), -1, dtype)
    b = jnp.full((8, width), -2, dtype)
    lens = jnp.zeros((8,), jnp.int32)
    out = jax_stats.compute_stats(a, b, lens, lens, measures, impls)
    # the rest of the stats are XLA expressions inside compute_stats
    return {f: routes.get(f, "plain") for f in out}


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", [15, 63, 95, 511])
def test_stat_routes_follow_the_jax_router(monkeypatch, width, dtype):
    tdtype = torch.int8 if dtype == np.int8 else torch.int32
    for measures in SOAK_SETS + [("osa",), ("levenshtein", "osa"), ("jaro", "osa"),
                                 ("levenshtein", "jaro", "lcs_seq"), ("hamming",), ("soundex",)]:
        want = _jax_routes(monkeypatch, measures, width, dtype)
        assert torch_stats.stat_routes(measures, width, tdtype) == want, (measures, width, dtype)


@pytest.mark.parametrize("measures,width,dtype,routes", [
    (ALL, 63, torch.int8, {"lev_d": "lev_jaro_fused", "osa_d": "lev_jaro_fused",
                           "lcs_len": "lev_jaro_fused", "inter": "lev_jaro_fused",
                           "inter2": "bigram", "ham_m": "bigram", "eq": "bigram",
                           "sdx_eq": "plain"}),
    (ALL, 95, torch.int8, {"lev_d": "dp_fused", "osa_d": "dp_fused", "lcs_len": "dp_fused",
                           "jaro_m": "jaro_scan", "inter": "multiset_hist",
                           "inter2": "plain", "ham_m": "plain", "eq": "plain"}),
    (ALL, 95, torch.int32, {"inter": "plain", "jaro_t": "jaro_scan"}),
    (("osa",), 31, torch.int8, {"osa_d": "osa_scan"}),
    (("lcs_seq",), 31, torch.int32, {"lcs_len": "dp_fused"}),
    (("levenshtein", "osa"), 31, torch.int8, {"lev_d": "dp_fused", "osa_d": "dp_fused"}),
    (("levenshtein",), 31, torch.int8, {"lev_d": "levenshtein_myers"}),
    (("osa", "lcs_seq", "levenshtein"), 1023, torch.int8,
     {"lev_d": "plain", "osa_d": "plain", "lcs_len": "plain"}),
])
def test_stat_routes_table(measures, width, dtype, routes):
    got = torch_stats.stat_routes(measures, width, dtype)
    for stat, route in routes.items():
        assert got[stat] == route, stat


def test_block_rows_cap_plain_wide_forms():
    from strsim_tpu_torch.models import pipeline as tpipe

    cfg = torch_config.get_config()
    assert tpipe._block_rows(511, cfg, ("jaccard_bigram",), np.int8) == 32768
    assert tpipe._block_rows(511, cfg, ("soundex",), np.int8) == 32768
    assert tpipe._block_rows(63, cfg, ("jaccard_bigram",), np.int8) == cfg.max_batch_block
    assert tpipe._block_rows(511, cfg, ("osa", "lcs_seq"), np.int32) == cfg.max_batch_block
