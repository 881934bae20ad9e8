"""strsim_tpu_torch end to end on the CPU: the five measures through the
port's API are byte-identical to strsim_tpu (and to the oracle) on the golden
corpus, the README demo table and seeded random Unicode columns; null,
broadcast and shape rules; the host short-circuit; the conversion helpers;
and the package's independence from jax."""
import dataclasses
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import strsim_tpu as jst
import strsim_tpu_torch as tst
from strsim_tpu.ops.oracle import ORACLES
from strsim_tpu_torch import config as torch_config
from strsim_tpu_torch import convert
from strsim_tpu_torch.models import pipeline as tpipe

# small tensors: one intra-op thread keeps torch from contending with the
# other test workers for the cores
torch.set_num_threads(1)

FIVE = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def cpu_config(monkeypatch):
    """The plain torch versions on the CPU, with the host short-circuit off
    so tiny inputs still go through the stat kernels' code (as
    tests/conftest.py sets for strsim_tpu)."""
    cfg = torch_config.StrsimConfig(device="cpu", host_short_circuit_rows=0)
    monkeypatch.setattr(torch_config, "_CONFIG", cfg)
    return cfg


def random_columns(seed: int, n: int, wide: bool = True):
    """Two columns of str|None over ASCII, BMP and astral codepoints and NUL,
    with lengths across the whole ladder and two extend rows (> 511), or
    below 64 when not `wide`; equal pairs, near-duplicates, empties and
    nulls."""
    rng = np.random.default_rng(seed)
    alphabets = ["abc\0", "abcdefgh xyz", "аб你好￿", "😀😁б\U0010fffdx\0"]
    lengths = np.concatenate([
        rng.integers(0, 8, n // 2), rng.integers(8, 64, n // 4),
        rng.integers(64, 512, n - n // 2 - n // 4 - 2) if wide else rng.integers(0, 64, n - n // 2 - n // 4 - 2),
        [530, 700] if wide else [63, 64],
    ])
    col_a, col_b = [], []
    for i, la in enumerate(rng.permutation(lengths)):
        alphabet = alphabets[i % len(alphabets)]
        a = "".join(rng.choice(list(alphabet), int(la)))
        kind = i % 6
        if kind == 0:
            b = a
        elif kind in (1, 2) and a:
            k = int(rng.integers(0, len(a)))
            b = a[:k] + alphabet[0] + a[k + 1:]
            if len(b) > 2:
                b = b[1] + b[0] + b[2:]
        else:
            lb = int(rng.integers(0, max(int(la) + 3, 2)))
            b = "".join(rng.choice(list(alphabet), lb))
        col_a.append(a)
        col_b.append(b)
    for i in rng.choice(n, 6, replace=False):
        if i % 2:
            col_a[i] = None
        else:
            col_b[i] = None
    return col_a, col_b


def oracle_scores(measure, col_a, col_b):
    return np.array([np.nan if a is None or b is None else ORACLES[measure](a, b)
                     for a, b in zip(col_a, col_b)])


@pytest.mark.parametrize("measure", FIVE)
def test_golden_byte_identical(golden, measure):
    cases = golden[measure]
    col_a = [a for a, _, _ in cases]
    col_b = [b for _, b, _ in cases]
    got = tst.compute(measure, col_a, col_b)
    assert got.tobytes() == jst.compute(measure, col_a, col_b).tobytes()
    assert got.tobytes() == oracle_scores(measure, col_a, col_b).tobytes()
    assert np.all(np.abs(got - np.array([e for _, _, e in cases])) < 1e-8)
    fn = getattr(tst, measure)
    assert fn(col_a, col_b).tobytes() == got.tobytes()


def test_golden_compute_many_byte_identical(golden):
    pairs = [(a, b) for cases in golden.values() for a, b, _ in cases]
    col_a = [a for a, _ in pairs]
    col_b = [b for _, b in pairs]
    got = tst.compute_many(FIVE, col_a, col_b)
    want = jst.compute_many(FIVE, col_a, col_b)
    for m in FIVE:
        assert got[m].tobytes() == want[m].tobytes(), m


def test_readme_demo_table():
    name_a = ["phillips", "phillips", "", "", None, None]
    name_b = ["phillips", "philips", "phillips", "", "phillips", None]
    expected = {
        "levenshtein": [1.0, 0.875, 0.0, 1.0],
        "jaro": [1.0, 0.9583333333333334, 0.0, 1.0],
        "jaro_winkler": [1.0, 0.975, 0.0, 1.0],
        "jaccard": [1.0, 0.875, 0.0, 1.0],
        "sorensen_dice": [1.0, 0.9333333333333333, 0.0, 1.0],
    }
    out = tst.compute_many(list(expected), name_a, name_b)
    want = jst.compute_many(list(expected), name_a, name_b)
    for m, values in expected.items():
        assert out[m][:4].tolist() == values
        assert np.isnan(out[m][4:]).all()
        assert out[m].tobytes() == want[m].tobytes()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_unicode_columns_byte_identical(seed):
    col_a, col_b = random_columns(seed, 160)
    got = tst.compute_many(FIVE, col_a, col_b)
    want = jst.compute_many(FIVE, col_a, col_b)
    for m in FIVE:
        assert got[m].tobytes() == want[m].tobytes(), m
        assert got[m].tobytes() == oracle_scores(m, col_a, col_b).tobytes(), m


def test_measure_functions_and_validity():
    col_a, col_b = random_columns(4, 40, wide=False)
    many = tst.compute_many(FIVE, col_a, col_b)
    for m in FIVE:
        assert getattr(tst, m)(col_a, col_b).tobytes() == many[m].tobytes()
        values, validity = tst.compute_with_validity(m, col_a, col_b)
        assert values.tobytes() == many[m].tobytes()
        assert validity.tolist() == [a is not None and b is not None for a, b in zip(col_a, col_b)]


def test_null_propagation():
    values, validity = tst.compute_with_validity("jaro", ["a", None, "c", None], ["a", "b", None, None])
    assert list(validity) == [True, False, False, False]
    assert values[0] == 1.0 and all(math.isnan(v) for v in values[1:])


def test_broadcast_literal():
    got = tst.compute("levenshtein", ["smith", "smyth", None], tst.lit("smith"))
    assert got[0] == 1.0 and abs(got[1] - 0.8) < 1e-12 and math.isnan(got[2])
    got2 = tst.compute("levenshtein", "smith", ["smith", "smyth"])  # bare str literal
    assert got2[0] == 1.0 and abs(got2[1] - 0.8) < 1e-12
    want = jst.compute("jaro_winkler", ["martha", "marhta", None], jst.lit("martha"))
    assert tst.jaro_winkler(["martha", "marhta", None], tst.lit("martha")).tobytes() == want.tobytes()


@pytest.mark.parametrize("call,error,match", [
    (lambda: tst.compute("jaro", ["a", "b"], ["a", "b", "c"]), ValueError, "same length"),
    (lambda: tst.compute("jaro", ["a", "b"], tst.lit(None)), ValueError, "null literal"),
    (lambda: tst.compute("jaro", None, ["a"]), ValueError, "null literal"),
    (lambda: tst.compute("nope", ["a"], ["b"]), KeyError, "available"),
    (lambda: tst.compute("jaro", ["a", 3], ["a", "b"]), TypeError, "row 1"),
])
def test_errors(call, error, match):
    with pytest.raises(error, match=match):
        call()


def test_empty_column():
    assert tst.compute("jaro", [], []).shape == (0,)
    assert tst.compute_many(FIVE, [], [])["jaccard"].shape == (0,)


def test_mixed_length_bucketing_and_overflow_policies():
    """Rows across several buckets, incl. beyond the ladder: extend buckets
    on the device and, with overflow_policy="oracle", host rows."""
    cases = [("a" * 5, "a" * 4), ("b" * 30, "b" * 31), ("c" * 100, "c" * 90),
             ("d" * 600, "d" * 601), ("x", "y"), ("ab" * 300, "ba" * 290)]
    col_a = [a for a, _ in cases]
    col_b = [b for _, b in cases]
    base = torch_config.get_config()
    for cfg in (base, base.replace(overflow_policy="oracle"), base.replace(max_extend_len=600)):
        for m in FIVE:
            got = tst.compute(m, col_a, col_b, config=cfg)
            assert got.tobytes() == oracle_scores(m, col_a, col_b).tobytes(), (m, cfg)


def test_config_override():
    cfg = torch_config.get_config().replace(equal_fast_path=False, buckets=(8, 16))
    got = tst.compute("levenshtein", ["same", "longer-than-sixteen-chars"],
                      ["same", "longer-than-sixteen-chars!"], config=cfg)
    assert got[0] == 1.0
    assert got[1] == ORACLES["levenshtein"]("longer-than-sixteen-chars", "longer-than-sixteen-chars!")


def test_no_fast_path_still_exact():
    cfg = torch_config.get_config().replace(equal_fast_path=False, narrow_tiles=False)
    col_a = ["s", "s", "x", "same", "ab", "你"]
    col_b = ["s", "t", "x", "same", "ab", "你"]
    for m in FIVE:
        got = tst.compute(m, col_a, col_b, config=cfg)
        assert got.tobytes() == oracle_scores(m, col_a, col_b).tobytes(), m


def test_host_short_circuit_skips_device():
    from strsim_tpu_torch.utils.metrics import RunMetrics

    cfg = torch_config.get_config().replace(host_short_circuit_rows=8192)
    metrics = RunMetrics()
    col_a = ["smith", "johnson", "wbc", None, ""]
    col_b = ["smyth", "jonson", "abc", "x", ""]
    out = tpipe.compute_scores(col_a, col_b, ("levenshtein", "jaro_winkler"), config=cfg, metrics=metrics)
    assert metrics.device_rows == 0 and metrics.oracle_rows == 3
    for m in ("levenshtein", "jaro_winkler"):
        values, validity = out[m]
        assert not validity[3] and values[4] == 1.0
        for i in range(3):
            assert values[i] == ORACLES[m](col_a[i], col_b[i])


def test_run_metrics_match_jax():
    """Rows by disposition and per-bucket occupancy agree with strsim_tpu."""
    from strsim_tpu.models.pipeline import compute_scores as jax_compute_scores
    from strsim_tpu.utils.metrics import RunMetrics as JaxMetrics
    from strsim_tpu_torch.utils.metrics import RunMetrics

    col_a, col_b = random_columns(5, 120)
    ours, theirs = RunMetrics(), JaxMetrics()
    tpipe.compute_scores(col_a, col_b, FIVE, metrics=ours)
    jax_compute_scores(col_a, col_b, FIVE, metrics=theirs)
    for field in ("n_rows", "null_rows", "fast_path_rows", "one_empty_rows", "device_rows", "oracle_rows"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert sorted(ours.buckets) == sorted(theirs.buckets)
    for width, bucket in ours.buckets.items():
        other = theirs.buckets[width]
        for field in ("rows", "padded_rows", "char_lanes", "useful_char_lanes"):
            assert getattr(bucket, field) == getattr(other, field), (width, field)
    assert ours.pairs_per_sec > 0 and ours.as_dict()["n_rows"] == 120


def test_pipeline_helpers_match_jax():
    from strsim_tpu.models import pipeline as jpipe
    from strsim_tpu.utils import encode as jenc

    jcfg, tcfg = jst.get_config(), torch_config.get_config()
    for n in (1, 511, 512, 513, 4096, 30000, 65536, 65537, 10 ** 6):
        assert tpipe._round_batch(n, tcfg) == jpipe._round_batch(n, jcfg)
    for length in (0, 1, 7, 8, 63, 64, 511, 512, 1023, 1024, 16383, 16384, 40000):
        assert tcfg.bucket_for(length) == jcfg.bucket_for(length)
    for cols in ((["Мюллер", "你好"], ["Миллер", "你woof"]), (["abc", "def"], ["abd", "dxf"])):
        ja = jenc.encode_column(cols[0], pad=jenc.PAD_A)
        jb = jenc.encode_column(cols[1], pad=jenc.PAD_B, width=ja.width)
        sides = [(c.codes.astype(np.int32), c.lengths, c.validity) for c in (ja, jb)]
        sel = np.arange(2)
        want = jpipe._narrow_bucket(jcfg, *(jenc.EncodedColumn(*s) for s in sides), sel, ja.width)
        got = tpipe._narrow_bucket(tcfg, *(convert.encoded_from_numpy(*s) for s in sides), sel, ja.width)
        assert got == want


def test_config_from_jax_carries_every_shared_field():
    fields = dataclasses.asdict(jst.get_config().replace(buckets=(7, 15, 31), min_batch=16, equal_fast_path=False))
    cfg = convert.config_from_jax(fields, device="cpu")
    assert cfg.buckets == (7, 15, 31) and cfg.min_batch == 16 and not cfg.equal_fast_path
    assert cfg.device == "cpu"
    shared = {f.name for f in dataclasses.fields(cfg)} - {"device"}
    for name in shared:
        assert getattr(cfg, name) == (tuple(fields[name]) if name == "buckets" else fields[name]), name
    with pytest.raises(KeyError, match="unknown"):
        convert.config_from_jax({**fields, "no_such_knob": 1})


def test_encoded_tiles_carried_across_score_the_same():
    """Tiles encoded by strsim_tpu, handed over as numpy arrays, score
    byte-identically in both packages (pre-encoded columns skip encoding)."""
    from strsim_tpu.models.pipeline import compute_scores as jax_compute_scores
    from strsim_tpu.utils import encode as jenc

    col_a, col_b = random_columns(6, 80)
    ja, jb = jenc.encode_pair(col_a, col_b)
    ta = convert.encoded_from_numpy(ja.codes, ja.lengths, ja.validity)
    tb = convert.encoded_from_numpy(jb.codes, jb.lengths, jb.validity)
    ours = tpipe.compute_scores(ta, tb, FIVE)
    theirs = jax_compute_scores(ja, jb, FIVE)
    for m in FIVE:
        assert ours[m][0].tobytes() == theirs[m][0].tobytes(), m
        assert ours[m][1].tolist() == theirs[m][1].tolist()
    with pytest.raises(ValueError):
        convert.encoded_from_numpy(ja.codes.astype(np.int64), ja.lengths, ja.validity)
    with pytest.raises(ValueError):
        convert.encoded_from_numpy(ja.codes, ja.lengths[:-1], ja.validity)


def test_cuda_device_raises_without_gpu(monkeypatch):
    """No quiet move to the CPU: device="cuda" (the default) raises when no
    GPU is present, before any work."""
    assert torch_config.StrsimConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_config.get_config().replace(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.compute("jaro", ["martha"] * 3, ["marhta"] * 3, config=cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.compute("jaro", ["martha"], ["marhta"], config=cfg.replace(host_short_circuit_rows=8192))


def test_import_leaves_jax_out():
    """The port and chip_smoke.py import neither jax nor strsim_tpu (the
    machine with the GPU has no jax)."""
    code = (
        "import sys\n"
        "import strsim_tpu_torch, strsim_tpu_torch.convert, chip_smoke\n"
        "from strsim_tpu_torch.ops import (_build, bigram_cuda, bitwords, dp_fused_cuda, finalize, jaro_cuda,\n"
        "    lcs, lev_jaro_cuda, levenshtein_cuda, multiset_cuda, oracle, osa_cuda, phonetic, stats)\n"
        "from strsim_tpu_torch.models import measures, pipeline\n"
        "from strsim_tpu_torch.utils import encode, metrics\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'strsim_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_chip_smoke_refuses_without_gpu():
    """chip_smoke.py exits non-zero and prints no result where torch sees no
    CUDA device."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
