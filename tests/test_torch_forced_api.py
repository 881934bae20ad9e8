"""The forced-implementation path through strsim_tpu_torch's API on the CPU:
compute and compute_many under the configs of tests/test_differential.py
(levenshtein_impl="pallas", jaro_impl="pallas" and the implementation
matrix) and under each family forced to each of its values, byte-identical
to the oracle on the golden corpus and on seeded Unicode columns, and to
strsim_tpu.compute under the same config on the rows of at most 31 chars;
config_from_jax carrying the overrides; no fallback without a GPU."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import strsim_tpu as jst
import strsim_tpu_torch as tst
from strsim_tpu_torch import config as torch_config
from strsim_tpu_torch import convert
from strsim_tpu_torch.config import IMPL_VALUES
from strsim_tpu_torch.models import pipeline as tpipe
from strsim_tpu_torch.ops import _build
from test_differential import _corpus
from test_torch_ext_api import ALL, FIVE, columns, oracle_scores

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the forced configurations chip_smoke.py drives)

torch.set_num_threads(1)

# tests/test_differential.py:50-52 and :61-69
DIFFERENTIAL = list(chip_smoke.DIFFERENTIAL)
SINGLE = chip_smoke.single_overrides()


def _id(overrides):
    return "+".join(f"{k[:-5]}={v}" for k, v in overrides.items())


def port_config(**overrides):
    return torch_config.StrsimConfig(device="cpu", host_short_circuit_rows=0,
                                     equal_fast_path=False, **overrides)


@pytest.mark.parametrize("overrides", DIFFERENTIAL, ids=[_id(o) for o in DIFFERENTIAL])
def test_differential_configs_match_oracle(golden, overrides):
    """The golden corpus and seeded Unicode columns (buckets 7..127, empty
    sides, len-1 pairs, nulls), every row on the device path."""
    cfg = port_config(**overrides)
    for measure, cases in golden.items():
        col_a = [c[0] for c in cases]
        col_b = [c[1] for c in cases]
        got = tst.compute(measure, col_a, col_b, config=cfg)
        assert got.tobytes() == oracle_scores(measure, col_a, col_b).tobytes(), measure
    col_a, col_b = columns(len(overrides), 140)
    out = tst.compute_many(ALL, col_a, col_b, config=cfg)
    for m in ALL:
        assert out[m].tobytes() == oracle_scores(m, col_a, col_b).tobytes(), m


@pytest.mark.parametrize("overrides", DIFFERENTIAL, ids=[_id(o) for o in DIFFERENTIAL])
def test_differential_configs_match_strsim_tpu(overrides):
    """Byte-identical to strsim_tpu.compute_many under the same config on
    test_differential's corpus cut to rows of at most 31 chars (the JAX
    engine's forced Pallas kernels run in interpret mode here)."""
    rows = [(a, b) for a, b in _corpus() if max(len(a), len(b)) <= 31]
    col_a = [a for a, _ in rows]
    col_b = [b for _, b in rows]
    want = jst.compute_many(FIVE, col_a, col_b, config=jst.get_config().replace(
        equal_fast_path=False, host_short_circuit_rows=0, **overrides))
    got = tst.compute_many(FIVE, col_a, col_b, config=port_config(**overrides))
    for m in FIVE:
        assert got[m].tobytes() == want[m].tobytes(), m


# what each family serves, beside levenshtein and jaro so that the forced
# value meets the fused kernels' conditions (K5 and K6 when it keeps them)
FAMILY_MEASURES = {
    "levenshtein": ("levenshtein", "jaro", "osa"),
    "jaro": ("levenshtein", "jaro", "jaro_winkler"),
    "multiset": ("levenshtein", "jaro", "jaccard", "cosine"),
    "osa": ("levenshtein", "jaro", "osa"),
    "bigram": ("jaccard_bigram", "sorensen_dice_bigram", "hamming"),
    "lcs": ("levenshtein", "jaro", "lcs_seq", "indel"),
}


@pytest.mark.parametrize("overrides", SINGLE, ids=[_id(o) for o in SINGLE])
def test_each_forced_value_matches_oracle(overrides):
    (key,) = overrides
    measures = FAMILY_MEASURES[key[:-5]]
    col_a, col_b = columns(7, 48)
    col_a += ["x", "Robert", "x" * 70]
    col_b += ["x", "Rupert", "xy" * 40]
    out = tst.compute_many(measures, col_a, col_b, config=port_config(**overrides))
    for m in measures:
        assert out[m].tobytes() == oracle_scores(m, col_a, col_b).tobytes(), m


def test_config_from_jax_carries_the_overrides():
    overrides = dict(levenshtein_impl="pallas", jaro_impl="pallas", multiset_impl="table",
                     osa_impl="myers", bigram_impl="xla", lcs_impl="pallas_scan")
    cfg = convert.config_from_jax(dataclasses.asdict(jst.get_config().replace(**overrides)),
                                  device="cpu")
    assert cfg.impls() == {k[:-5]: v for k, v in overrides.items()}
    assert not {f"{family}_impl" for family in IMPL_VALUES} & convert.DROPPED_FIELDS
    with pytest.raises(ValueError, match="jaro_impl"):
        convert.config_from_jax({"jaro_impl": "mosaic"})


def test_forced_path_reaches_its_wrappers(monkeypatch):
    """compute and compute_many under ("pallas", "pallas") call the K9 and
    K10 wrappers on every bucket (test_torch_forced_routes.py holds the
    plain forms past 512)."""
    from strsim_tpu_torch.ops import jaro_flags_cuda, levenshtein_wavefront_cuda, stats

    calls = []
    for module, route in ((levenshtein_wavefront_cuda, "levenshtein_wavefront"),
                          (jaro_flags_cuda, "jaro_flags")):
        fn = module.levenshtein_distance if route == "levenshtein_wavefront" else module.jaro_match_stats
        names, _ = stats._KERNELS[route]

        def spy(a, *args, _fn=fn, _route=route):
            calls.append((_route, a.shape[1]))
            return _fn(a, *args)

        monkeypatch.setitem(stats._KERNELS, route, (names, spy))
    cfg = port_config(levenshtein_impl="pallas", jaro_impl="pallas")
    col_a = ["martha", "dixon" * 20, "abc" * 100]
    col_b = ["marhta", "dicksonx" * 12, "acb" * 100]
    tst.compute_many(("levenshtein", "jaro_winkler"), col_a, col_b, config=cfg)
    tst.compute("jaro", col_a, col_b, config=cfg)
    assert sorted(set(calls)) == [(route, w) for route in ("jaro_flags", "levenshtein_wavefront")
                                  for w in (7, 127, 383)]
    assert _build.launch_counts().get("jaro_flags", 0) == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("overrides,kernels", [
    ({"multiset_impl": "pallas_hist"},
     {"lev_jaro_fused", "multiset_hist", "levenshtein_myers", "jaro_scan"}),
    (chip_smoke.FORCED, {"levenshtein_wavefront", "jaro_flags", "multiset_rank", "multiset_hist"}),
    ({"levenshtein_impl": "myers", "jaro_impl": "bitmask", "multiset_impl": "xla"}, {"jaro_scan"}),
])
def test_routed_kernels_from_run_metrics(overrides, kernels):
    """chip_smoke.routed_kernels reads each bucket's width and tile dtype
    from a run's RunMetrics and names the kernels the router sends them to:
    an ASCII bucket at w7 (int8) and w95 (int8), a non-ASCII one at w15."""
    from strsim_tpu_torch.utils.metrics import RunMetrics

    cfg = port_config(**overrides)
    rm = RunMetrics()
    tpipe.compute_scores(["martha", "ab" * 40, "смит" * 3], ["marhta", "ba" * 41, "смитт" * 3],
                         ("levenshtein", "jaro", "jaccard"), config=cfg, metrics=rm)
    assert {w: bm.dtype for w, bm in rm.buckets.items()} == {7: "int8", 15: "int32", 95: "int8"}
    assert chip_smoke.routed_kernels(rm, ("levenshtein", "jaro", "jaccard"), cfg) == kernels


def test_block_rows_cap_forced_plain_multiset():
    cfg = port_config(multiset_impl="table")
    assert tpipe._block_rows(511, cfg, ("jaccard",), np.int8) == 32768
    assert tpipe._block_rows(511, port_config(), ("jaccard",), np.int8) == cfg.max_batch_block
    assert tpipe._block_rows(511, port_config(levenshtein_impl="pallas", jaro_impl="pallas"),
                             FIVE, np.int8) == cfg.max_batch_block


def test_no_fallback_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_config.StrsimConfig(levenshtein_impl="pallas", jaro_impl="pallas",
                                    host_short_circuit_rows=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tst.compute("levenshtein", ["martha"], ["marhta"], config=cfg)
