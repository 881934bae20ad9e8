"""The stat router under forced per-family overrides against the JAX
engine's: for the implementation matrix of tests/test_differential.py, the
forced-Pallas pair ("pallas", "pallas") and each family forced to each of
its values, `stat_routes` names the port's counterpart of every function
strsim_tpu.ops.stats.compute_stats calls on a TPU, on the measure sets and
widths of test_torch_ext_api.test_stat_routes_follow_the_jax_router."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import strsim_tpu as jst
import strsim_tpu_torch as tst
from strsim_tpu_torch.ops import stats as torch_stats
from test_torch_ext_api import SOAK_SETS, _jax_routes

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the forced configurations chip_smoke.py drives)

MEASURE_SETS = SOAK_SETS + [("osa",), ("levenshtein", "osa"), ("jaro", "osa"),
                            ("levenshtein", "jaro", "lcs_seq"), ("hamming",), ("soundex",)]
WIDTHS = (15, 63, 95, 511)
# tests/test_differential.py:50-52 and :61-69, then each family forced to each value
FORCED = [*chip_smoke.DIFFERENTIAL, *chip_smoke.single_overrides()]


def _id(overrides):
    return "+".join(f"{k[:-5]}={v}" for k, v in overrides.items())


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("overrides", FORCED, ids=[_id(o) for o in FORCED])
def test_forced_routes_follow_the_jax_router(monkeypatch, overrides, dtype):
    jax_cfg = jst.get_config().replace(**overrides)
    impls = tst.StrsimConfig(device="cpu", **overrides).impls()
    tdtype = torch.int8 if dtype == np.int8 else torch.int32
    for width in WIDTHS:
        for measures in MEASURE_SETS:
            want = _jax_routes(monkeypatch, measures, width, dtype, jax_cfg)
            got = torch_stats.stat_routes(measures, width, tdtype, impls)
            assert got == want, (measures, width)


@pytest.mark.parametrize("impls,width,dtype,routes", [
    ({"levenshtein": "pallas", "jaro": "pallas"}, 31, torch.int8,
     {"lev_d": "levenshtein_wavefront", "jaro_m": "jaro_flags", "jaro_t": "jaro_flags",
      "prefix": "plain", "inter": "multiset_rank"}),
    ({"levenshtein": "pallas", "jaro": "pallas"}, 1023, torch.int8,
     {"lev_d": "plain", "jaro_m": "plain", "inter": "plain"}),
    ({"levenshtein": "pallas_scan", "jaro": "pallas_scan"}, 31, torch.int32,
     {"lev_d": "levenshtein_myers", "jaro_m": "jaro_scan"}),
    ({"levenshtein": "pallas_scan", "jaro": "pallas_scan_h"}, 31, torch.int32,
     {"lev_d": "lev_jaro_fused", "inter": "lev_jaro_fused"}),
    ({"multiset": "pallas_hist"}, 31, torch.int8, {"inter": "multiset_hist", "lev_d": "lev_jaro_fused"}),
    ({"multiset": "pallas_hist"}, 95, torch.int32, {"inter": "plain"}),
    ({"multiset": "table"}, 15, torch.int8, {"inter": "plain", "jaro_m": "lev_jaro_fused"}),
    ({"jaro": "scan"}, 15, torch.int8, {"jaro_m": "jaro_scan", "lev_d": "levenshtein_myers"}),
])
def test_forced_routes_table(impls, width, dtype, routes):
    got = torch_stats.stat_routes(("levenshtein", "jaro", "jaccard"), width, dtype, impls)
    for stat, route in routes.items():
        assert got[stat] == route, stat


def test_resolve_impls_auto_and_errors():
    auto = torch_stats.resolve_impls(31, torch.int8)
    assert auto == {"levenshtein": "pallas_scan", "jaro": "pallas_scan", "multiset": "pallas_scan",
                    "osa": "pallas_scan", "bigram": "pallas_scan", "lcs": "pallas_scan"}
    wide = torch_stats.resolve_impls(1023, torch.int32)
    assert wide == {"levenshtein": "myers", "jaro": "bitmask", "multiset": "chunked",
                    "osa": "myers", "bigram": "xla", "lcs": "xla"}
    assert torch_stats.resolve_impls(31, torch.int32)["jaro"] == "pallas_scan_f"
    assert torch_stats.resolve_impls(255, torch.int8, {"jaro": "xla"})["jaro"] == "xla"
    assert torch_stats.resolve_impls(31, torch.int8, tst.StrsimConfig().impls()) == auto
    with pytest.raises(ValueError, match="levenshtein_impl"):
        tst.StrsimConfig(levenshtein_impl="cuda")
    with pytest.raises(ValueError, match="jaro_impl"):
        tst.StrsimConfig(jaro_impl="nope")
