"""strsim_tpu_torch stat kernels' plain torch versions against strsim_tpu.

Every ladder width 7..511, int8 and int32 tiles, the same numpy-seeded tiles
through both packages; all comparisons are exact (integer stats):

  * myers_plain        vs levenshtein_distance_myers (XLA)
  * jaro_plain         vs jaro_match_stats_bitmask (XLA)
  * rank_plain         vs multiset_intersection_chunked (XLA)
  * hist_plain         vs multiset_intersection_chunked (8-bit tiles)
  * shared_prefix_length / row_equal vs their jnp counterparts
  * lev_jaro_plain     vs all of the above at once (widths <= 64)

(test_torch_stats_pallas.py holds them against the Pallas kernels in
interpret mode). On CPU tensors each kernel wrapper runs its plain version,
so the wrappers and the compute_stats router are held to the same
references.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from strsim_tpu.ops import stats as jax_stats
from strsim_tpu.ops.jaro_bitmask import jaro_match_stats_bitmask
from strsim_tpu.ops.levenshtein_myers import levenshtein_distance_myers
from strsim_tpu.ops.multiset_loop import multiset_intersection_chunked
from strsim_tpu_torch.ops import _build, jaro_cuda, lev_jaro_cuda, levenshtein_cuda, multiset_cuda
from strsim_tpu_torch.ops import stats as torch_stats
from torch_tiles import LADDER, as_jax, as_torch, assert_same, make_tiles

@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", LADDER)
def test_plain_stats_match_xla(width, dtype):
    tiles = make_tiles(width * 7 + np.dtype(dtype).itemsize, 67 if width > 63 else 131, width, dtype)
    ta, tb, tla, tlb = as_torch(*tiles)
    ja, jb, jla, jlb = as_jax(*tiles)

    lev = levenshtein_distance_myers(ja, jb, jla, jlb)
    assert_same(levenshtein_cuda.myers_plain(ta, tb, tla, tlb), lev)
    assert_same(levenshtein_cuda.levenshtein_distance(ta, tb, tla, tlb), lev)

    m, t = jaro_match_stats_bitmask(ja, jb, jla, jlb)
    pm, pt = jaro_cuda.jaro_plain(ta, tb, tla, tlb)
    assert_same(pm, m)
    assert_same(pt, t)
    wm, wt = jaro_cuda.jaro_match_stats(ta, tb, tla, tlb)
    assert_same(wm, m)
    assert_same(wt, t)

    inter = multiset_intersection_chunked(ja, jb, jla, jlb)
    assert_same(multiset_cuda.rank_plain(ta, tb, tla, tlb), inter)
    if dtype == np.int8:
        assert_same(multiset_cuda.hist_plain(ta, tb, tla, tlb), inter)
        assert_same(multiset_cuda.multiset_intersection_hist(ta, tb, tla, tlb), inter)
    if width <= multiset_cuda.RANK_MAX_WIDTH:
        assert_same(multiset_cuda.multiset_intersection_rank(ta, tb, tla, tlb), inter)

    prefix = jax_stats.shared_prefix_length(ja, jb)
    assert_same(torch_stats.shared_prefix_length(ta, tb), prefix)
    assert_same(torch_stats.row_equal(ta, tb, tla, tlb), jax_stats.row_equal(ja, jb, jla, jlb))

    five = ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice")
    routed = torch_stats.compute_stats(ta, tb, tla, tlb, five)
    assert sorted(routed) == ["inter", "jaro_m", "jaro_t", "lev_d", "prefix"]
    for field, want in (("lev_d", lev), ("jaro_m", m), ("jaro_t", t),
                        ("inter", inter), ("prefix", prefix)):
        assert_same(routed[field], want)


@pytest.mark.parametrize("with_inter", [True, False], ids=["inter", "no_inter"])
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", [7, 31, 47, 64])
def test_fused_plain_matches_xla(width, dtype, with_inter):
    """The fused kernel's wrapper (its plain version on CPU tiles) gives the
    stats of the separate XLA formulations, in `fields` order."""
    tiles = make_tiles(width * 5 + np.dtype(dtype).itemsize, 97, width, dtype)
    ja, jb, jla, jlb = as_jax(*tiles)
    want = {"lev_d": levenshtein_distance_myers(ja, jb, jla, jlb),
            "prefix": jax_stats.shared_prefix_length(ja, jb),
            "inter": multiset_intersection_chunked(ja, jb, jla, jlb)}
    want["jaro_m"], want["jaro_t"] = jaro_match_stats_bitmask(ja, jb, jla, jlb)
    got = lev_jaro_cuda.lev_jaro_stats(*as_torch(*tiles), with_inter=with_inter)
    names = lev_jaro_cuda.fields(with_inter)
    assert len(got) == len(names) == 4 + with_inter
    for name, value in zip(names, got):
        assert_same(value, want[name])


@pytest.mark.parametrize("width,measures,expect", [
    (31, ("levenshtein", "jaro", "jaro_winkler", "jaccard", "sorensen_dice"), True),
    (63, ("levenshtein", "jaro_winkler"), False),
    (64, ("jaro", "levenshtein", "jaccard"), True),
    (31, ("levenshtein", "jaccard"), None),
    (31, ("jaro", "jaccard"), None),
    (95, ("levenshtein", "jaro", "jaccard"), None),
])
def test_router_takes_fused_kernel(monkeypatch, width, measures, expect):
    """lev and jaro together at widths <= 64 go to the fused kernel, with
    the multiset step when inter is needed too (strsim_tpu/ops/stats.py:
    326-374); every other request takes the separate kernels."""
    calls = []
    real = lev_jaro_cuda.lev_jaro_stats

    def spy(a, b, la, lb, with_inter=False, **flags):
        calls.append(with_inter)
        return real(a, b, la, lb, with_inter, **flags)

    monkeypatch.setattr(lev_jaro_cuda, "lev_jaro_stats", spy)
    a, b, la, lb = as_torch(*make_tiles(width, 24, width, np.int8))
    out = torch_stats.compute_stats(a, b, la, lb, measures)
    assert calls == ([] if expect is None else [expect])
    need = {f for m in measures for f in torch_stats.STAT_FIELDS[m]}
    assert set(out) == need


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
def test_extend_width_plain_stats_match_xla(dtype):
    """Extend buckets (> 511) take the plain versions on every device."""
    width = 1023
    tiles = make_tiles(5, 16, width, dtype)
    ta, tb, tla, tlb = as_torch(*tiles)
    ja, jb, jla, jlb = as_jax(*tiles)
    out = torch_stats.compute_stats(ta, tb, tla, tlb, ("levenshtein", "jaro", "jaccard"))
    assert_same(out["lev_d"], levenshtein_distance_myers(ja, jb, jla, jlb))
    m, t = jaro_match_stats_bitmask(ja, jb, jla, jlb)
    assert_same(out["jaro_m"], m)
    assert_same(out["jaro_t"], t)
    assert_same(out["inter"], multiset_intersection_chunked(ja, jb, jla, jlb))


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
def test_wrappers_take_column_slices_of_the_packed_tile(dtype):
    """The pipeline hands the kernels column slices of one [B, 2L] tile (row
    stride 2L, no copy); the result equals that of contiguous tiles."""
    width = 47
    a, b, la, lb = make_tiles(17, 50, width, dtype)
    packed = torch.from_numpy(np.concatenate([a, b], axis=1))
    sa, sb = packed[:, :width], packed[:, width:]
    assert sa.stride() == (2 * width, 1) and not sa.is_contiguous()
    ta, tb, tla, tlb = as_torch(a, b, la, lb)
    assert torch.equal(levenshtein_cuda.levenshtein_distance(sa, sb, tla, tlb),
                       levenshtein_cuda.myers_plain(ta, tb, tla, tlb))
    for got, want in zip(jaro_cuda.jaro_match_stats(sa, sb, tla, tlb),
                         jaro_cuda.jaro_plain(ta, tb, tla, tlb)):
        assert torch.equal(got, want)
    assert torch.equal(multiset_cuda.multiset_intersection_rank(sa, sb, tla, tlb),
                       multiset_cuda.rank_plain(ta, tb, tla, tlb))


def _good_inputs(width=15, dtype=torch.int8, n=4):
    a = torch.full((n, width), -1, dtype=dtype)
    b = torch.full((n, width), -2, dtype=dtype)
    lens = torch.zeros(n, dtype=torch.int32)
    return a, b, lens, lens.clone()


@pytest.mark.parametrize("case", [
    "int16_tiles", "int64_lengths", "shape_mismatch", "too_wide", "transposed",
    "short_lengths", "meta_device", "hist_int32", "fused_too_wide",
])
def test_wrappers_reject_bad_inputs(case):
    a, b, la, lb = _good_inputs()
    fn = levenshtein_cuda.levenshtein_distance
    error = ValueError
    if case == "int16_tiles":
        a, b, error = a.to(torch.int16), b.to(torch.int16), TypeError
    elif case == "int64_lengths":
        la = la.long()
    elif case == "shape_mismatch":
        b = b[:, :-1]
    elif case == "too_wide":
        a, b, la, lb = _good_inputs(width=levenshtein_cuda.MAX_WIDTH + 1)
    elif case == "transposed":
        a, b, la, lb = _good_inputs(width=4, n=4)
        a = a.t()
    elif case == "short_lengths":
        lb = lb[:-1]
    elif case == "meta_device":
        a, b, la, lb = (x.to("meta") for x in (a, b, la, lb))
    elif case == "hist_int32":
        fn, error = multiset_cuda.multiset_intersection_hist, TypeError
        a, b = a.to(torch.int32), b.to(torch.int32)
    elif case == "fused_too_wide":
        fn = lev_jaro_cuda.lev_jaro_stats
        a, b, la, lb = _good_inputs(width=lev_jaro_cuda.MAX_WIDTH + 1)
    with pytest.raises(error):
        fn(a, b, la, lb)


def test_rank_wrapper_rejects_wide_tiles():
    a, b, la, lb = _good_inputs(width=multiset_cuda.RANK_MAX_WIDTH + 1)
    with pytest.raises(ValueError, match="width"):
        multiset_cuda.multiset_intersection_rank(a, b, la, lb)


@pytest.mark.parametrize("width,dtype,route", [
    (7, torch.int8, "multiset_rank"), (63, torch.int32, "multiset_rank"),
    (64, torch.int8, "multiset_rank"), (95, torch.int8, "multiset_hist"),
    (511, torch.int8, "multiset_hist"), (95, torch.int32, "plain"),
    (1023, torch.int8, "plain"),
])
def test_multiset_route(width, dtype, route):
    """K3 through width 64 (any codepoint), K4 on wide 8-bit tiles, the plain
    version for wide int32 and extend buckets, as in the JAX engine's routing."""
    auto = torch_stats.resolve_impls(width, dtype)["multiset"]
    assert torch_stats.multiset_route(width, dtype, auto) == route


def test_cpu_calls_neither_build_nor_count():
    """CPU tiles run the plain versions: no library is loaded, no launch is
    counted, and nothing was built when the package was imported."""
    _build.reset_launch_counts()
    a, b, la, lb = as_torch(*make_tiles(3, 20, 31, np.int8))
    levenshtein_cuda.levenshtein_distance(a, b, la, lb)
    jaro_cuda.jaro_match_stats(a, b, la, lb)
    multiset_cuda.multiset_intersection_rank(a, b, la, lb)
    multiset_cuda.multiset_intersection_hist(a, b, la, lb)
    lev_jaro_cuda.lev_jaro_stats(a, b, la, lb, with_inter=True)
    assert _build.launch_counts() == {}
    assert _build._loaded == {}


def test_build_target_names_carry_a_source_hash():
    names = {_build._target(name).name for name in _build.LIBRARIES}
    assert len(names) == len(_build.LIBRARIES)
    for name in _build.LIBRARIES:
        target = _build._target(name)
        assert target.parent == _build.BUILD_DIR
        assert target.name.startswith(name + "-") and target.suffix == ".so"
        assert (_build._CSRC / _build.LIBRARIES[name][0]).is_file()


def test_build_dir_follows_the_environment(monkeypatch, tmp_path):
    """$STRSIM_TPU_TORCH_BUILD_DIR wins; a source checkout builds under its
    own build/ directory."""
    monkeypatch.setenv("STRSIM_TPU_TORCH_BUILD_DIR", str(tmp_path))
    assert _build._build_dir() == tmp_path
    monkeypatch.delenv("STRSIM_TPU_TORCH_BUILD_DIR")
    root = Path(_build.__file__).resolve().parents[2]
    assert _build._build_dir() == root / "build" / "strsim_tpu_torch"
