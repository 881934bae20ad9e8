"""The lane-group CUDA kernels run on the CPU against their plain versions.

K1 (`csrc/levenshtein_myers.cu`), K6 (`csrc/dp_fused.cu`, every subset it
takes), K7 (`csrc/osa_scan.cu`), which share the scan kernel of
`csrc/dp_scan.cuh`, K2 (`csrc/jaro_scan.cu`), K5 (`csrc/lev_jaro_fused.cu`,
the four output sets `chip_smoke.py` times), K8 (`csrc/bigram.cu`) and K3/K4
(`csrc/multiset.cu`) are compiled with g++
against `tests/cuda_emulation/cuda_runtime.h`, which runs one thread per CUDA
thread and each warp collective as a rendezvous of its lanes. Their C entry
points then take numpy tiles from `chip_smoke.make_tiles` (the lane rows
included), packed as the pipeline packs them and as separate tiles, and
their outputs must equal the plain versions', exactly. This holds the
kernels' lane logic (the carry-lookahead ballots, the shift-ins from below
and from above, the int8 table with its sign mask for codes below 0, the
window masks, the rank slots of the transposition count, the multiset and
bigram counts by greedy consumption, K4's packed histograms with their
shared-memory atomics, the staging of packed and strided rows) on a
machine without a card; speed and the compiler for the card are the card's
tests (`tests/test_torch_cuda.py`, `chip_smoke.py`). Skipped without g++.
"""
import ctypes
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from strsim_tpu_torch.ops import (_build, bigram_cuda, dp_fused_cuda, jaro_cuda, lev_jaro_cuda,
                                  levenshtein_cuda, multiset_cuda, osa_cuda)
from torch_tiles import make_packed_tiles

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"
SHIM = Path(__file__).resolve().parent / "cuda_emulation"
LIBRARIES = ("levenshtein_myers", "dp_fused", "osa_scan", "jaro_scan", "lev_jaro_fused", "bigram",
             "multiset")
DP_SUBSETS = ((True, True, True), (True, True, False), (False, True, True), (False, False, True),
              (True, False, True))
# K5's (inter, osa and lcs) output sets, as chip_smoke.kernel_cases times them
FUSED_FLAGS = ((True, False, False), (False, False, False), (True, True, True), (False, True, True))


def _for_the_cpu(source: str) -> str:
    """A kernel source with its launches and its dynamic shared memory in
    the emulation's terms."""
    source = source.replace("extern __shared__ __align__(16) unsigned char smem[];",
                            "unsigned char* smem = emu_smem();")
    return re.sub(r"(\w+)<<<(.*?)>>>\((.*?)\);", r"emu_launch(\2, \1, [&] { \1(\3); });", source,
                  flags=re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """{library: ctypes library} of the LIBRARIES sources built for the CPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("lane_kernels")
    for path in CSRC.glob("*.cu*"):
        (out / path.name).write_text(_for_the_cpu(path.read_text()))

    def build(name):
        lib = out / f"{name}.so"
        done = subprocess.run([gxx, "-std=c++17", "-O1", "-pthread", "-shared", "-fPIC", f"-I{SHIM}",
                               f"-I{out}", "-x", "c++", "-o", str(lib), str(out / f"{name}.cu")],
                              capture_output=True, text=True)
        assert done.returncode == 0, f"g++ {name}.cu:\n{done.stderr[-4000:]}"
        return lib

    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        paths = dict(zip(LIBRARIES, pool.map(build, LIBRARIES)))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _build.LIBRARIES[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _launch(lib, fn, a, b, len_a, len_b, outs, elem_bytes=True):
    """fn(a, b, strides, lengths, *outs, n, L[, elem_bytes], stream)."""
    n, width = a.shape
    rc = getattr(lib, fn)(a.data_ptr(), b.data_ptr(), a.stride(0), b.stride(0),
                          len_a.data_ptr(), len_b.data_ptr(),
                          *(None if o is None else o.data_ptr() for o in outs),
                          n, width, *((a.element_size(),) if elem_bytes else ()), None)
    assert rc == 0


def _tiles(width, dtype, packed, rows):
    codes, lens = make_packed_tiles(np.random.default_rng(width * 29 + 7), rows, width, dtype)
    codes = torch.from_numpy(codes)
    a, b = codes[:, :width], codes[:, width:]
    if not packed:
        a, b = a.contiguous(), b.contiguous()
    return a, b, torch.from_numpy(lens[0].copy()), torch.from_numpy(lens[1].copy())


def _check(emulated, a, b, la, lb):
    n = a.shape[0]
    got = torch.empty(n, dtype=torch.int32)
    _launch(emulated["levenshtein_myers"], "strsim_levenshtein_myers", a, b, la, lb, (got,))
    assert torch.equal(got, levenshtein_cuda.myers_plain(a, b, la, lb))
    got = torch.empty(n, dtype=torch.int32)
    _launch(emulated["osa_scan"], "strsim_osa_distance", a, b, la, lb, (got,))
    assert torch.equal(got, osa_cuda.osa_plain(a, b, la, lb))
    for flags in DP_SUBSETS:
        outs = [torch.empty(n, dtype=torch.int32) if on else None for on in flags]
        _launch(emulated["dp_fused"], "strsim_dp_fused", a, b, la, lb, outs)
        want = dp_fused_cuda.dp_fused_plain(a, b, la, lb, *flags)
        for g, w in zip((o for o in outs if o is not None), want):
            assert torch.equal(g, w), flags
    m, t, prefix = (torch.empty(n, dtype=torch.int32) for _ in range(3))
    _launch(emulated["jaro_scan"], "strsim_jaro_scan", a, b, la, lb, (m, t, prefix))
    want_m, want_t, want_prefix = jaro_cuda.jaro_plain(a, b, la, lb, with_prefix=True)
    assert torch.equal(m, want_m) and torch.equal(t, want_t) and torch.equal(prefix, want_prefix)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "separate"])
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width,rows", [(7, 40), (33, 40), (95, 24), (160, 12)])
def test_lane_kernels_match_plain(emulated, width, rows, dtype, packed):
    """G = 1, 2, 4 and 8 lanes a row; the rows of one warp end at different
    steps, and the last warp of a launch is short of rows."""
    _check(emulated, *_tiles(width, dtype, packed, rows))


@pytest.mark.parametrize("width", [31, 95])
def test_lane_kernels_take_int8_codes_below_zero(emulated, width):
    """int8 chars below 0 inside the lengths, which share their table row
    with the char 128 above: the sign mask keeps them exact."""
    rng = np.random.default_rng(width)
    n = 24
    codes = rng.integers(-128, 128, (n, 2 * width))
    twins = np.array([5, 5 - 128, 127, -1, 0, -128])  # pairs 128 apart share a table row
    codes = np.where(rng.random(codes.shape) < 0.5, codes, twins[rng.integers(0, 6, codes.shape)])
    lens = rng.integers(0, width + 1, (2, n)).astype(np.int32)
    codes = torch.from_numpy(codes.astype(np.int8))
    _check(emulated, codes[:, :width], codes[:, width:], torch.from_numpy(lens[0].copy()),
           torch.from_numpy(lens[1].copy()))


def _check_fused_and_bigram(emulated, a, b, la, lb):
    n = a.shape[0]
    for with_inter, with_osa, with_lcs in FUSED_FLAGS:
        names = lev_jaro_cuda.fields(with_inter, with_osa, with_lcs)
        outs = {f: torch.empty(n, dtype=torch.int32) for f in names}
        _launch(emulated["lev_jaro_fused"], "strsim_lev_jaro_fused", a, b, la, lb,
                [outs.get(f) for f in ("lev_d", "jaro_m", "jaro_t", "prefix", "inter", "osa_d",
                                       "lcs_len")])
        want = lev_jaro_cuda.lev_jaro_plain(a, b, la, lb, with_inter, with_osa, with_lcs)
        for f, w in zip(names, want):
            assert torch.equal(outs[f], w), (f, with_inter, with_osa, with_lcs)
    outs = [torch.empty(n, dtype=torch.int32) for _ in range(3)]
    _launch(emulated["bigram"], "strsim_bigram", a, b, la, lb, outs)
    for f, g, w in zip(("inter2", "ham_m", "eq"), outs, bigram_cuda.bigram_plain(a, b, la, lb)):
        assert torch.equal(g, w), f


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "separate"])
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", [7, 15, 31, 33, 47, 63, 64])
def test_fused_and_bigram_kernels_match_plain(emulated, width, dtype, packed):
    """K5 and K8 at G = 1 (widths <= 32) and G = 2, on 100 rows: a warp
    short of rows at the end, and at G = 2 a second block."""
    _check_fused_and_bigram(emulated, *_tiles(width, dtype, packed, 100))


@pytest.mark.parametrize("width", [7, 15, 31, 63])
def test_fused_and_bigram_kernels_take_int8_codes_below_zero(emulated, width):
    """K5 and K8 on int8 chars below 0 inside the lengths (register
    compares at w7/w15, the table above), few distinct codes so that chars
    and bigrams repeat; padded -1 / -2 past the lengths, as the bigram
    contract needs (no -2 inside them)."""
    rng = np.random.default_rng(width + 1)
    n = 40
    twins = np.array([5, 5 - 128, 127, -1, 0, -128])  # pairs 128 apart share a table row
    a, b = twins[rng.integers(0, 6, (2, n, width))]
    la, lb = rng.integers(0, width + 1, (2, n)).astype(np.int32)
    pos = np.arange(width)[None, :]
    a[pos >= la[:, None]] = -1
    b[pos >= lb[:, None]] = -2
    _check_fused_and_bigram(emulated, *(torch.from_numpy(x.astype(x.dtype if x.ndim == 1 else np.int8))
                                        for x in (a, b, la, lb)))


def _check_multiset(emulated, a, b, la, lb):
    """K3 (widths <= 64) and K4 (int8) against rank_plain / hist_plain."""
    n, width = a.shape
    if width <= multiset_cuda.RANK_MAX_WIDTH:
        got = torch.empty(n, dtype=torch.int32)
        _launch(emulated["multiset"], "strsim_multiset_rank", a, b, la, lb, (got,))
        assert torch.equal(got, multiset_cuda.rank_plain(a, b, la, lb)), "rank"
    if a.dtype == torch.int8:
        got = torch.empty(n, dtype=torch.int32)
        _launch(emulated["multiset"], "strsim_multiset_hist", a, b, la, lb, (got,), elem_bytes=False)
        assert torch.equal(got, multiset_cuda.hist_plain(a, b, la, lb)), "hist"


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "separate"])
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width", [7, 15, 31, 33, 47, 63, 64])
def test_multiset_rank_kernel_matches_plain(emulated, width, dtype, packed):
    """K3 at G = 1 (widths <= 32) and G = 2 on 100 rows (a warp short of
    rows; at G = 2 a second block), and K4 on the same int8 tiles."""
    _check_multiset(emulated, *_tiles(width, dtype, packed, 100))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "separate"])
@pytest.mark.parametrize("width", [95, 255, 511])
def test_multiset_hist_kernel_matches_plain(emulated, width, packed):
    """K4 at R = 4, 8 and 16 lanes a row (its narrow widths run in
    test_multiset_rank_kernel_matches_plain) on 149 rows: more than one
    block, and a last warp short of rows."""
    _check_multiset(emulated, *_tiles(width, np.int8, packed, 149))


@pytest.mark.parametrize("width", [7, 31, 63, 64, 95, 511])
def test_multiset_kernels_on_edge_rows(emulated, width):
    """int8 chars below 0 inside the lengths (K3 counts them, K4 does not),
    few distinct chars so that they repeat, one char put more often in a
    than in b or the other way round, sides of length 0 and 1, and lengths
    past the width (both kernels clamp them)."""
    rng = np.random.default_rng(width + 3)
    n = 149
    twins = np.array([5, 5 - 128, 127, -1, 0, -128, -2])
    a, b = twins[rng.integers(0, twins.size, (2, n, width))]
    rows = np.arange(n)
    rep = rows[rows % 4 == 0]  # one char, more often in one side
    more_a = rng.random(rep.size) < 0.5
    c = rng.integers(0, 128, rep.size)[:, None]
    a[rep] = np.where(rng.random((rep.size, width)) < np.where(more_a, 0.8, 0.3)[:, None], c, a[rep])
    b[rep] = np.where(rng.random((rep.size, width)) < np.where(more_a, 0.3, 0.8)[:, None], c, b[rep])
    la, lb = rng.integers(0, width + 1, (2, n))
    la[rows % 5 == 1] = rows[rows % 5 == 1] % 2  # 0 or 1
    lb[rows % 5 == 2] = rows[rows % 5 == 2] % 2
    la[rows % 7 == 3] = width + 5
    lb[rows % 7 == 4] = width + 1
    pos = np.arange(width)[None, :]
    a[pos >= la[:, None]] = -1
    b[pos >= lb[:, None]] = -2
    _check_multiset(emulated, *(torch.from_numpy(x.astype(np.int8)) for x in (a, b)),
                    *(torch.from_numpy(x.astype(np.int32)) for x in (la, lb)))
