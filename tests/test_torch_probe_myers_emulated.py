"""The Myers and fused lev + jaro probe kernels K16-K19
(`csrc/probe_myers.cu`, `csrc/probe_fused_lj.cu`) run on the CPU against
their plain versions (`strsim_tpu_torch/probes/myers.py`).

The sources are compiled with g++ against `tests/cuda_emulation/cuda_runtime.h`
as `tests/test_torch_lane_kernels_cpu.py` compiles K1-K8 (one thread per CUDA
thread). Their C entry points take tiles from `chip_smoke.make_tiles` (the
lane rows and the word-boundary lengths included), packed as the pipeline
packs them and as separate tiles, and their outputs must equal the plain
versions', exactly: K16 (both loop forms, over `pattern_eq_words`), K17 on
int8 and int32 and K18 at w7, w15, w31 and w32, K19 at w15 and w31, each
over more rows than one block holds and a warp short of rows at the end.
Skipped without g++.
"""
import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from strsim_tpu_torch.ops import _build
from strsim_tpu_torch.probes import myers as probes
from test_torch_lane_kernels_cpu import CSRC, SHIM, _for_the_cpu, _tiles

LIBRARIES = ("probe_myers", "probe_fused_lj")
ROWS = 150  # two blocks of 128 rows, the second a warp and 22 rows short


@pytest.fixture(scope="module")
def probe_libs(tmp_path_factory):
    """{library: ctypes library} of the two sources built for the CPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("probe_myers")
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


def _tile_call(lib, fn, a, b, len_a, len_b, outs, *args):
    """fn(a, b, strides, lengths, *outs, n, L, *args, stream); returns its
    cudaError_t."""
    n, width = a.shape
    return getattr(lib, fn)(a.data_ptr(), b.data_ptr(), a.stride(0), b.stride(0),
                            len_a.data_ptr(), len_b.data_ptr(), *(o.data_ptr() for o in outs),
                            n, width, *args, None)


def _out(n):
    return torch.empty(n, dtype=torch.int32)


PACKED = pytest.mark.parametrize("packed", [True, False], ids=["packed", "separate"])
WIDTHS = pytest.mark.parametrize("width", [7, 15, 31, 32])


@pytest.mark.parametrize("unroll", [0, 1], ids=["scan", "unroll"])
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@WIDTHS
def test_eq_scan_kernel_matches_plain(probe_libs, width, dtype, unroll):
    """K16 over the words of each tile."""
    a, b, la, lb = _tiles(width, dtype, True, ROWS)
    eq = probes.pattern_eq_words(a, b)
    got = _out(ROWS)
    assert probe_libs["probe_myers"].strsim_probe_myers_eq_scan(
        eq.data_ptr(), la.data_ptr(), lb.data_ptr(), got.data_ptr(), ROWS, width, unroll, None) == 0
    assert torch.equal(got, probes.myers_eq_scan_plain(eq, la, lb, bool(unroll)))


@PACKED
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@WIDTHS
def test_ineq_kernel_matches_plain(probe_libs, width, dtype, packed):
    """K17 on both tile dtypes."""
    a, b, la, lb = _tiles(width, dtype, packed, ROWS)
    got = _out(ROWS)
    assert _tile_call(probe_libs["probe_myers"], "strsim_probe_myers_ineq", a, b, la, lb, (got,),
                      a.element_size()) == 0
    assert torch.equal(got, probes.myers_ineq_plain(a, b, la, lb))


@PACKED
@WIDTHS
def test_swar_kernel_matches_plain(probe_libs, width, packed):
    """K18 on int8 at one to eight words of a's bytes."""
    a, b, la, lb = _tiles(width, np.int8, packed, ROWS)
    got = _out(ROWS)
    assert _tile_call(probe_libs["probe_myers"], "strsim_probe_myers_swar", a, b, la, lb,
                      (got,)) == 0
    assert torch.equal(got, probes.myers_swar_plain(a, b, la, lb))


@PACKED
@pytest.mark.parametrize("width", [15, 31])
def test_fused_kernel_matches_plain(probe_libs, width, packed):
    """K19's raw (lev, m, t) at both transpose tiles (16 and 32)."""
    a, b, la, lb = _tiles(width, np.int8, packed, ROWS)
    got = [_out(ROWS) for _ in range(3)]
    assert _tile_call(probe_libs["probe_fused_lj"], "strsim_probe_fused_lev_jaro", a, b, la, lb,
                      got) == 0
    for g, w in zip(got, probes.fused_lev_jaro_plain(a, b, la, lb)):
        assert torch.equal(g, w)


def test_kernels_refuse_widths_past_their_word(probe_libs):
    a, b, la, lb = _tiles(33, np.int8, True, 8)
    lib = probe_libs["probe_myers"]
    assert _tile_call(lib, "strsim_probe_myers_ineq", a, b, la, lb, (_out(8),), 1) != 0
    assert _tile_call(lib, "strsim_probe_myers_swar", a, b, la, lb, (_out(8),)) != 0
    a, b, la, lb = _tiles(32, np.int8, True, 8)
    outs = [_out(8) for _ in range(3)]
    assert _tile_call(probe_libs["probe_fused_lj"], "strsim_probe_fused_lev_jaro", a, b, la, lb,
                      outs) != 0
