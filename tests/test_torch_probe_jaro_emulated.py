"""The jaro probe kernels K12-K15 (`csrc/probe_jaro.cu`) run on the CPU
against their plain versions (`strsim_tpu_torch/probes/jaro.py`).

The source is compiled with g++ against `tests/cuda_emulation/cuda_runtime.h`
as `tests/test_torch_lane_kernels_cpu.py` compiles K1-K8 (one thread per CUDA
thread, each warp collective a rendezvous of its lanes). Its C entry points
take tiles from `chip_smoke.make_tiles` (the lane rows and the word-boundary
lengths included), packed as the pipeline packs them and as separate tiles,
and their outputs must equal the plain versions', exactly: K12 at w7 and
w32, K13 at w95, w255 and w511, K14 (both clips) at w95, w383 and w511, K15
in every mode at w15, w31, w63 and w511. Skipped without g++.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from strsim_tpu_torch.ops import _build
from strsim_tpu_torch.probes import jaro as probes
from test_torch_lane_kernels_cpu import CSRC, SHIM, _for_the_cpu, _tiles


@pytest.fixture(scope="module")
def probe_lib(tmp_path_factory):
    """csrc/probe_jaro.cu built for the CPU, its entry points typed."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("probe_jaro")
    for path in CSRC.glob("*.cu*"):
        (out / path.name).write_text(_for_the_cpu(path.read_text()))
    lib = out / "probe_jaro.so"
    done = subprocess.run([gxx, "-std=c++17", "-O1", "-pthread", "-shared", "-fPIC", f"-I{SHIM}",
                           f"-I{out}", "-x", "c++", "-o", str(lib), str(out / "probe_jaro.cu")],
                          capture_output=True, text=True)
    assert done.returncode == 0, f"g++ probe_jaro.cu:\n{done.stderr[-4000:]}"
    lib = ctypes.CDLL(str(lib))
    for fn, argtypes in _build.LIBRARIES["probe_jaro"][1].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _outs(n, k):
    return [torch.empty(n, dtype=torch.int32) for _ in range(k)]


def _call(lib, fn, a, b, len_a, len_b, outs, *args, elem_bytes=None):
    """fn(a, b, strides, lengths, *outs, n, L, elem_bytes, *args, stream);
    returns its cudaError_t."""
    n, width = a.shape
    return getattr(lib, fn)(a.data_ptr(), b.data_ptr(), a.stride(0), b.stride(0),
                            len_a.data_ptr(), len_b.data_ptr(), *(o.data_ptr() for o in outs),
                            n, width, elem_bytes or a.element_size(), *args, None)


def _rows(width):
    """Enough rows for several blocks: 8 rows a block at G = 16, 32 at G = 4."""
    return 40 if width < 300 else 24


def _assert_equal(got, want, what):
    for g, w in zip(got, want):
        assert torch.equal(g, w), what


PACKED = pytest.mark.parametrize("packed", [True, False], ids=["packed", "separate"])
DTYPES = pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])


@PACKED
@DTYPES
@pytest.mark.parametrize("width", [7, 32])
def test_flags_scan_kernel_matches_plain(probe_lib, width, dtype, packed):
    """K12: m and the two flag words, G = 1, 100 rows (a warp short of rows)."""
    a, b, la, lb = _tiles(width, dtype, packed, 100)
    got = _outs(a.shape[0], 3)
    assert _call(probe_lib, "strsim_probe_jaro_flags", a, b, la, lb, got) == 0
    _assert_equal(got, probes.jaro_flags_scan_plain(a, b, la, lb), "flags")


@PACKED
@pytest.mark.parametrize("width", [95, 255, 511])
def test_packed_t_kernel_matches_plain(probe_lib, width, packed):
    """K13's raw stats on int8 at G = 4, 8 and 16."""
    a, b, la, lb = _tiles(width, np.int8, packed, _rows(width))
    got = _outs(a.shape[0], 2)
    assert _call(probe_lib, "strsim_probe_jaro_packed_t", a, b, la, lb, got) == 0
    _assert_equal(got, probes.packed_t_stats_plain(a, b, la, lb), "packed_t")


def test_packed_t_kernel_refuses_int32(probe_lib):
    a, b, la, lb = _tiles(95, np.int32, True, 8)
    assert _call(probe_lib, "strsim_probe_jaro_packed_t", a, b, la, lb, _outs(8, 2)) != 0


@pytest.mark.parametrize("clip", probes.CLIPS)
@PACKED
@DTYPES
@pytest.mark.parametrize("width", [95, 383, 511])
def test_clipped_kernel_matches_plain(probe_lib, width, dtype, packed, clip):
    """K14 at G = 4 and 16, both dtypes, the warp's window union and the
    row's own window: the raw (m, t) of K2's scan."""
    a, b, la, lb = _tiles(width, dtype, packed, _rows(width))
    got = _outs(a.shape[0], 2)
    assert _call(probe_lib, "strsim_probe_jaro_clipped", a, b, la, lb, got,
                 probes.CLIPS.index(clip)) == 0
    _assert_equal(got, probes.jaro_clipped_plain(a, b, la, lb, clip), clip)


@pytest.mark.parametrize("mode", probes.MODES)
@DTYPES
@pytest.mark.parametrize("width", [15, 31, 63, 511])
def test_ablated_kernel_matches_plain(probe_lib, width, dtype, mode):
    """K15 in every mode at G = 1, 2 and 16, on packed tiles."""
    a, b, la, lb = _tiles(width, dtype, True, _rows(width))
    got = _outs(a.shape[0], 2)
    assert _call(probe_lib, "strsim_probe_jaro_ablated", a, b, la, lb, got,
                 probes.MODES.index(mode)) == 0
    _assert_equal(got, probes.jaro_ablated_plain(a, b, la, lb, mode), mode)
