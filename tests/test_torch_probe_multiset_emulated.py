"""The multiset probe kernels K20-K22 (`csrc/probe_multiset.cu`) run on the
CPU against their plain versions (`strsim_tpu_torch/probes/multiset.py`).

The source is compiled with g++ against `tests/cuda_emulation/cuda_runtime.h`
as `tests/test_torch_lane_kernels_cpu.py` compiles K1-K8 (one thread per CUDA
thread). Its C entry points take tiles from `chip_smoke.make_tiles` (the lane
rows, NUL chars and the word-boundary lengths included), packed as the
pipeline packs them and as separate tiles, and their outputs must equal the
plain versions', exactly, at every width of the narrow ladder: K20 in its
three modes and K22 with GI 4 and 8 on int8 and int32, K21 on int8, each over
more rows than one block holds and a warp short of rows at the end. Skipped
without g++.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from strsim_tpu_torch.ops import _build
from strsim_tpu_torch.probes import multiset as probes
from test_torch_lane_kernels_cpu import CSRC, SHIM, _for_the_cpu, _tiles

ROWS = 150  # two blocks of 128 rows, the second a warp and 22 rows short


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The ctypes library of probe_multiset.cu built for the CPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("probe_multiset")
    for path in CSRC.glob("*.cu*"):
        (out / path.name).write_text(_for_the_cpu(path.read_text()))
    so = out / "probe_multiset.so"
    done = subprocess.run([gxx, "-std=c++17", "-O1", "-pthread", "-shared", "-fPIC", f"-I{SHIM}",
                           f"-I{out}", "-x", "c++", "-o", str(so), str(out / "probe_multiset.cu")],
                          capture_output=True, text=True)
    assert done.returncode == 0, f"g++ probe_multiset.cu:\n{done.stderr[-4000:]}"
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build.LIBRARIES["probe_multiset"][1].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _run(lib, fn, a, b, len_a, *args):
    """fn(a, b, strides, len_a, out, n, L, *args, stream) -> out; asserts
    that it returned cudaSuccess."""
    n, width = a.shape
    out = torch.full((n,), -7, dtype=torch.int32)
    rc = getattr(lib, fn)(a.data_ptr(), b.data_ptr(), a.stride(0), b.stride(0), len_a.data_ptr(),
                          out.data_ptr(), n, width, *args, None)
    assert rc == 0, f"{fn} returned cudaError_t {rc}"
    return out


PACKED = pytest.mark.parametrize("packed", [True, False], ids=["packed", "separate"])
WIDTHS = pytest.mark.parametrize("width", probes.WIDTHS)
DTYPES = pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])


@PACKED
@DTYPES
@WIDTHS
def test_unrolled_kernel_matches_plain(lib, width, dtype, packed):
    """K20 in each mode."""
    a, b, la, _ = _tiles(width, dtype, packed, ROWS)
    for index, mode in enumerate(probes.MODES):
        got = _run(lib, "strsim_probe_multiset_unrolled", a, b, la, a.element_size(), index)
        assert torch.equal(got, probes.multiset_unrolled_plain(a, b, la, mode)), mode


@PACKED
@WIDTHS
def test_swar_kernel_matches_plain(lib, width, packed):
    """K21 on int8, NUL chars on both sides among the tiles' rows."""
    a, b, la, _ = _tiles(width, np.int8, packed, ROWS)
    assert bool((a == 0).any()) and bool((b == 0).any())
    got = _run(lib, "strsim_probe_multiset_swar", a, b, la)
    assert torch.equal(got, probes.multiset_swar_plain(a, b, la))


@PACKED
@DTYPES
@WIDTHS
def test_blocked_kernel_matches_plain(lib, width, dtype, packed):
    """K22 with 4 and 8 a-positions a read."""
    a, b, la, _ = _tiles(width, dtype, packed, ROWS)
    for gi in probes.GROUPS:
        got = _run(lib, "strsim_probe_multiset_blocked", a, b, la, a.element_size(), gi)
        assert torch.equal(got, probes.multiset_blocked_plain(a, b, la, gi)), gi


def test_kernels_refuse_what_they_were_not_built_for(lib):
    """Widths off the ladder, an unknown mode or GI, an element size other
    than 1 or 4: cudaErrorInvalidValue, no launch."""
    a, b, la, _ = _tiles(32, np.int8, True, 8)
    out = torch.empty(8, dtype=torch.int32)

    def call(fn, a, *args):
        return getattr(lib, fn)(a.data_ptr(), a.data_ptr(), a.stride(0), a.stride(0),
                                la.data_ptr(), out.data_ptr(), 8, a.shape[1], *args, None)

    assert call("strsim_probe_multiset_unrolled", a, 1, 0) != 0
    assert call("strsim_probe_multiset_swar", a) != 0
    assert call("strsim_probe_multiset_blocked", a, 1, 4) != 0
    a = a[:, :31]
    assert call("strsim_probe_multiset_unrolled", a, 1, 3) != 0
    assert call("strsim_probe_multiset_unrolled", a, 2, 0) != 0
    assert call("strsim_probe_multiset_blocked", a, 1, 6) != 0
