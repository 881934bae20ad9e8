"""K2 (`csrc/jaro_scan.cu`, its kernel in `csrc/jaro_body.cuh`) and K11
(`csrc/warm.cu`) run on the CPU against their plain versions.

The sources are compiled with g++ against `tests/cuda_emulation/cuda_runtime.h`
as `tests/test_torch_lane_kernels_cpu.py` compiles the lane-group kernels
(one thread per CUDA thread, each warp collective a rendezvous of its
lanes). K2's C entry point takes tiles from `chip_smoke.make_tiles` at a
width of every instantiation (G = 1 with 8, 16 and 32 chars a lane, G = 2,
4, 8, 16), int8 and int32, packed as the pipeline packs them and as separate
tiles, with and without its prefix output; (m, t) must equal `jaro_plain`'s
and the prefix `shared_prefix_length`'s, exactly, also on a second device
after a launch on the first (the emulation keeps a kernel's shared memory
limit a device). K11's takes int32 input
and output views at every offset from a 16-byte boundary (the 16-byte path
where the two share it, single accesses where they do not), n < 4 and n % 4
!= 0, and must equal `warm_plain` without touching the elements around the
output. Skipped without g++.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from strsim_tpu_torch.ops import _build, jaro_cuda
from strsim_tpu_torch.ops.stats import shared_prefix_length
from strsim_tpu_torch.ops.warm_cuda import warm_plain
from test_torch_lane_kernels_cpu import CSRC, SHIM, _for_the_cpu, _tiles


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{library: ctypes library} of jaro_scan.cu and warm.cu built for the CPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("jaro_warm")
    for path in CSRC.glob("*.cu*"):
        (out / path.name).write_text(_for_the_cpu(path.read_text()))
    procs = {name: subprocess.Popen(
        [gxx, "-std=c++17", "-O1", "-pthread", "-shared", "-fPIC", f"-I{SHIM}", f"-I{out}",
         "-x", "c++", "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in ("jaro_scan", "warm")}
    loaded = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"g++ {name}.cu:\n{log[-4000:]}"
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, argtypes in _build.LIBRARIES[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        loaded[name] = lib
    return loaded


@pytest.mark.parametrize("with_prefix", [False, True], ids=["m_t", "prefix"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "separate"])
@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
@pytest.mark.parametrize("width,rows", [(7, 40), (15, 40), (23, 40), (33, 40), (95, 40),
                                        (200, 24), (511, 24)])
def test_jaro_scan_matches_plain(libs, width, rows, dtype, packed, with_prefix):
    """Every instantiation: a warp short of rows at the end, and more than
    one block."""
    a, b, la, lb = _tiles(width, dtype, packed, rows)
    n = a.shape[0]
    m, t = torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.int32)
    prefix = torch.full((n,), -7, dtype=torch.int32)
    rc = libs["jaro_scan"].strsim_jaro_scan(
        a.data_ptr(), b.data_ptr(), a.stride(0), b.stride(0), la.data_ptr(), lb.data_ptr(),
        m.data_ptr(), t.data_ptr(), prefix.data_ptr() if with_prefix else None, n, width,
        a.element_size(), None)
    assert rc == 0
    want_m, want_t = jaro_cuda.jaro_plain(a, b, la, lb)
    assert torch.equal(m, want_m) and torch.equal(t, want_t)
    if with_prefix:
        assert torch.equal(prefix, shared_prefix_length(a, b))
    else:
        assert (prefix == -7).all()  # a null prefix_out writes nothing


@pytest.mark.parametrize("dtype", [np.int8, np.int32], ids=["int8", "int32"])
def test_jaro_scan_configures_each_device(libs, dtype):
    """The emulation holds a kernel's dynamic shared memory limit a device,
    as a card does: K2 at w200 (more than 48 KB a block on int8) launches on
    a device after launching on another, and on the first again."""
    a, b, la, lb = _tiles(200, dtype, True, 24)
    want = jaro_cuda.jaro_plain(a, b, la, lb)
    try:
        for device in (0, 1, 0):
            libs["jaro_scan"].emu_set_device(device)
            m, t = torch.empty(a.shape[0], dtype=torch.int32), torch.empty(a.shape[0], dtype=torch.int32)
            rc = libs["jaro_scan"].strsim_jaro_scan(
                a.data_ptr(), b.data_ptr(), a.stride(0), b.stride(0), la.data_ptr(), lb.data_ptr(),
                m.data_ptr(), t.data_ptr(), None, a.shape[0], 200, a.element_size(), None)
            assert rc == 0, f"device {device}: cudaError_t {rc}"
            assert torch.equal(m, want[0]) and torch.equal(t, want[1])
    finally:
        libs["jaro_scan"].emu_set_device(0)


@pytest.mark.parametrize("width", [0, 513])
def test_jaro_scan_refuses_widths_outside_the_ladder(libs, width):
    a = torch.zeros((4, max(width, 1)), dtype=torch.int8)
    la = torch.zeros(4, dtype=torch.int32)
    m = torch.empty(4, dtype=torch.int32)
    assert libs["jaro_scan"].strsim_jaro_scan(a.data_ptr(), a.data_ptr(), a.stride(0), a.stride(0),
                                              la.data_ptr(), la.data_ptr(), m.data_ptr(),
                                              m.data_ptr(), None, 4, width, 1, None) != 0


@pytest.mark.parametrize("x_skip,out_skip", [(0, 0), (1, 1), (2, 2), (3, 3), (1, 0), (0, 3)])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1021, 1024, 4099])
def test_warm_matches_plain(libs, n, x_skip, out_skip):
    """x and out start x_skip and out_skip int32 past a 16-byte boundary:
    16-byte accesses with a head of 4 - skip elements where the two agree,
    single accesses where they do not; n % 4 and n < 4 leave a tail."""
    rng = np.random.default_rng(n * 16 + x_skip * 4 + out_skip)
    x_base = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n + 8).astype(np.int32))
    out_base = torch.full((n + 8,), 12345, dtype=torch.int32)
    # torch's allocations are 16-byte aligned: the views sit `skip` elements past a boundary
    assert x_base.data_ptr() % 16 == 0 and out_base.data_ptr() % 16 == 0
    x, out = x_base[x_skip:x_skip + n], out_base[out_skip:out_skip + n]
    assert libs["warm"].strsim_warm(x.data_ptr(), out.data_ptr(), n, None) == 0
    assert torch.equal(out, warm_plain(x))
    untouched = torch.ones(n + 8, dtype=torch.bool)
    untouched[out_skip:out_skip + n] = False
    assert (out_base[untouched] == 12345).all()


def test_warm_of_no_elements_launches_nothing(libs):
    x = torch.zeros(4, dtype=torch.int32)
    assert libs["warm"].strsim_warm(x.data_ptr(), x.data_ptr(), 0, None) == 0
    assert (x == 0).all()
